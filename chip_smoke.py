#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit (``nvcc`` on PATH or under ``$CUDA_HOME``)::

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py observability    # phases 1-2, then 19 alone
    python3 chip_smoke.py train_serve      # phases 1-2, then 20 alone
    python3 chip_smoke.py generate         # phases 1-2, then 21 alone
    python3 chip_smoke.py parallel         # phases 1-2, then 22 alone
    python3 chip_smoke.py model_parallel   # phases 1-2, then 23 alone
    python3 chip_smoke.py fleet            # phases 1-2, then 24 alone
    python3 chip_smoke.py sparse           # phases 1-2, then 25 alone
    python3 chip_smoke.py detection        # phases 1-2, then 26 alone

Phases, each of which raises on failure:

1. device: the card's name and power limit, and the TF32 settings;
2. build: the hand-written CUDA kernels, compiled from
   ``mxnet_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all at once);
   then ``cuobjdump -sass`` of the flash library counts the bf16
   tensor-core instructions (``HMMA.16816.F32.BF16``) of the bf16 D-64
   instances of K7a, K7b and K7c, and that of the softmax library the
   128-bit global loads (``LDG.E.128``) and the cluster's instructions
   (``STAS``, ``SYNCS.PHASECHK``, ``UCGABAR``) of K2's wide-row instances
   at C 10000 (fp32 and bf16), none of which may be 0;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes a batch-32 ResNet-50 forward gives it.  K3 (BatchNorm->ReLU
   epilogue) must be bitwise equal at all 33 fused sites, fp32 and bf16,
   relu on and off; K2 (softmax) within 1e-6 in fp32 and 1e-2 in bf16,
   rows summing to 1, at the serving buckets of 32, 8 and 1 rows and at
   the edges of its layouts (C 1, 999, 1024, 1025, 4097; past 1024
   columns ``K2_WIDE_CASES``: one CTA a row, a cluster a row, scalar
   loads, the streaming form), and a NaN in one row reaching that whole
   row and no other (``K2_NAN_CASES``).  Each is timed
   beside its plain version, the one PyTorch call that computes the same
   function where there is one, and the least time the card could take
   (bytes over HBM rate, operations over the fp32 rate); K2 also at
   (96 x 1024, 1024), where bytes and not the launch bound it, and at
   the wide rows of ``K2_WIDE_TIMED``;
4. serving (the main path): full-width ResNet-50 v1 with random weights
   from a seed (the classifier scaled so the logits are O(1), see
   ``calibrate_fc``), served by ``ModelServer`` (buckets 1..32): warmup of
   every bucket, then 64 requests of 1-3 rows from 8 client threads.
   Every answer is held against a ``Predictor`` forward of the same rows
   with both kernel knobs at 0, and the launch counts are held to 33 (K3)
   and 1 (K2) per forward.  Then a bucket-32 forward is timed with the
   kernels and with both knobs at 0, and profiled by kind of kernel;
5. training (the second main path): ``Module.fit`` on full-width ResNet-50
   v1 fp32 at batch 32 with ``kvstore="tpu"`` (the executor's fused step),
   SGD momentum 0.9, wd 1e-4, Xavier weights from a seed, on one fixed
   synthetic batch held on the card: 3 warmup steps and 20 timed ones.
   The launch counts are held to buckets x steps (K1b) and one per step
   (K2), and the cross-entropy on the batch must fall from the first step
   to the last;
6. parity: from one saved state, one step with the sweep kernels and one
   with ``MXNET_PALLAS_FUSED_OPT=0`` (the per-array path), cuDNN
   deterministic: weights, momentum and moving stats bitwise equal, or
   within 1e-6 relative;
7. the other optimizer paths: Adam (K4) and SGD without momentum (K1a)
   on the same model, 3 warmup and 10 timed steps each, each launching
   its kernel; Adam's bias correction rewrites the hyperparameter table
   every step, so its step time is printed beside the constant-lr SGD
   step; after phase 8's profiler timings two more steps of each path run
   with torch's sync debug mode at "error", which raises if a step makes
   the host wait for the card;
8. the sweep kernels (K1a, K1b, K4) bitwise against their plain versions
   at the bucket sizes of the training path, at 1, 3 and 4097 elements,
   on a view whose offset breaks 16-byte alignment, clip on and off, and
   timed per bucket beside their plain versions and bounds;
9. the transformer kernels against their plain versions, at the shapes a
   GPT-2-small-width ``TransformerLM`` forward at batch 8 gives them: K6a
   (LayerNorm) at (8192, 768) and at C = 37 and 1000, K7a (flash
   attention) at (96, 1024, 64) causal and full, at T 8/64/1024 x D
   32/64/128, at the edges of its tiles (T 1/127/129/1000 x D 64/128),
   at Tq != Tk and at D 8-512 (D 320 and 512 in chunks of 64 columns),
   each in fp32 and in bf16,
   K5a (bias softmax) at (96, 1020, 1020) with the causal bias and without
   a mask; fp32 and bf16; each timed beside its plain version, its bound
   and one PyTorch call, K7a also full, in bf16 and at (48, 1024, 128),
   with its achieved TFLOP/s;
10. the transformer (the third main path): gluon ``TransformerLM`` at
   GPT-2 small's widths (vocab 50257, 768 units, 3072 hidden, 12 layers,
   12 heads, 1024 positions), Xavier weights from a seed, hybridized, run
   at (8, 1024), where attention takes the flash kernel, and at (8,
   1020), where it takes the einsum logits and K5a.  Launches are held to
   25 K6a + 12 K7a and 25 K6a + 12 K5a per forward; the logits to a
   plain fp32 forward of the same parameters (``causal_attention`` and
   the plain LayerNorm) within 1e-4 of their largest magnitude, a bound
   the same plain forward with TF32 matmuls must break.  Then the forward
   time by CUDA events and tokens/s;
11. the backward kernels against their plain versions, at the shapes the
   transformer's training step gives them: K6b (LayerNorm dx) at (8192,
   768) fp32 and bf16 and at ``K6B_EDGE`` (the edges of its vector
   layout's instances, the scalar and block layouts, operands off their
   16-byte alignment, row counts that are not a multiple of its
   persistent grid), K7b (flash dq) and K7c (flash dk, dv)
   at (96, 1024, 64) causal and full, at ragged T (1, 7, 15, 17, 63, 65,
   1020), at Tq != Tk and across head dims (8, 72, 200, every instance
   width 32-256, 320 and 512), K5b (softmax backward) at
   (96, 1020, 1020) with the causal probabilities; fp32 within 1e-5 of the
   largest magnitude, bf16 within one rounding; each timed
   beside its plain version, its bound and one PyTorch call (K7b and K7c
   against both their 3xTF32 tensor-core bound and their fp32 CUDA-core
   one, with their TFLOP/s);
12. transformer training (the fourth main path): the same GPT-2-small-width
   ``TransformerLM``, fresh from the same seed, trained at (8, 1024) and
   at (8, 1020): ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` ->
   ``.mean()`` -> ``backward()`` -> ``gluon.Trainer("adam", lr 1e-4)
   .step(1)`` on one fixed batch held on the card.  The first step's
   gradients are held within 1e-4 of each parameter's largest magnitude
   to the same step through plain torch (every knob 0 and
   ``impl="einsum"``) that takes the kernel forward's ReLU decisions (an
   fp32 ReLU input within rounding of 0 may fall on the other side in
   another summation order: the run counts them, and prints both fp32
   steps against a float64 one); every parameter's gradient must be
   nonzero; the first main-path step's launches are held to 25 K6a + 25
   K6b + 12 K7a + 12 K7b + 12 K7c (T 1024) and 25 K6a + 25 K6b + 12 K5a +
   12 K5b (T 1020); then 1 more warmup and 5 timed steps (CUDA events,
   tokens/s), and the loss on the batch must fall from the first step to
   the last;
13. checkpoints, cuDNN deterministic, in a temporary directory of the
   checkout removed at the end: ResNet-50 through ``Module.fit`` (batch
   32, ``kvstore="tpu"``, SGD momentum, 2 epochs of 3 steps) with
   ``module_checkpoint(save_optimizer_states=True)``, each save timed, the
   files read back (``nd.load``, ``load_optimizer_states``); the epoch-2
   files served by ``ModelServer.load_model`` (one bucket-32 batch, 33
   K3 + 1 K2) and held to the module's forward (bitwise, or within 1e-6
   of the largest); ``Module.load(prefix, 1, load_optimizer_states=True)``
   and ``fit(begin_epoch=1)`` held to the uninterrupted run's weights,
   momentum and moving stats (bitwise, or within 1e-6 of each tensor's
   largest; K1b launches), and the same resume without the momentum,
   which must exceed that bound; then phase 12's T 1024 transformer
   through ``save_parameters`` and ``Trainer.save_states`` (SGD momentum
   after one step, and Adam) into a fresh model and trainers: logits
   bitwise, Adam's m and v bitwise as loaded, one SGD step of each model
   (weights bitwise or within 1e-6; 25 K6a + 25 K6b + 12 K7a/b/c), one
   Adam step of each (m and v likewise; the resumed update count restarts,
   as in the JAX package); sizes, save and load ms and MB/s printed;
14. the operator library and Inception-BN: (a) every ``OP_CASES`` entry
   (each op name the library added, over its attribute variants) on the
   card against the same call on CPU tensors, forward, the inputs after
   the call and the backward of the differentiable ones, in the table's
   bands (bitwise for data movement, indexing, comparisons and casts,
   1e-6 of the largest for fp32 arithmetic, the stated bound of a
   special function), every output on the card; every sampler's moments
   over 10^6 draws on the card within 5 standard errors, the same seed
   giving the same draws twice, each draw under sync debug mode "error"
   (a draw made on the host and copied would raise); one
   ``nd.contrib.fused_bn_relu`` call: one K3 launch, bitwise equal to
   ``scale_bias_relu_ref``.  (b) Inception-BN (``symbols/inception_bn``,
   1000 classes, 3x224x224, fp32, batch 32) through ``Module.fit``
   (``kvstore="tpu"``, SGD lr 0.02 momentum 0.9 wd 1e-4, Xavier from
   the seed): 3 warmup and 10 timed steps on one fixed batch, launches
   held to K1b once a bucket and K2 once a step, the loss falling; then
   the trained parameters served by ``ModelServer`` (buckets 1..32), each
   answer held to a ``Predictor`` bound at the answer's own bucket on the
   same parameters (bitwise or within 1e-6 of the largest; across shapes
   cuDNN runs other engines for 1, 2 and 4 rows than for 32, so the
   distance from the module's 32-row forward is printed beside it, not
   held), 69 K3 and 1 K2 a forward; after the profiler timings one
   profiled step (idle share) and 2 steps under sync debug mode "error";
15. bf16 mixed precision: (a) ResNet-50 v1 (1000 classes, 3x224x224,
   batch 32) through ``Module(sym, compute_dtype="bfloat16").fit`` with
   ``kvstore="tpu"`` (SGD lr 0.02 momentum 0.9 wd 1e-4, Xavier from the
   seed): first one step against the same step with every kernel knob at
   0 (cuDNN deterministic; the fp32 masters' updates within one bf16
   rounding of each tensor's largest; its convolutions and FC read bf16
   data and weights, ``op_dtype_spy``), then 3 warmup and 20 timed steps
   on one fixed batch, launches held to K1b once a bucket a step on the
   fp32 masters and K2 once a step (in fp32: SoftmaxOutput upcasts its
   bf16 logits, as the JAX op does), masters, moving stats, momentum and
   buckets fp32, the loss falling; then a bucket-32 bf16 eval forward of
   the trained parameters with its logits as a second output: 33 K3 in
   bf16 and 1 K2, the logits within ``BF16_EVAL_TOL`` of the largest of
   the knobs-0 forward's, and no further from the fp32 forward's than
   twice the knobs-0 ones.  (b) phase 10's GPT-2-small-width
   ``TransformerLM`` cast with ``lm.cast("bfloat16")``, hybridized, at (8,
   1024): the forward's 25 K6a and 12 K7a in bf16, its logits held to the
   knobs-0 bf16 forward (``LM_BF16_LOGIT_TOL``); one step's gradients
   (bf16, all nonzero) held to the knobs-0 step with the same ReLU
   decisions (``LM_BF16_GRAD_TOL``, or twice that step's own distance
   from float64); one ``record`` -> ``SoftmaxCrossEntropyLoss`` ->
   ``backward`` -> ``Trainer("adam", lr 1e-4).step`` launching 25 K6a, 25
   K6b, 12 K7a, 12 K7b and 12 K7c in bf16; 1 warmup and 5 timed steps,
   the loss falling.  (c) a small gluon MLP cast to float16 through 5
   steps of ``Trainer("sgd", multi_precision, momentum 0.9)`` on the card
   and on the CPU: fp16 weights, fp32 masters within ``FP16_TOL`` of the
   CPU's, the loss falling;
16. the training-loop API: (a) ResNet-50 v1 fp32 (1000 classes,
   3x224x224, batch 32, Xavier from the seed) bound once by a ``Module``
   with ``kvstore="tpu"``; for each of the fourteen optimizers that update
   one array at a time (``LOOP_OPTIMIZERS``, each with a
   ``PolyScheduler``) one step from the same parameters, its new weights
   and states held within ``LOOP_TOL`` of each array's largest to the same
   update replayed through the port on CPU tensors from the card's
   weights, gradients and the updater's pickled optimizer and states
   (SGLD stepped twice from the same state: with its noise set to zeros,
   held so; with the card's noise, that noise by its mean and standard
   deviation), K2 launched once and no sweep kernel, then 2 steps timed by
   CUDA events; (b) one ``Module.fit`` (2 epochs of 3 batches, ``nag``
   momentum 0.9 under a ``PolyScheduler``) with a ``CompositeEvalMetric``
   of ``Perplexity``, ``NegativeLogLikelihood``, ``Loss`` and a
   ``metric.np`` metric, each held to numpy's formula on the fetched
   outputs, ``monitor=Monitor(1, pattern=".*(conv0|fc1).*")`` (a finite
   stat for each matched name each batch), ``Speedometer``,
   ``log_train_metric``, ``ProgressBar`` and, on one ``eval_data``
   batch, ``LogValidationMetricsCallback`` (their log lines counted); K2
   once a step and once an eval forward, K3 at the 33 sites of each eval
   forward; then 3 steps from one state with every node tapped by
   ``Monitor(monitor_all=True)`` bitwise equal to 3 without a monitor
   (cuDNN deterministic), both timed; (c) inside ``engine.naive()`` the
   stream is idle after each imperative op, and a worker's exception with
   no receiver raises at the next ``nd.waitall()`` and not again;
17. the data pipeline and the module family: (a) 640 synthetic JPEGs
   (short side 256, long side 256-384, quality 95, 10 classes of smooth
   patterns, from the seed) written into a ``.rec``/``.idx`` by the
   port's ``recordio.pack_img`` in a temporary directory of the checkout;
   one epoch of ``ImageRecordIter`` alone (images/s); then ResNet-50 v1
   fp32 through ``Module.fit`` from the records (batch 32, shuffle,
   random crop and mirror, train_imagenet.py's means, ``seed_aug``,
   ``kvstore="tpu"``, SGD lr 0.02 momentum 0.9 wd 1e-4, one epoch of 20
   batches and an ``eval_data`` of 2 batches from every 10th record):
   K1b once a bucket a step, K2 once a step and once an eval forward, K3
   at the 33 sites of each eval forward; every batch the model received
   bitwise equal to the host's replay of the reader (``_mp_decode`` and
   the normalisation, record by record, from the same seeds), and so the
   3 batches of ``PrefetchingIter(ResizeIter(...))`` over a fresh reader;
   the cross-entropy of the last 4 batches below that of the first 4.
   (b) example/rnn/lstm_bucketing.py's model (two unrolled ``LSTMCell``
   layers of 200, embedding 200, vocabulary 10,000, batch 32, buckets
   10-60) over ``BucketSentenceIter`` on a synthetic corpus from the seed
   (3 batches a bucket), through ``BucketingModule.fit`` with Adam lr
   0.01 and ``kvstore="tpu"`` (the kvstore's store, not the executor's
   step), 2 epochs: each bucket's first-step gradients within
   ``BUCKET_GRAD_TOL`` of the CPU's, K2 once a step, the cross-entropy
   falling, a step in bucket 60 read bitwise by bucket 10's executor
   (the same arrays), and ``FusedRNNCell`` (the ``RNN`` op, cuDNN)
   against its ``unfuse()``d cells within ``FUSED_TOL`` (an LSTM, a GRU
   and a bidirectional LSTM, each at the model's widths and T 60).  (c)
   K2 at (320, 10000) and (1920, 10000) against its plain version, timed
   beside ``torch.softmax``, its bound and K2 as the parent commit had it
   past 1024 columns (the strided form, built by ``time_variants.py`` as
   a variant of ``softmax.cu``);
18. gluon's image path: (a) example/gluon/image_classification.py's loop
   on the port: model-zoo ResNet-50 v1 (1000 classes, 25.6 M values in
   299 arrays, 193 of them updated a step), ``initialize(Xavier())``,
   ``hybridize()``, ``gluon.Trainer`` SGD lr 0.05 momentum 0.9,
   ``SoftmaxCrossEntropyLoss`` under ``autograd.record()``, batch 32
   from a ``DataLoader`` (4 threads, shuffled, the short last batch
   discarded) over ``ImageRecordDataset`` of phase 17's records through
   ``RandomResizedCrop(224)``, ``RandomFlipLeftRight``, ``ToTensor`` and
   ImageNet's ``Normalize``; 3 warmup and 10 timed steps (CUDA events,
   the loader's wait included).  (b) The first step held to the CPU as
   phase 16 holds its updates: the Trainer's SGD replayed on the CPU from
   the card's weights and gradients, each BatchNorm's moving statistics
   replayed by the op on the CPU from the input the card's op had, all
   within ``LOOP_TOL``.  (c) An eval forward of the next batch held to
   the same network on the CPU within ``CROSS_SHAPE_TOL``; then, as the
   example trains, 10 steps on the first batch alone, the median of the
   last 3 losses below that of the first 3.  (d)
   ``symbols/resnet.py``'s ResNet-50 written by ``model.save_checkpoint``
   and served through ``SymbolBlock.imports``: 4 batches bitwise equal to
   a ``Predictor``'s at batch 32 from the same files, with K3 at 33
   sites and K2 once a forward;
19. (after the timing below) telemetry, tracing and the profiler: (a)
   phase 5's ResNet-50 fit, 3 + 10 steps cuDNN deterministic, with
   ``MXNET_TELEMETRY``, the step log, tracing and the profiler's device
   trace (``set_config(jax_trace_dir=...)``, torch.profiler) on, then on
   without the profiler and all off in turns (``OBS_RUNS``): weights on
   and off bitwise equal, one step line a batch, no compile past the
   first step, the kernel counter ``mxnet_pallas_kernel_calls_total``
   at 2 K1b and 1 K2 a step and equal to the device trace's launches,
   the exposition valid, the dump holding the ``fit.step`` spans, the
   ``'C'`` events and the kernels; the step's cost of telemetry; (b)
   phase 4's load through ``ModelServer`` with all of it on: ``stats()``
   equal to the ``mxnet_serving_*`` families, cache misses equal to
   compiles, K3 33 and K2 1 a forward on the counter and in the trace,
   one ``serving:batch`` span a forward; (c) gluon.rnn's medium LSTM LM
   (``LSTM_LM``: Zaremba et al. 2014) trained by ``gluon.Trainer`` with
   ``clip_global_norm``: its first step (dropout 0) against the CPU
   within ``LSTM_LM_TOL``, the LSTM layer against its unrolled
   ``LSTMCell``s within ``FUSED_TOL``, 3 + 10 timed steps, 10 steps on
   the first batch alone with the loss falling, the step's device busy
   time and its parts' alone;
20. (after 19) the train-to-serve loop, cuDNN deterministic, in a
   temporary directory of the checkout removed at the end, on full-width
   ResNet-50 v1 fp32: (a) ``Module.fit`` (batch 32, ``kvstore="tpu"``,
   SGD lr 0.02 momentum 0.9 wd 1e-4, Xavier from the seed, a seeded
   synthetic ``NDArrayIter`` with ``shuffle=True``) checkpointed by a
   ``CheckpointManager`` (a save every 3 steps, async, ``keep_last=2``):
   its step ms with and without the manager in turns, each save's
   staging ms, the writer's MB/s, every save the writer took committed;
   then 3 epochs of 3 steps with (b) a ``ModelServer`` beside it
   (buckets 1..32, the warmup manifest, ``canary_fraction=0.25``)
   watching the directory, 4 client threads sending 1-3 rows at
   priorities 0-2: at each save the fit waits for the commit and the
   verdict; every version warmed at every bucket before promotion, each
   after the first through the canary gate, no warmup failure logged,
   retention keeping the newest two; serial requests after the last
   promotion bitwise equal to a ``Predictor`` over that checkpoint at
   the answer's bucket; a version with a NaN in its FC weight committed
   into the store rolled back and unloaded by the non-finite sentinel on
   its first canary batch, the last good version answering after;
   (c) a burst at max(6x the sustained rate, 2000/s) over three priority
   classes with 400 ms deadlines: brownout entered and left, class 0
   served, every shed and rejection counted by class and reason in
   ``stats()``, on the client and in the registry, the ledger balanced;
   (f) one ``serving.worker`` fault failing its batch only; (g) the
   launches of (a)-(c) held through ``mxnet_pallas_kernel_calls_total``:
   K1b once a bucket and K2 once a fit step, K3 at the 33 sites and K2
   once a served forward; (d) the server restarted in a new process on
   the manifest (``python3 chip_smoke.py _ts_restart ...``): the
   manifest's buckets bound before the first live request, no miss
   after, the compile cache's hits and no ``nvcc``; the first live
   requests' p50 and p99 with the manifest warmup and cold; (e) the
   newest checkpoint restored by ``CheckpointManager.restore_latest``
   into a fresh ``Module``, two steps bitwise (or within ``CKPT_TOL``)
   the uninterrupted run's; (f) one ``checkpoint.store.commit`` fault
   failing its save only;
21. (after 20) generative serving and the elastic fit: (a) the
   GPT-2-small-width ``TransformerLM`` (phase 10's widths, Xavier from
   the seed, fp32) through ``ModelServer.add_generative_model("lm", blk,
   slots=8, max_len=1024, prefill_batch=4)`` and ``warmup_generative()``
   (3 batch rungs x 11 length rungs = 33 grid cells bound and run), then
   ``infer_stream`` traffic as bench_serving.py's generative leg at this
   width (``GEN_SOLO``: 8 waves of 4 class-0 requests, 12-token prompts,
   16 new tokens; the same waves beside one class-1 generation of a
   32-token prompt and 512 new tokens; then rounds of a full pool of
   24-token prompts with 256 new tokens until 1000 decode steps have
   run): warmup seconds, TTFT p50/p99 solo and mixed (mixed p99 at most
   ``GEN_CONVOY`` x solo p99: no convoy), steady tokens/s with no
   executor-cache miss and ``compile_stats()`` unchanged across those
   steps, every tenant's ledger balanced; the decode step of 8 live slots
   by CUDA events and one decode step's and one (4, 32) prefill's device
   busy time and idle share by the profiler; KV and weight bytes.  (b)
   prompts of 5, 64, 200 and 512 tokens served for 32 greedy tokens each,
   held to the block's own forward (K6a, and K7a or K5a by the length,
   counted as ``launches_generative``) by ``GEN_NEAR_TIE``'s rule; one
   prefill and 8 decode steps against the same model on the CPU (tokens
   equal, K/V within ``GEN_CPU_TOL``); a ``serving.decode.step`` fault for
   one tenant failing that stream alone, the others' tokens those served
   without the plan.  (c) phase 20's ResNet-50 fit (2 epochs of 8 steps,
   cuDNN deterministic, a ``CheckpointManager`` save every 2 steps) under
   ``fit(elastic=True)`` with a SIGTERM at the first attempt's step 5 and
   an error at the second's step 8: weights, momentum and moving stats
   bitwise the uninterrupted fit's, 2 faults injected and retried, one
   run recovered, K1b once a bucket and K2 once for every step run
   (replays included, ``launches_elastic``), each fault's time to
   recover;
22. data-parallel training across the cards (``parallel_phase``);
23. model-axis sharding (``model_parallel_phase``): K7a, K7b and K7c at
   the per-rank shape of four ranks' Ulysses step of GPT-2 small, (24,
   1024, 64) causal, against the plain route; then, in a world of one
   rank per card over NCCL (``run_ranks``): (a) GPT-2 small through
   ``ParallelTrainer`` (Adam, zero=2) on dp=2 x tp=2, dp=1 x fsdp=4 and
   dp=2 x sp=2 (on one card, the one-rank mesh), each mesh's first SGD
   update from the seeded state within ``MP_TOL`` of the dp-only
   trainer's, 2 warmup and 5 timed steps (CUDA events), their losses
   within ``MP_LOSS_TOL`` of the dp-only trainer's, one profiled
   step's NCCL kernels by kind; (b) the LM at T 8192 under an sp mesh of every card
   (its attention through the ring) against its dense forward,
   ``ulysses_attention`` at (8, 4096, 12, 64) and ``ring_attention`` at
   T 4093 (padded), causal, forward and backward, against
   ``local_attention``; (c) ``pipeline_apply`` of one
   ``TransformerEncoderCell`` a card at (8, 1024, 768), 8 microbatches,
   against the sequential apply; (d) ``switch_moe`` with 8 FFN experts
   768 -> 3072 -> 768 over 8192 tokens, with and without dropped tokens,
   against the routing token by token on one rank (``moe_reference``);
   each within ``MP_ATTN_TOL``; ``launches_model_parallel`` by kernel and
   main-path call, and on four cards K7a, K7b, K7c, K6a, K6b and K4 each
   launched;
24. the asynchronous and multi-process rest of multi-GPU
   (``fleet_phase``);
25. sparse storage (``sparse_phase``), on data written from the seed:
   (a) ``example/sparse/linear_classification.py``'s flow at 1,000,001
   features (LIBSVM avazu-app's width), batch 8192, 15 stored values a
   row, 16 batches for 2 epochs (``LibSVMIter``, ``row_sparse_pull``,
   the CSR ``dot`` both ways, a row-sparse push and the lazy SGD on a
   ``local`` store), each batch's CSR exact to a numpy parse, the first
   two steps within ``SPARSE_TWIN_TOL`` of the port on the CPU, the rows
   no batch named bitwise, accuracy above 0.8 and under 1 GiB of device
   memory; (b) ``example/recommenders/matrix_fact.py``'s ``MFBlock`` at
   MovieLens-10M's id ranges, factor 128, batch 4096, one pass over 10 M
   ratings under ``gluon.Trainer("adam")``, the first two steps within
   ``SPARSE_TWIN_TOL`` of the CPU, the rows no batch looked up bitwise in
   the weights and both Adam states, the validation RMSE falling, and no
   K1a, K1b or K4 launch in ``mxnet_pallas_kernel_calls_total``;
26. the detection and ROI ops (``detection_phase``), fp32 without TF32,
   random weights and synthetic images from the seed: (a)
   ``example/ssd/train.py``'s flow at SSD300's widths (VGG16-reduced,
   8,732 anchors, 21 classes, batch 32): 3 + 10 ``gluon.Trainer`` SGD
   steps on one batch (the loss falling), the host syncs of a step and
   its idle share, ``MultiBoxTarget`` held to the port on the CPU (mining
   flips within fp32 rounding counted), the decode at ``nms_topk`` 400
   and -1 held to a numpy sequential NMS (``detection_oracle``) on 4
   images; (b) ``example/rcnn``'s ``detect`` flow at VGG16 end to end's
   widths (4 images of 600 x 1000, 21,546 anchors an image):
   ``MultiProposal``, ``ROIPooling`` and ``ROIAlign`` on 1,200 ROIs with
   their backward, per-class ``box_nms``, 8 ROIs' gradient held to the
   CPU; (c) the deformable pair at Deformable R-FCN's res5 width, held to
   the CPU; no kernel launch expected;
then every kernel's device time by the profiler (K6b's with the L2 cache
overwritten before each launch; the bf16 instances of K3, K6a, K6b,
K7a, K7b and K7c that phase 15 launches beside their plain versions,
bounds at the bf16 rate and one PyTorch call each), one profiled serving
forward, training step, transformer forward and transformer training
step, and phase 15's ResNet-50 step, bf16 transformer forward and step.

Prints one JSON line ``{"checkpoints": {...}}`` with phase 13's numbers,
``{"ops": {...}}`` and ``{"inception_bn": {...}}`` with phase 14's,
``{"mixed_precision": {...}}`` with phase 15's, ``{"training_loop":
{...}}`` with phase 16's, ``{"data_pipeline": {...}}`` with phase 17's
(with the records fit's idle share), ``{"gluon": {...}}`` with phase
18's (with its step's idle share and per-array SGD's device time),
``{"observability": {...}}`` with phase 19's, ``{"train_serve":
{...}}`` with phase 20's, ``{"generative": {...}}`` and ``{"elastic":
{...}}`` with phase 21's, ``{"parallel": {...}}`` with phase 22's,
``{"model_parallel": {...}}`` with phase 23's, ``{"fleet": {...}}``
with phase 24's, ``{"sparse": {...}}`` with phase 25's,
``{"detection": {...}}`` with phase 26's, one
``{"kernels":
[...]}`` (all twelve kernels; K3, K2 and K1b with their
``launches_inception``, K1b, K2, K3, K6a, K6b, K7a, K7b and K7c with
their ``launches_mixed``, K2 and K3 with their
``launches_training_loop``, K1b, K2 and K3 with their
``launches_data_pipeline``, K2 and K3 with their ``launches_gluon``
(a SymbolBlock forward's), K1b, K2 and K3 with their
``launches_observability`` (phase 19's counter and device trace) and
``launches_train_serve`` (phase 20's), K6a, K7a and K5a with their
``launches_generative`` (phase 21's oracle forwards), K1b and K2 with
their ``launches_elastic`` (phase 21's elastic fit), the kernels
phases 22 and 23 launch with their ``launches_parallel`` and
``launches_model_parallel``, K2 with its ``lm``
jobs (the parent's
strided form's times beside them) and its wide rows' SASS counts
(``sass_wide``), K3,
K6a, K7b and K7c with their ``bf16``
times, K7a, K7b and K7c with the ``HMMA.16816.F32.BF16`` count of their
bf16 D-64 instances (``hmma_bf16_dp64``), K6b's fp32 and bf16 repeats beside
aten's), the serving, training
and transformer numbers beside the card's name and power limit, and as
its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
import contextlib
import json
import logging
import math
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import torch

BATCH = 32                  # the largest serving bucket
IMAGE = (3, 224, 224)
LAYERS = 50
REQUESTS = 64
CLIENTS = 8
SEED = 0
KNOBS = ("MXNET_PALLAS_BN_RELU", "MXNET_PALLAS_SOFTMAX")
FUSED_OPT = ("MXNET_PALLAS_FUSED_OPT",)
CLASSES = 1000
TRAIN_WARMUP = 3            # untimed steps before the timed ones
TRAIN_STEPS = 20            # timed steps
OTHER_STEPS = 10            # timed steps of each other optimizer path
SGD_PARAMS = {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4}
# GPT-2 small's published widths (Radford et al. 2019, the gpt2
# config.json: n_embd 768, n_head 12, n_layer 12, n_ctx 1024, vocab 50257)
GPT2_SMALL = {"vocab_size": 50257, "units": 768, "hidden_size": 3072,
              "num_layers": 12, "num_heads": 12, "max_len": 1024}
LM_BATCH = 8
LM_T = (1024, 1020)         # the flash route, then the K5a route
LM_TRAIN_WARMUP = 2         # untimed training steps, the first one counted
LM_TRAIN_STEPS = 5          # timed training steps
LM_ADAM = {"learning_rate": 1e-4}
CKPT_STEPS = 3              # steps an epoch of phase 13's ResNet-50 fit
LM_SGD = {"learning_rate": 1e-4, "momentum": 0.9}
# Phase 13: a resumed run against the uninterrupted one, and a served
# checkpoint against the module that wrote it, when not bitwise equal
# (another cuDNN algorithm), within this much of each tensor's largest
# magnitude.  Dropping the momentum at the resume must exceed it.
CKPT_TOL = 1e-6
# Phase 14: a served Inception-BN answer at bucket 1, 2 or 4 against the
# module's 32-row forward of the same rows, which cuDNN computes with other
# convolution engines: within this much of the largest logit.  Readings on
# an H100 so far reach 2.61e-6; a wrong kernel or op moves logits by far more.
CROSS_SHAPE_TOL = 1e-4
# The kernel step's gradients against the plain torch step's with the same
# ReLU decisions: the same fp32 arithmetic with sums in another order,
# ~1e-6 to 1e-5 of each parameter's largest gradient.
GRAD_TOL = 1e-4
# The port's fp32 forward and the plain one differ only in the order of
# fp32 sums (attention, LayerNorm): ~1e-6 of the largest logit.  TF32
# rounds every matmul input to 10 mantissa bits: ~1e-3.  The bound sits
# between, so a forward that ran its matmuls in TF32 fails it.
LOGIT_TOL = 1e-4

# (name fragment, HBM bytes/s, fp32 FLOP/s outside the tensor cores, dense
# TF32 and dense bf16 tensor-core FLOP/s: half the data sheets' rates with
# sparsity), from NVIDIA's data sheets; the first fragment found in the
# card's name wins.  A bf16 job is bound by the bf16 rate, whatever units
# its kernel computes on.
CARDS = (("H200", 4.8e12, 67e12, 494.5e12, 989.5e12),
         ("H100 NVL", 3.9e12, 60e12, 417.5e12, 835.5e12),
         ("H100 PCIe", 2.0e12, 51e12, 378e12, 756.5e12),
         ("H100", 3.35e12, 67e12, 494.5e12, 989.5e12))


class knobs:
    """Set kernel knobs (default: both serving knobs; None: unset, i.e.
    ``auto``) for a block."""

    def __init__(self, value, names=KNOBS):
        self.value = value
        self.names = names
        self.saved = {}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.names}
        for k in self.names:
            if self.value is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = self.value
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_rates(name):
    """(HBM bytes/s, fp32 FLOP/s, dense TF32 FLOP/s, dense bf16 FLOP/s)
    of the card."""
    for frag, bw, fp32, tf32, bf16 in CARDS:
        if frag in name:
            return bw, fp32, tf32, bf16
    raise RuntimeError("no published peak rates known for the card %r" % name)


def _device_us(evt):
    d = getattr(evt, "self_device_time_total", None)
    return d if d is not None else getattr(evt, "self_cuda_time_total", 0.0)


def device_times(fn, n=20):
    """{kernel name: device us per call} over ``n`` calls, by
    torch.profiler: the kernels' own time, without the host's."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e):
            out[e.key] = out.get(e.key, 0.0) + _device_us(e) / n
    return out


def device_ms(fn, n=20):
    """Device time per call of everything ``fn`` launches, in ms."""
    total = sum(device_times(fn, n).values())
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return total / 1e3


def _l2_flush(dev):
    """A sum of 128 MB of int32, whose reads replace what the L2 cache (50
    MB on the H100) held with clean lines (a write would leave dirty ones,
    which the timed kernel would pay to write back), in a kernel no timed
    function launches."""
    buf = torch.ones(32 * 2 ** 20, dtype=torch.int32, device=dev)
    return lambda: buf.sum()


def device_ms_cold(fn, dev, n=20):
    """Device time per call of the kernels ``fn`` launches, in ms, each
    call after the L2 cache is overwritten, so it finds its operands in
    device memory, as a training step finds a LayerNorm's x, written long
    before: the profiler's time of ``fn``'s own kernels, the flush's left
    out (it raises if the two share a kernel name)."""
    flush = _l2_flush(dev)
    theirs = device_times(flush, n=2)
    if set(theirs) & set(device_times(fn, n=2)):
        raise RuntimeError("the function launches the L2 flush's kernel")
    times = device_times(lambda: (flush(), fn()), n)
    total = sum(v for k, v in times.items() if k not in theirs)
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return total / 1e3


def time_cold_ms(fn, dev, n=20, reps=5):
    """Median over ``reps`` of the mean of ``n`` launches of ``fn``, each
    timed alone by CUDA events after the L2 cache is overwritten."""
    flush = _l2_flush(dev)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for a, b in ev:
            flush()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        times.append(sum(a.elapsed_time(b) for a, b in ev) / n)
    return sorted(times)[reps // 2]


def time_ms(fn, n=20, reps=5, warmup=3):
    """Median over ``reps`` of the mean time of ``n`` back-to-back calls,
    by CUDA events: what the caller sees, launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def bound_ms(nbytes, ops, bw, flops):
    t_bytes, t_ops = nbytes / bw, ops / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 14 (a): the operator library's case table, shared with the CPU
# tests (tests/test_torch_ops_*.py), which hold the same cases against the
# JAX package.  numpy inputs made from SEED; nothing here imports either
# package.
# ---------------------------------------------------------------------------
# bands: "exact" bitwise (data movement, indexing, comparisons, casts,
# integer-valued results); "f32" within OP_F32 of the largest |reference|
# (fp32 arithmetic, reductions, transcendental functions: the CPU, the
# card and XLA each round their own polynomial); a float: that op's own
# bound, given with its reason in OP_BAND_REASONS.  Gradients (the
# ``grad`` cases, d sum(out * w) / d input for a fixed random w) are held
# within OP_GRAD of the largest.
OP_F32 = 1e-6
OP_GRAD = 1e-5
OP_BAND_REASONS = {
    "special": "special functions (erfinv, gamma, gammaln, cbrt, rcbrt, "
               "tan, arccosh, arctanh) use other approximations on the CPU, "
               "on the card and in XLA; gamma, exp(lgamma(x)), compounds "
               "two of them: a few ulp of the largest value",
    "linalg": "factorizations and triangular solves (LAPACK, cuSOLVER and "
              "XLA order their sums differently) on well-conditioned 4x4 "
              "batches: some ulp more than one product",
    "rnn": "the fused RNN on the card is cuDNN's, whose LSTM and GRU cells "
           "at narrow widths (and tanh RNNs) take sigmoid and tanh from "
           "approximations: 3.5e-6 to 1.1e-5 of the largest output from a "
           "float64 run, against at most 9e-7 for fp32 on the CPU "
           "(time_variants.py rnn_accuracy; NVIDIA H100, cuDNN 9.22)",
}
OP_SPECIAL = 2e-6
OP_LINALG = 5e-6
OP_RNN = 5e-5
# ops whose call on the card may wait on it, so run_case does not hold
# them to no_host_sync (their outputs must still lie on the card)
_EIGH = ("torch.linalg.eigh reads its solver's info flag back to the "
         "host to raise on a failed decomposition, and torch has no eigh "
         "that skips that check; the decomposition runs on the card")
_NNZ = ("nd.cast_storage to a sparse storage type compacts the dense "
        "value on the card, and torch.nonzero reads the count of what is "
        "stored back to size the payload: the one host scalar of the JAX "
        "package's compaction")
_NMS = ("greedy NMS runs as a fixed point of one matrix-vector step and "
        "reads a convergence flag back after each round of steps (1, 2, 4, "
        "...): exact greedy suppression is sequential in the depth of its "
        "chains, which only the data knows")
_ROI = ("ROIPooling gathers each bin's window at the size of the call's "
        "largest bin, whose extent it reads back once (a bin may cover the "
        "whole map); the pooling runs on the card")
OP_HOST_SYNC = {"_linalg_syevd": _EIGH, "linalg_syevd": _EIGH,
                "cast_storage": _NNZ, "_contrib_box_nms": _NMS,
                "_contrib_box_non_maximum_suppression": _NMS,
                "MultiBoxDetection": _NMS, "_contrib_MultiBoxDetection": _NMS,
                "Proposal": _NMS, "_contrib_Proposal": _NMS,
                "_contrib_MultiProposal": _NMS, "ROIPooling": _ROI,
                "_contrib_ROIPooling": _ROI}


def _op_cases(seed=SEED):
    """The case table: a list of dicts with ``name`` (the op's registered
    name), ``inputs`` (numpy arrays), ``attrs``, ``band`` ("exact",
    "f32" or a float), ``grad`` (hold the backward too), ``ctx`` (the op
    takes a ``ctx`` attr: it has no tensor inputs), ``canon`` (outputs
    unique only up to sign, normalised before comparing) and ``after``
    (hold the inputs after the call: the optimizer ops write their
    states back into them)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32

    def u(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(f32)

    def ints(*shape, lo=-3, hi=4):
        return rng.randint(lo, hi, shape).astype(f32)

    def spd(b, n):
        m = rng.randn(b, n, n).astype(f32)
        return (m @ m.transpose(0, 2, 1) + n * np.eye(n, dtype=f32)) \
            .astype(f32)

    def tri(b, n, lower=True):
        m = rng.uniform(-1, 1, (b, n, n)).astype(f32)
        m = np.tril(m) if lower else np.triu(m)
        return (m + n * np.eye(n, dtype=f32)).astype(f32)

    cases = []

    def add(name, inputs, attrs=None, band="f32", grad=False, ctx=False,
            canon=None, after=True):
        cases.append({"name": name, "inputs": list(inputs),
                      "attrs": dict(attrs or {}), "band": band,
                      "grad": grad, "ctx": ctx, "canon": canon,
                      "after": after})

    # -- elemwise: unary ---------------------------------------------------
    for name in ("abs", "_abs", "sign", "rint", "round", "ceil", "floor",
                 "trunc", "fix"):
        x = rng.uniform(-4, 4, (4, 5)).astype(f32)
        x[0, :4] = [0.5, 1.5, -2.5, -0.5]       # halves: to even
        add(name, [x], band="exact", grad=name in ("abs", "_abs"))
    for name in ("sqrt", "rsqrt", "log", "log10", "log2", "log1p"):
        add(name, [u(4, 5, lo=0.1, hi=4.0)], grad=True)
    for name in ("exp", "expm1", "sin", "cos", "sinh", "cosh", "tanh",
                 "arcsin", "arccos", "arctan", "arcsinh", "degrees",
                 "radians", "sigmoid", "softsign", "reciprocal", "relu",
                 "softrelu", "erf"):
        x = u(4, 5, lo=-0.95, hi=0.95) if name in ("arcsin", "arccos") \
            else u(4, 5, lo=-3, hi=3)
        if name == "reciprocal":
            x = np.where(np.abs(x) < 0.1, 0.5, x).astype(f32)
        add(name, [x], grad=True)
    add("tan", [u(4, 5, lo=-1.2, hi=1.2)], band=OP_SPECIAL, grad=True)
    add("arccosh", [u(4, 5, lo=1.1, hi=4)], band=OP_SPECIAL, grad=True)
    add("arctanh", [u(4, 5, lo=-0.9, hi=0.9)], band=OP_SPECIAL, grad=True)
    for name in ("cbrt", "rcbrt"):
        x = u(4, 5, lo=-3, hi=3)
        if name == "rcbrt":
            x = np.where(np.abs(x) < 0.1, 0.5, x).astype(f32)
        add(name, [x], band=OP_SPECIAL, grad=True)
    add("erfinv", [u(4, 5, lo=-0.9, hi=0.9)], band=OP_SPECIAL, grad=True)
    add("gamma", [u(4, 5, lo=0.2, hi=4)], band=OP_SPECIAL, grad=True)
    add("gamma", [u(4, 5, lo=-2.9, hi=-0.1)], band=OP_SPECIAL)
    add("gammaln", [u(4, 5, lo=0.2, hi=6)], band=OP_SPECIAL, grad=True)
    add("logical_not", [ints(4, 5, lo=-1, hi=2)], band="exact")
    add("_copy", [u(3, 4)], band="exact", grad=True)
    add("identity", [u(3, 4)], band="exact", grad=True)
    for name in ("BlockGrad", "stop_gradient", "make_loss_grad_blocked"):
        add(name, [u(3, 4)], band="exact", grad=True)
    for dt in ("float16", "bfloat16", "int32", "uint8", "int8", "float64",
               "int64", "bool", "float32"):
        add("Cast", [u(3, 4, lo=-3, hi=3) if dt not in ("uint8",)
                     else u(3, 4, lo=0, hi=200)], {"dtype": dt},
            band="exact")
    add("cast", [u(3, 4, lo=-3, hi=3)], {"dtype": "int32"}, band="exact")
    add("clip", [u(4, 5, lo=-2, hi=2)], {"a_min": -0.5, "a_max": 0.7},
        band="exact", grad=True)
    add("clip", [u(4, 5, lo=-2, hi=2)], {"a_min": -0.5}, band="exact")
    add("hard_sigmoid", [u(4, 5, lo=-4, hi=4)], grad=True)
    add("hard_sigmoid", [u(4, 5, lo=-4, hi=4)], {"alpha": 0.3, "beta": 0.4})
    add("smooth_l1", [u(4, 5, lo=-2, hi=2)], {"scalar": 1.5}, grad=True)
    # -- elemwise: binary --------------------------------------------------
    for name, alias in (("_mod", "broadcast_mod"),):
        a = rng.uniform(-6, 6, (3, 4)).astype(f32)
        b = rng.uniform(0.5, 3, (3, 4)).astype(f32) * \
            rng.choice([-1, 1], (3, 4)).astype(f32)
        add(name, [a, b])
        add(alias, [a, b[:1]])
    for name, alias in (("_maximum", "broadcast_maximum"),
                        ("_minimum", "broadcast_minimum"),
                        ("_hypot", "broadcast_hypot")):
        add(name, [u(3, 4), u(3, 4)], grad=True)
        add(alias, [u(3, 4), u(1, 4)], grad=True)
    a, b = ints(3, 4), ints(3, 4)          # integer values: ties happen
    add("_maximum", [a, b], band="exact", grad=True)
    add("_grad_add", [u(3, 4), u(3, 4)], grad=True)
    add("_scatter_elemwise_div", [u(3, 4), u(3, 4, lo=0.5, hi=2)],
        grad=True)
    for name in ("_equal", "_not_equal", "_greater", "_greater_equal",
                 "_lesser", "_lesser_equal", "_logical_and", "_logical_or",
                 "_logical_xor"):
        add(name, [ints(3, 4, lo=-1, hi=2), ints(3, 4, lo=-1, hi=2)],
            band="exact")
        add("broadcast" + name, [ints(3, 4, lo=-1, hi=2),
                                 ints(1, 4, lo=-1, hi=2)], band="exact")
    add("_equal", [ints(3, 4).astype(np.int32), ints(3, 4).astype(np.int32)],
        band="exact")
    # -- elemwise: scalar forms ---------------------------------------------
    for name in ("_mod_scalar", "_rmod_scalar"):
        add(name, [u(3, 4, lo=-5, hi=5)], {"scalar": -1.7})
        add(name, [u(3, 4, lo=0.5, hi=5)], {"scalar": 2.5})
    for name in ("_maximum_scalar", "_MaximumScalar", "_minimum_scalar",
                 "_MinimumScalar", "_hypot_scalar", "_HypotScalar",
                 "_scatter_plus_scalar", "_scatter_minus_scalar"):
        add(name, [u(3, 4)], {"scalar": 0.25}, grad=True)
    for name in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
                 "_greater_equal_scalar", "_lesser_scalar",
                 "_lesser_equal_scalar", "_logical_and_scalar",
                 "_logical_or_scalar", "_logical_xor_scalar"):
        add(name, [ints(3, 4, lo=-1, hi=2)], {"scalar": 1.0}, band="exact")
        add(name, [ints(3, 4, lo=-1, hi=2)], {"scalar": 0.0}, band="exact")
    add("_greater_scalar", [ints(3, 4).astype(np.int32)], {"scalar": 0.5},
        band="exact")
    add("_plus_scalar", [u(3, 4).astype(np.float16)], {"scalar": 0.1},
        band="exact")
    for name in ("add_n", "ElementWiseSum", "_sum", "elemwise_sum"):
        add(name, [u(3, 4), u(3, 4), u(3, 4)], grad=True)
    # -- reductions and ordering ------------------------------------------
    x = u(3, 4, 5, lo=0.5, hi=1.5)
    for name in ("max", "min", "max_axis", "min_axis"):
        add(name, [x], band="exact")
        add(name, [x], {"axis": 1}, band="exact", grad=True)
        add(name, [x], {"axis": (0, 2), "keepdims": True}, band="exact")
        add(name, [x], {"axis": 1, "exclude": True}, band="exact")
        add(name, [x], {"keepdims": True}, band="exact")
    for name in ("prod", "nansum", "nanprod"):
        add(name, [x], grad=name == "prod")
        add(name, [x], {"axis": (0, 2)}, grad=True)
        add(name, [x], {"axis": 1, "keepdims": True, "exclude": True})
    xn = x.copy()
    xn[0, 1, :3] = np.nan
    add("nansum", [xn], {"axis": 2})
    add("nanprod", [xn], {"axis": 2})
    add("prod", [ints(3, 4, lo=1, hi=4).astype(np.int32)], {"axis": 1},
        band="exact")
    for attrs in ({}, {"axis": 1}, {"ord": 1}, {"ord": 1, "axis": (0, 2),
                                                "keepdims": True}):
        add("norm", [x - 1.0], attrs, grad=True)
    t = ints(4, 6, lo=0, hi=3)              # ties
    for name in ("argmax", "argmin"):
        add(name, [t], {"axis": 1}, band="exact")
        add(name, [t], {"axis": 0, "keepdims": True}, band="exact")
        add(name, [t], band="exact")
    add("argmax_channel", [t], band="exact")
    for attrs in ({"k": 3}, {"k": 2, "axis": 0}, {"k": 3, "is_ascend": True},
                  {"k": 3, "ret_typ": "value"}, {"k": 3, "ret_typ": "both"},
                  {"k": 2, "ret_typ": "mask"},
                  {"k": 4, "axis": None, "ret_typ": "both"}):
        add("topk", [t], attrs, band="exact")
    add("topk", [u(4, 6)], {"k": 3, "ret_typ": "value"}, band="exact",
        grad=True)
    for attrs in ({}, {"axis": 0}, {"is_ascend": False}, {"axis": None}):
        add("sort", [t], attrs, band="exact")
        add("argsort", [t], attrs, band="exact")
    add("sort", [u(4, 6)], {"is_ascend": False}, band="exact", grad=True)
    add("broadcast_to", [u(1, 4, 1)], {"shape": (3, 4, 2)}, band="exact",
        grad=True)
    add("broadcast_to", [u(1, 4, 1)], {"shape": (3, 0, 2)}, band="exact")
    for name in ("broadcast_axis", "broadcast_axes"):
        add(name, [u(1, 4, 1)], {"axis": (0, 2), "size": (3, 5)},
            band="exact", grad=True)
    add("broadcast_like", [u(1, 4), u(3, 4)], band="exact", grad=True)
    # -- matrix: products -------------------------------------------------
    add("dot", [u(3, 4), u(4, 5)], grad=True)
    add("dot", [u(4, 3), u(4, 5)], {"transpose_a": True}, grad=True)
    add("dot", [u(3, 4), u(5, 4)], {"transpose_b": True})
    add("dot", [u(4), u(4)], grad=True)
    add("dot", [u(2, 3, 4), u(4, 5)])
    add("batch_dot", [u(2, 3, 4), u(2, 4, 5)], grad=True)
    add("batch_dot", [u(2, 4, 3), u(2, 5, 4)],
        {"transpose_a": True, "transpose_b": True}, grad=True)
    add("khatri_rao", [u(3, 4), u(2, 4), u(5, 4)], grad=True)
    # -- matrix: shape ------------------------------------------------------
    x = u(2, 3, 4)
    add("transpose", [x], band="exact", grad=True)
    add("transpose", [x], {"axes": (1, 0, 2)}, band="exact", grad=True)
    add("squeeze", [u(2, 1, 3, 1)], band="exact")
    add("squeeze", [u(2, 1, 3, 1)], {"axis": 1}, band="exact", grad=True)
    for name in ("SwapAxis", "swapaxes"):
        add(name, [x], {"dim1": 0, "dim2": 2}, band="exact", grad=True)
    add("depth_to_space", [u(2, 8, 3, 2)], {"block_size": 2}, band="exact",
        grad=True)
    add("space_to_depth", [u(2, 2, 4, 6)], {"block_size": 2}, band="exact",
        grad=True)
    y = u(4, 6, 5)
    for name in ("slice", "crop"):
        add(name, [y], {"begin": (1, None, 0), "end": (3, 5, None)},
            band="exact", grad=True)
    add("slice", [y], {"begin": (3, 4), "end": (0, 1), "step": (-1, -2)},
        band="exact", grad=True)
    add("slice", [y], {"begin": (None, -2), "end": (None, None),
                       "step": (2, 1)}, band="exact")
    add("slice_axis", [y], {"axis": 1, "begin": 1, "end": 4}, band="exact",
        grad=True)
    add("slice_axis", [y], {"axis": -1, "begin": -3, "end": None},
        band="exact")
    for name in ("Concat", "concat"):
        add(name, [u(2, 3), u(2, 1), u(2, 4)], band="exact", grad=True)
    add("Concat", [u(2, 3), u(1, 3)], {"dim": 0}, band="exact")
    add("stack", [u(2, 3), u(2, 3), u(2, 3)], {"axis": 1}, band="exact",
        grad=True)
    for name in ("SliceChannel", "split"):
        add(name, [u(2, 6, 3)], {"num_outputs": 3}, band="exact", grad=True)
    add("SliceChannel", [u(2, 6, 3)], {"num_outputs": 3, "axis": 2,
                                       "squeeze_axis": True}, band="exact")
    add("tile", [u(2, 3)], {"reps": (2, 1, 3)}, band="exact", grad=True)
    add("repeat", [u(2, 3)], {"repeats": 2, "axis": 1}, band="exact",
        grad=True)
    add("repeat", [u(2, 3)], {"repeats": 3}, band="exact")
    for name in ("reverse", "flip"):
        add(name, [x], {"axis": (0, 2)}, band="exact", grad=True)
    z = u(1, 2, 3, 4)
    for name in ("Pad", "pad"):
        add(name, [z], {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2,
                                                          2, 1),
                        "constant_value": 0.5}, band="exact", grad=True)
    add("Pad", [z], {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)},
        band="exact", grad=True)
    add("Pad", [z], {"mode": "reflect",
                     "pad_width": (0, 0, 0, 0, 2, 2, 3, 1)}, band="exact",
        grad=True)
    # -- matrix: indexing ---------------------------------------------------
    w = u(5, 3)
    add("take", [w, np.array([[0, 4], [2, -1.5], [7, 3]], f32)],
        band="exact", grad=True)
    add("take", [u(3, 5), np.array([0, 6, -2, 4], f32)],
        {"axis": 1, "mode": "wrap"}, band="exact", grad=True)
    add("take", [w, np.array([1, 9], f32)], {"mode": "raise"}, band="exact")
    add("batch_take", [u(4, 3), np.array([0, 2, -1, 1], f32)],
        band="exact", grad=True)
    for attrs in ({"depth": 4}, {"depth": 3, "on_value": 2.0,
                                 "off_value": -1.0, "dtype": "int32"}):
        add("one_hot", [np.array([0, 3, 1, -1, 2], f32)], attrs,
            band="exact")
    gi = np.array([[0, 2, 1], [1, 0, 3]], f32)
    add("gather_nd", [u(3, 4, 2), gi], band="exact", grad=True)
    add("scatter_nd", [u(3, 2), gi], {"shape": (3, 4, 2)}, band="exact",
        grad=True)
    add("_scatter_set_nd", [u(3, 4, 2), gi, u(3, 2)], {"shape": (3, 4, 2)},
        band="exact", grad=True)
    add("where", [ints(3, 4, lo=0, hi=2), u(3, 4), u(3, 4)], band="exact",
        grad=True)
    add("where", [ints(4, lo=0, hi=2), u(3, 4), u(3, 4)], band="exact")
    seq = u(5, 3, 2)
    lens = np.array([2, 5, 1], f32)
    add("SequenceMask", [seq, lens], {"use_sequence_length": True,
                                      "value": -1.0}, band="exact", grad=True)
    add("SequenceMask", [u(3, 5, 2), lens], {"use_sequence_length": True,
                                             "axis": 1}, band="exact")
    add("SequenceMask", [seq], band="exact")
    add("SequenceLast", [seq, lens], {"use_sequence_length": True},
        band="exact", grad=True)
    add("SequenceLast", [u(3, 5, 2)], {"axis": 1}, band="exact")
    add("SequenceReverse", [seq, lens], {"use_sequence_length": True},
        band="exact", grad=True)
    add("SequenceReverse", [seq], band="exact")
    for mode in ("instance", "channel", "spatial"):
        add("L2Normalization", [u(2, 3, 4)], {"mode": mode}, grad=True)
    # -- linalg -------------------------------------------------------------
    for pre in ("_linalg_", "linalg_"):
        a, b, c = u(2, 3, 4), u(2, 4, 5), u(2, 3, 5)
        add(pre + "gemm2", [a, b], {"alpha": 0.5}, band=OP_LINALG, grad=True)
        add(pre + "gemm", [a, b, c], {"alpha": 0.5, "beta": 2.0},
            band=OP_LINALG, grad=True)
        add(pre + "potrf", [spd(2, 4)], band=OP_LINALG, grad=True)
        add(pre + "trsm", [tri(2, 4), u(2, 4, 3)], {"alpha": 2.0},
            band=OP_LINALG, grad=True)
        add(pre + "trmm", [tri(2, 4), u(2, 4, 3)], band=OP_LINALG,
            grad=True)
        add(pre + "syrk", [u(2, 3, 4)], {"alpha": 1.5}, band=OP_LINALG,
            grad=True)
        add(pre + "sumlogdiag", [spd(2, 4)], band=OP_LINALG, grad=True)
        add(pre + "potri", [tri(2, 4)], band=OP_LINALG)
        add(pre + "gelqf", [u(2, 3, 4)], band=OP_LINALG, canon="gelqf")
        add(pre + "syevd", [spd(2, 4)], band=OP_LINALG, canon="syevd")
    add("_linalg_potrf", [spd(2, 4)], {"lower": False}, band=OP_LINALG)
    add("_linalg_trsm", [tri(2, 4, lower=False), u(2, 3, 4)],
        {"transpose": True, "rightside": True, "lower": False},
        band=OP_LINALG, grad=True)
    add("_linalg_trmm", [tri(2, 4), u(2, 3, 4)],
        {"transpose": True, "rightside": True}, band=OP_LINALG)
    add("_linalg_potri", [tri(2, 4, lower=False)], {"lower": False},
        band=OP_LINALG)
    # -- creation -----------------------------------------------------------
    for name in ("_zeros", "zeros_like_shape", "_ones"):
        add(name, [], {"shape": (2, 3)}, band="exact", ctx=True)
    add("_full", [], {"shape": (2, 3), "value": 1.5}, band="exact", ctx=True)
    add("_eye", [], {"N": 3, "M": 5, "k": 1}, band="exact", ctx=True)
    add("_eye", [], {"N": 4, "k": -2, "dtype": "int32"}, band="exact",
        ctx=True)
    for name in ("zeros_like", "ones_like", "shape_array", "size_array"):
        add(name, [u(2, 3, 4)], band="exact")
    # -- nn -------------------------------------------------------------------
    img = u(2, 3, 7, 6)
    for act in ("sigmoid", "tanh", "softrelu", "softsign"):
        add("Activation", [img], {"act_type": act}, grad=True)
    for attrs in ({"act_type": "leaky", "slope": 0.1}, {"act_type": "elu"},
                  {"act_type": "selu"}):
        add("LeakyReLU", [img], attrs, grad=True)
    # rrelu's slopes are random under record() (training): forward only
    add("LeakyReLU", [img], {"act_type": "rrelu"})
    add("LeakyReLU", [img, u(3)], {"act_type": "prelu"}, grad=True)
    for attrs in (
            {"kernel": (3, 3), "pool_type": "sum", "stride": (2, 2)},
            {"kernel": (3, 3), "pool_type": "max", "stride": (2, 2),
             "pooling_convention": "full"},
            {"kernel": (3, 2), "pool_type": "avg", "stride": (2, 2),
             "pad": (1, 1), "pooling_convention": "full"},
            {"kernel": (3, 3), "pool_type": "avg", "pad": (1, 1),
             "count_include_pad": False},
            {"kernel": (3, 3), "pool_type": "avg", "pad": (1, 1),
             "stride": (2, 2), "count_include_pad": False,
             "pooling_convention": "full"},
            {"kernel": (2, 2), "pool_type": "max",
             "pooling_convention": "same"},
            {"kernel": (1, 1), "pool_type": "sum", "global_pool": True}):
        band = "exact" if attrs["pool_type"] == "max" else "f32"
        add("Pooling", [img], attrs, band=band, grad=True)
    add("Pooling", [u(2, 3, 9)], {"kernel": (3,), "pool_type": "avg",
                                  "stride": (2,)}, grad=True)
    add("Pooling", [u(1, 2, 5, 4, 6)], {"kernel": (2, 2, 3),
                                        "pool_type": "max"}, band="exact")
    add("Deconvolution", [u(2, 4, 5, 5), u(4, 3, 3, 3)],
        {"kernel": (3, 3), "num_filter": 3}, grad=True)
    add("Deconvolution", [u(2, 4, 5, 5), u(4, 3, 3, 3), u(6)],
        {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
         "stride": (2, 2), "pad": (1, 1), "adj": (1, 1), "no_bias": False},
        grad=True)
    add("Deconvolution", [u(2, 2, 7), u(2, 3, 4)],
        {"kernel": (4,), "num_filter": 3, "stride": (2,), "dilate": (2,)},
        grad=True)
    add("InstanceNorm", [img, u(3, lo=0.5, hi=1.5), u(3)], {"eps": 1e-3},
        grad=True)
    add("LRN", [img], {"nsize": 3}, grad=True)
    add("LRN", [u(2, 6, 3, 3)], {"nsize": 5, "alpha": 0.01, "beta": 0.5,
                                 "knorm": 1.0}, grad=True)
    add("UpSampling", [u(2, 3, 3, 4)], {"scale": 2}, band="exact",
        grad=True)
    add("UpSampling", [u(2, 3, 3, 4), u(2, 2, 3, 4)],
        {"scale": 2, "num_args": 2}, band="exact")
    add("UpSampling", [u(2, 3, 3, 4), u(3, 1, 4, 4)],
        {"scale": 2, "sample_type": "bilinear", "num_filter": 3,
         "num_args": 2}, grad=True)
    for mode in ("instance", "channel"):
        add("SoftmaxActivation", [img], {"mode": mode}, grad=True)
    add("softmax", [u(3, 7, lo=-3, hi=3)], grad=True)
    add("softmax", [img], {"axis": 1, "temperature": 2.0}, grad=True)
    add("softmax_cross_entropy", [u(4, 6, lo=-3, hi=3),
                                  np.array([0, 5, 2, 3], f32)], grad=True)
    add("_contrib_AdaptiveAvgPooling2D", [u(2, 3, 8, 6)],
        {"output_size": (4, 3)}, grad=True)
    add("_contrib_AdaptiveAvgPooling2D", [u(2, 3, 8, 6)], grad=True)
    add("_contrib_AdaptiveAvgPooling2D", [u(2, 3, 7, 6)],
        {"output_size": (3, 4)})
    add("_contrib_BilinearResize2D", [u(2, 3, 5, 4)],
        {"height": 9, "width": 7})
    add("_contrib_BilinearResize2D", [u(2, 3, 8, 6)],
        {"scale_height": 0.5, "scale_width": 0.5})
    # -- loss layers ---------------------------------------------------------
    add("LinearRegressionOutput", [u(4, 3), u(4, 3)], {"grad_scale": 2.0},
        band="exact", grad=True)
    add("MAERegressionOutput", [u(4, 3), u(4, 3)], band="exact", grad=True)
    add("LogisticRegressionOutput", [u(4, 3), u(4, 3, lo=0, hi=1)],
        grad=True)
    for name in ("MakeLoss", "make_loss"):
        add(name, [u(4, 3)], {"grad_scale": 0.5, "normalization": "batch"},
            band="exact", grad=True)
    add("SVMOutput", [u(4, 5), np.array([0, 4, 2, 1], f32)], {"margin": 0.5},
        band="exact", grad=True)
    add("SVMOutput", [u(4, 5), np.array([3, 4, 0, 1], f32)],
        {"use_linear": True, "regularization_coefficient": 0.5},
        band="exact", grad=True)
    # -- misc ------------------------------------------------------------------
    add("reshape_like", [u(2, 6), u(3, 4)], band="exact", grad=True)
    add("_identity_with_attr_like_rhs", [u(2, 3), u(4)], band="exact",
        grad=True)
    add("_slice_assign", [u(4, 5), u(2, 2)], {"begin": (1, 0), "end": (3, 4),
                                             "step": (1, 2)},
        band="exact", grad=True)
    add("_slice_assign", [u(4, 5, 2), u(2, 5, 2)],
        {"begin": (3,), "end": (0,), "step": (-2,)}, band="exact")
    add("_slice_assign_scalar", [u(4, 5)], {"begin": (0, 1), "end": (2, 5),
                                            "scalar": 3.0}, band="exact",
        grad=True)
    for name in ("_contrib_quadratic", "quadratic"):
        add(name, [u(3, 4)], {"a": 0.5, "b": -1.0, "c": 2.0}, grad=True)
    add("Crop", [u(2, 3, 6, 7)], {"h_w": (3, 4), "offset": (1, 2)},
        band="exact", grad=True)
    add("Crop", [u(2, 3, 6, 7), u(1, 1, 4, 3)], {"center_crop": True},
        band="exact")
    # the JAX package writes the new moving rho into the data input of an
    # imperative call (moving_rho is a keyword there, not an input slot);
    # this package does not, so the inputs after the call are not held
    add("IdentityAttachKLSparseReg", [u(4, 3, lo=0.1, hi=0.9)],
        {"penalty": 0.01}, grad=True, after=False)
    # -- contrib ---------------------------------------------------------------
    add("_contrib_fused_bn_relu", [img, u(3, lo=0.5, hi=1.5), u(3),
                                   u(3, lo=-0.2, hi=0.2),
                                   u(3, lo=0.5, hi=2)])
    add("_contrib_fused_bn_relu", [img, u(3), u(3), u(3),
                                   u(3, lo=0.5, hi=2)],
        {"act": False, "eps": 1e-3})
    add("_contrib_fft", [u(3, 8)])
    add("_contrib_ifft", [u(3, 16)])
    add("_contrib_count_sketch", [u(3, 6), np.array([0, 3, 1, 3, 2, 0], f32),
                                  np.array([1, -1, 1, 1, -1, 1], f32)],
        {"out_dim": 4}, grad=True)
    # -- optimizer updates (states written back through mutate_aux) -----------
    wt, gr = u(3, 4), u(3, 4)
    pos = u(3, 4, lo=0.1, hi=1.0)
    hyper = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5}
    add("sgd_update", [wt, gr], dict(hyper, clip_gradient=0.2))
    add("sgd_mom_update", [wt, gr, u(3, 4)], dict(hyper, momentum=0.9))
    add("adam_update", [wt, gr, u(3, 4), pos], dict(hyper, beta1=0.8))
    add("rmsprop_update", [wt, gr, pos], dict(hyper, clip_weights=0.5))
    add("rmspropalex_update", [wt, gr, pos + 1.0, u(3, 4, lo=-0.1, hi=0.1),
                               u(3, 4)], dict(hyper))
    add("ftrl_update", [wt, gr, u(3, 4), pos], dict(hyper, lamda1=0.05))
    add("ftml_update", [wt, gr, pos, pos, u(3, 4)], dict(hyper, t=3))
    add("signsgd_update", [wt, gr], dict(hyper))
    add("signum_update", [wt, gr, u(3, 4)], dict(hyper, momentum=0.9,
                                                 wd_lh=0.01))
    w16 = wt.astype(np.float16)
    add("mp_sgd_update", [w16, gr.astype(np.float16), wt], dict(hyper))
    add("mp_sgd_mom_update", [w16, gr.astype(np.float16), u(3, 4), wt],
        dict(hyper, momentum=0.9))
    # a batch member that is not positive definite: NaN in the factor's
    # triangle, zeros in the other, as jnp.linalg.cholesky gives
    not_pd = np.array([[[1, 2], [2, 1]], [[4, 1], [1, 3]]], f32)
    for lower in (True, False):
        add("_linalg_potrf", [not_pd], {"lower": lower}, band=OP_LINALG)
    # -- the fused RNN and its zero begin state --------------------------------
    for mode, layers, bi, outs in (("lstm", 2, True, True),
                                   ("gru", 1, False, True),
                                   ("rnn_relu", 2, False, False)):
        gates = {"lstm": 4, "gru": 3, "rnn_relu": 1}[mode]
        d = 2 if bi else 1
        size = sum(d * gates * 6 * ((4 if layer == 0 else 6 * d) + 6)
                   for layer in range(layers)) + layers * d * 2 * gates * 6
        ins = [u(5, 3, 4), u(size, lo=-0.4, hi=0.4), u(layers * d, 3, 6)]
        if mode == "lstm":
            ins.append(u(layers * d, 3, 6))
        add("RNN", ins, {"mode": mode, "state_size": 6, "num_layers": layers,
                         "bidirectional": bi, "state_outputs": outs},
            band=OP_RNN if mode in ("lstm", "gru") else "f32", grad=True)
    add("_rnn_state_zeros", [u(5, 3, 4)], {"shape": (2, 0, 6),
                                           "ref_batch_axis": 1}, band="exact")
    # -- image: gluon.data.vision's ops (HWC uint8 in [0, 255] as float32)
    for name in ("_image_to_tensor", "to_tensor"):
        add(name, [rng.randint(0, 256, (5, 6, 3)).astype(f32)])
        add(name, [rng.randint(0, 256, (2, 5, 6, 3)).astype(f32)])
    for name in ("_image_normalize", "image_normalize"):
        norm = {"mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)}
        add(name, [u(3, 5, 6, lo=0.0, hi=1.0)], norm, grad=True)
        add(name, [u(2, 3, 5, 6, lo=0.0, hi=1.0)], norm, grad=True)
    # -- sparse storage: the ops on dense values (nd.cast_storage and
    # nd.sparse_retain of a row-sparse array make sparse arrays, read back
    # dense here)
    rows = u(6, 3)
    rows[[1, 4]] = 0.0
    for stype in ("default", "row_sparse", "csr"):
        add("cast_storage", [rows], {"stype": stype}, band="exact")
    for name in ("_sparse_retain", "sparse_retain"):
        add(name, [rows, np.array([0, 3, 4, 3], f32)], band="exact",
            grad=True)
    for name in ("_square_sum", "square_sum"):
        add(name, [u(4, 5)], {"axis": 1}, grad=True)
        add(name, [u(3, 4, 2)], {"axis": (0, 2), "keepdims": True},
            grad=True)
        add(name, [u(4, 5)], grad=True)
    add("_contrib_SparseEmbedding", [np.array([[0, 4, 2], [4, 4, 1]], f32),
                                     u(5, 3)],
        {"input_dim": 5, "output_dim": 3}, band="exact", grad=True)
    add("_sparse_adagrad_update", [wt, gr, pos],
        dict(hyper, clip_gradient=0.3, epsilon=1e-6))
    # -- detection and ROI (ops/contrib.py, ops/misc.py) ------------------
    def corners(*shape, lo=0.0, hi=1.0):
        a, b = u(*shape, 2, lo=lo, hi=hi), u(*shape, 2, lo=lo, hi=hi)
        return np.concatenate([np.minimum(a, b), np.maximum(a, b)], -1)

    fmap = u(2, 3, 5, 7)
    for name, attrs in (
            ("MultiBoxPrior", {"sizes": (0.2, 0.272), "ratios": (1, 2, 0.5),
                               "steps": (0.125, 0.125), "clip": True}),
            ("_contrib_MultiBoxPrior", {"sizes": (0.3, 0.6),
                                        "ratios": (1.0, 2.0, 3.0),
                                        "offsets": (0.25, 0.75)}),
            ("MultiBoxPrior", {})):
        add(name, [fmap], attrs, band="exact")
    anchors = corners(1, 48)
    labels = np.concatenate([ints(3, 4, 1, lo=0, hi=3), corners(3, 4)], -1)
    labels[1, 2:] = -1.0                                 # padded label rows
    logits = u(3, 4, 48, lo=-2, hi=2)
    for name, attrs in (
            ("MultiBoxTarget", {"overlap_threshold": 0.3,
                                "negative_mining_ratio": 3.0}),
            ("_contrib_MultiBoxTarget", {"overlap_threshold": 0.4}),
            ("MultiBoxTarget", {"overlap_threshold": 0.2,
                                "negative_mining_ratio": 2.0,
                                "negative_mining_thresh": 0.3,
                                "minimum_negative_samples": 5,
                                "variances": (0.1, 0.1, 0.25, 0.25)})):
        add(name, [anchors, labels, logits], attrs)
    add("_contrib_box_iou", [corners(5), corners(2, 3)], grad=True)
    add("_contrib_box_iou", [u(4, 4, lo=0.2, hi=0.8), u(3, 4, lo=0.2, hi=0.8)],
        {"format": "center"}, grad=True)
    dets = np.concatenate([ints(2, 30, 1, lo=0, hi=3), u(2, 30, 1, lo=0, hi=1),
                           corners(2, 30)], -1)
    dets[0, 5:9, 1] = dets[0, 4, 1]                      # score ties
    for name, attrs in (
            ("_contrib_box_nms", {"overlap_thresh": 0.3}),
            ("_contrib_box_nms", {"overlap_thresh": 0.4, "id_index": 0,
                                  "topk": 12, "valid_thresh": 0.1}),
            ("_contrib_box_non_maximum_suppression",
             {"overlap_thresh": 0.3, "id_index": 0, "force_suppress": True,
              "out_format": "center"}),
            ("_contrib_box_nms", {"overlap_thresh": 0.5, "in_format": "center",
                                  "out_format": "corner"})):
        add(name, [dets], attrs, band="exact", grad=True)
    scores = u(2, 6, 4, lo=0, hi=1)
    for attrs in ({"threshold": 0.3}, {"threshold": 0.7, "is_ascend": True},
                  {"threshold": 0.1, "topk": 2}):
        add("_contrib_bipartite_matching", [scores], attrs, band="exact")
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = u(3, 48 * 4, lo=-1, hi=1)
    for name, attrs in (("MultiBoxDetection", {"nms_threshold": 0.3}),
                        ("_contrib_MultiBoxDetection",
                         {"nms_threshold": 0.45, "nms_topk": 10,
                          "threshold": 0.2}),
                        ("MultiBoxDetection",
                         {"nms_threshold": 0.3, "force_suppress": True,
                          "clip": False, "background_id": 1})):
        add(name, [prob.astype(f32), loc, anchors], attrs)
    # integer-valued maps (tied maxima) and ROIs that reach past the map
    # (empty bins) for ROIPooling's backward
    rois = np.array([[0, 2, 3, 40, 50], [1, 0, 0, 60, 60], [0, 10, 10, 11, 12],
                     [1, -20, 5, 30, 90], [1, 70, 70, 90, 95]], f32)
    for name in ("ROIPooling", "_contrib_ROIPooling"):
        add(name, [ints(2, 4, 8, 9), rois], {"pooled_size": (3, 2),
                                             "spatial_scale": 0.125},
            band="exact", grad=True)
    add("ROIPooling", [u(2, 4, 8, 9), rois], {"pooled_size": (2, 2),
                                              "spatial_scale": 0.25},
        band="exact", grad=True)
    for attrs in ({"pooled_size": (3, 2), "spatial_scale": 0.125},
                  {"pooled_size": (2, 3), "spatial_scale": 0.125,
                   "sample_ratio": -1}):
        add("_contrib_ROIAlign", [u(2, 4, 8, 9), rois[:4]], attrs, grad=True)
    add("_contrib_PSROIPooling", [u(2, 18, 8, 9), rois],
        {"spatial_scale": 0.125, "output_dim": 2, "pooled_size": 3},
        grad=True)
    add("_contrib_PSROIPooling", [u(2, 8, 8, 9), rois],
        {"spatial_scale": 0.125, "output_dim": 2, "pooled_size": 3,
         "group_size": 2}, grad=True)
    cls_prob = u(2, 6, 4, 5, lo=0, hi=1)
    info = np.array([[64, 80, 1.0], [60, 70, 1.0]], f32)
    for name, attrs in (
            ("_contrib_Proposal", {"rpn_pre_nms_top_n": 30,
                                   "rpn_post_nms_top_n": 10, "threshold": 0.5,
                                   "rpn_min_size": 4, "scales": (2, 4, 8),
                                   "ratios": (1.0,), "feature_stride": 16}),
            ("Proposal", {"rpn_pre_nms_top_n": 40, "rpn_post_nms_top_n": 30,
                          "threshold": 0.3, "rpn_min_size": 8,
                          "scales": (2, 4, 8), "ratios": (1.0,),
                          "feature_stride": 16, "output_score": True}),
            ("_contrib_MultiProposal", {"rpn_pre_nms_top_n": 20,
                                        "rpn_post_nms_top_n": 8,
                                        "threshold": 0.7, "rpn_min_size": 4,
                                        "scales": (4,),
                                        "ratios": (0.5, 1, 2),
                                        "feature_stride": 16,
                                        "output_score": True})):
        add(name, [cls_prob, u(2, 12, 4, 5, lo=-0.5, hi=0.5), info], attrs)
    x = u(2, 4, 6, 7)
    add("_contrib_DeformableConvolution",
        [x, u(2, 18, 6, 7, lo=-1.5, hi=1.5), u(5, 4, 3, 3), u(5)],
        {"kernel": (3, 3), "pad": (1, 1), "num_filter": 5}, grad=True)
    add("_contrib_DeformableConvolution",
        [x, u(2, 2 * 2 * 4, 3, 4, lo=-2, hi=2), u(4, 2, 2, 2)],
        {"kernel": (2, 2), "stride": (2, 2), "dilate": (2, 2), "pad": (1, 1),
         "num_filter": 4, "num_group": 2, "num_deformable_group": 2,
         "no_bias": True}, grad=True)
    add("_contrib_DeformablePSROIPooling",
        [u(2, 18, 8, 9), rois, u(5, 2, 3, 3)],
        {"spatial_scale": 0.125, "output_dim": 2, "pooled_size": 3,
         "group_size": 3, "trans_std": 0.1}, grad=True)
    add("_contrib_DeformablePSROIPooling",
        [u(2, 8, 8, 9), rois, u(5, 4, 2, 2)],
        {"spatial_scale": 0.125, "output_dim": 2, "pooled_size": 3,
         "group_size": 2, "part_size": 2, "sample_per_part": 2,
         "trans_std": 0.2}, grad=True)
    add("_contrib_DeformablePSROIPooling", [u(2, 18, 8, 9), rois],
        {"spatial_scale": 0.125, "output_dim": 2, "pooled_size": 3,
         "group_size": 3, "no_trans": True}, grad=True)
    return cases


OP_CASES = _op_cases()


def random_moments(kind, p):
    """(mean, variance) of one draw of sampler ``kind`` with parameters
    ``p``, in the JAX package's parameterisation."""
    if kind == "uniform":
        return (p["low"] + p["high"]) / 2, (p["high"] - p["low"]) ** 2 / 12
    if kind == "normal":
        return p["loc"], p["scale"] ** 2
    if kind == "gamma":
        return p["alpha"] * p["beta"], p["alpha"] * p["beta"] ** 2
    if kind == "exponential":
        return 1 / p["lam"], 1 / p["lam"] ** 2
    if kind == "poisson":
        return p["lam"], p["lam"]
    if kind == "negative_binomial":
        k, q = p["k"], p["p"]
        return k * (1 - q) / q, k * (1 - q) / q ** 2
    if kind == "generalized_negative_binomial":
        return p["mu"], p["mu"] + p["alpha"] * p["mu"] ** 2
    if kind == "randint":
        n = p["high"] - p["low"]
        return (p["low"] + p["high"] - 1) / 2, (n * n - 1) / 12
    raise KeyError(kind)


# sampler kind -> (scalar-parameter sets, one per row of the _sample_ op's
# parameter arrays; integer-valued draws)
RANDOM_CASES = {
    "uniform": ([{"low": -1.0, "high": 3.0}, {"low": 2.0, "high": 2.5}],
                False),
    "normal": ([{"loc": 1.0, "scale": 2.0}, {"loc": -3.0, "scale": 0.5}],
               False),
    "gamma": ([{"alpha": 2.0, "beta": 1.5}, {"alpha": 0.5, "beta": 3.0}],
              False),
    "exponential": ([{"lam": 2.0}, {"lam": 0.25}], False),
    "poisson": ([{"lam": 3.0}, {"lam": 12.0}], True),
    "negative_binomial": ([{"k": 3, "p": 0.4}, {"k": 1, "p": 0.8}], True),
    "generalized_negative_binomial": ([{"mu": 2.0, "alpha": 0.5},
                                       {"mu": 5.0, "alpha": 0.1}], True),
    "randint": ([{"low": -2, "high": 5}], True),
}
# the _sample_ op's parameter names, in its input order
SAMPLE_INPUTS = {"uniform": ("low", "high"), "normal": ("loc", "scale"),
                 "gamma": ("alpha", "beta"), "exponential": ("lam",),
                 "poisson": ("lam",), "negative_binomial": ("k", "p"),
                 "generalized_negative_binomial": ("mu", "alpha")}


def _to_host(a):
    """An NDArray of either package as a numpy array; bfloat16 as
    float32."""
    h = np.asarray(a.asnumpy())
    if h.dtype.name == "bfloat16":
        h = h.astype(np.float32)
    return h


class no_host_sync:
    """On a card (``ctx`` a GPU context), torch's sync debug mode "error"
    for the body, so an op that waits on the card, reads a tensor back,
    or copies one from the host (what a value made on the host needs)
    raises; elsewhere nothing."""

    def __init__(self, ctx):
        self.on_card = ctx.device_type == "gpu"

    def __enter__(self):
        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        if self.on_card:
            torch.cuda.set_sync_debug_mode("default")


def _on_ctx(arrays, ctx, what, name):
    """Raise unless every NDArray of ``arrays`` lies on ``ctx``."""
    for a in arrays:
        if a.context != ctx:
            raise AssertionError("%s: %s on %s, not on %s"
                                 % (name, what, a.context, ctx))


def run_case(mx, case, ctx, grad=True, seed=SEED):
    """Run one ``OP_CASES`` entry through ``mx`` (either package) on
    ``ctx``: ``(outputs, inputs after the call, gradients)`` as numpy
    arrays.  The gradients (None unless ``grad`` and ``case["grad"]``)
    are d sum(out_k * w_k) / d input for each float input, with fixed
    random weights w_k.  On a card the op's calls run under
    ``no_host_sync`` (but those of ``OP_HOST_SYNC``), and every output,
    input after the call and gradient must lie on ``ctx``."""
    def fresh():
        return [mx.nd.array(x, ctx=ctx, dtype=x.dtype)
                for x in case["inputs"]]

    on_card = ctx.device_type == "gpu"
    guard = mx.cpu() if case["name"] in OP_HOST_SYNC else ctx
    attrs = dict(case["attrs"])
    if case["ctx"]:
        attrs["ctx"] = ctx
    fn = getattr(mx.nd, case["name"])
    ins = fresh()
    with no_host_sync(guard):
        out = fn(*ins, **attrs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    if on_card:
        _on_ctx(outs, ctx, "output", case["name"])
        _on_ctx(ins, ctx, "input after the call", case["name"])
    host = [_to_host(o) for o in outs]
    after = [_to_host(x) for x in ins]
    grads = None
    if grad and case["grad"]:
        ins = fresh()
        diff = [x for x, a in zip(ins, case["inputs"])
                if a.dtype == np.float32]
        for x in diff:
            x.attach_grad()
        rng = np.random.RandomState(seed + 7)
        ws = [mx.nd.array(rng.uniform(-1, 1, h.shape).astype(np.float32),
                          ctx=ctx) for h in host]
        with mx.autograd.record():
            with no_host_sync(guard):
                out = fn(*ins, **attrs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            loss = None
            for o, w in zip(outs, ws):
                term = (o * w).sum()
                loss = term if loss is None else loss + term
        loss.backward()
        if on_card:
            _on_ctx([x.grad for x in diff], ctx, "gradient", case["name"])
        grads = [_to_host(x.grad) for x in diff]
    return host, after, grads


def _canon(kind, outs):
    """Decompositions unique up to sign, fixed: gelqf's L with a positive
    diagonal (Q's rows flipped to match), syevd's rows with their largest
    |component| positive."""
    if kind == "gelqf":
        L, Q = outs
        s = np.sign(np.diagonal(L, axis1=-2, axis2=-1))
        return [L * s[..., None, :], Q * s[..., :, None]]
    U, w = outs
    idx = np.abs(U).argmax(-1)
    s = np.sign(np.take_along_axis(U, idx[..., None], -1))
    return [U * s, w]


def case_error(got, ref, band):
    """How far ``got`` is from ``ref`` (lists of numpy arrays) in the
    case's band: 0.0 when equal, else the largest |difference| over the
    largest |reference| (inf for a shape, dtype or NaN mismatch, or any
    difference in the exact band).  The case passes at or below
    ``band_limit(band)``."""
    worst = 0.0
    for a, b in zip(got, ref):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            continue
        if band == "exact" or a.dtype.kind not in "fc":
            return float("inf")
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            return float("inf")
        ok = ~np.isnan(b)
        scale = float(np.abs(b[ok]).max()) if ok.any() else 0.0
        d = float(np.abs(a[ok].astype(np.float64)
                         - b[ok].astype(np.float64)).max())
        worst = max(worst, d / scale if scale else float("inf"))
    return worst


def band_limit(band):
    return 0.0 if band == "exact" else OP_F32 if band == "f32" else band


def compare_case(case, got, ref):
    """``[(what, error, limit)]`` of one case: outputs, inputs after the
    call, gradients (each a triple of ``run_case``)."""
    g_out, g_after, g_grad = got
    r_out, r_after, r_grad = ref
    if case["canon"]:
        g_out, r_out = _canon(case["canon"], g_out), _canon(case["canon"],
                                                            r_out)
    lim = band_limit(case["band"])
    res = [("out", case_error(g_out, r_out, case["band"]), lim)]
    if case["after"]:
        res.append(("after", case_error(g_after, r_after, case["band"]), lim))
    if g_grad is not None and r_grad is not None:
        res.append(("grad", case_error(g_grad, r_grad, OP_GRAD), OP_GRAD))
    return res



def case_checks(case, mx, ctx, ref_mx, ref_ctx):
    """``compare_case`` of one case run through ``mx`` on ``ctx`` against
    the same case through ``ref_mx`` on ``ref_ctx``."""
    return compare_case(case, run_case(mx, case, ctx),
                        run_case(ref_mx, case, ref_ctx))


def case_indices(modules):
    """The indices of the ``OP_CASES`` entries whose op this package
    defines in one of ``modules`` (names under ``mxnet_tpu_torch.ops``)."""
    from mxnet_tpu_torch.ops.registry import get_op
    return [i for i, c in enumerate(OP_CASES)
            if get_op(c["name"]).fn.__module__.rsplit(".", 1)[-1] in modules]


def case_id(i):
    return "%d-%s" % (i, OP_CASES[i]["name"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def resnet_symbol(layers, image):
    from mxnet_tpu_torch.symbols import resnet
    return resnet.get_symbol(1000, layers, ",".join(map(str, image)))


def k3_sites(mx, sym, batch, image):
    """``(BatchNorm name, data shape)`` of every BatchNorm->ReLU site the
    executor's peephole fuses, at ``batch`` rows."""
    from mxnet_tpu_torch.symbol.symbol import _bn_relu_peephole
    with knobs("1"):
        _, fuse = _bn_relu_peephole(sym, sym._topo(), False, "cpu")
    bns = list(fuse.values())
    heads = mx.sym.Group([mx.sym.Symbol([bn.inputs[0]]) for bn in bns])
    _, shapes, _ = heads.infer_shape(data=(batch,) + tuple(image))
    return [(bn.name, tuple(s)) for bn, s in zip(bns, shapes)]


def he_params(sym, image, seed):
    """Random fp32 weights from ``seed``: He-scaled normal conv and FC
    weights, gamma 1, beta and biases 0, moving mean 0, moving var 1."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1,) + tuple(image))
    rng = np.random.RandomState(seed)
    arg = {}
    for n, shp in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            std = np.sqrt(2.0 / int(np.prod(shp[1:])))
            arg[n] = (rng.randn(*shp) * std).astype(np.float32)
        elif n.endswith("_gamma"):
            arg[n] = np.ones(shp, np.float32)
        else:
            arg[n] = np.zeros(shp, np.float32)
    aux = {n: (np.ones if n.endswith("_var") else np.zeros)(shp, np.float32)
           for n, shp in zip(sym.list_auxiliary_states(), aux_shapes)}
    return arg, aux


def calibrate_fc(mx, sym, args, auxs, ctx, x):
    """Divide the classifier's weight by the rms of its input features on
    ``x``.  With moving var 1 every residual unit adds its branch at full
    scale, the features reach an rms in the hundreds and the softmax
    saturates to one-hot, which no comparison of probabilities could see
    through; after this the logits are O(1)."""
    fc = next(n for n in sym._topo()
              if not n.is_variable and n.op.name == "FullyConnected")
    feat = mx.sym.Symbol([fc.inputs[0]])
    p = mx.Predictor.from_parts(feat, args, auxs, {"data": x.shape}, ctx=ctx)
    f = p.forward(data=x).get_output(0)._data
    args[fc.name + "_weight"]._data.div_(float(f.pow(2).mean().sqrt()))


# ---------------------------------------------------------------------------
# phase 2 (b): the bf16 instances of K7a, K7b and K7c on the tensor cores
# ---------------------------------------------------------------------------
# the bf16 tensor-core instruction of mma.sync m16n8k16 bf16 -> fp32, and
# the mangled names of the bf16 D-64 instances that must hold it
HMMA_BF16 = "HMMA.16816.F32.BF16"
HMMA_KERNELS = (("K7a", "flash_fwd_bf16_kernelILi64E"),
                ("K7b", "flash_bwd_dq_bf16_kernelILi64E"),
                ("K7c", "flash_bwd_dkv_bf16_kernelILi64E"))


# K2's wide-row instances at C 10000 (fp32: 16 values a thread in four
# 16-byte chunks; bf16: two chunks of eight), and the SASS they must hold:
# 128-bit global loads; the cluster's st.async of the partial max and sum
# into the other CTAs' shared memory (STAS), the mbarrier waits that
# count them in (SYNCS.PHASECHK) and the cluster barrier (barrier.cluster
# arrive and wait) that finds every CTA's mbarriers ready first
K2_WIDE_KERNELS = (("fp32", "softmax_rows_onchip_kernelIfLi16ELi4EE"),
                   ("bf16",
                    "softmax_rows_onchip_kernelI13__nv_bfloat16Li16ELi8EE"))
K2_WIDE_SASS = (("ldg_e128", "LDG.E.128"), ("st_async", "STAS"),
                ("mbarrier_wait", "SYNCS.PHASECHK"),
                ("cluster_barrier", "UCGABAR"))


def sass_counts(library, opcode, cuobjdump):
    """``{mangled function name: lines of its SASS that hold
    ``opcode``}`` of a built shared library, by ``cuobjdump -sass``."""
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        head = line.strip()
        if head.startswith("Function :"):
            name = head.split(":", 1)[1].strip()
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


def _cuobjdump(build):
    """The CUDA toolkit's ``cuobjdump`` (PATH, or beside ``nvcc``)."""
    import shutil
    nvcc_dir = os.path.dirname(build.nvcc_path())
    cuobjdump = shutil.which("cuobjdump") or os.path.join(nvcc_dir,
                                                          "cuobjdump")
    if not os.path.exists(cuobjdump):
        raise AssertionError("cuobjdump not found (PATH, %s): the CUDA "
                             "toolkit's SASS dump shows what the kernels "
                             "run" % nvcc_dir)
    return cuobjdump


def hmma_counts(build):
    """The ``HMMA.16816.F32.BF16`` count of each function in
    ``HMMA_KERNELS`` in the built flash library (``build`` is the
    package's ``ops._build``); raises if ``cuobjdump`` is missing, a
    function is not in the library, or a count is 0."""
    counts = sass_counts(os.path.join(build.BUILD_DIR,
                                      "libmxtt_flash_attention.so"),
                         HMMA_BF16, _cuobjdump(build))
    out = {}
    for knum, frag in HMMA_KERNELS:
        names = [n for n in counts if frag in n]
        if len(names) != 1 or counts[names[0]] <= 0:
            raise AssertionError(
                "%s's bf16 D-64 instance: functions %s, %s counts %s (must "
                "be one function with a count above 0)" % (
                    knum, names, HMMA_BF16, [counts[n] for n in names]))
        out[knum] = {"function": names[0], "count": counts[names[0]]}
    return out


def k2_wide_counts(build):
    """``{dtype: {"function": name, <key>: count for each key of
    K2_WIDE_SASS}}`` for each of ``K2_WIDE_KERNELS`` in the built softmax
    library; raises if a function is missing or a count is 0."""
    library = os.path.join(build.BUILD_DIR, "libmxtt_softmax.so")
    counts = {key: sass_counts(library, opcode, _cuobjdump(build))
              for key, opcode in K2_WIDE_SASS}
    out = {}
    for dtype, frag in K2_WIDE_KERNELS:
        names = [n for n in counts["ldg_e128"] if frag in n]
        if len(names) != 1 or not all(counts[key][names[0]] > 0
                                       for key, _ in K2_WIDE_SASS):
            raise AssertionError(
                "K2's %s wide-row instance: functions %s, counts %s (must "
                "be one function, each count above 0)" % (
                    dtype, names, {key: [counts[key][n] for n in names]
                                   for key, _ in K2_WIDE_SASS}))
        out[dtype] = dict({key: counts[key][names[0]]
                           for key, _ in K2_WIDE_SASS}, function=names[0])
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def _bf16_close(got, ref, atol):
    """Within one bf16 rounding of the larger magnitude, plus ``atol``:
    the kernel and its plain version both compute in fp32 and round once
    to bf16."""
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs())
    return bool(((got - ref).abs() <= mag * 2.0 ** -7 + atol).all())


def check_k3(ck, sites, dev, bw, flops):
    """K3 bitwise against its plain version at every site, fp32 and bf16,
    relu on and off.  Returns its record and one timing job per distinct
    shape (fp32, relu on, as the forward runs it)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    jobs = {}             # shape -> timing job
    nbytes = ops = 0
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for name, shape in sites:
        c = shape[1]
        x32 = torch.randn(shape, generator=gen, device=dev) * 2
        s = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            for relu in (True, False):
                y = ck.scale_bias_relu(x, s, b, relu)
                ref = ck.scale_bias_relu_ref(x, s, b, relu)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                if y.dtype != dt or not torch.equal(y.view(bits[dt]),
                                                    ref.view(bits[dt])):
                    raise AssertionError(
                        "K3 differs from its plain version at %s %s %s "
                        "relu=%s: max |d| %g" % (name, shape, dt, relu, err))
                worst = max(worst, err)
        if shape not in jobs:
            jobs[shape] = {"count": 0, "shape": shape, "fns": {
                "": lambda x=x32, s=s, b=b: ck.scale_bias_relu(x, s, b),
                "plain_": lambda x=x32, s=s, b=b: ck.scale_bias_relu_ref(
                    x, s, b)}}
        jobs[shape]["count"] += 1
        jobs[shape]["bound_ms"] = bound_ms(
            2 * x32.numel() * 4 + 2 * c * 4, 3 * x32.numel(), bw, flops)[0]
        nbytes += 2 * x32.numel() * 4 + 2 * c * 4
        ops += 3 * x32.numel()
    bms, by = bound_ms(nbytes, ops, bw, flops)
    return {
        "name": "scale_bias_relu (K3)", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/scale_bias_relu.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:439",
        "shape": "%d BatchNorm->ReLU sites of ResNet-50 v1 at batch %d, "
                 "fp32; times summed over one forward's sites"
                 % (len(sites), sites[0][1][0]),
        "max_abs_err": worst, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "library_call_ms": None,
    }, list(jobs.values())


# K2 past 1024 columns, checked in both dtypes (rows, C), scale: the
# bucketed LM's logits (one CTA a row), a 32-row batch (clusters of 4), one
# row (a cluster of 8), C 10001 (scalar loads), (2, 50257) (scalar, a
# cluster of 8), (2, 300000) (past what eight CTAs hold: the streaming
# form), logits x1e4
K2_WIDE_CASES = (((320, 10000), 3.0), ((1920, 10000), 3.0),
                 ((32, 10000), 3.0), ((1, 10000), 3.0), ((7, 10001), 1.0),
                 ((2, 50257), 1.0), ((2, 300000), 1.0), ((32, 10000), 1e4))
# a NaN in row 1 of these, on each form
K2_NAN_CASES = ((4, 1000), (320, 10000), (32, 10000), (2, 300000))
# wide rows timed beside the LM's (counted 0 times): a 32-row batch and
# one row (clusters), GPT-2's vocabulary (2 rows), the streaming form
K2_WIDE_TIMED = ((32, 10000), (1, 10000), (2, 50257), (2, 300000))


def check_k2(ck, dev, bw, flops, rows):
    """K2 against its plain version at the serving shape and at the edges
    of its layouts, fp32 within 1e-6 and bf16 within one rounding: below
    1024 rows one row a block of 1, 2, 4 or 8 warps (the buckets of 1 and
    8 rows, and of 2, 4 and 16 for phase 24, C 1, 100, 256, 500, 999,
    1000 and 1024); from 1024 rows one
    warp a row with 4, 8, 16 or 32 values a lane, each with vector loads
    (C 100, 256, 500 and 512, 1000, 1024) and scalar ones (C 99, 255, 511,
    999); past 1024 columns the row on chip (``K2_WIDE_CASES``: one CTA a
    row, a cluster a row, scalar loads, the streaming form past what eight
    CTAs hold); logits x1e4; a NaN in one row (that row NaN, the others
    held).  Returns its record and its timing jobs: ``(rows, 1000)`` fp32,
    the one a forward runs, and, counted 0 times, unmasked attention
    probabilities (96 x 1024, 1024) fp32, a shape bound by bytes rather
    than by the launch, and the wide rows of ``K2_WIDE_TIMED``, each held
    to its plain version before it is timed."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = 0.0

    def held(x, what):
        y = ck.softmax_lastaxis(x)
        ref = ck.softmax_lastaxis_ref(x)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        total = (y.float().sum(-1) - 1).abs().max().item()
        f32 = x.dtype == torch.float32
        ok = (y.dtype == x.dtype and bool(torch.isfinite(y).all())
              and (err <= 1e-6 if f32 else _bf16_close(y, ref, 1e-6))
              and total <= (1e-5 if f32 else 1e-2))
        if not ok:
            raise AssertionError("K2 at %s %s: max |d| %g, row sums off by "
                                 "%g" % (what, x.dtype, err, total))
        return err if f32 else 0.0

    cases = (((rows, 1000), 1.0), ((1, 1000), 1.0), ((8, 1000), 1.0),
             # phase 24: the fleet's smaller buckets and each context's
             # 16 rows of the multi-context fit
             ((2, 1000), 1.0), ((4, 1000), 1.0), ((16, 1000), 1.0),
             ((7, 1), 1.0), ((6, 100), 1.0), ((6, 256), 1.0),
             ((6, 500), 1.0), ((3, 1024), 1.0), ((3, 1025), 1.0),
             ((5, 999), 1.0), ((5, 4097), 1.0), ((rows, 1000), 1e4),
             ((1024, 100), 1.0), ((1024, 99), 1.0), ((1024, 256), 1.0),
             ((1024, 255), 1.0), ((1500, 500), 1.0), ((1500, 512), 1.0),
             ((1024, 511), 1.0), ((2048, 1000), 1.0), ((1024, 999), 1.0),
             ((1024, 1024), 1.0)) + K2_WIDE_CASES
    for shape, scale in cases:
        x32 = torch.randn(shape, generator=gen, device=dev) * scale
        for dt in (torch.float32, torch.bfloat16):
            worst = max(worst, held(x32.to(dt), "%s x%g" % (shape, scale)))
    for shape in K2_NAN_CASES:
        x32 = torch.randn(shape, generator=gen, device=dev)
        x32[1, shape[1] * 2 // 3] = float("nan")
        keep = torch.arange(shape[0], device=dev) != 1
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            y = ck.softmax_lastaxis(x).float()
            ref = ck.softmax_lastaxis_ref(x).float()
            torch.cuda.synchronize()
            nan = int(torch.isnan(y[1]).sum())
            y, ref = y[keep], ref[keep]
            err = (y - ref).abs().max().item()
            if not (nan == shape[1] and bool(torch.isfinite(y).all()) and (
                    err <= 1e-6 if dt == torch.float32
                    else _bf16_close(y, ref, 1e-6))):
                raise AssertionError(
                    "K2 at %s %s with a NaN in row 1: %d of its %d values "
                    "NaN; the other rows max |d| %g" % (
                        shape, dt, nan, shape[1], err))
    jobs = []
    for shape, count in (((rows, 1000), 1), ((96 * 1024, 1024), 0)) + tuple(
            (shape, 0) for shape in K2_WIDE_TIMED):
        x = torch.randn(shape, generator=gen, device=dev)
        worst = max(worst, held(x, "%s (timed)" % (shape,)))
        b = bound_ms(2 * x.numel() * 4, 5 * x.numel(), bw, flops)
        jobs.append({"count": count, "shape": shape, "bound_ms": b[0],
                     "bound_by": b[1], "fns": {
                         "": lambda x=x: ck.softmax_lastaxis(x),
                         "plain_": lambda x=x: ck.softmax_lastaxis_ref(x),
                         "library_": lambda x=x: torch.softmax(x, -1)}})
    return {
        "name": "softmax_lastaxis (K2)", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/softmax.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:868",
        "shape": "(%d, 1000) fp32, the SoftmaxOutput of one forward" % rows,
        "max_abs_err": worst, "bound_ms": jobs[0]["bound_ms"],
        "bound_by": jobs[0]["bound_by"],
    }, jobs


def time_jobs(rec, jobs, key, timer):
    """``rec[<prefix> + key]`` = the sum over ``jobs`` of count x
    ``timer(fn)``, for the kernel, its plain version and the library
    call; each job keeps its own numbers.  Jobs counted 0 times (shapes
    off the main path) are timed too and listed in ``rec["extra"]``."""
    for pre in ("", "plain_", "library_"):
        if pre in jobs[0]["fns"]:
            for job in jobs:
                job[pre + key] = timer(job["fns"][pre])
            rec[pre + key] = sum(j["count"] * j[pre + key] for j in jobs)
    extra = [j for j in jobs if j["count"] == 0]
    if extra:
        rec["extra"] = [{k: v for k, v in j.items() if k not in ("fns",
                                                                   "count")}
                        for j in extra]


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------
def serve(mx, ck, ctx, sym, image, n_sites, max_batch=BATCH,
          n_requests=REQUESTS, n_clients=CLIENTS, seed=SEED):
    """Serve ``sym`` through ModelServer on ``ctx`` and hold every answer
    against a kernels-off Predictor.  Returns the numbers it measured."""
    from mxnet_tpu_torch.serving import ModelServer
    arg, aux = he_params(sym, image, seed)
    args, auxs = mx.convert.params_from_numpy(arg, aux, ctx, symbol=sym)
    del arg, aux
    rng = np.random.RandomState(seed + 1)
    xs = [rng.randn(rng.randint(1, 4), *image).astype(np.float32)
          for _ in range(n_requests)]
    answers, lats, errors = [None] * n_requests, [0.0] * n_requests, []

    def client(k):
        try:
            for i in range(k, n_requests, n_clients):
                t = time.perf_counter()
                answers[i] = srv.infer("resnet", {"data": xs[i]},
                                       timeout_ms=120000.0)[0]
                lats[i] = (time.perf_counter() - t) * 1e3
        except Exception as exc:    # noqa: BLE001 — re-raised below
            errors.append(exc)

    calibrate_fc(mx, sym, args, auxs, ctx, xs[0])
    ck.reset_kernel_calls()
    srv = ModelServer(max_batch=max_batch, ctx=ctx)
    srv.add_model("resnet", sym, args, auxs, {"data": (1,) + tuple(image)})
    srv.start()
    try:
        t0 = time.perf_counter()
        warmed = srv.warmup("resnet")
        warm_s = time.perf_counter() - t0
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
    calls = ck.kernel_calls()
    if errors:
        raise errors[0]
    st = srv.stats()
    forwards = st["batches"]["count"]
    want = dict.fromkeys(calls, 0)
    want.update(scale_bias_relu=n_sites * forwards, softmax_lastaxis=forwards)
    if calls != want:
        raise AssertionError("kernel launches %s over %d forwards; expected "
                             "%s" % (calls, forwards, want))

    # every answer against a Predictor of the same rows, both knobs at 0
    worst, agree = 0.0, 0
    with knobs("0"):
        preds = {}
        for x, got in zip(xs, answers):
            r = x.shape[0]
            if r not in preds:
                preds[r] = mx.Predictor.from_parts(sym, args, auxs,
                                                   {"data": x.shape}, ctx=ctx)
            ref = preds[r].forward(data=x).get_output(0).asnumpy()
            if got.shape != ref.shape or not np.isfinite(got).all():
                raise AssertionError("answer of shape %s (finite: %s), "
                                     "expected %s" % (got.shape,
                                                      np.isfinite(got).all(),
                                                      ref.shape))
            agree += int((got.argmax(1) == ref.argmax(1)).all())
            worst = max(worst, float(np.abs(got - ref).max()))
        if ck.kernel_calls() != calls:
            raise AssertionError("knob 0 launched a kernel")
    top = np.concatenate([a.max(1) for a in answers])
    if agree != n_requests or worst > 1e-5:
        raise AssertionError("server vs knobs-0 Predictor: argmax equal in "
                             "%d/%d requests, max |dp| %g (limit 1e-5)"
                             % (agree, n_requests, worst))

    # one full-bucket forward, kernels on and knobs 0, in turns
    xb = np.random.RandomState(seed + 2).randn(
        max_batch, *image).astype(np.float32)
    fwd = {}
    for mode in (None, "0"):
        with knobs(mode):
            fwd[mode] = mx.Predictor.from_parts(sym, args, auxs,
                                                {"data": xb.shape}, ctx=ctx)

    def run(mode):
        with knobs(mode):
            t = time.perf_counter()
            fwd[mode].forward(data=xb).get_output(0).asnumpy()
            return (time.perf_counter() - t) * 1e3

    times = {None: [], "0": []}
    for mode in (None, "0", "0", None):
        run(mode)
    for _ in range(5):
        for mode in (None, "0", "0", None):
            times[mode].append(run(mode))
    rows = sum(x.shape[0] for x in xs)
    return {
        "requests": n_requests, "rows": rows, "clients": n_clients,
        "wall_s": wall, "req_per_s": n_requests / wall,
        "rows_per_s": rows / wall,
        "p50_ms": float(np.percentile(lats, 50)),
        "p99_ms": float(np.percentile(lats, 99)),
        "warmup_s": warm_s, "buckets": [b for (_, _, b) in warmed],
        "forwards": forwards, "launches": calls,
        "occupancy": st["batches"]["occupancy"],
        "max_abs_dp": worst, "argmax_equal": agree,
        "top_p_mean": float(top.mean()), "top_p_min": float(top.min()),
        "fwd_ms": float(np.median(times[None])),
        "fwd_ms_knobs0": float(np.median(times["0"])),
        "predictor": fwd[None], "batch_input": xb,
    }


# the kernels of softmax.cu by fragments of their names as the profiler
# prints them ("void (anonymous namespace)::softmax_regs_kernel<float, 32,
# 4, 1>(...)"): K5b's softmax_bwd_{regs,rows}_kernel, K5a's
# bias_softmax_{regs,rows}_kernel, K2's softmax_regs_kernel and
# softmax_rows_{onchip,stream}_kernel (and the parent commit's strided
# softmax_rows_kernel); the leading "::" keeps each kind's fragments out
# of the others' names
SOFTMAX_KINDS = (("K5b", ("::softmax_bwd_",)), ("K5a", ("::bias_softmax_",)),
                 ("K2", ("::softmax_regs_", "::softmax_rows_")))

# flash_attention.cu's kernels by name: K7a's flash_fwd_kernel and
# flash_fwd_bf16_kernel, K7b's flash_bwd_dq_kernel and
# flash_bwd_dq_bf16_kernel, K7c's flash_bwd_dkv_kernel and
# flash_bwd_dkv_bf16_kernel
FLASH_KINDS = (("K7a", ("flash_fwd",)), ("K7b", ("flash_bwd_dq",)),
               ("K7c", ("flash_bwd_dkv",)))

# kinds of kernel in a profile, by fragments of the kernel's name; the
# first kind that matches wins
KINDS = (("K3", ("scale_bias_relu",)),) + SOFTMAX_KINDS + FLASH_KINDS + (
    ("K1a/K1b/K4 sweep", ("sweep_kernel",)),
    ("convolution", ("xmma", "conv", "implicit", "gemm", "cudnn", "wgrad",
                     "dgrad", "nvjet")),
    ("copy to device", ("Memcpy HtoD",)),
    ("copy to host", ("Memcpy DtoH",)),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized")),
    ("pooling", ("pool",)))


def by_kind(by_name, kinds=KINDS):
    """``{kind: device us}`` of a ``device_times`` result."""
    us = dict.fromkeys([k for k, _ in kinds] + ["other"], 0.0)
    for name, v in by_name.items():
        kind = next((k for k, frags in kinds
                     if any(f in name for f in frags)), "other")
        us[kind] += v
    return us


def profile_forward(pred, x, wall_ms):
    """Device time by kind of kernel over one forward (torch.profiler),
    beside the forward's wall time ``wall_ms`` measured without the
    profiler; a printable line."""
    def fwd():
        pred.forward(data=x).get_output(0).asnumpy()

    by_name = device_times(fwd, n=1)
    wall, busy = wall_ms * 1e3, sum(by_name.values())
    if busy <= 0:
        return "profile: not measured (the trace holds no device time)"
    return ("profile of one bucket-%d forward: wall %.0f us, device busy "
            "%.0f us (idle share %.3f); by kind: %s"
            % (x.shape[0], wall, busy, max(0.0, 1 - busy / wall),
               ", ".join("%s %.0f us" % kv
                         for kv in by_kind(by_name).items())))


# ---------------------------------------------------------------------------
# phases 5-7: the training path
# ---------------------------------------------------------------------------
def synthetic_iter(mx, ctx, batch, image, steps, seed=SEED, classes=CLASSES):
    """One fixed random batch held on ``ctx``, handed out ``steps`` times
    per epoch (example/image-classification/common/data.py
    SyntheticDataIter, with the batch made from ``seed``)."""
    rng = np.random.RandomState(seed)
    data = mx.nd.array(rng.uniform(-1, 1, (batch,) + tuple(image))
                       .astype(np.float32), ctx=ctx)
    label = mx.nd.array(rng.randint(0, classes, (batch,))
                        .astype(np.float32), ctx=ctx)

    class SyntheticDataIter(mx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=batch)
            self.cur = 0
            self.provide_data = [mx.io.DataDesc("data", data.shape)]
            self.provide_label = [mx.io.DataDesc("softmax_label",
                                                 label.shape)]

        def next(self):
            self.cur += 1
            if self.cur > steps:
                raise StopIteration
            return mx.io.DataBatch(data=[data], label=[label], pad=0)

        def reset(self):
            self.cur = 0

    return SyntheticDataIter()


def cross_entropy(prob, label):
    """Mean cross-entropy of softmax output ``prob`` against ``label``."""
    p = prob.gather(1, label.long().view(-1, 1)).clamp_min(1e-12)
    return float(-p.log().mean())


def _marker(device):
    """A point on ``device``'s timeline: a recorded CUDA event, or the
    host clock on the CPU."""
    if device.type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def _elapsed_ms(a, b):
    if isinstance(a, float):
        return (b - a) * 1e3
    b.synchronize()
    return a.elapsed_time(b)


def train(mx, ck, ctx, sym, image, batch, steps, warmup=0, optimizer="sgd",
          optimizer_params=SGD_PARAMS, arg_params=None, aux_params=None,
          seed=SEED, classes=CLASSES, compute_dtype=None):
    """``Module.fit`` of ``sym`` on ``ctx`` with ``kvstore="tpu"``, one
    epoch of ``warmup + steps`` batches of one fixed synthetic batch,
    Xavier initialisation (``fit.py``'s: gaussian, fan in, magnitude 2)
    unless parameters are given, in ``compute_dtype`` (None: fp32).  The
    launch counts are reset just before ``fit`` and read just after.
    Returns the module and what it measured."""
    total = warmup + steps
    it = synthetic_iter(mx, ctx, batch, image, total, seed, classes)
    mod = mx.mod.Module(sym, context=ctx, compute_dtype=compute_dtype)
    device = torch.device("cuda", ctx.device_id) \
        if ctx.device_type == "gpu" else torch.device("cpu")
    marks, probs = [], {}

    def on_batch(param):
        if param.nbatch in (0, total - 1):
            probs[param.nbatch] = mod.get_outputs()[0]._data.clone()
        marks.append(_marker(device))

    mx.random.seed(seed)
    ck.reset_kernel_calls()
    mod.fit(it, num_epoch=1, kvstore="tpu", optimizer=optimizer,
            optimizer_params=optimizer_params,
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            arg_params=arg_params, aux_params=aux_params,
            eval_metric="acc",
            batch_end_callback=[on_batch,
                                mx.callback.Speedometer(batch, 10)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    calls = ck.kernel_calls()
    exe = mod._exec_group.execs[0]
    label = it.next().label[0]._data
    step_ms = _elapsed_ms(marks[warmup - 1], marks[-1]) / steps \
        if warmup else None
    return mod, {
        "steps": total, "calls": calls,
        "fused": mod._fused_exec_update,
        "buckets": [b.n for b, _ in exe._sweep["plan"]]
        if exe._sweep is not None else [],
        "kernel": exe._sweep["kernel"] if exe._sweep is not None else None,
        "step_ms": step_ms,
        "images_per_s": batch / step_ms * 1e3 if step_ms else None,
        "ce_first": cross_entropy(probs[0], label),
        "ce_last": cross_entropy(probs[total - 1], label),
    }


def steps_without_sync(mod, batch, n=2):
    """``n`` more training steps of ``mod`` with torch's sync debug mode
    at "error": anything in a step that makes the host wait for the card
    (a blocking copy from pageable memory, an ``.item()``) raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            mod.forward_backward(batch)
            mod.update()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def momentum_by_name(exe):
    """``{weight name: first optimizer slot}`` of a fused-step executor,
    whether its slots are bucket-major (the sweep) or per weight."""
    return {n: st[0] for n, st in exe.optimizer_slots().items()}


def module_state(mod):
    """Copies of a fused-step module's ``(weights, momentum, moving
    stats)``, each ``{name: tensor}``."""
    exe = mod._exec_group.execs[0]
    return ({n: exe.arg_dict[n]._data.clone()
             for n in mod._exec_group.param_names},
            {n: m.clone() for n, m in momentum_by_name(exe).items()},
            {n: a._data.clone() for n, a in exe.aux_dict.items()})


def compare_states(sa, sb):
    """Two tuples of ``{name: fp32 tensor}`` (``module_state``s, say): the
    number of tensors, whether every one is bitwise equal, and the
    largest difference of any tensor relative to that tensor's largest
    magnitude in ``sb``."""
    worst, bitwise, count = 0.0, True, 0
    for ka, kb in zip(sa, sb):
        if set(ka) != set(kb):
            raise AssertionError("the two states hold different tensors")
        for n in ka:
            a, b = ka[n].to(kb[n].device), kb[n]
            bitwise &= torch.equal(a.view(torch.int32), b.view(torch.int32))
            rel = ((a - b).abs().max()
                   / b.abs().max().clamp_min(1e-30)).item()
            worst = max(worst, rel)
            count += 1
    return {"tensors": count, "bitwise": bitwise, "max_rel": worst}


def parity(mx, ck, ctx, sym, image, batch, arg_params, aux_params,
           classes=CLASSES, on=None):
    """Two steps from the same saved state (the second one uses the
    momentum of the first), once with the sweep kernels
    (``MXNET_PALLAS_FUSED_OPT`` = ``on``; None leaves it at ``auto``) and
    once with it at 0, cuDNN deterministic.  Returns the largest
    difference of any weight, momentum or moving-stat tensor relative to
    that tensor's largest magnitude, and whether every tensor is bitwise
    equal."""
    state = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in (on, "0"):
            with knobs(mode, FUSED_OPT):
                mod, res = train(mx, ck, ctx, sym, image, batch, 2,
                                 arg_params=arg_params,
                                 aux_params=aux_params, classes=classes)
            if (res["kernel"] is not None) != (mode != "0"):
                raise AssertionError("MXNET_PALLAS_FUSED_OPT=%s took the "
                                     "wrong path" % mode)
            state[mode] = module_state(mod)
            del mod
    finally:
        torch.backends.cudnn.deterministic = saved
    return compare_states(state[on], state["0"])


# ---------------------------------------------------------------------------
# phase 8: the sweep kernels against their plain versions
# ---------------------------------------------------------------------------
SWEEPS = (  # name, K number, slots, TPU kernel line, float ops per element
    ("sgd_sweep", "K1a", 0, 538, 5),
    ("sgd_mom_sweep", "K1b", 1, 543, 7),
    ("adam_sweep", "K4", 2, 551, 15),
)


def sweep_hyper(name, use_clip):
    h = {"sgd_sweep": [0.02, 1e-4, 1.0 / BATCH],
         "sgd_mom_sweep": [0.02, 0.9, 1e-4, 1.0 / BATCH],
         "adam_sweep": [1e-3, 0.9, 0.999, 1.0 - 0.9, 1.0 - 0.999, 1e-8,
                        1e-4, 1.0 / BATCH]}[name]
    return h + ([0.5] if use_clip else [])


def check_sweeps(ck, dev, bw, flops, buckets):
    """Each sweep bitwise equal to its plain version (on clones: both
    write in place) at the training path's bucket sizes and at the edges,
    aligned and misaligned, clip on and off.  Returns one record per
    kernel and its timing jobs, one per bucket."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    recs, jobs = {}, {}
    for name, knum, n_slots, line, ops in SWEEPS:
        worst = 0.0
        for n in list(buckets) + [1, 3, 4097]:
            for offset in (0, 1):
                for use_clip in (False, True):
                    bufs = [torch.randn(n + offset, generator=gen,
                                        device=dev)[offset:]
                            for _ in range(2 + n_slots)]
                    bufs[1] *= 3.0
                    if n_slots == 2:
                        bufs[3] = bufs[3].abs() * 0.01
                    h = torch.tensor(sweep_hyper(name, use_clip),
                                     dtype=torch.float32, device=dev)
                    kb = [b.clone() for b in bufs]
                    pb = [b.clone() for b in bufs]
                    getattr(ck, name)(kb[0], kb[1], *kb[2:], h, use_clip)
                    getattr(ck, name + "_ref")(pb[0], pb[1], *pb[2:], h,
                                               use_clip)
                    torch.cuda.synchronize()
                    for k, p in zip(kb, pb):
                        if not torch.equal(k.view(torch.int32),
                                           p.view(torch.int32)):
                            raise AssertionError(
                                "%s %s differs from its plain version at "
                                "n=%d offset=%d clip=%s: max |d| %g"
                                % (knum, name, n, offset, use_clip,
                                   (k - p).abs().max().item()))
                        worst = max(worst, (k - p).abs().max().item())
        nbytes = ops_total = 0
        jobs[name] = []
        for n in buckets:
            bufs = [torch.randn(n, generator=gen, device=dev)
                    for _ in range(2 + n_slots)]
            if n_slots == 2:
                bufs[3] = bufs[3].abs() * 0.01
            h = torch.tensor(sweep_hyper(name, False), dtype=torch.float32,
                             device=dev)
            moved = 4 * n * (2 + 2 * n_slots + 1)    # reads w g slots; writes
            nbytes += moved
            ops_total += ops * n
            fns = {"": lambda b=bufs, h=h, f=getattr(ck, name):
                   f(b[0], b[1], *b[2:], h),
                   "plain_": lambda b=bufs, h=h,
                   f=getattr(ck, name + "_ref"): f(b[0], b[1], *b[2:], h)}
            jobs[name].append({"count": 1, "n": n, "fns": fns,
                               "bound_ms": bound_ms(moved, ops * n, bw,
                                                    flops)[0]})
        bms, by = bound_ms(nbytes, ops_total, bw, flops)
        recs[name] = {
            "name": "%s (%s)" % (name, knum), "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/optimizer_sweep.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:%d" % line,
            "shape": "flat fp32 buckets of %s elements (one fused step of "
                     "ResNet-50 v1); times summed over the buckets" % (
                         list(buckets),),
            "max_abs_err": worst, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "library_call_ms": None,
            "library_note": "none computes this function: torch's fused "
                            "SGD keeps buf = mu*buf + g, its Adam puts eps "
                            "elsewhere",
        }
    return recs, jobs


# ---------------------------------------------------------------------------
# phase 9: the transformer kernels against their plain versions
# ---------------------------------------------------------------------------
def check_k6a(ck, dev, bw, flops, rows=LM_BATCH * LM_T[0],
              cols=GPT2_SMALL["units"]):
    """K6a against its plain version at the transformer's shape, at
    ragged widths and at the wider rows of the block-per-row layouts
    (GPT-2 medium to XL widths 1024-1600, 2048, 4096, and 10000 past the
    registers), fp32 within 1e-5 (the row sums run in another order;
    rsqrtf is within 2 ulp) and bf16 within one rounding.  Returns its
    record and its timing job at ``(rows, cols)`` fp32."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    worst = 0.0
    for shape in ((rows, cols), (rows // 8, 37), (rows // 8, 1000),
                  (rows // 8, 1280), (rows // 8, 1600), (rows // 8, 2048),
                  (rows // 8, 4096), (rows // 32, 10000)):
        c = shape[1]
        x32 = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
        g = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            o, mu, rstd = ck.layernorm_fwd(x, g, b, 1e-5)
            ro, rmu, rrstd = ck.layernorm_fwd_ref(x, g, b, 1e-5)
            torch.cuda.synchronize()
            err = (o.float() - ro.float()).abs().max().item()
            ok = (o.dtype == dt and (mu - rmu).abs().max().item() <= 1e-5
                  and ((rstd - rrstd).abs() / rrstd).max().item() <= 1e-5
                  and (err <= 1e-5 if dt == torch.float32
                       else _bf16_close(o, ro, 1e-5)))
            if not ok:
                raise AssertionError("K6a at %s %s: max |d| %g" % (shape, dt,
                                                                    err))
            if dt == torch.float32:
                worst = max(worst, err)
    x = torch.randn((rows, cols), generator=gen, device=dev)
    g, b = torch.ones(cols, device=dev), torch.zeros(cols, device=dev)
    bms, by = bound_ms(2 * x.numel() * 4 + 2 * cols * 4 + 2 * rows * 4,
                       7 * x.numel(), bw, flops)
    return {
        "name": "layernorm_fwd (K6a)", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/layernorm.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:772",
        "shape": "(%d, %d) fp32, one LayerNorm of the transformer forward"
                 % (rows, cols),
        "max_abs_err": worst, "bound_ms": bms, "bound_by": by,
    }, [{"count": 1, "shape": (rows, cols), "bound_ms": bms, "fns": {
        "": lambda: ck.layernorm_fwd(x, g, b, 1e-5),
        "plain_": lambda: ck.layernorm_fwd_ref(x, g, b, 1e-5),
        "library_": lambda: torch.nn.functional.layer_norm(
            x, (cols,), g, b, 1e-5)}}]


def flash_bound(bh, tq, tk, d, causal, itemsize, bw, flops):
    """Bytes (q, k, v read and o written once, lse written) and fp32
    operations (two products of 2 d each per visible (query, key) pair:
    under a causal mask row r sees min(r + 1, tk) keys) of one K7a call."""
    pairs = sum(min(r + 1, tk) for r in range(tq)) if causal else tq * tk
    return bound_ms((2 * bh * tq * d + 2 * bh * tk * d) * itemsize
                    + bh * tq * 4, 4 * d * bh * pairs, bw, flops)


def attention_terms(q, k, v, causal, largest, scale=None):
    """Per element of o: ``w_j |v_j|`` over the keys j of its row, w the
    fp32 softmax weights (``scale`` default 1/sqrt(D)); the largest term
    (``largest``) or their sum."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        keep = torch.ones(s.shape[1:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    w = torch.softmax(s, -1)
    av = v.float().abs()
    if largest:
        return (w[..., None] * av[:, None]).amax(2)
    return torch.matmul(w, av)


def bf16_attention_close(o, ro, terms, atol):
    """bf16 o against its plain version: one bf16 step of the larger
    magnitude (the output's own rounding) plus one step of ``terms`` (the
    p that the two round to the two sides of a step), plus ``atol``."""
    o, ro = o.float(), ro.float()
    mag = torch.maximum(o.abs(), ro.abs())
    return bool(((o - ro).abs() <= (mag + terms) * 2.0 ** -7 + atol).all())


def k7a_key_tile(d):
    """The keys a step of K7a's instance for head dim ``d`` in bf16 (the
    kernel's ``FwdBf16Tile``; above 256 the WIDE instance's 64)."""
    return 32 if 128 < d <= 256 else 64


def check_k7a(ck, dev, bw, flops, bf16,
              bh=LM_BATCH * GPT2_SMALL["num_heads"], t=LM_T[0],
              d=GPT2_SMALL["units"] // GPT2_SMALL["num_heads"]):
    """K7a against its plain version at the transformer's shape, causal
    and full, at T 8/64/1024 x D 32/64/128, at the edges of its tiles (T
    1, 127, 129 and 1000 at D 64 and 128), at Tq != Tk (40 and 72 both
    ways at D 64, 90 queries and 130 keys at D 128 and 320), and at other
    head dims at T 200: the other multiples of 16 up to 128, the padded
    widths 8, 72, 200 and 256, and D 320 and 512 (chunks of 64 columns),
    each case in fp32 and in bf16: fp32 o and lse within 1e-5 (the kernel
    sums 32- or 64-key tiles with online rescaling, the plain version one
    product over up to 1024 keys); bf16 lse within 1e-5 too, and o, where
    both round p to bf16 before ``p v``: where the keys fit in one of the
    instance's key tiles (``k7a_key_tile``; the same p rounded) within
    one rounding of its magnitude plus one step of its largest term ``w_j
    |v_j|`` (an exp that differs in its last bit puts one p on the other
    side of a step); beyond, where the kernel rounds p at its running
    max, plus one step of the sum of its terms.  Returns its record and its
    timing jobs: causal fp32 at the transformer's shape, and, counted 0
    times, the same shape full and in bf16, and (bh / 2, t, 2 d) causal,
    the widest instance with 64-row tiles; fp32 jobs bound at the fp32
    rate ``flops``, bf16 ones at the bf16 tensor-core rate ``bf16``."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    worst = 0.0
    shapes = [(bh, t, t, d)]
    shapes += [(4, tt, tt, dd) for tt in (8, 64, 1024) for dd in (32, 64, 128)]
    shapes += [(4, tt, tt, dd) for tt in (1, 127, 129, 1000)
               for dd in (64, 128)]
    shapes += [(4, 40, 72, 64), (4, 72, 40, 64), (4, 90, 130, 128),
               (4, 90, 130, 320)]
    shapes += [(4, 200, 200, dd)
               for dd in (16, 48, 80, 96, 112, 8, 72, 200, 256, 320, 512)]
    cases = [shape + (c, dt) for dt in (torch.float32, torch.bfloat16)
             for shape in shapes for c in (True, False)]
    for b_, tq, tk, d_, causal, dt in cases:
        q = torch.randn((b_, tq, d_), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((b_, tk, d_), generator=gen, device=dev).to(dt)
                for _ in range(2))
        o, lse = ck.flash_attention_fwd(q, k, v, causal)
        ro, rlse = ck.flash_attention_fwd_ref(q, k, v, causal)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lerr = (lse - rlse).abs().max().item()
        if dt == torch.float32:
            close = err <= 1e-5
        else:
            close = bf16_attention_close(o, ro, attention_terms(
                q, k, v, causal, largest=tk <= k7a_key_tile(d_)), 1e-6)
        ok = (o.dtype == dt and bool(torch.isfinite(o).all()) and lerr <= 1e-5
              and close)
        if not ok:
            raise AssertionError("K7a at %s causal=%s %s: max |d| o %g, lse "
                                 "%g" % ((b_, tq, tk, d_), causal, dt, err,
                                         lerr))
        if dt == torch.float32:
            worst = max(worst, err, lerr)
    heads = GPT2_SMALL["num_heads"]
    jobs = []
    for b_, d_, causal, dt, count in (
            (bh, d, True, torch.float32, 1), (bh, d, False, torch.float32, 0),
            (bh, d, True, torch.bfloat16, 0),
            (bh // 2, 2 * d, True, torch.float32, 0)):
        q, k, v = (torch.randn((b_, t, d_), generator=gen, device=dev).to(dt)
                   for _ in range(3))
        q4, k4, v4 = (a.view(b_ // heads, heads, t, d_) for a in (q, k, v))
        b = flash_bound(b_, t, t, d_, causal, q.element_size(), bw,
                        flops if dt == torch.float32 else bf16)
        pairs = t * (t + 1) // 2 if causal else t * t
        jobs.append({
            "count": count, "shape": (b_, t, d_), "causal": causal,
            "dtype": str(dt).replace("torch.", ""), "bound_ms": b[0],
            "bound_by": b[1], "ops": 4 * d_ * b_ * pairs, "fns": {
                "": lambda q=q, k=k, v=v, c=causal: ck.flash_attention_fwd(
                    q, k, v, c),
                "plain_": lambda q=q, k=k, v=v, c=causal:
                    ck.flash_attention_fwd_ref(q, k, v, c),
                "library_": lambda q=q4, k=k4, v=v4, c=causal:
                    torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=c)}})
    return {
        "name": "flash_attention_fwd (K7a)", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:153",
        "shape": "(%d, %d, %d) fp32 causal, one attention of the "
                 "transformer forward at T=%d" % (bh, t, d, t),
        "max_abs_err": worst, "bound_ms": jobs[0]["bound_ms"],
        "bound_by": jobs[0]["bound_by"],
    }, jobs


def causal_bias(t, dev):
    """The (t, t) causal mask as local_attention hands it to K5a."""
    keep = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    return torch.where(keep, 0.0, -1e30).to(torch.float32)


# C at the edges of the register instances of softmax.cu (4, 8, 16 or 32
# values a lane: C <= 128, 256, 512, 1024), with 16-byte loads where C %
# 4 == 0 (bf16: % 8, or 8-byte loads at % 4) and scalar ones elsewhere,
# and past them (1025, 4097: the strided loop)
SOFTMAX_EDGE_C = (1, 31, 32, 33, 99, 100, 128, 129, 255, 256, 511, 512, 513,
                  999, 1000, 1020, 1024, 1025, 4097)


def offset_view(t, k):
    """A contiguous copy of ``t`` starting ``k`` elements past an aligned
    allocation: every 16-byte (and 8-byte bf16) load then falls back to
    scalar ones."""
    out = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:]
    return out.view(t.shape).copy_(t)


def softmax_edge_cases(gen, dev):
    """(x fp32, bias, masked, off, what) at every C of ``SOFTMAX_EDGE_C``
    below 1024 rows, (2, 3, C), and from there on, (3, 343, C) and (5,
    205, C): not a multiple of four rows a block; the bias causal with row
    1 masked entirely (that row comes out uniform), ``masked`` the columns
    that must come out 0.  Then four C again with ``off`` set: the caller
    views x one element off its alignment."""
    cases = [((b, r, c), False) for b, r in ((2, 3), (3, 343), (5, 205))
             for c in SOFTMAX_EDGE_C]
    cases += [((3, 343, c), True) for c in (100, 256, 512, 1020)]
    for shape, off in cases:
        r, c = shape[1:]
        keep = torch.ones((r, c), dtype=torch.bool, device=dev).tril()
        keep[1] = False
        bias = torch.where(keep, 0.0, -1e30).to(torch.float32)
        masked = ~keep
        masked[1] = False
        x = torch.randn(shape, generator=gen, device=dev) * 3
        yield x, bias, masked, off, "%s%s" % (shape, " offset" if off else "")


def check_k5a(ck, dev, bw, flops, bh=LM_BATCH * GPT2_SMALL["num_heads"],
              t=LM_T[1]):
    """K5a against its plain version at the transformer's shape with the
    causal bias and with a zero bias (no mask), and at every case of
    ``softmax_edge_cases``: fp32 within 1e-6 (the sum in another order, as
    K2); bf16 within one bf16 rounding of the magnitude plus 1e-6, since
    both compute in fp32 and round once (a flat 1e-2 would be ten times a
    typical probability of 1/1020); masked columns exactly 0.  Returns its
    record and its timing job, causal fp32."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    worst = 0.0

    def held(x, bias, masked, what):
        y = ck.bias_softmax(x, bias)
        ref = ck.bias_softmax_ref(x, bias)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        f32 = x.dtype == torch.float32
        close = err <= 1e-6 if f32 else _bf16_close(y, ref, 1e-6)
        zero = bool((y[..., masked] == 0).all())
        if y.dtype != x.dtype or not close or not zero:
            raise AssertionError("K5a at %s %s: max |d| %g, masked columns "
                                 "zero: %s" % (what, x.dtype, err, zero))
        return err if f32 else 0.0

    causal = causal_bias(t, dev)
    for bias, dt in ((causal, torch.float32),
                     (torch.zeros_like(causal), torch.float32),
                     (causal, torch.bfloat16)):
        x = (torch.randn((bh, t, t), generator=gen, device=dev) * 3).to(dt)
        worst = max(worst, held(x, bias, bias < 0, (bh, t, t)))
        del x
    for x32, bias, masked, off, what in softmax_edge_cases(gen, dev):
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            worst = max(worst, held(offset_view(x, 1) if off else x, bias,
                                    masked, what))
    x = torch.randn((bh, t, t), generator=gen, device=dev) * 3
    bms, by = bound_ms(2 * x.numel() * 4 + causal.numel() * 4,
                       5 * x.numel(), bw, flops)
    return {
        "name": "bias_softmax (K5a)", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/softmax.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:875",
        "shape": "(%d, %d, %d) fp32 with the causal bias, one attention "
                 "of the transformer forward at T=%d" % (bh, t, t, t),
        "max_abs_err": worst, "bound_ms": bms, "bound_by": by,
    }, [{"count": 1, "shape": (bh, t, t), "bound_ms": bms, "fns": {
        "": lambda: ck.bias_softmax(x, causal),
        "plain_": lambda: ck.bias_softmax_ref(x, causal),
        "library_": lambda: torch.softmax(x + causal, -1)}}]


# ---------------------------------------------------------------------------
# phase 11: the backward kernels against their plain versions
# ---------------------------------------------------------------------------
def rel_err(got, ref):
    """max |got - ref| over the largest |ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _bf16_bwd_close(got, ref):
    """bf16 backward: within one bf16 rounding of each element's
    magnitude, plus one rounding of the largest magnitude for the values
    (p and ds in K7b/K7c, the row means in K6b) that the kernel and the
    plain version round to the two sides of one bf16 step."""
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs())
    return bool(((got - ref).abs() <= (mag + ref.abs().max())
                 * 2.0 ** -7).all())


# K6b's shapes besides the training step's (8192, 768): ((rows, C), dtype,
# elements the operands start past an aligned allocation).  C at the edges
# of the vector layout's instances (16-byte chunks, 1-8 a lane: fp32 C %
# 4 == 0 up to 128, 256, 384, 512, 768, 1024, bf16 C % 8 == 0 up to 256,
# 512, 768, 1024) and one chunk past each; C that take the scalar warp
# layout (37; 1020 in bf16; any C off its alignment); 1025 and 9000 (the
# block layouts); row counts that are not a multiple of the persistent
# grid (8191, 1031) or below one block (3).
K6B_EDGE = tuple(
    [((1031, c), torch.float32, 0) for c in (
        4, 128, 132, 256, 260, 384, 388, 512, 516, 768, 772, 1020, 1024)]
    + [((1031, c), torch.bfloat16, 0) for c in (
        8, 256, 264, 512, 520, 768, 776, 1020, 1024)]
    + [((r, c), dt, 0) for dt in (torch.float32, torch.bfloat16)
       for r, c in ((8191, 768), (3, 768), (1031, 37), (1031, 1025),
                    (257, 9000))]
    + [((8192, 768), torch.float32, 1), ((1031, 768), torch.float32, 2),
       ((8192, 768), torch.bfloat16, 1), ((1031, 768), torch.bfloat16, 4)])


def k6b_operands(dev, shape, dtype, seed, off=0):
    """x, do (``dtype``, starting ``off`` elements past an aligned
    allocation), fp32 gamma, and K6a's own fp32 mu and rstd of x."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
    do = torch.randn(shape, generator=gen, device=dev)
    g = 1 + 0.1 * torch.randn(shape[-1], generator=gen, device=dev)
    x, do = x.to(dtype), do.to(dtype)
    if off:
        x, do = offset_view(x, off), offset_view(do, off)
    _, mu, rstd = ck.layernorm_fwd(x, g, torch.zeros_like(g), 1e-5)
    return x, do, g, mu, rstd


def aten_layernorm_dx(x, do, g):
    """One call of aten's ``native_layer_norm_backward`` computing only dx
    for these operands, with gamma in x's dtype and aten's own saved mean
    and rstd."""
    c = x.shape[-1]
    gw = g.to(x.dtype)
    bw = torch.zeros_like(gw)
    _, mean, rstd = torch.native_layer_norm(x, [c], gw, bw, 1e-5)
    return lambda: torch.ops.aten.native_layer_norm_backward(
        do, x, [c], mean, rstd, gw, bw, [True, False, False])


def k6b_close(dx, ref):
    """(ok, max |d| over the largest |ref|): fp32 within 1e-5 of the
    largest |dx| (the two row sums in another order), bf16 within one
    rounding (``_bf16_bwd_close``)."""
    err = rel_err(dx, ref)
    if dx.dtype != ref.dtype:
        return False, err
    return (err <= 1e-5 if dx.dtype == torch.float32
            else _bf16_bwd_close(dx, ref)), err


def check_k6b(ck, dev, bw, flops, bf16, rows=LM_BATCH * LM_T[0],
              cols=GPT2_SMALL["units"]):
    """K6b against its plain version at the training step's shape, fp32
    and bf16, and at ``K6B_EDGE``, from K6a's own mu and rstd (fp32 within
    1e-5 of the largest |dx|, bf16 within one rounding).  Returns its
    record and its timing jobs: fp32 at ``(rows, cols)`` (the main path's
    instance), then bf16 there (off the fp32 path; phase 15 launches it),
    each beside aten's dx-only backward on the same operands; the bf16
    job's operations at the bf16 rate ``bf16`` (bound by bytes all the
    same)."""
    worst = 0.0
    for shape, dt, off in (((rows, cols), torch.float32, 0),
                           ((rows, cols), torch.bfloat16, 0)) + K6B_EDGE:
        x, do, g, mu, rstd = k6b_operands(dev, shape, dt, SEED + 7, off)
        dx = ck.layernorm_bwd(x, do, g, mu, rstd)
        ref = ck.layernorm_bwd_ref(x, do, g, mu, rstd)
        torch.cuda.synchronize()
        ok, err = k6b_close(dx, ref)
        if not ok:
            raise AssertionError("K6b at %s %s offset %d: max |d| %g of the "
                                 "largest" % (shape, dt, off, err))
        if dt == torch.float32:
            worst = max(worst, (dx - ref).abs().max().item())
    jobs = []
    for k, dt in enumerate((torch.float32, torch.bfloat16)):
        x, do, g, mu, rstd = k6b_operands(dev, (rows, cols), dt, SEED + 8)
        nbytes = 3 * x.numel() * x.element_size() + cols * 4 + 2 * rows * 4
        bms, by = bound_ms(nbytes, 10 * x.numel(), bw,
                           flops if dt == torch.float32 else bf16)
        jobs.append({
            "count": 1 - k, "shape": (rows, cols), "dtype": str(dt)[6:],
            "bound_ms": bms, "bound_by": by, "fns": {
                "": (lambda a: lambda: ck.layernorm_bwd(*a))(
                    (x, do, g, mu, rstd)),
                "plain_": (lambda a: lambda: ck.layernorm_bwd_ref(*a))(
                    (x, do, g, mu, rstd)),
                "library_": aten_layernorm_dx(x, do, g)}})
    return {
        "name": "layernorm_bwd (K6b)", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/layernorm.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:784",
        "shape": "(%d, %d) fp32, the dx of one LayerNorm of the training "
                 "step" % (rows, cols),
        "max_abs_err": worst, "bound_ms": jobs[0]["bound_ms"],
        "bound_by": jobs[0]["bound_by"],
        "library_note": "aten native_layer_norm_backward with only dx "
                        "requested",
    }, jobs


def flash_bwd_operands(ck, gen, bh, tq, tk, d, causal, dtype, dev):
    """q, k, v, do, lse, delta of one backward call: random q, k, v and
    do, lse from K7a, delta = sum(do * o)."""
    q = torch.randn((bh, tq, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((bh, tk, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn((bh, tq, d), generator=gen, device=dev).to(dtype)
    o, lse = ck.flash_attention_fwd(q, k, v, causal)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1)


def flash_bwd_bound(bh, tq, tk, d, causal, n_out, n_products, bw, flops,
                    tf32):
    """Bytes (q, k, v, do read, lse and delta read, ``n_out`` outputs of
    (BH, T, D) written) and fp32 operations (``n_products`` products of
    2 d per visible (query, key) pair) of one K7b or K7c call.  Returns
    ``(ops, (ms, by) on the fp32 CUDA cores, (ms, by) on the tensor cores
    in 3xTF32)``: each fp32 product there is three TF32 products, so 3 x
    ops at the TF32 rate.  The shipped kernels run 3xTF32 and are held to
    the second."""
    pairs = sum(min(r + 1, tk) for r in range(tq)) if causal else tq * tk
    nbytes = flash_bwd_bytes(bh, tq, tk, d, n_out, 4)
    ops = 2 * d * n_products * bh * pairs
    return ops, bound_ms(nbytes, ops, bw, flops), bound_ms(nbytes, 3 * ops,
                                                           bw, tf32)


def flash_bwd_bytes(bh, tq, tk, d, n_out, itemsize):
    """Bytes of one K7b or K7c call: q, k, v and do read and ``n_out``
    outputs of (BH, T, D) written in ``itemsize``-byte values, lse and
    delta read in fp32."""
    return ((2 * bh * tq * d + 2 * bh * tk * d + n_out * bh * tk * d)
            * itemsize + 2 * bh * tq * 4)


def check_k7bc(ck, dev, bw, flops, tf32,
               bh=LM_BATCH * GPT2_SMALL["num_heads"], t=LM_T[0],
               d=GPT2_SMALL["units"] // GPT2_SMALL["num_heads"]):
    """K7b and K7c against their plain versions at the training step's
    shape, causal and full, at ragged T (7, 15, 17, 63, 65, 1020, the
    edges of the 16-row warp tiles and 64-row block tiles; at T 1 dv must
    equal do and dq, dk be 0 within 1e-5 of the largest |dv|, in fp32),
    at Tq != Tk, at every instance width (D 32 to 256 by 32) and the
    padded widths 8, 72, 150 and 200, and at D 320 and 512 (chunks of 64
    columns), each case in fp32 and in bf16 (K7b's bf16 instance reads
    the lse of K7a's): dq, dk and dv within 1e-5 of their largest
    magnitude in fp32 (the kernels sum 3xTF32 products over tiles, the
    plain version one fp32 product), within one rounding in bf16
    (``_bf16_bwd_close``).  Returns their two records and timing
    jobs, causal fp32; the library call, the backward of
    ``scaled_dot_product_attention(is_causal=True)``, computes dq, dk and
    dv together.  ``bound_ms`` is the 3xTF32 tensor-core bound the
    kernels are designed to; ``bound_cuda_cores_ms`` the fp32 one."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = {"dq": 0.0, "dkv": 0.0}
    cases = [(bh, t, t, d, c) for c in (True, False)]
    cases += [(4, tt, tt, 64, c)
              for tt in (7, 15, 17, 63, 65, 1020) for c in (True, False)]
    cases += [(4, 40, 72, 64, c) for c in (True, False)]
    cases += [(4, 72, 40, 64, c) for c in (True, False)]
    cases += [(4, 200, 200, dd, c)
              for dd in (8, 16, 32, 48, 72, 96, 128, 150, 160, 192, 200, 224,
                         256, 320, 512) for c in (True, False)]
    cases += [(4, 90, 130, 128, False), (4, 90, 130, 320, False)]
    cases = [case + (dt,) for dt in (torch.float32, torch.bfloat16)
             for case in cases]
    for b_, tq, tk, d_, causal, dt in cases:
        args = flash_bwd_operands(ck, gen, b_, tq, tk, d_, causal, dt, dev)
        dq = ck.flash_attention_bwd_dq(*args, causal)
        dk, dv = ck.flash_attention_bwd_dkv(*args, causal)
        rdq = ck.flash_attention_bwd_dq_ref(*args, causal)
        rdk, rdv = ck.flash_attention_bwd_dkv_ref(*args, causal)
        torch.cuda.synchronize()
        for name, got, ref in (("dq", dq, rdq), ("dkv", dk, rdk),
                               ("dkv", dv, rdv)):
            err = rel_err(got, ref)
            ok = (got.dtype == dt and bool(torch.isfinite(got).all())
                  and (err <= 1e-5 if dt == torch.float32
                       else _bf16_bwd_close(got, ref)))
            if not ok:
                raise AssertionError("K7%s at %s causal=%s %s: max |d| %g of "
                                     "the largest" % (
                                         "b" if name == "dq" else "c",
                                         (b_, tq, tk, d_), causal, dt, err))
            if dt == torch.float32:
                worst[name] = max(worst[name],
                                  (got - ref).abs().max().item())
        del args, dq, dk, dv, rdq, rdk, rdv
    # T 1: the one key takes p = 1, so dv is do, and dq and dk are 0 up to
    # the rounding of dp - delta (two fp32 dot products of do and v): held
    # within 1e-5 of the largest |dv|, not relative to their own near-0
    # largest value
    for causal in (True, False):
        args = flash_bwd_operands(ck, gen, 4, 1, 1, 64, causal,
                                  torch.float32, dev)
        dq = ck.flash_attention_bwd_dq(*args, causal)
        dk, dv = ck.flash_attention_bwd_dkv(*args, causal)
        torch.cuda.synchronize()
        top = dv.abs().max().item()
        if not (rel_err(dv, args[3]) <= 1e-5
                and max(dq.abs().max().item(), dk.abs().max().item())
                <= 1e-5 * top):
            raise AssertionError("K7b/K7c at T 1 causal=%s: dv vs do %g, "
                                 "|dq| %g, |dk| %g, largest |dv| %g" % (
                                     causal, rel_err(dv, args[3]),
                                     dq.abs().max(), dk.abs().max(), top))
    args = flash_bwd_operands(ck, gen, bh, t, t, d, True, torch.float32, dev)
    heads = GPT2_SMALL["num_heads"]
    q4, k4, v4 = (a.view(bh // heads, heads, t, d).clone().requires_grad_()
                  for a in args[:3])
    o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True)
    do4 = args[3].view(bh // heads, heads, t, d)

    def sdpa_backward():
        return torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

    recs, jobs = [], []
    for name, knum, line, n_out, n_prod in (
            ("flash_attention_bwd_dq", "K7b", 199, 1, 3),
            ("flash_attention_bwd_dkv", "K7c", 234, 2, 4)):
        ops, (cms, cby), (bms, by) = flash_bwd_bound(
            bh, t, t, d, True, n_out, n_prod, bw, flops, tf32)
        kernel = getattr(ck, name)
        plain = getattr(ck, name + "_ref")
        recs.append({
            "name": "%s (%s)" % (name, knum), "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:%d" % line,
            "shape": "(%d, %d, %d) fp32 causal, one attention of the "
                     "training step at T=%d" % (bh, t, d, t),
            "max_abs_err": worst["dq" if knum == "K7b" else "dkv"],
            "bound_ms": bms, "bound_by": by,
            "bound_note": "3xTF32 on the tensor cores (3 x %d fp32 "
                          "operations at the dense TF32 rate), what the "
                          "kernel runs" % ops,
            "bound_cuda_cores_ms": cms, "bound_cuda_cores_by": cby,
            "library_note": "the backward of scaled_dot_product_attention"
                            "(is_causal=True), fp32: one call for dq, dk "
                            "and dv, beside K7b + K7c",
        })
        jobs.append([{"count": 1, "shape": (bh, t, d), "bound_ms": bms,
                      "ops": ops,
                      "fns": {"": lambda f=kernel: f(*args, True),
                              "plain_": lambda f=plain: f(*args, True),
                              "library_": sdpa_backward}}])
    return recs, jobs


def check_k5b(ck, dev, bw, flops, bh=LM_BATCH * GPT2_SMALL["num_heads"],
              t=LM_T[1]):
    """K5b against its plain version at the training step's shape, with
    the causal probabilities K5a gives and with unmasked ones, and at
    every case of ``softmax_edge_cases`` (p and do one element off their
    alignment where x is): fp32 within 1e-5 of the largest |dx| (the row
    dot in another order), bf16 within one rounding; a masked probability
    (exactly 0) gives a dx of exactly 0.  Returns its record and its
    timing job, causal fp32."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    worst = 0.0

    def held(p, do, masked, what):
        dx = ck.softmax_bwd(p, do)
        ref = ck.softmax_bwd_ref(p, do)
        torch.cuda.synchronize()
        err = rel_err(dx, ref)
        f32 = p.dtype == torch.float32
        close = err <= 1e-5 if f32 else _bf16_bwd_close(dx, ref)
        zero = bool((dx[..., masked] == 0).all())
        if dx.dtype != p.dtype or not close or not zero:
            raise AssertionError("K5b at %s %s: max |d| %g of the largest, "
                                 "masked columns zero: %s"
                                 % (what, p.dtype, err, zero))
        return (dx - ref).abs().max().item() if f32 else 0.0

    causal = causal_bias(t, dev)
    for bias, dt in ((causal, torch.float32),
                     (torch.zeros_like(causal), torch.float32),
                     (causal, torch.bfloat16)):
        x = (torch.randn((bh, t, t), generator=gen, device=dev) * 3).to(dt)
        p = ck.bias_softmax(x, bias)
        del x
        do = torch.randn((bh, t, t), generator=gen, device=dev).to(dt)
        worst = max(worst, held(p, do, bias < 0, (bh, t, t)))
        del p, do
    for x32, bias, masked, off, what in softmax_edge_cases(gen, dev):
        do32 = torch.randn(x32.shape, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            p, do = ck.bias_softmax(x32.to(dt), bias), do32.to(dt)
            if off:
                p, do = offset_view(p, 1), offset_view(do, 1)
            worst = max(worst, held(p, do, masked, what))
    p = ck.bias_softmax(torch.randn((bh, t, t), generator=gen, device=dev)
                        * 3, causal)
    do = torch.randn((bh, t, t), generator=gen, device=dev)
    bms, by = bound_ms(3 * p.numel() * 4, 4 * p.numel(), bw, flops)
    return {
        "name": "softmax_bwd (K5b)", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/softmax.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:882",
        "shape": "(%d, %d, %d) fp32 causal probabilities, one attention of "
                 "the training step at T=%d" % (bh, t, t, t),
        "max_abs_err": worst, "bound_ms": bms, "bound_by": by,
        "library_note": "torch._softmax_backward_data",
    }, [{"count": 1, "shape": (bh, t, t), "bound_ms": bms, "fns": {
        "": lambda: ck.softmax_bwd(p, do),
        "plain_": lambda: ck.softmax_bwd_ref(p, do),
        "library_": lambda: torch._softmax_backward_data(do, p, -1,
                                                         p.dtype)}}]


# ---------------------------------------------------------------------------
# phase 10: the transformer path
# ---------------------------------------------------------------------------
def transformer_lm(mx, ctx, config=GPT2_SMALL, seed=SEED):
    """gluon TransformerLM with ``config``'s widths, Xavier weights from
    ``seed`` on ``ctx``, hybridized, as a user builds it."""
    from mxnet_tpu_torch.gluon.contrib.transformer import TransformerLM
    mx.random.seed(seed)
    lm = TransformerLM(**config)
    lm.initialize(mx.init.Xavier(), ctx=ctx)
    lm.hybridize()
    return lm


def lm_tokens(mx, ctx, vocab, batch, t, seed=SEED):
    """Random token ids from ``seed``, float32 as the reference feeds
    them."""
    ids = np.random.RandomState(seed + t).randint(0, vocab, (batch, t))
    return mx.nd.array(ids.astype(np.float32), ctx=ctx)


def plain_forward(ck, lm, ids, weights=None):
    """The forward of ``lm``'s parameters in plain torch: the embeddings,
    each block's plain LayerNorm, projections, ``causal_attention`` and
    ReLU FFN, then the head.  ``ids`` is a (B, T) tensor of token ids.
    With ``weights`` (``{parameter name: tensor}``, say float64 copies)
    the forward runs on those tensors and its LayerNorm in their dtype;
    without, on the parameters' values (outside any autograd graph) with
    ``layernorm_fwd_ref``."""
    from mxnet_tpu_torch.gluon.contrib.transformer import causal_attention

    def w(p):
        return p.data()._data.detach() if weights is None \
            else weights[p.name]

    def ln(x, blk):
        if weights is None:
            return ck.layernorm_fwd_ref(x, w(blk.gamma), w(blk.beta),
                                        blk._epsilon)[0]
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + blk._epsilon) * w(blk.gamma) \
            + w(blk.beta)

    b, t = ids.shape
    x = w(lm.embed.weight)[ids.long()] + w(lm.pos_embed.weight)[:t]
    for cell in lm.blocks:
        a = cell.attn
        h = ln(x, cell.ln1)
        q, k, v = ((h @ w(p.weight).T).reshape(b, t, -1, a._d)
                   for p in (a.q_proj, a.k_proj, a.v_proj))
        x = x + causal_attention(q, k, v).reshape(b, t, -1) \
            @ w(a.out_proj.weight).T
        h = ln(x, cell.ln2)
        f1, f2 = cell.ffn[0], cell.ffn[1]
        h = torch.relu(h @ w(f1.weight).T + w(f1.bias))
        x = x + (h @ w(f2.weight).T + w(f2.bias))
    return ln(x, lm.ln_f) @ w(lm.head.weight).T + w(lm.head.bias)


def logits_deviation(ck, lm, tokens, logits, tf32=False):
    """``max |logits - plain|`` over the plain forward's largest
    magnitude, and that magnitude; with ``tf32`` the plain forward runs
    its matmuls in TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        ref = plain_forward(ck, lm, tokens._data)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    mag = ref.abs().max().item()
    return (logits - ref).abs().max().item() / mag, mag


def lm_forward(ck, lm, tokens, reps=3):
    """The main path: one forward of ``lm`` on ``tokens`` with the launch
    counts set to 0 just before and read just after, then ``reps`` timed
    forwards (CUDA events on the card, the host clock on the CPU).
    Returns the logits tensor and the numbers."""
    device = tokens._data.device
    ck.reset_kernel_calls()
    logits = lm(tokens)._data
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    calls = ck.kernel_calls()
    times = []
    for _ in range(reps):
        a = _marker(device)
        lm(tokens)
        times.append(_elapsed_ms(a, _marker(device)))
    fwd_ms = float(np.median(times))
    b, t = tokens.shape
    return logits, {"calls": calls, "fwd_ms": fwd_ms,
                    "tokens_per_s": b * t / fwd_ms * 1e3,
                    "shape": tuple(logits.shape),
                    "finite": bool(torch.isfinite(logits).all())}


# kinds of kernel in a transformer forward's profile; the first match wins
LM_KINDS = (("K6a", ("layernorm_fwd",)),) + FLASH_KINDS + SOFTMAX_KINDS \
    + (
    ("GEMM", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
    ("embedding", ("indexSelect", "index_select", "embedding", "gather")),
    ("copy", ("Memcpy", "copy")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized")))


def profile_lm(lm, tokens, fwd_ms):
    """Device time by kind over one transformer forward beside its time
    without the profiler; a printable line."""
    by_name = device_times(lambda: lm(tokens), n=1)
    wall, busy = fwd_ms * 1e3, sum(by_name.values())
    if busy <= 0:
        return "transformer profile: not measured (no device time)"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return ("profile of one transformer forward at %s: %.0f us (CUDA "
            "events, no profiler), device busy %.0f us (idle share %.3f); "
            "by kind: %s; top kernels: %s"
            % (tuple(tokens.shape), wall, busy, max(0.0, 1 - busy / wall),
               ", ".join("%s %.0f us" % kv
                         for kv in by_kind(by_name, LM_KINDS).items()),
               "; ".join("%s %.0f us" % (k[:60], v) for k, v in top)))


# ---------------------------------------------------------------------------
# phase 12: the transformer training path
# ---------------------------------------------------------------------------
def lm_batch(mx, ctx, vocab, batch, t, seed=SEED):
    """One fixed batch from ``seed``: ``(tokens, labels)``, the labels the
    tokens shifted by one, both float32 (B, T) arrays on ``ctx``."""
    ids = np.random.RandomState(seed + t).randint(0, vocab, (batch, t + 1))
    ids = ids.astype(np.float32)
    return (mx.nd.array(ids[:, :-1], ctx=ctx),
            mx.nd.array(ids[:, 1:], ctx=ctx))


class plain_path:
    """Every kernel knob at 0 and attention forced to ``impl="einsum"``:
    the transformer step in plain torch, differentiated by its
    autograd."""

    def __enter__(self):
        from mxnet_tpu_torch.parallel import attention
        self.attention = attention
        self.real = attention.local_attention
        self.knobs = knobs("0", ("MXNET_PALLAS_NORM", "MXNET_PALLAS_SOFTMAX"))
        self.knobs.__enter__()
        attention.local_attention = lambda *a, **kw: self.real(
            *a, **dict(kw, impl="einsum"))
        return self

    def __exit__(self, *exc):
        self.attention.local_attention = self.real
        self.knobs.__exit__(*exc)


def lm_loss(mx, lm, loss_fn, x, y):
    """The canonical step's forward and backward: under ``record()`` the
    logits, the cross-entropy's mean over every token, then
    ``backward()``.  Returns the loss array."""
    vocab = lm._vocab_size
    with mx.autograd.record():
        loss = loss_fn(lm(x).reshape((-1, vocab)), y.reshape((-1,))).mean()
    loss.backward()
    return loss


class relu_decisions:
    """Record each ReLU's decisions (``input > 0``) in one forward, or
    replay recorded ones (``relu(x)`` as ``where(mask, x, 0)``, with the
    backward that follows) in another, through the registered
    ``Activation`` op.  A replay counts the inputs whose own sign
    disagrees with the recorded decision in ``flips``."""

    def __init__(self, masks=None):
        self.record = masks is None
        self.masks = [] if masks is None else masks
        self.flips = self.total = 0

    def __enter__(self):
        from mxnet_tpu_torch.ops.registry import get_op
        self.op = get_op("Activation")
        self.real, calls = self.op.fn, iter(range(len(self.masks)))

        def fn(data, act_type="relu", **attrs):
            if self.record:
                self.masks.append(data.detach() > 0)
                return self.real(data, act_type=act_type, **attrs)
            mask = self.masks[next(calls)]
            self.flips += int(((data.detach() > 0) != mask).sum())
            self.total += mask.numel()
            return torch.where(mask, data, 0.0)
        self.op.fn = fn
        return self

    def __exit__(self, *exc):
        self.op.fn = self.real


def f64_grads(ck, lm, x, y):
    """The step's loss and gradients in float64 plain torch, from float64
    copies of the parameters: the reference both fp32 paths are held
    against."""
    params = lm.collect_params()
    weights = {p.name: p.data()._data.detach().double().requires_grad_()
               for p in params.values()}
    logits = plain_forward(ck, lm, x._data, weights)
    lp = torch.log_softmax(logits.reshape(-1, logits.shape[-1]), dim=-1)
    loss = -lp.gather(1, y._data.long().reshape(-1, 1)).mean()
    grads = torch.autograd.grad(loss, list(weights.values()))
    return dict(zip(params.keys(), grads))


def lm_train(mx, ck, lm, x, y, warmup=LM_TRAIN_WARMUP, steps=LM_TRAIN_STEPS):
    """Train ``lm`` on the batch ``(x, y)``.  First the step's gradients
    four ways from the same weights: the kernel path (its ReLU decisions
    recorded), the plain torch path (``plain_path``) with those ReLU
    decisions, which must agree within ``GRAD_TOL`` of each parameter's
    largest gradient, the plain path with its own decisions, and float64
    plain torch; an fp32 ReLU input within rounding of 0 may take the
    other side in another summation order and move that weight's
    gradient by far more than ``GRAD_TOL``, in either fp32 path.  Then
    the main path, ``warmup`` steps (the first one with the launch counts
    set to 0 just before and read just after) and ``steps`` timed ones,
    each ``lm_loss`` then ``Trainer.step(1)`` (Adam).  Returns the
    trainer, the loss block and the numbers."""
    trainer = mx.gluon.Trainer(lm.collect_params(), "adam", dict(LM_ADAM))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = lm.collect_params()
    device = x._data.device

    def grads():
        return {n: p.grad()._data.clone() for n, p in params.items()}

    def dev(a, b):
        return max(rel_err(a[n], b[n]) for n in a)

    with relu_decisions() as rec:
        lm_loss(mx, lm, loss_fn, x, y)
    kernel = grads()
    with plain_path(), relu_decisions(rec.masks) as rep:
        lm_loss(mx, lm, loss_fn, x, y)
    grad_dev = dev(kernel, grads())
    del rec
    with plain_path():
        lm_loss(mx, lm, loss_fn, x, y)
    plain = grads()
    ref64 = f64_grads(ck, lm, x, y)
    zero = [n for n, g in kernel.items() if not bool(g.abs().max() > 0)]
    checks = {"grad_dev": grad_dev, "relu_flips": rep.flips,
              "relu_inputs": rep.total,
              "grad_dev_own_relu": dev(kernel, plain),
              "kernel_vs_f64": dev(kernel, ref64),
              "plain_vs_f64": dev(plain, ref64), "zero_grads": zero}
    del kernel, plain, ref64

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ck.reset_kernel_calls()
    losses = [lm_loss(mx, lm, loss_fn, x, y)]
    trainer.step(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    calls = ck.kernel_calls()
    for _ in range(warmup - 1):
        losses.append(lm_loss(mx, lm, loss_fn, x, y))
        trainer.step(1)
    marks = [_marker(device)]
    for _ in range(steps):
        losses.append(lm_loss(mx, lm, loss_fn, x, y))
        trainer.step(1)
        marks.append(_marker(device))
    step_ms = _elapsed_ms(marks[0], marks[-1]) / steps
    b, t = x.shape
    return trainer, loss_fn, dict(
        checks, calls=calls, n_params=len(params.keys()),
        losses=[float(v.asnumpy()) for v in losses], step_ms=step_ms,
        tokens_per_s=b * t / step_ms * 1e3)


# kinds of kernel in a transformer training step's profile; the first
# match wins
LM_TRAIN_KINDS = (
    ("K6a", ("layernorm_fwd",)), ("K6b", ("layernorm_bwd",))) \
    + FLASH_KINDS + SOFTMAX_KINDS + (
    ("loss", ("SoftMax", "softmax_warp", "log_softmax", "gather",
              "scatter")),
    ("GEMM", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
    ("embedding", ("indexSelect", "index_select", "embedding", "Radix",
                   "segment", "grad_weight")),
    ("copy", ("Memcpy", "copy")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized")))


def profile_lm_train(mx, lm, trainer, loss_fn, x, y, step_ms):
    """Device time of one training step by kind: the forward and backward
    by kernel name, the optimizer as everything ``Trainer.step``
    launches; beside the step's time without the profiler.  A printable
    line."""
    fb = device_times(lambda: lm_loss(mx, lm, loss_fn, x, y), n=1)
    opt = device_times(lambda: trainer.step(1), n=1)
    busy = sum(fb.values()) + sum(opt.values())
    if busy <= 0:
        return "transformer training profile: not measured (no device time)"
    kinds = by_kind(fb, LM_TRAIN_KINDS)
    kinds["optimizer (Trainer.step, per-array Adam)"] = sum(opt.values())
    top = sorted(fb.items(), key=lambda kv: -kv[1])[:6]
    return ("profile of one transformer training step at %s: %.0f us (CUDA "
            "events, no profiler), device busy %.0f us (idle share %.3f); "
            "by kind: %s; top kernels of forward and backward: %s"
            % (tuple(x.shape), step_ms * 1e3, busy,
               max(0.0, 1 - busy / (step_ms * 1e3)),
               ", ".join("%s %.0f us" % kv for kv in kinds.items()),
               "; ".join("%s %.0f us" % (k[:60], v) for k, v in top)))


def step_profile(mod, batch_input, step_ms):
    """One training step under the profiler: ``{"busy_us", "idle_share",
    "by_kind", "top"}`` beside the step's time ``step_ms`` measured
    without it (None when the trace holds no device time)."""
    def step():
        mod.forward_backward(batch_input)
        mod.update()

    by_name = device_times(step, n=1)
    busy = sum(by_name.values())
    if busy <= 0:
        return None
    return {"busy_us": busy,
            "idle_share": max(0.0, 1 - busy / (step_ms * 1e3)),
            "by_kind": by_kind(by_name),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def profile_step(mod, batch_input, step_ms, prof=None):
    """Device time of one training step (forward, backward, sweep) by
    kind of kernel and its top kernels, beside the step's time without
    the profiler; a printable line (of ``prof``, a ``step_profile`` taken
    before, where given)."""
    if prof is None and mod is not None:
        prof = step_profile(mod, batch_input, step_ms)
    if prof is None:
        return "training step profile: not measured (no device time)"
    return ("profile of one training step: step %.0f us (CUDA events, no "
            "profiler), device busy %.0f us (idle share %.3f); by kind: %s; "
            "top kernels: %s"
            % (step_ms * 1e3, prof["busy_us"], prof["idle_share"],
               ", ".join("%s %.0f us" % kv for kv in prof["by_kind"].items()),
               "; ".join("%s %.0f us" % (k[:60], v) for k, v in prof["top"])))

# ---------------------------------------------------------------------------
# phase 13: checkpoints
# ---------------------------------------------------------------------------
def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mb(*paths):
    return sum(os.path.getsize(p) for p in paths) / 1e6


def _timed(device, fn):
    """``(result, ms)`` of ``fn()`` by the host clock between two
    synchronisations: what a save or a load costs the caller."""
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t) * 1e3


def ckpt_fit(mx, ctx, sym, image, batch, steps, prefix, seed=SEED,
             classes=CLASSES):
    """Phase 13 (a): ``Module.fit`` of ``sym`` with ``kvstore="tpu"``, SGD
    with momentum, 2 epochs of ``steps`` fixed synthetic batches, Xavier
    weights from ``seed``, checkpointed every epoch by
    ``module_checkpoint(save_optimizer_states=True)`` (each save timed).
    Then the epoch-2 files are read back: the parameters by ``nd.load``
    onto ``ctx``, the states by ``load_optimizer_states`` into the module,
    which must leave its momentum bitwise as it was.  Returns the module,
    its state after the 2 epochs (``module_state``) and the numbers."""
    device = ctx.torch_device
    it = synthetic_iter(mx, ctx, batch, image, steps, seed, classes)
    mod = mx.mod.Module(sym, context=ctx)
    save = mx.callback.module_checkpoint(mod, prefix,
                                         save_optimizer_states=True)
    save_ms = []

    def timed_save(epoch, *args):
        save_ms.append(_timed(device, lambda: save(epoch, *args))[1])

    mx.random.seed(seed)
    mod.fit(it, num_epoch=2, kvstore="tpu", optimizer="sgd",
            optimizer_params=SGD_PARAMS,
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            eval_metric="acc", epoch_end_callback=timed_save)
    files = {k: "%s-%s" % (prefix, k) for k in (
        "symbol.json", "0001.params", "0001.states", "0002.params",
        "0002.states")}
    missing = [f for f in files.values() if not os.path.exists(f)]
    if missing or len(save_ms) != 2:
        raise AssertionError("checkpoint files missing: %s" % missing)
    state = module_state(mod)
    params, states = files["0002.params"], files["0002.states"]
    loaded, load_ms = _timed(device, lambda: mx.nd.load(params, ctx=ctx))
    if set(loaded) != {"arg:" + n for n in state[0]} | {
            "aux:" + n for n in state[2]}:
        raise AssertionError("%s holds %d arrays, not the module's"
                             % (params, len(loaded)))
    del loaded
    _, load_states_ms = _timed(device,
                               lambda: mod.load_optimizer_states(states))
    rt = compare_states(state[1:2], module_state(mod)[1:2])
    if not rt["bitwise"]:
        raise AssertionError("momentum after save and load differs by %g"
                             % rt["max_rel"])
    pm, sm = _mb(params), _mb(states)
    return mod, state, {
        "params_mb": pm, "states_mb": sm, "save_ms": save_ms,
        "save_mb_per_s": (pm + sm) / (save_ms[-1] / 1e3),
        "load_params_ms": load_ms, "load_params_mb_per_s": pm / (
            load_ms / 1e3),
        "load_states_ms": load_states_ms,
        "load_states_mb_per_s": sm / (load_states_ms / 1e3),
        "fused": mod._fused_exec_update,
        "kernel": mod._exec_group.execs[0]._sweep["kernel"]
        if mod._exec_group.execs[0]._sweep is not None else None}


def ckpt_serve(mx, ck, ctx, mod, prefix, epoch, image, batch, seed=SEED):
    """Phase 13 (b): ``ModelServer.load_model`` of the epoch's files on
    ``ctx`` and one request of ``batch`` rows (the largest bucket), with
    the launch counts set to 0 just before and read just after, held
    against the in-memory module's inference forward on the same rows.
    Returns the numbers."""
    from mxnet_tpu_torch.serving import ModelServer
    device = ctx.torch_device
    x = np.random.RandomState(seed + 3).uniform(
        -1, 1, (batch,) + tuple(image)).astype(np.float32)
    srv = ModelServer(max_batch=batch, ctx=ctx)
    _, load_ms = _timed(device, lambda: srv.load_model(
        "r50", "%s-symbol.json" % prefix, "%s-%04d.params" % (prefix, epoch),
        {"data": (1,) + tuple(image)}))
    srv.start()
    try:
        ck.reset_kernel_calls()
        got = srv.infer("r50", {"data": x}, timeout_ms=120000.0)[0]
        _sync(device)
        calls = ck.kernel_calls()
    finally:
        srv.stop()
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=ctx)]),
                is_train=False)
    ref = mod.get_outputs()[0].asnumpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError("served %s (finite: %s), module %s" % (
            got.shape, np.isfinite(got).all(), ref.shape))
    return {"calls": calls, "load_ms": load_ms, "shape": got.shape,
            "bitwise": bool(np.array_equal(got.view(np.int32),
                                           ref.view(np.int32))),
            "max_rel": float(np.abs(got - ref).max() / np.abs(ref).max())}


def ckpt_resume(mx, ck, ctx, prefix, image, batch, steps, states=True,
                seed=SEED, classes=CLASSES):
    """Phase 13 (c): ``Module.load(prefix, 1, load_optimizer_states=
    states, context=ctx)``, then ``fit(begin_epoch=1, num_epoch=2)`` on
    the same batches, with the launch counts set to 0 just before and
    read just after.  Returns the module's ``module_state`` and the
    counts."""
    it = synthetic_iter(mx, ctx, batch, image, steps, seed, classes)
    mod = mx.mod.Module.load(prefix, 1, load_optimizer_states=states,
                             context=ctx)
    ck.reset_kernel_calls()
    mod.fit(it, begin_epoch=1, num_epoch=2, kvstore="tpu", optimizer="sgd",
            optimizer_params=SGD_PARAMS, eval_metric="acc")
    _sync(ctx.torch_device)
    return module_state(mod), ck.kernel_calls()


def _lm_params(lm):
    """``({name: weight},)`` of a gluon block, its root prefix stripped."""
    return ({n[len(lm.prefix):]: p.data()._data
             for n, p in lm.collect_params().items()},)


def _trainer_slots(trainer):
    """A gluon Trainer's optimizer slots as one ``{index: tensor}`` a
    slot: ``(momentum,)`` of SGD, ``(m, v)`` of Adam."""
    from mxnet_tpu_torch.optimizer import state_slots
    slots = {i: state_slots(st) for i, st in trainer._updater.states.items()}
    return tuple({i: s[j] for i, s in slots.items()}
                 for j in range(len(next(iter(slots.values())))))


def ckpt_lm(mx, ck, lm, adam, x, y, config, workdir):
    """Phase 13 (d): after ``lm``'s training with the Adam trainer
    ``adam``, one step of an SGD-momentum trainer (so a momentum exists),
    then ``save_parameters`` and both trainers' ``save_states``; a fresh
    ``TransformerLM`` with ``load_parameters(ctx=...)``, fresh trainers
    with ``load_states``.  Held: the logits bitwise, Adam's m and v as
    loaded, one SGD step of each model (the resumed one's with the launch
    counts set to 0 just before and read just after), then one Adam step
    of each (its update count restarts in the resumed trainer, as in the
    JAX package, so only m and v must agree).  Returns the numbers."""
    from mxnet_tpu_torch.gluon.contrib.transformer import TransformerLM
    device = x._data.device
    ctx = mx.gpu(device.index or 0) if device.type == "cuda" else mx.cpu()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    sgd = mx.gluon.Trainer(lm.collect_params(), "sgd", dict(LM_SGD))
    lm_loss(mx, lm, loss_fn, x, y)
    sgd.step(1)
    f, g_sgd, g_adam = (os.path.join(workdir, n) for n in (
        "lm.params", "lm-sgd.states", "lm-adam.states"))
    _, save_params_ms = _timed(device, lambda: lm.save_parameters(f))
    _, save_states_ms = _timed(device, lambda: (
        sgd.save_states(g_sgd), adam.save_states(g_adam)))
    lm2 = TransformerLM(**config)
    _, load_params_ms = _timed(device,
                               lambda: lm2.load_parameters(f, ctx=ctx))
    lm2.hybridize()
    sgd2 = mx.gluon.Trainer(lm2.collect_params(), "sgd", dict(LM_SGD))
    adam2 = mx.gluon.Trainer(lm2.collect_params(), "adam", dict(LM_ADAM))
    _, load_states_ms = _timed(device, lambda: (
        sgd2.load_states(g_sgd), adam2.load_states(g_adam)))
    adam_loaded = compare_states(_trainer_slots(adam2), _trainer_slots(adam))
    logits_bitwise = torch.equal(lm(x)._data, lm2(x)._data)
    ck.reset_kernel_calls()
    loss2 = lm_loss(mx, lm2, loss_fn, x, y)
    sgd2.step(1)
    _sync(device)
    calls = ck.kernel_calls()
    loss1 = lm_loss(mx, lm, loss_fn, x, y)
    sgd.step(1)
    step = compare_states(_lm_params(lm2), _lm_params(lm))
    for model, trainer in ((lm, adam), (lm2, adam2)):
        lm_loss(mx, model, loss_fn, x, y)
        trainer.step(1)
    adam_step = compare_states(_trainer_slots(adam2), _trainer_slots(adam))
    pm = _mb(f)
    return {
        "params_mb": pm, "sgd_states_mb": _mb(g_sgd),
        "adam_states_mb": _mb(g_adam), "save_params_ms": save_params_ms,
        "save_params_mb_per_s": pm / (save_params_ms / 1e3),
        "save_states_ms": save_states_ms, "load_params_ms": load_params_ms,
        "load_params_mb_per_s": pm / (load_params_ms / 1e3),
        "load_states_ms": load_states_ms,
        "adam_loaded_bitwise": adam_loaded["bitwise"],
        "logits_bitwise": logits_bitwise, "calls": calls,
        "losses": (float(loss1.asnumpy()), float(loss2.asnumpy())),
        "sgd_step_bitwise": step["bitwise"],
        "sgd_step_max_rel": step["max_rel"],
        "adam_mv_bitwise": adam_step["bitwise"],
        "adam_mv_max_rel": adam_step["max_rel"]}


# ---------------------------------------------------------------------------
# phase 14: the operator library and Inception-BN
# ---------------------------------------------------------------------------
INCEPTION_WARMUP = 3        # untimed Inception-BN steps
INCEPTION_STEPS = 10        # timed Inception-BN steps
RANDOM_DRAWS = 10 ** 6      # draws a sampler's moments are taken over
MOMENT_SE = 5.0             # moments within this many standard errors


def op_sweep(mx, ctx, ref_ctx):
    """Every ``OP_CASES`` entry on ``ctx`` against the same call on
    ``ref_ctx`` (both through this package): forward, inputs after the
    call and, for the differentiable cases, the backward; on a card
    under ``no_host_sync``, every output, input and gradient on ``ctx``
    (``run_case``).  A case that raises counts as a failed check.
    Returns ``{"cases", "checks", "bitwise", "within", "failed", "worst",
    "worst_by_limit", "seconds"}``: ``worst`` holds the five checks
    farthest from equal relative to their band, ``worst_by_limit`` the
    largest error under each limit."""
    t0 = time.perf_counter()
    checks = []
    for case in OP_CASES:
        try:
            res = case_checks(case, mx, ctx, mx, ref_ctx)
        except Exception as exc:    # counted as failed; main() raises
            res = [("raised %r" % exc, float("inf"), 0.0)]
        for what, err, lim in res:
            checks.append({"op": case["name"], "attrs": str(case["attrs"]),
                           "check": what, "err": err, "limit": lim})
    failed = [c for c in checks if not c["err"] <= c["limit"]]
    worst = sorted((c for c in checks if c["err"] > 0),
                   key=lambda c: -c["err"] / max(c["limit"], 1e-30))[:5]
    by_limit = {}
    for c in checks:
        k = "%g" % c["limit"]
        by_limit[k] = max(by_limit.get(k, 0.0), c["err"])
    return {"cases": len(OP_CASES), "checks": len(checks),
            "bitwise": sum(c["err"] == 0 for c in checks),
            "within": len(checks) - len(failed), "failed": failed,
            "worst": worst, "worst_by_limit": by_limit,
            "seconds": time.perf_counter() - t0}


def _moments_ok(x, mean, var, k=MOMENT_SE):
    """Sample mean and variance of the 1-D float64 array ``x`` against
    the distribution's, each within ``k`` standard errors (the
    variance's from the sample's fourth central moment)."""
    n = x.size
    m = x.mean()
    d = x - m
    s2 = (d * d).mean()
    m4 = (d ** 4).mean()
    se_m = np.sqrt(var / n)
    se_v = np.sqrt(max(m4 - s2 * s2, 1e-30) / n)
    return (abs(m - mean) <= k * se_m and abs(s2 - var) <= k * se_v,
            {"mean": m, "want_mean": mean, "var": s2, "want_var": var})


def _draw(mx, on, name, *args, **attrs):
    """One call of sampler ``name`` (on the context ``on``); on a card,
    under torch's sync debug mode "error", so a draw made on the host and
    copied over would raise."""
    with no_host_sync(on):
        return getattr(mx.nd, name)(*args, **attrs)


def random_sweep(mx, ctx, n=RANDOM_DRAWS, seed=SEED):
    """Every sampler on ``ctx``: ``n`` draws of each ``_random_*`` op and
    of each ``_sample_*`` op (rows of parameters) hold their moments,
    the same seed gives the same draws twice, each output lies on
    ``ctx`` with the JAX package's dtype and shape; then every alias of
    a sampler, the ``_like`` forms, ``_sample_multinomial`` (frequencies,
    ``get_prob``) and ``_shuffle``.  Returns ``{"checks", "failed"}``."""
    from mxnet_tpu_torch.ops.registry import _OP_REGISTRY
    t0 = time.perf_counter()
    failed, checks = [], 0

    def check(ok, what):
        nonlocal checks
        checks += 1
        if not ok:
            failed.append(what)

    def host(a):
        check(a.context == ctx, "device of %s" % (a,))
        return a.asnumpy().astype(np.float64).reshape(-1)

    for kind, (psets, integer) in RANDOM_CASES.items():
        name = "_random_" + kind
        want_dt = "int32" if kind == "randint" else "float32"
        draws = []
        for _ in range(2):
            mx.random.seed(seed)
            draws.append(_draw(mx, ctx, name, shape=(n,), ctx=ctx,
                               **psets[0]))
        a = draws[0]
        check(a.shape == (n,) and a.dtype == want_dt,
              "%s shape %s dtype %s" % (name, a.shape, a.dtype))
        xa = host(a)
        check(np.array_equal(xa, host(draws[1])), "%s reseeded" % name)
        if integer:
            check(np.array_equal(xa, np.round(xa)), "%s integer" % name)
        ok, got = _moments_ok(xa, *random_moments(kind, psets[0]))
        check(ok, "%s moments %s" % (name, got))
        if kind not in SAMPLE_INPUTS:
            continue
        name = "_sample_" + kind
        params = [mx.nd.array(np.array([p[k] for p in psets], np.float32),
                              ctx=ctx) for k in SAMPLE_INPUTS[kind]]
        per = n // len(psets)
        b = _draw(mx, ctx, name, *params, shape=(per,))
        check(b.shape == (len(psets), per) and b.dtype == "float32",
              "%s shape %s" % (name, b.shape))
        xb = host(b).reshape(len(psets), per)
        for row, p in zip(xb, psets):
            ok, got = _moments_ok(row, *random_moments(kind, p))
            check(ok, "%s moments %s" % (name, got))
    # every other sampler name runs on the card, small
    small = {"_random_": {"shape": (4, 3), "ctx": ctx}}
    for nm, op in _OP_REGISTRY.items():
        if not op.needs_rng or op.name in ("Dropout", "LeakyReLU"):
            continue
        if op.sig.required:
            continue
        a = _draw(mx, ctx, nm, **small["_random_"])
        check(a.shape == (4, 3) and a.context == ctx, "%s small" % nm)
    x = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3), ctx=ctx)
    for nm in ("_random_uniform_like", "random_uniform_like",
               "_random_normal_like", "random_normal_like"):
        a = _draw(mx, ctx, nm, x)
        check(a.shape == x.shape and a.context == ctx, nm)
    like = _draw(mx, ctx, "_random_normal_like",
                 mx.nd.zeros((n,), ctx=ctx), loc=1.0, scale=2.0)
    ok, got = _moments_ok(host(like), 1.0, 4.0)
    check(ok, "_random_normal_like moments %s" % got)
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    for nm in ("_sample_multinomial", "sample_multinomial"):
        s, lp = _draw(mx, ctx, nm, mx.nd.array(probs, ctx=ctx),
                      shape=(n // 2,), get_prob=True)
        check(s.shape == (2, n // 2) and s.dtype == "int32"
              and lp.dtype == "float32", "%s shapes" % nm)
        hs = s.asnumpy()
        for r in range(2):
            freq = np.bincount(hs[r], minlength=3) / hs.shape[1]
            se = np.sqrt(probs[r] * (1 - probs[r]) / hs.shape[1])
            check(np.all(np.abs(freq - probs[r]) <= MOMENT_SE * se),
                  "%s frequencies %s" % (nm, freq))
        check(np.allclose(lp.asnumpy(), np.log(probs)[
            np.arange(2)[:, None], hs], atol=1e-6), "%s get_prob" % nm)
    for nm in ("_shuffle", "shuffle"):
        y = _draw(mx, ctx, nm, x)
        check(y.context == ctx and np.array_equal(
            np.sort(y.asnumpy()[:, 0]), x.asnumpy()[:, 0]) and
            np.array_equal(y.asnumpy() % 3, x.asnumpy() % 3),
            "%s permutes rows" % nm)
    return {"checks": checks, "failed": failed,
            "seconds": time.perf_counter() - t0}


def fused_bn_relu_once(mx, ck, ctx, shape=(BATCH, 64, 56, 56), seed=SEED):
    """One ``mx.nd.contrib.fused_bn_relu`` call at a ResNet/Inception site
    shape: its K3 launches (counted from 0 just before), and whether its
    output is bitwise equal to ``scale_bias_relu_ref`` on the same
    scale and bias."""
    rng = np.random.RandomState(seed)
    c = shape[1]
    data = rng.randn(*shape).astype(np.float32)
    g, b = rng.uniform(0.5, 1.5, c), rng.randn(c)
    mean, var = rng.randn(c) * 0.1, rng.uniform(0.5, 2.0, c)
    arrs = [mx.nd.array(a.astype(np.float32), ctx=ctx)
            for a in (data, g, b, mean, var)]
    ck.reset_kernel_calls()
    out = mx.nd.contrib.fused_bn_relu(*arrs, eps=1e-5)
    launches = ck.kernel_calls()["scale_bias_relu"]
    gt, bt, mt, vt = (a._data for a in arrs[1:])
    scale = (gt * torch.rsqrt(vt + 1e-5)).float()
    bias = (bt - mt * scale).float()
    ref = ck.scale_bias_relu_ref(arrs[0]._data, scale, bias, relu=True)
    return {"launches": launches,
            "bitwise": bool(torch.equal(out._data, ref))}


def inception_symbol(classes=CLASSES):
    from mxnet_tpu_torch.symbols import inception_bn
    return inception_bn.get_symbol(classes)


def inception_requests(image, batch, seed, n_requests=8):
    """A full batch and ``n_requests`` requests of 1-3 rows, from
    ``seed``."""
    rng = np.random.RandomState(seed)
    full = rng.uniform(-1, 1, (batch,) + tuple(image)).astype(np.float32)
    return [full] + [rng.uniform(-1, 1, (rng.randint(1, min(batch, 3) + 1),)
                                 + tuple(image)).astype(np.float32)
                     for _ in range(n_requests)]


def served_answers(mx, ctx, sym, arg, aux, image, batch, xs):
    """``xs`` answered one at a time by a ``ModelServer`` (buckets
    1..``batch``) serving ``sym`` with ``arg``/``aux``: ``(answers,
    forwards)``."""
    from mxnet_tpu_torch.serving import ModelServer
    srv = ModelServer(max_batch=batch, ctx=ctx)
    srv.add_model("inception", sym, arg, aux, {"data": (1,) + tuple(image)})
    srv.start()
    try:
        answers = [srv.infer("inception", {"data": x},
                             timeout_ms=120000.0)[0] for x in xs]
    finally:
        srv.stop()
    return answers, srv.stats()["batches"]["count"]


def bucket_forwards(mx, ctx, sym, arg, aux, image, batch, xs, bucket=None):
    """Each of ``xs`` run as the server runs it: padded to its bucket of
    the ladder 1..``batch`` (or to ``bucket``) by repeating its last row
    (``io.pad_batch``) and forwarded by a ``Predictor`` bound at that
    shape on ``arg``/``aux``.  Returns ``(outputs, buckets,
    predictors)``."""
    from mxnet_tpu_torch.io import pad_batch
    from mxnet_tpu_torch.serving.bucketing import pick_bucket, shape_buckets
    ladder = shape_buckets(batch)
    preds, outs, buckets = {}, [], []
    for x in xs:
        b = bucket or pick_bucket(x.shape[0], ladder)
        if b not in preds:
            preds[b] = mx.Predictor.from_parts(
                sym, arg, aux, {"data": (b,) + tuple(image)}, ctx=ctx)
        padded, rows = pad_batch([x], b)
        preds[b].forward(data=mx.nd.array(padded, ctx=ctx))
        outs.append(preds[b].get_output(0).asnumpy()[:rows])
        buckets.append(b)
    return outs, buckets, preds


def module_forwards(mx, ctx, mod, image, batch, xs):
    """Each of ``xs`` zero-padded to ``batch`` rows through the module's
    eval forward: its rows of the output."""
    outs = []
    for x in xs:
        padded = np.zeros((batch,) + tuple(image), np.float32)
        padded[:x.shape[0]] = x
        mod.forward(mx.io.DataBatch(data=[mx.nd.array(padded, ctx=ctx)],
                                    label=None), is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy()[:x.shape[0]])
    return outs


def largest_rel(got, ref):
    """max |got - ref| over ref's largest magnitude, in float64, where
    both are NaN at the same places (inf where they are not)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    nan = np.isnan(ref)
    if not np.array_equal(np.isnan(got), nan):
        return float("inf")
    if nan.all():
        return 0.0
    keep = ~nan
    return float(np.abs(got[keep] - ref[keep]).max()
                 / max(np.abs(ref[keep]).max(), 1e-30))


def inception_serve(mx, ck, ctx, mod, sym, image, batch, n_sites,
                    n_requests=8, seed=SEED):
    """The trained module's parameters served through ``ModelServer``
    (buckets 1..``batch``): a full bucket and ``n_requests`` requests of
    1-3 rows.  Each answer is held to a ``Predictor`` bound at the
    answer's own bucket on the same parameters and fed as the server
    feeds it (``bucket_forwards``), and, across shapes, to the module's
    forward of a ``batch``-row batch holding the same rows.  Launches
    counted from 0 at the server's start: ``n_sites`` K3 and one K2 a
    forward.  Returns what it measured."""
    arg, aux = mod.get_params()
    xs = inception_requests(image, batch, seed + 3, n_requests)
    ck.reset_kernel_calls()
    answers, forwards = served_answers(mx, ctx, sym, arg, aux, image, batch,
                                       xs)
    calls = ck.kernel_calls()
    same, buckets, _ = bucket_forwards(mx, ctx, sym, arg, aux, image, batch,
                                       xs)
    cross = module_forwards(mx, ctx, mod, image, batch, xs)
    worst, bitwise = 0.0, True
    cross_worst, cross_bitwise = 0.0, True
    for got, ref, ref32 in zip(answers, same, cross):
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError("inception answer of shape %s, expected "
                                 "%s" % (got.shape, ref.shape))
        bitwise &= bool(np.array_equal(got, ref))
        worst = max(worst, largest_rel(got, ref))
        cross_bitwise &= bool(np.array_equal(got, ref32))
        cross_worst = max(cross_worst, largest_rel(got, ref32))
    full = xs[0]
    # one bucket-`batch` forward timed by CUDA events, launches counted
    pred = mx.Predictor.from_parts(sym, arg, aux, {"data": full.shape},
                                   ctx=ctx)
    xb = mx.nd.array(full, ctx=ctx)

    def fwd():
        pred.forward(data=xb)
        return pred.get_output(0)

    fwd()
    device = torch.device("cuda", ctx.device_id) \
        if ctx.device_type == "gpu" else torch.device("cpu")
    ck.reset_kernel_calls()
    a = _marker(device)
    fwd()
    b = _marker(device)
    fwd_calls = ck.kernel_calls()
    times = [_elapsed_ms(a, b)]
    for _ in range(4):
        a = _marker(device)
        fwd()
        times.append(_elapsed_ms(a, _marker(device)))
    return {"forwards": forwards, "calls": calls, "fwd_calls": fwd_calls,
            "n_sites": n_sites, "answers": len(answers),
            "buckets": sorted(set(buckets)), "bitwise": bitwise,
            "max_rel": worst, "cross_shape_bitwise": cross_bitwise,
            "cross_shape_max_rel": cross_worst,
            "fwd_ms": float(np.median(times))}


def inception_phase(mx, ck, ctx, image=IMAGE, batch=BATCH, classes=CLASSES,
                    warmup=INCEPTION_WARMUP, steps=INCEPTION_STEPS):
    """Phase 14 (b): Inception-BN ``get_symbol(classes)`` trained by
    ``Module.fit`` (``kvstore="tpu"``, SGD momentum, Xavier from the
    seed) on one fixed batch, ``warmup`` untimed and ``steps`` timed
    steps, then served.  Launches are held to K1b once a bucket a step
    and K2 once a step in training, and to one K3 at every
    BatchNorm->ReLU site and one K2 a served forward; the loss must
    fall.  Returns ``(module, numbers)``; the numbers hold the sweep's
    bucket sizes and each site's ``(name, shape)``, for the kernels to be
    held to their plain versions at this path's shapes."""
    sym = inception_symbol(classes)
    sites = k3_sites(mx, sym, batch, image)
    on_card = ctx.device_type == "gpu"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    mod, tr = train(mx, ck, ctx, sym, image, batch, steps, warmup,
                    classes=classes)
    nb, total = len(tr["buckets"]), tr["steps"]
    want = dict.fromkeys(tr["calls"], 0)
    want.update(sgd_mom_sweep=nb * total, softmax_lastaxis=total)
    if on_card and (not tr["fused"] or tr["kernel"] != "sgd_mom_sweep"
                    or tr["calls"] != want):
        raise AssertionError("inception training: fused %s (%s), launches "
                             "%s; expected %s" % (tr["fused"], tr["kernel"],
                                                  tr["calls"], want))
    if not tr["ce_last"] < tr["ce_first"]:
        raise AssertionError("inception training: the cross-entropy went "
                             "from %.4f to %.4f" % (tr["ce_first"],
                                                    tr["ce_last"]))
    # what the fit added at its peak to what the process held before it
    mem = (torch.cuda.max_memory_allocated() - base) / 1e9 if on_card \
        else None
    sv = inception_serve(mx, ck, ctx, mod, sym, image, batch, len(sites))
    per_fwd = dict.fromkeys(sv["calls"], 0)
    per_fwd.update(scale_bias_relu=len(sites), softmax_lastaxis=1)
    want = {k: v * sv["forwards"] for k, v in per_fwd.items()}
    if on_card and (sv["calls"] != want or sv["fwd_calls"] != per_fwd):
        raise AssertionError("inception serving: launches %s over %d "
                             "forwards (expected %s), one timed forward %s"
                             % (sv["calls"], sv["forwards"], want,
                                sv["fwd_calls"]))
    if not (sv["bitwise"] or sv["max_rel"] <= CKPT_TOL):
        raise AssertionError("inception serving: answers %.3g of the "
                             "largest from a Predictor at their own bucket "
                             "(limit %g)" % (sv["max_rel"], CKPT_TOL))
    if not (sv["cross_shape_bitwise"]
            or sv["cross_shape_max_rel"] <= CROSS_SHAPE_TOL):
        raise AssertionError("inception serving: answers %.3g of the "
                             "largest from the module's %d-row forward "
                             "(limit %g)" % (sv["cross_shape_max_rel"],
                                             batch, CROSS_SHAPE_TOL))
    n_params = sum(int(np.prod(v.shape))
                   for v in mod.get_params()[0].values())
    return mod, {
        "sites": len(sites), "params": n_params, "batch": batch,
        "image": list(image), "classes": classes, "warmup": warmup,
        "steps": steps, "step_ms": tr["step_ms"],
        "images_per_s": tr["images_per_s"], "buckets": len(tr["buckets"]),
        "bucket_sizes": list(tr["buckets"]), "site_shapes": sites,
        "launches_step": {k: v / total for k, v in tr["calls"].items() if v},
        "ce_first": tr["ce_first"], "ce_last": tr["ce_last"],
        "peak_mem_gb": mem, "serve": sv,
        "launches_forward": {k: v for k, v in sv["fwd_calls"].items() if v},
    }


# ---------------------------------------------------------------------------
# phase 15: bf16 mixed precision
# ---------------------------------------------------------------------------
# The first bf16 step's fp32 masters against the same step with every
# kernel knob at 0, cuDNN deterministic: the two differ only where K2's
# fp32 probabilities (within 1e-6 of torch.softmax's) round the bf16 loss
# gradient to the other side of a bf16 step, one element of 32,000 in
# expectation, which moves a gradient by far less than one bf16 rounding
# of the largest; held within one rounding (2^-8) of each tensor's largest
# update.
MIXED_STEP_TOL = 2.0 ** -8
# The bf16 eval forward's logits against the knobs-0 bf16 forward, over
# the largest logit.  K3 computes relu(x * scale + bias) in fp32 where the
# plain chain computes ((x - mean) * (rsqrt(var + eps) * g) + beta), so
# the two round a BatchNorm output to neighbouring bf16 values where it
# sits on a rounding boundary, and the 50 layers after carry each such
# step on and round again.  With mean and beta 0 the two are one
# expression and the paths are bitwise equal; with other stats the JAX
# package's own peephole lies 0.0086 of the largest logit from its plain
# bf16 path at ResNet-50's depth, the port's 0.0076
# (tests/test_torch_mixed_precision.py, on the CPU).  One bf16 rounding
# (2^-8) is below what either package's peephole gives; the limit is
# 2^-6, which a wrong scale, bias or ReLU (a change of order 1 at a site)
# breaks.  As a second witness the kernel path lies no further from the
# fp32 forward of the same parameters than twice the knobs-0 path does
# (1.2x in the JAX package, 1.3x in the port, in that test): not "no
# further", since in that test both packages' peephole paths land a
# little further from fp32 than their plain chains.
BF16_EVAL_TOL = 2.0 ** -6
# The bf16-cast transformer against its knobs-0 bf16 forward and step
# (plain LayerNorm, einsum attention): the einsum route rounds the
# attention logits and p to bf16, the flash kernel keeps the logits fp32
# and rounds p, and 12 layers carry each difference on, a few bf16 steps
# of the largest logit: within 2^-5 of it, or twice the knobs-0 bf16
# forward's own distance from the fp32 forward of the same parameters
# where that is larger; the gradients, each the bf16 sum of nearly
# cancelling terms (softmax and LayerNorm backwards), within 2^-4 of each
# parameter's largest or twice the plain bf16 step's own distance from
# the float64 step of the same parameters, where that is larger (two
# bf16 roundings of one computation lie at most that far apart).
LM_BF16_LOGIT_TOL = 2.0 ** -5
LM_BF16_GRAD_TOL = 2.0 ** -4
# fp16 multi-precision on the card against the CPU: fp16 keeps 11 bits
# (2^-11 a rounding), the card and the CPU sum in other orders, and each
# master moves by the fp32 sum of five such gradients under momentum;
# the masters within 2^-7 of each one's largest movement, the fp16
# weights rounded from them within that and one fp16 rounding.
FP16_TOL = 2.0 ** -7
FP16_STEPS = 5
# kernels whose launches phase 15 counts, and the dtype of their operands
MIXED_KERNELS = ("scale_bias_relu", "softmax_lastaxis", "sgd_mom_sweep",
                 "layernorm_fwd", "layernorm_bwd", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "bias_softmax", "softmax_bwd")


class dtype_spy:
    """Record the dtype of the first tensor of every call of the named
    ``cuda_kernels`` wrappers (callers look them up on the module at each
    call) that is not on the ``meta`` device: ``{name: {dtype: calls}}``."""

    def __init__(self, ck, names=MIXED_KERNELS):
        self.ck, self.names, self.seen, self.real = ck, names, {}, {}

    def __enter__(self):
        for name in self.names:
            real = self.real[name] = getattr(self.ck, name)

            def spy(*args, _real=real, _name=name, **kw):
                t = next(a for a in args if isinstance(a, torch.Tensor))
                if t.device.type != "meta":
                    d = self.seen.setdefault(_name, {})
                    key = str(t.dtype)[6:]
                    d[key] = d.get(key, 0) + 1
                return _real(*args, **kw)
            setattr(self.ck, name, spy)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.ck, name, real)


class op_dtype_spy(torch.overrides.TorchFunctionMode):
    """Record the dtypes of the data and weight of every ``F.conv2d`` and
    ``F.linear`` called in the block on a real device (not ``meta``, where
    shapes are inferred): ``{name: {"data/weight": calls}}``, the dtypes a
    forward's convolutions and products really ran in."""
    NAMES = ("conv2d", "linear")

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.NAMES and args[0].device.type != "meta":
            key = "/".join(str(a.dtype)[6:] for a in args[:2])
            d = self.seen.setdefault(name, {})
            d[key] = d.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def initial_params(mx, ctx, sym, image, batch, seed=SEED):
    """Copies of ``fit``'s Xavier initialisation of ``sym`` from
    ``seed``: ``(arg_params, aux_params)``."""
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (batch,) + tuple(image))],
             [("softmax_label", (batch,))])
    mx.random.seed(seed)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    arg, aux = mod.get_params()
    return ({k: v.copy() for k, v in arg.items()},
            {k: v.copy() for k, v in aux.items()})


def update_deviation(init, sa, sb):
    """The largest difference of two states' updates from ``init``
    (``module_state`` weights, momentum, moving stats) over each tensor's
    largest update in ``sb``; moving stats and momentum compare as they
    are (one step: the momentum is the update)."""
    worst = {}
    for kind, ka, kb in zip(("weights", "momentum", "aux"), sa, sb):
        w = 0.0
        for n in ka:
            a, b = ka[n].float(), kb[n].float()
            if kind == "weights":
                a, b = a - init[n]._data, b - init[n]._data
            w = max(w, rel_err(a, b))
        worst[kind] = w
    return worst


def mixed_fit(mx, ck, ctx, sym, image, batch=BATCH, steps=TRAIN_STEPS,
              warmup=TRAIN_WARMUP, classes=CLASSES, on=None):
    """Phase 15 (a): ``Module(sym, compute_dtype="bfloat16").fit`` with
    ``kvstore="tpu"`` from ``fit``'s Xavier initialisation.  First one
    step with the kernel knobs at ``on`` (None: ``auto``), the dtypes of
    its convolutions' and FC's operands read (``op_dtype_spy``), against
    the same step with every knob at 0, cuDNN deterministic
    (``update_deviation``); then the main path, ``warmup`` + ``steps``
    steps (``train``, launches counted over the whole fit, operand dtypes
    by ``dtype_spy``).  Returns the numbers and the module."""
    arg, aux = initial_params(mx, ctx, sym, image, batch)
    names = KNOBS + FUSED_OPT
    state, compute = {}, {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in (on, "0"):
            with knobs(mode, names), op_dtype_spy() as ops:
                mod, _ = train(mx, ck, ctx, sym, image, batch, 1,
                               arg_params=arg, aux_params=aux,
                               classes=classes, compute_dtype="bfloat16")
            state[mode] = module_state(mod)
            compute[mode] = ops.seen
            del mod
    finally:
        torch.backends.cudnn.deterministic = saved
    first = update_deviation(arg, state[on], state["0"])
    first["max_by_largest_update"] = max(first["weights"],
                                         first["momentum"])
    del state
    device = torch.device("cuda", ctx.device_id) \
        if ctx.device_type == "gpu" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) if device.type == "cuda" \
        else 0
    with knobs(on, names), dtype_spy(ck) as spy:
        mod, res = train(mx, ck, ctx, sym, image, batch, steps, warmup,
                         arg_params=arg, aux_params=aux, classes=classes,
                         compute_dtype="bfloat16")
    exe = mod._exec_group.execs[0]
    tensors = [exe.arg_dict[n]._data for n in mod._exec_group.param_names]
    tensors += [a._data for a in exe.aux_dict.values()]
    tensors += [s for v in exe.optimizer_slots().values() for s in v]
    if exe._sweep is not None:
        tensors += list(exe._sweep["flats"])
    a, b = mod.get_params()
    res.update(
        module=mod, first_step=first, dtypes=spy.seen,
        compute_dtypes=compute[on],
        masters_fp32=all(t.dtype == torch.float32 for t in tensors) and all(
            v.dtype == "float32" for v in list(a.values())
            + list(b.values())),
        peak_mem_gb=(torch.cuda.max_memory_allocated(device) - base) / 1e9
        if device.type == "cuda" else None)
    return res


def mixed_eval(mx, ck, ctx, mod, image, batch=BATCH, classes=CLASSES,
               on=None, reps=5):
    """Phase 15 (a), the eval forward: ``mod``'s symbol with its logits
    (the FC under the SoftmaxOutput) as a second output, bound with
    ``compute_dtype="bfloat16"`` twice, with the kernel knobs at ``on``
    (the BatchNorm->ReLU peephole is read at bind time) and at 0, on
    ``mod``'s parameters and a batch from the seed: the launches of the
    first forward (counts set to 0 just before), the logits' distance
    from the knobs-0 ones over the largest logit, the distance of each
    of the two from the logits of an fp32 forward (no
    ``compute_dtype``) of the same parameters, and the forward's time
    (CUDA events, median of ``reps``)."""
    sym = mod.symbol
    grp = mx.sym.Group([sym, sym.get_children()[0]])
    arg, aux = mod.get_params()
    x = synthetic_iter(mx, ctx, batch, image, 1, SEED + 1,
                       classes).next().data[0]
    out = {}
    for mode, cdt in ((on, "bfloat16"), ("0", "bfloat16"), ("0", None)):
        with knobs(mode, KNOBS):
            exe = grp.simple_bind(ctx, grad_req="null", compute_dtype=cdt,
                                  cast_exclude=("softmax_label",),
                                  data=(batch,) + tuple(image),
                                  softmax_label=(batch,))
            exe.copy_params_from(arg, aux)
            ck.reset_kernel_calls()
            with dtype_spy(ck) as spy:
                probs, logits = exe.forward(is_train=False, data=x)
            if x._data.is_cuda:
                torch.cuda.synchronize()
            out[mode, cdt] = (probs, logits, ck.kernel_calls(), spy.seen,
                              exe)
    probs, logits, calls, seen, exe = out[on, "bfloat16"]
    ref = out["0", "bfloat16"][1]._data.float()
    f32 = out["0", None][1]._data
    res = {"calls": calls, "dtypes": seen, "dtype": str(probs.dtype),
           "logits_dtype": str(logits.dtype),
           "max_by_largest": rel_err(logits._data, ref),
           "kernel_vs_fp32": rel_err(logits._data, f32),
           "plain_vs_fp32": rel_err(ref, f32),
           "largest_logit": ref.abs().max().item(),
           "finite": bool(torch.isfinite(probs._data).all())}
    if x._data.is_cuda:
        res["fwd_ms"] = time_ms(lambda: exe.forward(is_train=False, data=x),
                                n=reps, reps=3)
    return res


def fp16_multi_precision(mx, ctx, steps=FP16_STEPS, seed=SEED):
    """Phase 15 (c): a small gluon MLP (Dense 32 -> 64 tanh -> 10) with
    weights from ``seed``, cast to float16, trained ``steps`` steps on one
    batch by ``Trainer("sgd", multi_precision, momentum 0.9)``.  Returns
    the losses, the dtypes of the weights and of the masters in the
    optimizer state, and the weights at the start, the weights and the
    masters at the end, as fp32 numpy by parameter name."""
    rng = np.random.RandomState(seed)
    net = mx.gluon.nn.HybridSequential(prefix="mp_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(64, activation="tanh", in_units=32),
                mx.gluon.nn.Dense(10, in_units=64))
    net.initialize(mx.init.Zero(), ctx=ctx)
    for name, p in sorted(net.collect_params().items()):
        p.set_data(mx.nd.array((rng.randn(*p.shape) * 0.3).astype(
            np.float32), ctx=ctx))
    net.cast("float16")
    start = {k: p.data().asnumpy().astype(np.float32)
             for k, p in net.collect_params().items()}
    x = mx.nd.array(rng.randn(32, 32), ctx=ctx, dtype="float16")
    y = mx.nd.array(rng.randint(0, 10, 32).astype(np.float32), ctx=ctx)
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "multi_precision": True})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    states = trainer._updater.states
    keys = list(params.keys())
    return {"losses": losses, "start": start,
            "weights": {str(p.data().dtype) for p in params.values()},
            "masters": {str(states[i][1].dtype) for i in range(len(keys))},
            "weight": {k: params[k].data().asnumpy().astype(np.float32)
                       for k in keys},
            "master": {k: states[i][1].asnumpy() for i, k in enumerate(keys)}}


def bf16_grad_check(mx, ck, lm, loss_fn, x, y):
    """One step's gradients of the bf16 ``lm`` three ways from the same
    parameters: the kernel path (its ReLU decisions recorded), the
    knobs-0 path with those decisions, and float64 plain torch.  Returns
    what phase 15 holds: ``grad_dev_by_band``, the largest over the
    parameters of the kernel path's distance from the knobs-0 path over
    that parameter's band, max(``LM_BF16_GRAD_TOL``, twice the knobs-0
    path's own distance from float64), and ``worst``, that parameter, with
    the ReLU inputs that flip between the two paths' forwards, the widest
    band, and the distances from float64."""
    params = lm.collect_params()

    def grads():
        return {n: p.grad()._data.clone() for n, p in params.items()}

    with relu_decisions() as rec:
        lm_loss(mx, lm, loss_fn, x, y)
    kernel = grads()
    with plain_path(), relu_decisions(rec.masks) as rep:
        lm_loss(mx, lm, loss_fn, x, y)
    plain = grads()
    del rec
    ref64 = f64_grads(ck, lm, x, y)
    bands = {n: max(LM_BF16_GRAD_TOL, 2 * rel_err(plain[n], ref64[n]))
             for n in kernel}
    by_band = {n: rel_err(kernel[n], plain[n]) / bands[n] for n in kernel}
    worst = max(by_band, key=by_band.get)
    return {
        "grad_dev_by_band": by_band[worst], "worst": worst,
        "relu_flips": rep.flips, "relu_inputs": rep.total,
        "kernel_vs_f64": max(rel_err(kernel[n], ref64[n]) for n in kernel),
        "plain_vs_f64": max(rel_err(plain[n], ref64[n]) for n in kernel),
        "widest_band": max(bands.values()),
        "zero_grads": [n for n, g in kernel.items()
                       if not bool(g.abs().max() > 0)],
        "grad_dtypes": sorted({str(g.dtype)[6:] for g in kernel.values()})}


def lm_mixed(mx, ck, ctx, config=GPT2_SMALL, batch=LM_BATCH, t=LM_T[0],
             warmup=1, steps=LM_TRAIN_STEPS):
    """Phase 15 (b): the GPT-2-small-width ``TransformerLM`` of phase 10
    (Xavier from the seed), cast to bf16 with ``lm.cast("bfloat16")``,
    hybridized, at (``batch``, ``t``).  The forward (launches and
    operand dtypes, logits against the knobs-0 bf16 forward and the fp32
    plain forward of the same parameters, time); one step's gradients
    three ways from the same parameters (the kernel path, its ReLU
    decisions recorded; ``plain_path`` with those decisions; float64
    plain torch); then the main path, one counted step and ``warmup`` - 1
    more, and ``steps`` timed ones, each ``lm_loss`` then
    ``Trainer("adam").step(1)``.  Returns the numbers and
    ``(lm, trainer, loss_fn, x, y)`` for the profile."""
    lm = transformer_lm(mx, ctx, config)
    lm.cast("bfloat16")
    vocab = config["vocab_size"]
    tokens = lm_tokens(mx, ctx, vocab, batch, t)
    with dtype_spy(ck) as spy:
        lm(tokens)
    logits, fwd = lm_forward(ck, lm, tokens)
    fwd["dtypes"] = spy.seen
    fwd["logits_dtype"] = str(logits.dtype)[6:]
    with plain_path():
        ref = lm(tokens)._data
    fwd["dev"] = rel_err(logits, ref)
    f32 = {p.name: p.data()._data.detach().float()
           for p in lm.collect_params().values()}
    ref32 = plain_forward(ck, lm, tokens._data, f32)
    fwd["dev_kernel_fp32"] = rel_err(logits, ref32)
    fwd["dev_plain_fp32"] = rel_err(ref, ref32)
    del logits, ref, ref32, f32

    x, y = lm_batch(mx, ctx, vocab, batch, t)
    trainer = mx.gluon.Trainer(lm.collect_params(), "adam", dict(LM_ADAM))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = lm.collect_params()
    train = bf16_grad_check(mx, ck, lm, loss_fn, x, y)

    device = x._data.device
    ck.reset_kernel_calls()
    with dtype_spy(ck) as spy:
        losses = [lm_loss(mx, lm, loss_fn, x, y)]
        trainer.step(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train["calls"] = ck.kernel_calls()
    train["dtypes"] = spy.seen
    for _ in range(warmup - 1):
        losses.append(lm_loss(mx, lm, loss_fn, x, y))
        trainer.step(1)
    marks = [_marker(device)]
    for _ in range(steps):
        losses.append(lm_loss(mx, lm, loss_fn, x, y))
        trainer.step(1)
        marks.append(_marker(device))
    step_ms = _elapsed_ms(marks[0], marks[-1]) / steps
    train.update(losses=[float(v.asnumpy()) for v in losses],
                 step_ms=step_ms,
                 tokens_per_s=batch * t / step_ms * 1e3,
                 param_dtypes=sorted({str(p.data().dtype)
                                      for p in params.values()}))
    return fwd, train, (lm, trainer, loss_fn, x, y)


def bf16_instances(ck, dev, bw, bf16, sites,
                   rows=LM_BATCH * LM_T[0], cols=GPT2_SMALL["units"],
                   bh=LM_BATCH * GPT2_SMALL["num_heads"], t=LM_T[0],
                   d=GPT2_SMALL["units"] // GPT2_SMALL["num_heads"]):
    """Timing jobs of the bf16 instances phase 15 launches that no earlier
    phase times (K6b's and K7a's bf16 instances are in their own jobs):
    K3 at the ResNet-50 sites of a bucket-32 forward, K6a at (8192, 768)
    beside ``F.layer_norm`` in bf16, K7b and K7c at (96, 1024, 64) causal
    beside the backward of SDPA in bf16 (its bf16 tensor cores).  The
    correctness of each was held in phases 3, 9 and 11.  Returns ``{K:
    jobs}``; each job's bound is the bf16 one: 2-byte operands, the
    operations at the card's bf16 tensor-core rate ``bf16`` (the bf16
    instances of both run bf16 mma.sync)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    out = {"K3": {}}
    for _, shape in sites:
        c = shape[1]
        job = out["K3"].get(shape)
        if job is None:
            x = (torch.randn(shape, generator=gen, device=dev) * 2).to(
                torch.bfloat16)
            s = torch.rand(c, generator=gen, device=dev) + 0.5
            b = torch.randn(c, generator=gen, device=dev)
            job = out["K3"][shape] = {
                "count": 0, "shape": shape,
                "bound_ms": bound_ms(2 * x.numel() * 2 + 2 * c * 4,
                                     3 * x.numel(), bw, bf16)[0],
                "fns": {"": lambda x=x, s=s, b=b: ck.scale_bias_relu(x, s, b),
                        "plain_": lambda x=x, s=s, b=b:
                        ck.scale_bias_relu_ref(x, s, b)}}
        job["count"] += 1
    out["K3"] = list(out["K3"].values())
    x = torch.randn((rows, cols), generator=gen, device=dev).to(
        torch.bfloat16)
    g, b = torch.ones(cols, device=dev), torch.zeros(cols, device=dev)
    gb, bb = g.to(torch.bfloat16), b.to(torch.bfloat16)
    out["K6a"] = [{"count": 1, "shape": (rows, cols), "bound_ms": bound_ms(
        2 * x.numel() * 2 + 2 * cols * 4 + 2 * rows * 4, 7 * x.numel(), bw,
        bf16)[0], "fns": {
        "": lambda: ck.layernorm_fwd(x, g, b, 1e-5),
        "plain_": lambda: ck.layernorm_fwd_ref(x, g, b, 1e-5),
        "library_": lambda: torch.nn.functional.layer_norm(
            x, (cols,), gb, bb, 1e-5)}}]
    args = flash_bwd_operands(ck, gen, bh, t, t, d, True, torch.bfloat16,
                              dev)
    heads = GPT2_SMALL["num_heads"]
    q4, k4, v4 = (a.view(bh // heads, heads, t, d).clone().requires_grad_()
                  for a in args[:3])
    o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True)
    do4 = args[3].view(bh // heads, heads, t, d)

    def sdpa_backward():
        return torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)
    pairs = t * (t + 1) // 2
    for knum, name, n_out, n_prod in (("K7b", "flash_attention_bwd_dq", 1, 3),
                                      ("K7c", "flash_attention_bwd_dkv", 2,
                                       4)):
        nbytes = flash_bwd_bytes(bh, t, t, d, n_out, 2)
        ops = 2 * d * n_prod * bh * pairs
        kernel, plain = getattr(ck, name), getattr(ck, name + "_ref")
        out[knum] = [{"count": 1, "shape": (bh, t, d), "ops": ops,
                      "bound_ms": bound_ms(nbytes, ops, bw, bf16)[0],
                      "fns": {"": lambda f=kernel: f(*args, True),
                              "plain_": lambda f=plain: f(*args, True),
                              "library_": sdpa_backward}}]
    return out


# ---------------------------------------------------------------------------
# phase 16: the training-loop API
# ---------------------------------------------------------------------------
# The fourteen optimizers that update one array at a time (the fused step
# takes SGD and Adam only, by type name, as in the JAX package), each with
# a PolyScheduler (max_update LOOP_POLY[0], power LOOP_POLY[1]) over its
# learning rate
LOOP_OPTIMIZERS = (
    ("ccsgd", {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4}),
    ("signum", {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-4,
                "wd_lh": 1e-4}),
    ("ftml", {"learning_rate": 1e-3, "wd": 1e-4}),
    ("lbsgd", {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4,
               "warmup_strategy": "linear", "warmup_epochs": 1,
               "batch_scale": 2, "updates_per_epoch": 4}),
    ("dcasgd", {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4}),
    ("nag", {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4}),
    ("sgld", {"learning_rate": 1e-4, "wd": 1e-4}),
    ("test", {}),
    ("adagrad", {"learning_rate": 0.01, "wd": 1e-4}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True, "wd": 1e-4}),
    ("adadelta", {"wd": 1e-4}),
    ("ftrl", {"learning_rate": 0.02, "wd": 1e-4}),
    ("adamax", {"learning_rate": 2e-3, "wd": 1e-4}),
    ("nadam", {"learning_rate": 1e-3, "wd": 1e-4}),
)
LOOP_POLY = (10, 2)
LOOP_TIMED = 2              # timed steps of each optimizer after its check
# The card's update against the CPU's replay of the same update on the
# same weights, gradients and states: the same fp32 expressions, each
# rounded once on either side (the card divides by a scalar through its
# reciprocal, one rounding more), within 1e-6 of each array's largest
# magnitude.
LOOP_TOL = 1e-6
# SGLD's noise, N(0, sqrt(lr)) from the card's generator: the card's
# weights minus the CPU's noise-free update have a mean within this many
# standard errors of 0 and a standard deviation within this share of
# sqrt(lr).
SGLD_MEAN_SE = 5.0
SGLD_STD_REL = 0.02
LOOP_FIT_EPOCHS = 2
LOOP_FIT_BATCHES = 3
LOOP_MONITOR = ".*(conv0|fc1).*"
# each metric of the fit against numpy's formula on the fetched outputs
# (float64 here, float32 sums in the metric): relative
LOOP_METRIC_TOL = 1e-6
LOOP_MONITOR_STEPS = 3      # steps of each run of the monitor's check


def _host(array):
    """An NDArray's tensor copied to the host (a copy on the CPU too)."""
    return array._data.detach().to("cpu", copy=True)


def _state_tensors(state):
    """An Updater state (None, an NDArray or nested tuples of them) as a
    list of host tensors."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _state_tensors(s)]
    return [_host(state)]


@contextlib.contextmanager
def _sgld_noise_free(opt_mod, on):
    """Within the block, when ``on``, SGLD draws zeros for its noise."""
    noise = opt_mod._sgld_noise
    if on:
        opt_mod._sgld_noise = lambda weight, lr: torch.zeros_like(
            weight._data)
    try:
        yield
    finally:
        opt_mod._sgld_noise = noise


def loop_optimizers(mx, ck, ctx, sym, image, batch=BATCH, classes=CLASSES,
                    cases=LOOP_OPTIMIZERS, timed=LOOP_TIMED, seed=SEED):
    """Phase 16 (a): ``sym`` bound once by a ``Module`` with
    ``kvstore="tpu"``, Xavier from ``seed``; for each optimizer of
    ``cases`` (with a PolyScheduler): the parameters set back to the
    initial ones, ``init_optimizer(force_init=True)``, one
    ``forward_backward``, the weights and gradients copied to the host
    with the updater's pickled optimizer and states, ``update()``, then
    the same update replayed through the port on CPU tensors from that
    copy (so update counts and the scheduler agree), its weights and
    states held to the card's (SGLD's with its noise set to zeros on
    both sides; then SGLD steps again on the card from the same weights
    and update counts with its noise, held by that noise's moments);
    then ``timed`` more steps timed by CUDA events.  The launch
    counts are reset just before the checked step and read after it.
    Returns ``{optimizer name: numbers}``."""
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.ndarray import NDArray
    it = synthetic_iter(mx, ctx, batch, image, 1, seed, classes)
    data = it.next()
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    mx.random.seed(seed)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    arg0, aux0 = mod.get_params()
    names = mod._exec_group.param_names
    exe = mod._exec_group.execs[0]
    device = exe.device
    out = {}
    for name, params in cases:
        mod.set_params(arg0, aux0)
        kw = dict(params, lr_scheduler=mx.lr_scheduler.PolyScheduler(
            LOOP_POLY[0], base_lr=params.get("learning_rate", 0.01),
            pwr=LOOP_POLY[1]))
        mod.init_optimizer(kvstore="tpu", optimizer=name,
                           optimizer_params=kw, force_init=True)
        if mod._fused_exec_update:
            raise AssertionError("%s took the fused step" % name)
        ck.reset_kernel_calls()
        mod.forward_backward(data)
        w = {n: _host(exe.arg_dict[n]) for n in names}
        g = {n: _host(exe.grad_dict[n]) for n in names}
        upd = mod._kvstore._updater
        blob = upd.get_states(dump_optimizer=True)
        opt = upd.optimizer
        counts = dict(opt._index_update_count), opt.num_update
        with _sgld_noise_free(opt_mod, name == "sgld"):
            mod.update()
        card_w = {n: _host(exe.arg_dict[n]) for n in names}
        card_st = {n: _state_tensors(upd.states[n]) for n in names}
        calls = ck.kernel_calls()
        if name == "sgld":
            # the same step again from the same weights and update
            # counts, now with the card's noise
            for n in names:
                exe.arg_dict[n]._data.copy_(w[n])
            opt._index_update_count, opt.num_update = dict(counts[0]), \
                counts[1]
            mod.update()
            noisy_w = {n: _host(exe.arg_dict[n]) for n in names}
        cpu = opt_mod.get_updater(None)
        cpu.set_states(blob)
        cpu_w = {n: NDArray(w[n].clone()) for n in names}
        with _sgld_noise_free(opt_mod, name == "sgld"):
            for n in names:
                cpu(n, NDArray(g[n]), cpu_w[n])
        rec = {"launches": {k: v for k, v in calls.items() if v},
               "sweeps": sum(v for k, v in calls.items()
                             if k.endswith("_sweep")),
               "moved": any(not torch.equal(card_w[n], w[n]) for n in names),
               "states": sum(len(s) for s in card_st.values())}
        if name == "sgld":
            diff = torch.cat([(noisy_w[n].double()
                               - cpu_w[n]._data.double()).reshape(-1)
                              for n in names])
            sd = math.sqrt(cpu.optimizer._get_lr(names[0]))
            rec["sgld"] = {
                "values": int(diff.numel()), "sqrt_lr": sd,
                "mean_in_se": float(diff.mean()) / (
                    sd / math.sqrt(diff.numel())),
                "std_by_sqrt_lr": float(diff.std()) / sd}
        rec["weights"] = max(largest_rel(card_w[n].numpy(),
                                         cpu_w[n]._data.numpy())
                             for n in names)
        st = []
        for n in names:
            cs = _state_tensors(cpu.states[n])
            if len(cs) != len(card_st[n]):
                raise AssertionError("%s: %d states of %s on the card, %d "
                                     "on the CPU" % (name, len(card_st[n]),
                                                     n, len(cs)))
            st += [largest_rel(a.numpy(), b.numpy())
                   for a, b in zip(card_st[n], cs)]
        rec["states_max_rel"] = max(st) if st else 0.0
        marks = [_marker(device)]
        for _ in range(timed):
            mod.forward_backward(data)
            mod.update()
            marks.append(_marker(device))
        rec["step_ms"] = float(np.median(
            [_elapsed_ms(a, b) for a, b in zip(marks, marks[1:])])) \
            if timed else None
        out[name] = rec
    return out


def loop_failures(res, tol=LOOP_TOL):
    """What of ``loop_optimizers``' numbers breaks phase 16 (a)'s limits:
    a list of strings, empty when all hold."""
    bad = []
    for name, r in res.items():
        if r["launches"] != {"softmax_lastaxis": 1} or r["sweeps"]:
            bad.append("%s launched %s (expected K2 once)"
                       % (name, r["launches"]))
        if not r["moved"]:
            bad.append("%s did not move the weights" % name)
        if r["states_max_rel"] > tol:
            bad.append("%s states %.3g from the CPU's (limit %g)"
                       % (name, r["states_max_rel"], tol))
        if name == "sgld":
            s = r["sgld"]
            if abs(s["mean_in_se"]) > SGLD_MEAN_SE or \
                    abs(s["std_by_sqrt_lr"] - 1) > SGLD_STD_REL:
                bad.append("sgld noise: mean %.3g standard errors, std "
                           "%.4f of sqrt(lr)" % (s["mean_in_se"],
                                                 s["std_by_sqrt_lr"]))
        if not r["weights"] <= tol:
            bad.append("%s weights %.3g from the CPU's (limit %g)"
                       % (name, r["weights"], tol))
    return bad


def _top_prob(label, pred):
    """``metric.np``'s function here: the mean largest probability."""
    return float(pred.max(axis=1).mean())


def loop_metric_reference(seen):
    """numpy's formula for each metric of ``loop_fit``'s composite over
    the batches of an epoch so far: ``[(perplexity, nll, loss,
    top_prob)]`` after each batch of ``seen`` (``(epoch, nbatch, probs,
    labels)`` records)."""
    out, acc = [], None
    for epoch, nbatch, p, lab in seen:
        if nbatch == 0:
            acc = {"logp": 0.0, "nll": 0.0, "n": 0, "sum": 0.0, "size": 0,
                   "top": 0.0, "batches": 0}
        p = p.astype(np.float64)
        lab = lab.astype(np.int64)
        picked = p[np.arange(lab.size), lab]
        acc["logp"] -= np.log(np.maximum(1e-10, picked)).sum()
        acc["nll"] -= np.log(picked + 1e-12).sum()
        acc["n"] += lab.size
        acc["sum"] += p.sum()
        acc["size"] += p.size
        acc["top"] += p.max(axis=1).mean()
        acc["batches"] += 1
        out.append((math.exp(acc["logp"] / acc["n"]), acc["nll"] / acc["n"],
                    acc["sum"] / acc["size"], acc["top"] / acc["batches"]))
    return out


class _Lines(logging.Handler):
    """Collects the messages logged while it is the root logger's only
    handler (at INFO)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def loop_fit(mx, ck, ctx, sym, image, batch=BATCH, classes=CLASSES,
             epochs=LOOP_FIT_EPOCHS, batches=LOOP_FIT_BATCHES, seed=SEED):
    """Phase 16 (b): one ``Module.fit`` through the new API: ``epochs``
    epochs of ``batches`` batches with ``optimizer="nag"`` (momentum
    0.9) under a ``PolyScheduler``, a ``CompositeEvalMetric`` of
    ``Perplexity``, ``NegativeLogLikelihood``, ``Loss`` and a
    ``metric.np`` metric, ``monitor=Monitor(1, pattern=LOOP_MONITOR)``,
    ``Speedometer``, ``log_train_metric`` and ``ProgressBar`` after each
    batch, and one ``eval_data`` batch with
    ``LogValidationMetricsCallback``.  Launch counts are reset just
    before ``fit`` and read after it.  Returns ``(module, numbers)``; the
    numbers hold each metric's largest distance from numpy's formula on
    the fetched outputs, the monitor's windows and the callbacks' log
    lines."""
    train_it = synthetic_iter(mx, ctx, batch, image, batches, seed, classes)
    eval_it = synthetic_iter(mx, ctx, batch, image, 1, seed + 1, classes)
    metric = mx.metric.CompositeEvalMetric([
        mx.metric.Perplexity(ignore_label=None),
        mx.metric.NegativeLogLikelihood(), mx.metric.Loss(),
        mx.metric.np(_top_prob)])
    mon = mx.Monitor(1, pattern=LOOP_MONITOR)
    windows = []
    toc = mon.toc

    def recording_toc():
        report = toc()
        windows.append(report)
        return report

    mon.toc = recording_toc
    mod = mx.mod.Module(sym, context=ctx)
    seen, values = [], []
    label = train_it.next().label[0].asnumpy()
    train_it.reset()

    def record(param):
        seen.append((param.epoch, param.nbatch,
                     mod.get_outputs()[0].asnumpy(), label))
        values.append([v for _, v in param.eval_metric.get_name_value()])

    lines = _Lines()
    root = logging.getLogger()
    level, handlers = root.level, root.handlers[:]
    root.handlers = [lines]
    root.setLevel(logging.INFO)
    mx.random.seed(seed)
    ck.reset_kernel_calls()
    t0 = time.perf_counter()
    try:
        mod.fit(train_it, eval_data=eval_it, eval_metric=metric,
                batch_end_callback=[
                    record, mx.callback.Speedometer(batch, 2,
                                                    auto_reset=False),
                    mx.callback.log_train_metric(1),
                    mx.callback.ProgressBar(batches)],
                eval_end_callback=mx.callback.LogValidationMetricsCallback(),
                kvstore="tpu", optimizer="nag",
                optimizer_params={
                    "learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4,
                    "lr_scheduler": mx.lr_scheduler.PolyScheduler(
                        epochs * batches * 2, base_lr=0.01)},
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                num_epoch=epochs, monitor=mon)
    finally:
        root.handlers = handlers
        root.setLevel(level)
    seconds = time.perf_counter() - t0
    calls = ck.kernel_calls()
    ref = loop_metric_reference(seen)
    metric_rel = [max(abs(v - r) / max(abs(r), 1e-30) for v, r in zip(vs, rs))
                  for vs, rs in zip(values, ref)]
    names = [sorted(n for _, n, _ in w) for w in windows]
    finite = all(np.isfinite(float(s.strip("[]"))) for w in windows
                 for _, _, s in w)
    return mod, {
        "epochs": epochs, "batches": batches, "seconds": seconds,
        "calls": calls, "metric_names": metric.get()[0],
        "metric_max_rel": max(metric_rel), "metric_values_last": values[-1],
        "monitor_windows": len(windows), "monitor_names": names,
        "monitor_finite": finite,
        "log_speed": sum("Speed:" in s for s in lines.lines),
        "log_train": sum("] Train-" in s and "Iter[" in s
                         for s in lines.lines),
        "log_progress": sum(s.startswith("[") and "%" in s
                            for s in lines.lines),
        "log_validation": sum("Validation-" in s for s in lines.lines),
        "fused": mod._fused_exec_update,
    }


def loop_monitor_bitwise(mx, mod, ctx, image, batch=BATCH, classes=CLASSES,
                         steps=LOOP_MONITOR_STEPS, seed=SEED):
    """From one state of ``mod`` (parameters and the updater's pickled
    optimizer and states), ``steps`` steps three times under cuDNN
    deterministic: without a monitor, with ``Monitor(1, ".*",
    monitor_all=True)`` (every node tapped, ``tic``/``toc`` each step),
    and without again; the weights after each, and the step times by CUDA
    events."""
    exe = mod._exec_group.execs[0]
    exe.set_monitor_callback(None)
    data = synthetic_iter(mx, ctx, batch, image, 1, seed, classes).next()
    arg, aux = mod.get_params()
    upd = mod._kvstore._updater
    blob = upd.get_states(dump_optimizer=True)
    device = exe.device
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for run in ("off", "on", "off_again"):
            mod.set_params(arg, aux)
            upd.set_states(blob)
            mon = None
            if run == "on":
                mon = mx.Monitor(1, pattern=".*", monitor_all=True)
                mod.install_monitor(mon)
            ts, taps = [], 0
            for _ in range(steps):
                a = _marker(device)
                if mon is not None:
                    mon.tic()
                mod.forward_backward(data)
                mod.update()
                if mon is not None:
                    taps = len(mon.toc())
                ts.append(_elapsed_ms(a, _marker(device)))
            exe.set_monitor_callback(None)
            runs[run] = ({n: exe.arg_dict[n]._data.clone()
                          for n in mod._exec_group.param_names},
                         float(np.median(ts)), taps)
    finally:
        torch.backends.cudnn.deterministic = saved

    def same(a, b):
        return all(torch.equal(a[n].view(torch.int32), b[n].view(torch.int32))
                   for n in a)

    return {"steps": steps,
            "bitwise_on_vs_off": same(runs["on"][0], runs["off"][0]),
            "bitwise_off_vs_off": same(runs["off_again"][0], runs["off"][0]),
            "step_ms_off": runs["off"][1], "step_ms_on": runs["on"][1],
            "step_ms_off_again": runs["off_again"][1],
            "records_a_step_on": runs["on"][2]}


def loop_engine(mx, ctx, n=1 << 22, seed=SEED):
    """Phase 16 (c): inside ``engine.naive()`` each imperative op leaves
    the current stream idle (``query()``) when it returns; an exception a
    worker recorded raises at the next ``nd.waitall()`` and not at the one
    after."""
    rng = np.random.RandomState(seed)
    a = mx.nd.array(rng.randn(n).astype(np.float32), ctx=ctx)
    m = mx.nd.array(rng.randn(2048, 2048).astype(np.float32), ctx=ctx)
    ops = (("mul", lambda: a * 2.0), ("exp", lambda: mx.nd.exp(a)),
           ("dot", lambda: mx.nd.dot(m, m)), ("sum", lambda: mx.nd.sum(a)),
           ("softmax", lambda: mx.nd.softmax(m)))
    on_card = ctx.device_type == "gpu"
    idle = {}
    with mx.engine.naive():
        for name, op in ops:
            if on_card:
                torch.cuda.synchronize()
            op()
            idle[name] = torch.cuda.current_stream().query() \
                if on_card else None
    busy_outside = None
    if on_card:
        torch.cuda.synchronize()
        mx.nd.dot(m, m)
        mx.nd.dot(m, m)
        busy_outside = not torch.cuda.current_stream().query()
    mx.engine.clear_exception()
    exc = RuntimeError("phase 16: a worker's exception with no receiver")

    def worker():
        with mx.engine.worker_scope(lambda e: False):
            raise exc

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    first = again = None
    try:
        mx.nd.waitall()
    except RuntimeError as e:
        first = e is exc
    try:
        mx.nd.waitall()
        again = False
    except Exception:   # noqa: BLE001 — any second raise fails the phase
        again = True
    return {"naive_idle": idle, "busy_outside_naive": busy_outside,
            "raised_at_waitall": first, "raised_again": again}


# ---------------------------------------------------------------------------
# phase 17: the data pipeline and the module family
# ---------------------------------------------------------------------------
# (a) ResNet-50 from a .rec: 640 synthetic JPEGs in the form im2rec
# --resize 256 writes them (short side 256, long side 256-384, quality 95),
# 10 classes of smooth patterns; example/image-classification's
# train_imagenet.py means; 20 batches of 32, and 2 batches of evaluation
REC_IMAGES = 640
REC_CLASSES = 10
REC_SHORT = 256
REC_LONG = (256, 384)
REC_QUALITY = 95
REC_MEAN = (123.68, 116.779, 103.939)
REC_SEED_AUG = 17
REC_EVAL_PARTS = 10         # the evaluation reads every 10th record
REC_WARMUP = 3              # batches before the fit's timed ones
REC_LOSS_WINDOW = 4         # batches averaged at each end for the loss
# (b) example/rnn/lstm_bucketing.py's model at its defaults (num_hidden
# 200, num_embed 200, two LSTM layers, batch 32, buckets 10-60), PTB's
# 10,000-word vocabulary (id 0 the padding, as the example's
# invalid_label), Adam lr 0.01; about 3 batches a bucket, 2 epochs
BUCKET_VOCAB = 10000
BUCKET_HIDDEN = 200
BUCKET_EMBED = 200
BUCKET_LAYERS = 2
BUCKET_BATCH = 32
BUCKET_KEYS = (10, 20, 30, 40, 50, 60)
BUCKET_BATCHES = 3          # batches a bucket an epoch
BUCKET_EPOCHS = 2           # the first binds every bucket; the second is timed
BUCKET_ADAM = {"learning_rate": 0.01}
# a bucket's first-step gradients on the card against the CPU's, from the
# same parameters, within this much of each parameter's largest
BUCKET_GRAD_TOL = 1e-4
# the fused RNN op (cuDNN) against the unrolled cells it unfuses into, at
# the model's widths, outputs and gradients within this much of their
# largest magnitude (at hidden 200 cuDNN's LSTM and GRU cells are exact to
# fp32 rounding: 3.3e-7 to 3.8e-7 of a float64 run, time_variants.py
# rnn_accuracy; OP_BAND_REASONS["rnn"] has the narrower cells)
FUSED_TOL = 1e-5
# (c) K2 at the LM's logits, (32 T, 10000) for T 10 and 60, against its
# plain version within this much of the largest probability: fp32 sums of
# 10,000 terms in another order, ~sqrt(n) u = 6e-6 apart, at worst n u =
# 6e-4 (a wrong kernel is off by the probabilities themselves)
K2_LM_SHAPES = ((BUCKET_BATCH * 10, BUCKET_VOCAB),
                (BUCKET_BATCH * 60, BUCKET_VOCAB))
K2_LM_TOL = 1e-4


def rec_image(rng, label, short=REC_SHORT, long_range=REC_LONG,
              noise=None):
    """A smooth HWC uint8 image of class ``label``: two sinusoids whose
    frequencies and colours follow the class, at random phases, plus a
    window of ``noise`` (an int16 HWC bank at least as large) at a random
    offset; short side ``short``, long side drawn from ``long_range``."""
    long_side = int(rng.integers(long_range[0], long_range[1] + 1))
    h, w = (short, long_side) if rng.random() < 0.5 else (long_side, short)
    p1, p2 = rng.uniform(0, 2 * np.pi, 2)
    f1, f2 = 0.02 + 0.01 * label, 0.05 + 0.004 * label
    wave = (np.sin(f1 * np.arange(w, dtype=np.float32) + p1)[None, :]
            + 0.5 * np.sin(f2 * np.arange(h, dtype=np.float32) + p2)[:, None])
    base = np.array([(37 * label) % 256, (91 * label) % 256,
                     (151 * label) % 256], np.float32)
    img = base + 60.0 * wave[..., None]
    if noise is not None:
        y0 = int(rng.integers(0, noise.shape[0] - h + 1))
        x0 = int(rng.integers(0, noise.shape[1] - w + 1))
        img = img + noise[y0:y0 + h, x0:x0 + w]
    return np.clip(img, 0, 255).astype(np.uint8)


def write_rec(mx, prefix, n=REC_IMAGES, classes=REC_CLASSES, short=REC_SHORT,
              long_range=REC_LONG, quality=REC_QUALITY, seed=SEED):
    """``prefix.rec`` and ``prefix.idx`` of ``n`` images from ``seed``,
    written with the port's ``recordio.pack_img``.  Returns ``(rec path,
    labels, seconds)``."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    side = max(short, long_range[1]) + 16
    noise = rng.integers(-6, 7, (side, side, 3)).astype(np.int16)
    rec = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    labels = []
    for i in range(n):
        label = int(rng.integers(0, classes))
        img = rec_image(rng, label, short, long_range, noise)
        rec.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(label), i, 0), img,
            quality=quality))
        labels.append(label)
    rec.close()
    return prefix + ".rec", labels, time.perf_counter() - t0


def rec_args(image, batch, train=True, seed_aug=REC_SEED_AUG,
             threads=None, mean=REC_MEAN):
    """The ``ImageRecordIter`` arguments of phase 17 (a): the training
    reader shuffles, crops at random and mirrors; the evaluation one reads
    every ``REC_EVAL_PARTS``-th record and crops the centre."""
    args = dict(data_shape=tuple(image), batch_size=batch,
                mean_r=mean[0], mean_g=mean[1], mean_b=mean[2],
                preprocess_threads=threads or min(8, os.cpu_count() or 1),
                seed_aug=seed_aug)
    if train:
        args.update(shuffle=True, rand_crop=True, rand_mirror=True)
    else:
        args.update(num_parts=REC_EVAL_PARTS, part_index=0)
    return args


def rec_replay(mx, path, epoch=1, data_shape=None, batch_size=None,
               shuffle=False, rand_crop=False, rand_mirror=False,
               mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
               std_b=1.0, scale=1.0, num_parts=1, part_index=0, resize=-1,
               shuffle_chunk_size=256, seed_aug=None, **_):
    """What ``ImageRecordIter(path, ...)`` hands out in epoch ``epoch``,
    replayed on the host with the port's own record functions, one
    record at a time: ``[(data NCHW float32, label, pad)]`` a batch."""
    io = mx.io
    spans = io._scan_record_spans(path)
    if num_parts > 1:
        spans = spans[part_index::num_parts]
    chunks = [spans[i:i + shuffle_chunk_size]
              for i in range(0, len(spans), shuffle_chunk_size)]
    order = np.random.default_rng(seed_aug + epoch)
    ids = np.arange(len(chunks))
    if shuffle:
        order.shuffle(ids)
    raws = []
    with open(path, "rb") as f:
        for ci in ids:
            recs = []
            for s, e in chunks[ci]:
                f.seek(s)
                recs.append(io._split_chunk_records(f.read(e - s))[0])
            if shuffle:
                order.shuffle(recs)
            raws.extend(recs)
    cfg = dict(data_shape=tuple(data_shape), resize=int(resize),
               rand_crop=rand_crop, rand_mirror=rand_mirror)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        decoded = list(pool.map(
            lambda k: io._mp_decode((raws[k], (seed_aug, epoch, k)), cfg),
            range(len(raws))))
    c, h, w = data_shape
    mean = np.array([mean_r, mean_g, mean_b], np.float32).reshape(3, 1, 1)
    std = np.array([std_r, std_g, std_b], np.float32).reshape(3, 1, 1)
    out = []
    for b0 in range(0, len(decoded), batch_size):
        part = decoded[b0:b0 + batch_size]
        raw = np.zeros((batch_size, h, w, c), np.uint8)
        label = np.zeros((batch_size,), np.float32)
        for i, (img, lab) in enumerate(part):
            raw[i] = img
            label[i] = lab
        out.append((io._normalize_batch(raw, mean, std, scale), label,
                    batch_size - len(part)))
    return out


def _host_batch(batch):
    return (batch.data[0].asnumpy(), batch.label[0].asnumpy(),
            batch.pad or 0)


def batches_equal(got, want):
    """How many of ``got`` equal ``want`` bitwise (data, label, pad), and
    the largest |difference| of the data."""
    same, worst = 0, 0.0
    for (d, lab, pad), (rd, rlab, rpad) in zip(got, want):
        if d.shape == rd.shape:
            worst = max(worst, float(np.abs(d - rd).max()))
        same += int(np.array_equal(d, rd) and np.array_equal(lab, rlab)
                    and pad == rpad)
    return same, worst


def rec_throughput(mx, ctx, path, image, batch):
    """One epoch of a fresh training ``ImageRecordIter`` with no
    training: ``(images/s, batches)``."""
    with ctx:
        it = mx.io.ImageRecordIter(path, **rec_args(image, batch))
    t0 = time.perf_counter()
    n = 0
    for b in it:
        n += batch - (b.pad or 0)
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    it.close()
    return n / dt, n


def rec_breakdown(mx, ctx, path, image, batch, reps=3):
    """Where a batch of the reader's time goes, one part at a time on the
    producer's side: ``_mp_decode`` of one batch's records on one thread
    and on the reader's pool, the one-pass normalisation, and the copy to
    ``ctx`` (host clock, the copy synchronised), each the median of
    ``reps``, in ms."""
    from concurrent.futures import ThreadPoolExecutor
    io = mx.io
    args = rec_args(image, batch)
    spans = io._scan_record_spans(path)[:batch]
    raws = []
    with open(path, "rb") as f:
        for s, e in spans:
            f.seek(s)
            raws.append(io._split_chunk_records(f.read(e - s))[0])
    cfg = dict(data_shape=tuple(image), resize=-1, rand_crop=True,
               rand_mirror=True)
    jobs = [(r, (1, 1, k)) for k, r in enumerate(raws)]
    c, h, w = image
    mean = np.array(REC_MEAN, np.float32).reshape(3, 1, 1)
    std = np.ones((3, 1, 1), np.float32)
    raw = np.zeros((batch, h, w, c), np.uint8)

    def timed(fn):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    with ThreadPoolExecutor(max_workers=args["preprocess_threads"]) as pool:
        pooled = timed(lambda: list(pool.map(
            lambda j: io._mp_decode(j, cfg), jobs)))
    data = io._normalize_batch(raw, mean, std, 1.0)

    def copy():
        with ctx:
            mx.nd.array(data).wait_to_read()

    return {"decode_ms_one_thread": timed(
                lambda: [io._mp_decode(j, cfg) for j in jobs]),
            "decode_ms_pool": pooled,
            "threads": args["preprocess_threads"],
            "normalize_ms": timed(lambda: io._normalize_batch(
                raw, mean, std, 1.0)),
            "copy_ms": timed(copy), "batch": batch}


def rec_wrappers(mx, ctx, path, image, batch, replay, n=3):
    """``PrefetchingIter(ResizeIter(ImageRecordIter, n))``: its ``n``
    batches against the first ``n`` of ``replay``, bitwise."""
    with ctx:
        it = mx.io.ImageRecordIter(path, **rec_args(image, batch))
    wrapped = mx.io.PrefetchingIter(mx.io.ResizeIter(it, n))
    got = [_host_batch(b) for b in wrapped]
    it.close()
    same, worst = batches_equal(got, replay[:n])
    return {"batches": len(got), "bitwise": same, "max_abs": worst}


def rec_fit(mx, ck, ctx, sym, path, image, batch, optimizer_params=SGD_PARAMS,
            warmup=REC_WARMUP, seed=SEED):
    """``Module.fit`` of ``sym`` on ``ctx`` from the records: one epoch of
    the training ``ImageRecordIter`` with ``kvstore="tpu"`` and an
    ``eval_data`` of the evaluation reader; launch counts reset just
    before ``fit`` and read just after.  Returns the module, the batches
    it received (device tensors), a batch for profiling and what it
    measured."""
    with ctx:
        train_it = mx.io.ImageRecordIter(path, **rec_args(image, batch))
        eval_it = mx.io.ImageRecordIter(path, **rec_args(image, batch,
                                                         train=False))
    mod = mx.mod.Module(sym, context=ctx)
    device = torch.device("cuda", ctx.device_id) \
        if ctx.device_type == "gpu" else torch.device("cpu")
    marks, seen, probs = [], [], []

    def on_batch(param):
        b = param.locals["data_batch"]
        seen.append((b.data[0]._data, b.label[0]._data, b.pad or 0))
        probs.append(mod.get_outputs()[0]._data.clone())
        marks.append(_marker(device))

    mx.random.seed(seed)
    ck.reset_kernel_calls()
    mod.fit(train_it, eval_data=eval_it, num_epoch=1, kvstore="tpu",
            optimizer="sgd", optimizer_params=optimizer_params,
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            eval_metric="acc", batch_end_callback=on_batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    calls = ck.kernel_calls()
    train_it.close()
    eval_it.close()
    n = len(seen)
    ces = [cross_entropy(p, lab) for p, (_d, lab, _pad) in zip(probs, seen)]
    timed = n - warmup
    step_ms = _elapsed_ms(marks[warmup - 1], marks[-1]) / timed \
        if 0 < warmup < n else None
    exe = mod._exec_group.execs[0]
    k = min(REC_LOSS_WINDOW, max(n // 2, 1))
    return mod, seen, {
        "batches": n, "calls": calls, "fused": mod._fused_exec_update,
        "buckets": [b.n for b, _ in exe._sweep["plan"]]
        if exe._sweep is not None else [],
        "step_ms": step_ms,
        "images_per_s": batch / step_ms * 1e3 if step_ms else None,
        "timed_batches": timed,
        "ce_first": float(np.mean(ces[:k])), "ce_last": float(np.mean(ces[-k:])),
        "ce": ces}


def rec_pipeline(mx, ck, ctx, sym, workdir, image=IMAGE, batch=BATCH,
                 n_images=REC_IMAGES, classes=REC_CLASSES, short=REC_SHORT,
                 long_range=REC_LONG, seed=SEED):
    """Phase 17 (a): write the records, time the reader alone, fit from
    it, and hold the batches the model received, and those of
    ``PrefetchingIter``/``ResizeIter`` over it, to the host replay."""
    path, labels, write_s = write_rec(mx, os.path.join(workdir, "train"),
                                      n_images, classes, short, long_range,
                                      seed=seed)
    ips, n_read = rec_throughput(mx, ctx, path, image, batch)
    mod, seen, fit = rec_fit(mx, ck, ctx, sym, path, image, batch, seed=seed)
    replay = rec_replay(mx, path, epoch=1, **rec_args(image, batch))
    got = [(d.cpu().numpy(), lab.cpu().numpy(), pad) for d, lab, pad in seen]
    same, worst = batches_equal(got, replay)
    fit.update(
        records=n_images, write_s=write_s, rec_mb=os.path.getsize(path) / 1e6,
        reader_images_per_s=ips, reader_images=n_read,
        cpu_count=os.cpu_count(),
        preprocess_threads=rec_args(image, batch)["preprocess_threads"],
        breakdown=rec_breakdown(mx, ctx, path, image, batch),
        replay_batches=len(replay), bitwise_batches=same,
        max_abs_vs_replay=worst, data_on=str(seen[0][0].device),
        wrappers=rec_wrappers(mx, ctx, path, image, batch, replay))
    profile_batch = mx.io.DataBatch(
        data=[mx.nd.NDArray(seen[-1][0])], label=[mx.nd.NDArray(seen[-1][1])],
        pad=0)
    return mod, profile_batch, fit


def lm_sym_gen(mx, vocab=BUCKET_VOCAB, num_hidden=BUCKET_HIDDEN,
               num_embed=BUCKET_EMBED, num_layers=BUCKET_LAYERS):
    """example/rnn/lstm_bucketing.py's ``sym_gen`` (:86-100)."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=vocab,
                                 output_dim=num_embed, name="embed")
        stack = mx.rnn.SequentialRNNCell()
        for i in range(num_layers):
            stack.add(mx.rnn.LSTMCell(num_hidden=num_hidden,
                                      prefix="lstm_l%d_" % i))
        stack.reset()
        outputs, _states = stack.unroll(seq_len, inputs=embed,
                                        merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=vocab,
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def lm_corpus(vocab=BUCKET_VOCAB, buckets=BUCKET_KEYS, batch=BUCKET_BATCH,
              per_bucket=BUCKET_BATCHES, seed=SEED):
    """Synthetic sentences from ``seed``: ``per_bucket * batch`` of them a
    bucket, their lengths spread over the bucket's range, each a walk
    over word ids 1..vocab-1 whose next word is mostly a function of the
    last (0 is the padding)."""
    rng = np.random.default_rng(seed)
    sents, low = [], 1
    for b in buckets:
        for _ in range(per_bucket * batch):
            n = int(rng.integers(low, b + 1))
            w = [int(rng.integers(1, vocab))]
            for _ in range(n - 1):
                nxt = (w[-1] * 31 + int(rng.integers(0, 8))) % (vocab - 1)
                w.append(nxt + 1)
            sents.append(w)
        low = b + 1
    return sents


def lm_params(sym_gen, key, batch, seed=SEED):
    """numpy parameters of the bucketed LM from ``seed``: uniform in
    +-sqrt(3 / fan_in), biases 0."""
    sym = sym_gen(key)[0]
    arg_shapes, _, _ = sym.infer_shape(data=(batch, key),
                                       softmax_label=(batch, key))
    rng = np.random.RandomState(seed)
    out = {}
    for name, shp in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_bias"):
            out[name] = np.zeros(shp, np.float32)
        else:
            lim = math.sqrt(3.0 / shp[-1])
            out[name] = rng.uniform(-lim, lim, shp).astype(np.float32)
    return out


def _bucket_batch(mx, ctx, it, key):
    """The first batch of bucket ``key`` after a reset of ``it`` (whose
    bucket arrays are made anew on ``ctx``)."""
    with ctx:
        it.reset()
    for b in it:
        if b.bucket_key == key:
            return b
    raise AssertionError("no batch of bucket %d" % key)


def bucket_first_grads(mx, ctx, sym_gen, it, keys, batch, params):
    """Each bucket's first training step on ``ctx`` and on the CPU from the
    same numpy parameters: the largest gradient difference over each
    parameter's largest magnitude, a bucket."""
    out = {}
    for key in keys:
        b = _bucket_batch(mx, ctx, it, key)
        x, y = b.data[0].asnumpy(), b.label[0].asnumpy()
        grads = []
        for c in (ctx, mx.cpu()):
            sym = sym_gen(key)[0]
            mod = mx.mod.Module(sym, context=c)
            mod.bind(data_shapes=[("data", x.shape)],
                     label_shapes=[("softmax_label", y.shape)])
            arg, _ = mx.convert.params_from_numpy(params, {}, c, symbol=sym)
            mod.init_params(arg_params=arg, aux_params={})
            with c:
                mod.forward_backward(mx.io.DataBatch(
                    data=[mx.nd.array(x)], label=[mx.nd.array(y)]))
            grads.append({n: g[0].asnumpy() for n, g in zip(
                mod._exec_group.param_names, mod._exec_group.grad_arrays)})
        out[key] = max(largest_rel(grads[0][n], grads[1][n])
                       for n in grads[1])
    return out


def bucket_fit(mx, ck, ctx, sym_gen, it, epochs=BUCKET_EPOCHS, seed=SEED):
    """``BucketingModule.fit`` over ``it`` with ``kvstore="tpu"`` and Adam,
    the iterator's shuffles (Python's and numpy's generators) seeded: the
    launch counts reset just before and read just after, the mean
    cross-entropy of the first and of the last epoch (the same sentences)
    and, in the last epoch, each batch's time by bucket."""
    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    device = torch.device("cuda", ctx.device_id) \
        if ctx.device_type == "gpu" else torch.device("cpu")
    marks, ces = [], []

    def on_batch(param):
        b = param.locals["data_batch"]
        p = mod.get_outputs()[0]._data
        lab = b.label[0]._data.reshape(-1).long()
        ces.append(-p.gather(1, lab.view(-1, 1)).clamp_min(1e-12).log()
                   .mean())
        marks.append((param.epoch, b.bucket_key,
                      b.label[0].shape[0] * b.label[0].shape[1],
                      _marker(device)))

    mx.random.seed(seed)
    random.seed(seed)
    np.random.seed(seed)
    ck.reset_kernel_calls()
    with ctx:   # the iterator's reset makes its arrays on ctx
        it.reset()
        mod.fit(it, num_epoch=epochs, kvstore="tpu", optimizer="adam",
                optimizer_params=BUCKET_ADAM,
                eval_metric=mx.metric.Perplexity(0),
                initializer=mx.init.Xavier(factor_type="in",
                                           magnitude=2.34),
                batch_end_callback=on_batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    calls = ck.kernel_calls()
    ces = [float(c) for c in ces]
    by_bucket, tokens, total_ms = {}, 0, 0.0
    for prev, cur in zip(marks, marks[1:]):
        if cur[0] != epochs - 1 or prev[0] != epochs - 1:
            continue
        ms = _elapsed_ms(prev[3], cur[3])
        by_bucket.setdefault(cur[1], []).append(ms)
        tokens += cur[2]
        total_ms += ms
    per = len(ces) // epochs
    return mod, {
        "batches": len(ces), "calls": calls,
        "fused_exec": any(m._fused_exec_update
                          for m in mod._buckets.values()),
        "step_ms_by_bucket": {key: float(np.mean(v))
                              for key, v in sorted(by_bucket.items())},
        "tokens_per_s": tokens / total_ms * 1e3 if total_ms else None,
        "ce_first": float(np.mean(ces[:per])),
        "ce_last": float(np.mean(ces[-per:])),
        "buckets_bound": sorted(mod._buckets)}


def bucket_shared(mx, ctx, mod, it, big, small):
    """One step in bucket ``big``: bucket ``small``'s executor must hold
    the same NDArrays as ``big``'s and read the new weights bitwise."""
    exe_b = mod._buckets[big]._exec_group.execs[0]
    exe_s = mod._buckets[small]._exec_group.execs[0]
    names = mod._buckets[big]._exec_group.param_names
    before = {n: exe_s.arg_dict[n]._data.clone() for n in names}
    b = _bucket_batch(mx, ctx, it, big)
    mod.forward_backward(b)
    mod.update()
    return {"same_arrays": all(exe_s.arg_dict[n] is exe_b.arg_dict[n]
                               for n in names),
            "bitwise": all(torch.equal(exe_s.arg_dict[n]._data,
                                       exe_b.arg_dict[n]._data)
                           for n in names),
            "moved": sum(not torch.equal(before[n], exe_s.arg_dict[n]._data)
                         for n in names),
            "params": len(names)}


def pack_unrolled(params, mode, layers, bidirectional, prefix):
    """The ``FusedRNNCell`` parameter vector, in the ``RNN`` op's layout
    (all weights, layer-major with the direction inside, i2h then h2h;
    then all biases in the same order), from the parameters of the cells
    ``unfuse()`` gives (``<prefix>l<i>_`` forward, ``<prefix>r<i>_``
    backward)."""
    dirs = ("l", "r") if bidirectional else ("l",)
    cells = ["%s%s%d_" % (prefix, d, i) for i in range(layers) for d in dirs]
    ws = [params[c + k].reshape(-1) for c in cells
          for k in ("i2h_weight", "h2h_weight")]
    bs = [params[c + k].reshape(-1) for c in cells
          for k in ("i2h_bias", "h2h_bias")]
    lib = torch if isinstance(ws[0], torch.Tensor) else np
    return lib.concatenate(ws + bs) if lib is np else torch.cat(ws + bs)


def fused_vs_unrolled(mx, ctx, mode, bidirectional, layers, hidden, embed,
                      batch, t, seed=SEED):
    """A ``FusedRNNCell`` (the ``RNN`` op) against the unrolled cells of
    its ``unfuse()``, at the same weights packed into its vector: the
    forward outputs and, for random output gradients, the input and
    weight gradients, each as its largest difference over the largest
    magnitude."""
    prefix = "%s_" % mode
    cell = mx.rnn.FusedRNNCell(hidden, num_layers=layers, mode=mode,
                               bidirectional=bidirectional, prefix=prefix)
    data = mx.sym.var("data")
    fused, _ = cell.unroll(t, data, layout="NTC", merge_outputs=True)
    unrolled, _ = cell.unfuse().unroll(t, data, layout="NTC",
                                       merge_outputs=True)
    rng = np.random.RandomState(seed)
    shape = (batch, t, embed)
    ue = unrolled.simple_bind(ctx=ctx, grad_req="write", data=shape)
    fe = fused.simple_bind(ctx=ctx, grad_req="write", data=shape)
    uparams = {}
    for name, arr in ue.arg_dict.items():
        if name == "data":
            continue
        # torch's default RNN initialisation, U(-1/sqrt(H), 1/sqrt(H))
        lim = 1.0 / math.sqrt(hidden)
        uparams[name] = rng.uniform(-lim, lim, arr.shape).astype(np.float32)
        arr._data.copy_(torch.from_numpy(uparams[name]))
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    ue.arg_dict["data"]._data.copy_(torch.from_numpy(x))
    fe.arg_dict["data"]._data.copy_(torch.from_numpy(x))
    fe.arg_dict[prefix + "parameters"]._data.copy_(torch.from_numpy(
        pack_unrolled(uparams, mode, layers, bidirectional, prefix)))
    outs = [e.forward(is_train=True)[0].asnumpy() for e in (fe, ue)]
    g = rng.uniform(-1, 1, outs[1].shape).astype(np.float32)
    for e in (fe, ue):
        e.backward(out_grads=[mx.nd.array(g, ctx=ctx)])
    ugrads = {n: a.asnumpy() for n, a in ue.grad_dict.items()}
    return {"mode": mode, "bidirectional": bidirectional, "layers": layers,
            "hidden": hidden, "t": t,
            "output": largest_rel(outs[0], outs[1]),
            "data_grad": largest_rel(fe.grad_dict["data"].asnumpy(),
                                     ugrads["data"]),
            "param_grad": largest_rel(
                fe.grad_dict[prefix + "parameters"].asnumpy(),
                pack_unrolled(ugrads, mode, layers, bidirectional, prefix))}


def k2_lm_deviation(what, shape, y, ref):
    """``y``'s |difference| from ``ref`` (absolute, and over the largest
    probability) and its rows' distance from summing to 1; raises past
    ``K2_LM_TOL`` or on a value that is not finite."""
    err = (y - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    total = (y.sum(-1) - 1).abs().max().item()
    if not (rel <= K2_LM_TOL and total <= K2_LM_TOL
            and bool(torch.isfinite(y).all())):
        raise AssertionError("%s at %s: max |d| %g (%g of the largest; "
                             "limit %g), row sums off by %g"
                             % (what, shape, err, rel, K2_LM_TOL, total))
    return {"max_abs_err": err, "max_rel": rel, "row_sum_err": total}


def check_k2_lm(ck, dev, bw, flops, parent, shapes=K2_LM_SHAPES):
    """K2 at the LM's logits against its plain version (fp32, within
    ``K2_LM_TOL`` of the largest probability, rows summing to 1 within
    it) on logits from a seed: ``(worst, jobs)``, each job with its
    |difference|, its bound (bytes: read once, written once) and the
    four functions to time: the kernel, its plain version, torch.softmax
    and ``parent(x)``, K2 as the parent commit had it past 1024 columns
    (a call from ``time_variants.k2_call``, held to the same band)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    worst, jobs = 0.0, []
    for shape in shapes:
        x = torch.randn(shape, generator=gen, device=dev) * 3
        ref = ck.softmax_lastaxis_ref(x)
        job = k2_lm_deviation("K2", shape, ck.softmax_lastaxis(x), ref)
        k2_lm_deviation("the parent's K2", shape, parent(x)(), ref)
        worst = max(worst, job["max_abs_err"])
        b = bound_ms(2 * x.numel() * 4, 5 * x.numel(), bw, flops)
        jobs.append(dict(job, shape=shape, bound_ms=b[0], bound_by=b[1],
                         fns={"": lambda x=x: ck.softmax_lastaxis(x),
                              "plain_": lambda x=x: ck.softmax_lastaxis_ref(
                                  x),
                              "library_": lambda x=x: torch.softmax(x, -1),
                              "parent_": parent(x)}))
    return worst, jobs


def time_k2_lm(jobs, key, timer):
    for job in jobs:
        for pre in ("", "plain_", "library_", "parent_"):
            job[pre + key] = timer(job["fns"][pre])


# ---------------------------------------------------------------------------
# phase 18: gluon's image path
# ---------------------------------------------------------------------------
# example/gluon/image_classification.py's loop on the port: model-zoo
# ResNet-50 v1, Xavier, hybridize(), per-array SGD with momentum through
# gluon.Trainer, SoftmaxCrossEntropyLoss under autograd.record(), batches
# from a DataLoader over phase 17's .rec with ImageNet's augmentation
GLUON_SGD = {"learning_rate": 0.05, "momentum": 0.9}
GLUON_MEAN = (0.485, 0.456, 0.406)
GLUON_STD = (0.229, 0.224, 0.225)
GLUON_WARMUP = 3            # untimed steps, the first one held to the CPU
GLUON_STEPS = 10            # timed steps
GLUON_WORKERS = 4           # the DataLoader's threads
GLUON_SERVE = 4             # SymbolBlock forwards counted and compared
# The falling loss is the example's own: it trains on one fixed batch.
# On the DataLoader's batches at lr 0.05 and momentum 0.9 the loss on a
# fixed batch spikes (to 213 from ~9 in traced runs) and in 5 of 12 traced
# runs its median over the last 3 of the 10 timed steps lay above that
# over the first 3; 10 steps on the fixed batch itself after the timed
# ones fell in 8 of 8.  Its median over the first GLUON_LOSS_WINDOW of
# those steps is held above that over the last.
GLUON_LOSS_WINDOW = 3


def gluon_loader(mx, path, image, batch, workers=GLUON_WORKERS):
    """The DataLoader of phase 18: ``ImageRecordDataset`` of ``path``
    through ``transform_first(Compose([RandomResizedCrop, RandomFlip,
    ToTensor, Normalize]))``, shuffled, the short last batch discarded."""
    t = mx.gluon.data.vision.transforms
    aug = t.Compose([t.RandomResizedCrop(image[1]), t.RandomFlipLeftRight(),
                     t.ToTensor(), t.Normalize(GLUON_MEAN, GLUON_STD)])
    ds = mx.gluon.data.vision.ImageRecordDataset(path).transform_first(aug)
    return mx.gluon.data.DataLoader(ds, batch_size=batch, shuffle=True,
                                    last_batch="discard", num_workers=workers)


def gluon_resnet(mx, ctx, layers=LAYERS, classes=CLASSES, seed=SEED):
    """Model-zoo ResNet v1 of ``layers`` layers, Xavier on ``ctx`` (drawn
    at the first forward: the shapes are deferred), hybridized."""
    mx.random.seed(seed)
    with mx.name.NameManager():
        net = mx.gluon.model_zoo.vision.get_resnet(1, layers, classes=classes)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    return net


def _batchnorms(block):
    found = [block] if type(block).__name__ == "BatchNorm" else []
    for child in block._children.values():
        found += _batchnorms(child)
    return found


@contextlib.contextmanager
def bn_inputs(net, seen):
    """Within the block each BatchNorm of ``net`` appends ``(block, its
    input, running mean, running var)`` to ``seen`` as it runs, copied on
    their device before the op moves the statistics."""
    bns = _batchnorms(net)
    for bn in bns:
        def hybrid_forward(F, x, gamma, beta, running_mean, running_var,
                           bn=bn, orig=bn.hybrid_forward):
            seen.append((bn, x._data.detach().clone(),
                         running_mean._data.clone(),
                         running_var._data.clone()))
            return orig(F, x, gamma, beta, running_mean, running_var)
        bn.hybrid_forward = hybrid_forward
    try:
        yield bns
    finally:
        for bn in bns:
            del bn.hybrid_forward


def gluon_first_step(mx, net, trainer, loss_fn, x, y, batch):
    """The first training step, held to the CPU as phase 16 holds its
    updates: the Trainer's SGD replayed on CPU tensors from the card's
    weights and gradients (the updater's pickled optimizer, ``rescale_grad``
    as the step set it), and each BatchNorm's moving-statistics update
    replayed by the ``BatchNorm`` op on the CPU from the same input and
    statistics the card's op had.  Returns the largest distances from
    the card's, relative to each array's largest magnitude."""
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.ndarray import NDArray
    seen = []
    with bn_inputs(net, seen):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
    params = trainer._params
    live = [i for i, p in enumerate(params) if p.grad_req != "null"]
    w = {i: _host(params[i].data()) for i in live}
    g = {i: _host(params[i].grad()) for i in live}
    blob = trainer._updater.get_states(dump_optimizer=True)
    trainer.step(batch)
    cpu = opt_mod.get_updater(None)
    cpu.set_states(blob)
    cpu.optimizer.rescale_grad = trainer._optimizer.rescale_grad
    weights, states = [], []
    for i in live:
        cw = NDArray(w[i].clone())
        cpu(i, NDArray(g[i]), cw)
        weights.append(largest_rel(_host(params[i].data()).numpy(),
                                   cw._data.numpy()))
        for a, b in zip(_state_tensors(trainer._updater.states[i]),
                        _state_tensors(cpu.states[i])):
            states.append(largest_rel(a.numpy(), b.numpy()))
    stats = []
    for bn, xin, mean, var in seen:
        m, v = NDArray(mean.cpu()), NDArray(var.cpu())
        c = xin.shape[bn._axis]
        with mx.autograd.train_mode():
            mx.nd.BatchNorm(NDArray(xin.cpu()), mx.nd.ones((c,), ctx=mx.cpu()),
                            mx.nd.zeros((c,), ctx=mx.cpu()), m, v,
                            **bn._kwargs)
        stats.append(max(
            largest_rel(_host(bn.running_mean.data()).numpy(),
                        m._data.numpy()),
            largest_rel(_host(bn.running_var.data()).numpy(),
                        v._data.numpy())))
    return {"loss": float(loss.mean().asscalar()),
            "weights": len(weights), "weights_max_rel": max(weights),
            "momentum_max_rel": max(states) if states else 0.0,
            "batchnorms": len(stats), "running_stats_max_rel": max(stats)}


def gluon_train(mx, ck, ctx, path, image, batch, layers=LAYERS,
                classes=CLASSES, warmup=GLUON_WARMUP, steps=GLUON_STEPS,
                workers=GLUON_WORKERS, seed=SEED):
    """Phase 18 (a)-(c): ``warmup`` steps (the first held to the CPU by
    ``gluon_first_step``), then ``steps`` timed by CUDA events from one
    batch fetch to the next (the loader's wait included; the host's wait
    for the loader is reported beside), an eval forward of the next batch
    held to the same network's forward on the CPU, and then, as
    example/gluon/image_classification.py trains, ``steps`` more on the
    first batch alone, untimed, whose losses must fall.  Returns
    ``(net, trainer, loss_fn, (x, y), record)``."""
    np.random.seed(seed)        # the sampler's shuffle, the crops and flips
    net = gluon_resnet(mx, ctx, layers, classes, seed)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_SGD))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loader = gluon_loader(mx, path, image, batch, workers)
    with mx.cpu():
        batches = iter(loader)
    waits = []

    def fetch():
        t0 = time.perf_counter()
        data, label = next(batches)
        waits.append(time.perf_counter() - t0)
        return data.as_in_context(ctx), label.as_in_context(ctx)

    def step(x, y):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(batch)

    x0, y0 = fetch()
    first = gluon_first_step(mx, net, trainer, loss_fn, x0, y0, batch)
    for _ in range(warmup - 1):
        step(*fetch())
    device = x0._data.device
    _sync(device)
    waits.clear()
    marks = [_marker(device)]
    for _ in range(steps):
        step(*fetch())
        marks.append(_marker(device))
    _sync(device)
    ms = [_elapsed_ms(a, b) for a, b in zip(marks, marks[1:])]
    xe, ye = fetch()
    logits = _host(net(xe)).numpy()
    cpu_net = gluon_resnet(mx, mx.cpu(), layers, classes, seed)
    mx.convert.block_params_from_numpy(
        cpu_net, {k: _host(p.data()).numpy()
                  for k, p in net.collect_params().items()}, ctx=mx.cpu())
    cpu_logits = cpu_net(mx.nd.NDArray(_host(xe))).asnumpy()
    ces = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(x0), y0)
        loss.backward()
        trainer.step(batch)
        ces.append(loss.mean()._data)
    ces = [float(c) for c in ces]
    k = GLUON_LOSS_WINDOW
    params = net.collect_params().values()
    rec = {"layers": layers, "batch": batch, "image": list(image),
           "parameters": int(sum(int(np.prod(p.shape)) for p in params)),
           "parameter_arrays_updated": sum(p.grad_req != "null"
                                           for p in params),
           "first_step": first, "warmup": warmup, "steps": steps,
           "step_ms": float(np.median(ms)) if ms else None,
           "step_ms_all": ms, "images_per_s": batch * steps / sum(ms) * 1e3,
           "loader_wait_ms": float(np.median(waits)) * 1e3,
           "ce_first": float(np.median(ces[:k])),
           "ce_last": float(np.median(ces[-k:])), "ce": ces,
           "eval_logits_max_rel": largest_rel(logits, cpu_logits),
           "eval_shape": list(logits.shape), "workers": workers,
           "data_on": str(x0._data.device)}
    return net, trainer, loss_fn, (x0, y0), rec


def gluon_symbol_block(mx, ck, ctx, sym, image, batch, workdir,
                       n=GLUON_SERVE, seed=SEED):
    """Phase 18 (d): ``sym`` with ``he_params`` written by
    ``model.save_checkpoint``, served through ``SymbolBlock.imports``
    (inputs ``data`` and ``softmax_label``) and through a ``Predictor``
    bound at the same batch from the same files: ``n`` batches, each
    answer compared bitwise, the kernels' launches counted over the
    block's forwards alone."""
    arg, aux = he_params(sym, image, seed)
    prefix = os.path.join(workdir, "symbolblock")
    mx.model.save_checkpoint(
        prefix, 0, sym, {k: mx.nd.array(v, ctx=ctx) for k, v in arg.items()},
        {k: mx.nd.array(v, ctx=ctx) for k, v in aux.items()})
    with ctx:
        block = mx.gluon.SymbolBlock.imports(
            prefix + "-symbol.json", ["data", "softmax_label"],
            prefix + "-0000.params", ctx=ctx)
        pred = mx.Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": (batch,) + tuple(image)},
                            dev_type=ctx.device_type, dev_id=ctx.device_id)
        rng = np.random.RandomState(seed + 18)
        xs = [mx.nd.array(rng.rand(batch, *image).astype(np.float32))
              for _ in range(n)]
        label = mx.nd.zeros((batch,))
        block(xs[0], label)                 # binds the executor
        ck.reset_kernel_calls()
        got = [_host(block(x, label)) for x in xs]
        calls = ck.kernel_calls()
        want = [_host(pred.forward(data=x).get_output(0)) for x in xs]
    return {"forwards": n, "batch": batch,
            "bitwise": sum(bool(torch.equal(a, b))
                           for a, b in zip(got, want)),
            "max_abs_diff": max(float((a - b).abs().max())
                                for a, b in zip(got, want)),
            "launches": {k: v for k, v in calls.items() if v},
            "launches_per_forward": {k: v / n for k, v in calls.items()
                                     if v}}


def gluon_profile(mx, net, trainer, loss_fn, batch_xy, batch, step_ms):
    """One training step under the profiler: the forward and backward by
    kind, ``Trainer.step`` (per-array SGD) as the optimizer's share, the
    idle share beside ``step_ms`` measured without the profiler; None
    when the trace holds no device time."""
    x, y = batch_xy

    def fb():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()

    fwd_bwd = device_times(fb, n=1)
    opt = device_times(lambda: trainer.step(batch), n=1)
    busy = sum(fwd_bwd.values()) + sum(opt.values())
    if busy <= 0:
        return None
    kinds = by_kind(fwd_bwd)
    kinds["optimizer (Trainer.step, per-array SGD)"] = sum(opt.values())
    return {"busy_us": busy, "idle_share": max(0.0, 1 - busy
                                               / (step_ms * 1e3)),
            "optimizer_us": sum(opt.values()),
            "optimizer_share_of_busy": sum(opt.values()) / busy,
            "by_kind": kinds,
            "top": sorted(fwd_bwd.items(), key=lambda kv: -kv[1])[:8]}


# ---------------------------------------------------------------------------
# phase 19: telemetry, tracing and the profiler on the two main paths, and
# gluon.rnn's LSTM language model
# ---------------------------------------------------------------------------
OBS_WARMUP = 3              # untimed steps of each telemetry fit
OBS_STEPS = 10              # timed steps
# the fits of phase 19 (a), in this order: telemetry, the step log and
# tracing on and all off, in turns, then all of them and the profiler's
# device trace (last: a profiler session slows the host after it)
OBS_RUNS = ("on", "off", "off", "on", "profiled")
# kernel counter labels (the JAX package's) -> fragments of the names of
# the kernels the device trace must hold as many of
OBS_KERNELS = {"fused_sgd_momentum": ("sweep_kernel",),
               "fused_softmax_fwd": dict(SOFTMAX_KINDS)["K2"],
               "fused_scale_bias_relu": ("scale_bias_relu",)}
# Zaremba, Sutskever & Vinyals 2014, "Recurrent Neural Network
# Regularization" §4.1, the medium model: two LSTM layers of 650 units over
# 650-wide embeddings, 35 unrolled steps, batch 20, dropout 0.5 on the
# non-recurrent connections, PTB's 10,000 words, weights U(-0.05, 0.05),
# SGD lr 1 on the loss summed over steps and averaged over the batch, its
# gradient clipped to norm 5.  Layout of example/gluon/word_language_model
LSTM_LM = {"vocab": 10000, "hidden": 650, "layers": 2, "steps": 35,
           "batch": 20, "dropout": 0.5, "lr": 1.0, "clip": 5.0,
           "init": 0.05}
LSTM_LM_WARMUP = 3          # untimed steps from the stream
LSTM_LM_TIMED = 10          # timed steps
LSTM_LM_FIXED = 10          # steps on the first batch alone
LSTM_LM_WINDOW = 3          # losses averaged at each end of those
# The first step (dropout 0, the same parameters) on the card against the
# port's CPU replay: loss and every parameter's gradient within this much
# of its largest magnitude.  Both are fp32 with sums in other orders (the
# decoder's input gradient sums 10,000 terms, the weight gradients 700
# tokens, the LSTM's 35 steps feed back): ~sqrt(n) u = 1e-5 at worst, and
# cuDNN's LSTM is exact to fp32 rounding (FUSED_TOL's 3.3e-7 to 3.8e-7 at
# hidden 200).  A wrong gate order, a dropout left on or a lost state is
# off by the values themselves.
LSTM_LM_TOL = 1e-4


def _families(snap, name, key):
    """``{label value: value}`` of family ``name`` in a telemetry
    snapshot, by label ``key``."""
    fam = snap.get(name, {"values": []})
    return {v["labels"].get(key): v["value"] for v in fam["values"]}


def _total(snap, name, **labels):
    """The sum of a counter family's series whose labels hold
    ``labels``."""
    fam = snap.get(name, {"values": []})
    return sum(v["value"] for v in fam["values"]
               if all(v["labels"].get(k) == x for k, x in labels.items()))


def dump_counts(dump, kernels=OBS_KERNELS):
    """What a profiler dump holds: its ``fit.step`` and
    ``serving:batch`` spans, ``'C'`` counter events, device events, and
    the device kernels of each ``kernels`` label."""
    evs = dump["traceEvents"]
    device = [e for e in evs if e.get("pid") == "device"]
    out = {"fit.step": sum(1 for e in evs if e["name"] == "fit.step"),
           "serving:batch": sum(1 for e in evs
                                if e["name"] == "serving:batch"),
           "serving.request": sum(1 for e in evs
                                  if e["name"] == "serving.request"),
           "counters": sum(1 for e in evs if e["ph"] == "C"),
           "device_events": len(device)}
    out["launches"] = {label: sum(1 for e in device
                                  if e.get("cat") == "kernel"
                                  and any(f in e["name"] for f in frags))
                       for label, frags in kernels.items()}
    return out


class observed:
    """Telemetry (the registry reset; with ``counters``, the hot paths'
    recording on; the step log at ``log`` where given), tracing (with
    ``spans``, every trace kept) and, with ``trace_dir``, the profiler
    with its device trace, on for a block; all off after it."""

    def __init__(self, mx, log=None, trace_dir=None, counters=True,
                 spans=True):
        self.mx, self.log, self.trace_dir = mx, log, trace_dir
        self.counters, self.spans = counters, spans
        self.dump = None

    def __enter__(self):
        from mxnet_tpu_torch.telemetry import tracing
        mx = self.mx
        mx.telemetry.reset()
        tracing.reset()
        if self.counters:
            mx.telemetry.enable()
        if self.spans:
            tracing.enable(sample=1.0, seed=SEED)
        if self.log is not None:
            if os.path.exists(self.log):
                os.remove(self.log)
            os.environ["MXNET_TELEMETRY_STEP_LOG"] = self.log
        if self.trace_dir is not None:
            mx.profiler.set_config(
                jax_trace_dir=self.trace_dir,
                filename=os.path.join(self.trace_dir, "profile.json"))
            mx.profiler.set_state("run")
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.telemetry import tracing
        mx = self.mx
        if self.trace_dir is not None:
            mx.profiler.set_state("stop")
            self.dump = json.loads(mx.profiler.dumps(reset=True))
        os.environ.pop("MXNET_TELEMETRY_STEP_LOG", None)
        mx.telemetry.disable()
        tracing.disable()
        tracing.reset()


def telemetry_fit(mx, ck, ctx, sym, image, batch=BATCH, warmup=OBS_WARMUP,
                  steps=OBS_STEPS, classes=CLASSES, workdir="."):
    """Phase 19 (a): ``train``'s fit from one initialisation, the runs of
    ``OBS_RUNS`` in turns, cuDNN deterministic.  The profiled run's step
    log, registry, exposition and dump are read; its weights are held to
    the first run with everything off, bitwise."""
    from mxnet_tpu_torch import telemetry
    arg, aux = initial_params(mx, ctx, sym, image, batch)
    log = os.path.join(workdir, "steps.jsonl")
    trace_dir = os.path.join(workdir, "trace")
    step_ms = {"profiled": [], "on": [], "off": []}
    params, out = {}, {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in OBS_RUNS:
            scope = (observed(mx, log, trace_dir) if mode == "profiled"
                     else observed(mx, log) if mode == "on"
                     else contextlib.nullcontext())
            with scope as obs:
                mod, res = train(mx, ck, ctx, sym, image, batch, steps,
                                 warmup, arg_params=arg, aux_params=aux,
                                 classes=classes)
                snap = telemetry.snapshot()
                text = telemetry.prometheus_text()
            step_ms[mode].append(res["step_ms"])
            if mode not in params:
                a, x = mod.get_params()
                params[mode] = {k: v.asnumpy() for k, v in
                                list(a.items()) + list(x.items())}
            if mode != "profiled":
                continue
            with open(log) as f:
                lines = [json.loads(l) for l in f]
            try:
                telemetry.validate_exposition(text)
                valid = True
            except ValueError:
                valid = False
            out.update(
                step_lines=len(lines),
                step_keys=sorted(lines[0]) if lines else [],
                compiles_first=lines[0].get("mxnet_xla_compiles_delta")
                if lines else None,
                compiles_after_first=sum(
                    l.get("mxnet_xla_compiles_delta", 0) for l in lines[1:]),
                counter=_families(snap, "mxnet_pallas_kernel_calls_total",
                                  "kernel"),
                launches=res["calls"], exposition_valid=valid,
                exposition_bytes=len(text), dump=dump_counts(obs.dump),
                device_trace_mb=os.path.getsize(os.path.join(
                    trace_dir, "device-trace-%d.json" % os.getpid())) / 1e6)
            prof_mod = mod
    finally:
        torch.backends.cudnn.deterministic = saved
    out["weights_bitwise"] = all(
        np.array_equal(params["profiled"][k], params["off"][k])
        for k in params["off"]) and params["on"].keys() == \
        params["off"].keys() and all(
        np.array_equal(params["on"][k], params["off"][k])
        for k in params["off"])
    on, off = np.mean(step_ms["on"]), np.mean(step_ms["off"])
    out.update(step_ms=step_ms, step_ms_on=float(on), step_ms_off=float(off),
               cost=float(on / off - 1), steps=warmup + steps)
    if ctx.device_type == "gpu":
        prof = step_profile(prof_mod, synthetic_iter(
            mx, ctx, batch, image, 1, classes=classes).next(), on)
        out["idle_share"] = prof["idle_share"] if prof else None
        out["step_busy_us"] = prof["busy_us"] if prof else None
    return out


def telemetry_serve(mx, ck, ctx, sym, image, n_sites, max_batch=BATCH,
                    n_requests=REQUESTS, n_clients=CLIENTS, seed=SEED,
                    classes=CLASSES, workdir="."):
    """Phase 19 (b): phase 4's load through ``ModelServer`` with
    telemetry, tracing and the profiler on: ``stats()`` against the
    registry's ``mxnet_serving_*`` families, the cache's misses against
    the executor's compiles, the kernel counter against the device
    trace."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import ModelServer
    arg, aux = he_params(sym, image, seed)
    args, auxs = mx.convert.params_from_numpy(arg, aux, ctx, symbol=sym)
    del arg, aux
    rng = np.random.RandomState(seed + 1)
    xs = [rng.randn(rng.randint(1, 4), *image).astype(np.float32)
          for _ in range(n_requests)]
    answers, errors = [None] * n_requests, []

    def client(k):
        try:
            for i in range(k, n_requests, n_clients):
                answers[i] = srv.infer("resnet", {"data": xs[i]},
                                       timeout_ms=120000.0)[0]
        except Exception as exc:    # noqa: BLE001 — re-raised below
            errors.append(exc)

    with observed(mx, trace_dir=os.path.join(workdir, "serve")) as obs:
        ck.reset_kernel_calls()
        srv = ModelServer(max_batch=max_batch, ctx=ctx)
        srv.add_model("resnet", sym, args, auxs,
                      {"data": (1,) + tuple(image)})
        srv.start()
        try:
            warmed = srv.warmup("resnet")
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            srv.stop()
        snap = telemetry.snapshot()
        text = telemetry.prometheus_text()
    if errors:
        raise errors[0]
    telemetry.validate_exposition(text)
    st = srv.stats()
    req, cache = st["requests"], st["executor_cache"]
    agree = {
        "submitted": (req["submitted"],
                      _total(snap, "mxnet_serving_requests_total",
                             outcome="submitted")),
        "served": (req["served"], _total(
            snap, "mxnet_serving_requests_total", outcome="served")),
        "batches": (st["batches"]["count"],
                    _total(snap, "mxnet_serving_batches_total")),
        "rows": (st["batches"]["rows"],
                 _total(snap, "mxnet_serving_batch_rows_total")),
        "hits": (cache["hits"], _total(
            snap, "mxnet_serving_cache_events_total", outcome="hit")),
        "misses": (cache["misses"], _total(
            snap, "mxnet_serving_cache_events_total", outcome="miss")),
        "latency_count": (len([a for a in answers if a is not None])
                          + len(warmed),
                          snap["mxnet_serving_latency_ms"]["values"][0]
                          ["count"])}
    forwards = st["batches"]["count"]
    counter = _families(snap, "mxnet_pallas_kernel_calls_total", "kernel")
    finite = all(a is not None and a.shape == (x.shape[0], classes)
                 and np.isfinite(a).all() for a, x in zip(answers, xs))
    return {"requests": n_requests, "warmup": len(warmed),
            "batches": forwards,
            "stats_agree": all(a == b for a, b in agree.values()),
            "agree": agree, "misses": cache["misses"],
            "compiles": _total(snap, "mxnet_xla_compiles_total"),
            "counter": counter, "launches": ck.kernel_calls(),
            "counter_per_forward": {k: v / forwards
                                    for k, v in counter.items()},
            "dump": dump_counts(obs.dump), "finite": finite,
            "exposition_bytes": len(text)}


def lstm_vs_cells(mx, ctx, hidden=LSTM_LM["hidden"], embed=LSTM_LM["hidden"],
                  batch=LSTM_LM["batch"], steps=LSTM_LM["steps"], seed=SEED):
    """``gluon.rnn.LSTM(hidden, num_layers=2)`` against an unrolled
    ``SequentialRNNCell`` of two ``LSTMCell``s with the same weights, on
    ``ctx`` in predict mode: the outputs and final states, each as its
    largest difference over its largest magnitude."""
    rng = np.random.RandomState(seed)
    with mx.Context(ctx):
        with mx.name.NameManager():
            lstm = mx.gluon.rnn.LSTM(hidden, num_layers=2, layout="TNC",
                                     input_size=embed, prefix="lstm_")
            cells = mx.gluon.rnn.SequentialRNNCell(prefix="cells_")
            with cells.name_scope():
                for i in range(2):
                    cells.add(mx.gluon.rnn.LSTMCell(
                        hidden, input_size=embed if i == 0 else hidden,
                        prefix="l%d_" % i))
        lim = 1.0 / math.sqrt(hidden)
        lstm_arrays = {
            n: rng.uniform(-lim, lim, p.shape).astype(np.float32)
            for n, p in lstm.collect_params().items()}
        mx.convert.block_params_from_numpy(lstm, lstm_arrays, ctx=ctx)
        mx.convert.block_params_from_numpy(cells, {
            "cells_l%d_%s" % (i, kind): lstm_arrays["lstm_l%d_%s" % (i, kind)]
            for i in range(2) for kind in ("i2h_weight", "h2h_weight",
                                           "i2h_bias", "h2h_bias")}, ctx=ctx)
        x = mx.nd.array(rng.uniform(-1, 1, (steps, batch, embed))
                        .astype(np.float32))
        begin = [mx.nd.array(rng.uniform(-1, 1, (2, batch, hidden))
                             .astype(np.float32)) for _ in range(2)]
        out, (h, c) = lstm(x, begin)
        cell_begin = [begin[k][i:i + 1].reshape((batch, hidden))
                      for i in range(2) for k in range(2)]
        outs, states = cells.unroll(steps, x, begin_state=cell_begin,
                                    layout="TNC", merge_outputs=True)
    fused_states = np.concatenate([h.asnumpy(), c.asnumpy()], 0)
    cell_states = np.stack([states[k].asnumpy() for k in (0, 2, 1, 3)])
    return {"output": largest_rel(out.asnumpy(), outs.asnumpy()),
            "states": largest_rel(fused_states, cell_states)}


def lstm_lm_model(mx, vocab, hidden, layers, dropout):
    """The LM of example/gluon/word_language_model (RNNModel, tied
    weights off): Embedding, dropout, LSTM (TNC), dropout, Dense over the
    vocabulary; ``net(tokens, state) -> (logits, state)``."""
    class LSTMLM(mx.gluon.Block):
        def __init__(self):
            super().__init__(prefix="lstmlm_")
            with self.name_scope():
                self.embedding = mx.gluon.nn.Embedding(vocab, hidden)
                self.drop = mx.gluon.nn.Dropout(dropout)
                self.rnn = mx.gluon.rnn.LSTM(hidden, num_layers=layers,
                                             dropout=dropout, layout="TNC",
                                             input_size=hidden)
                self.decoder = mx.gluon.nn.Dense(vocab, flatten=False,
                                                 in_units=hidden)

        def forward(self, x, state):
            out, state = self.rnn(self.drop(self.embedding(x)), state)
            return self.decoder(self.drop(out)), state

    return LSTMLM()


def lm_stream(vocab, steps, batch, n_batches, seed=SEED):
    """``n_batches`` (x, y) pairs of (steps, batch) token ids cut from one
    synthetic corpus as the example's batchify does: word ids drawn from
    Zipf's law over the vocabulary (PTB's rank-frequency shape), from
    ``seed``."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    n = steps * n_batches + 1
    corpus = rng.choice(vocab, size=n * batch, p=p / p.sum())
    cols = corpus.reshape(batch, n).T.astype(np.float32)
    return [(cols[i * steps:(i + 1) * steps],
             cols[i * steps + 1:(i + 1) * steps + 1])
            for i in range(n_batches)]


def lm_train_step(mx, net, trainer, loss_fn, params, x, y, state, clip,
                  vocab, batch):
    """One step as the example's train loop: the state detached, the loss
    summed over the steps' tokens (averaged over the batch by
    ``trainer.step(batch)``), the gradients clipped to ``clip`` of that
    average.  Returns the per-token losses and the new state."""
    state = [s.detach() for s in state]
    with mx.autograd.record():
        out, state = net(x, state)
        loss = loss_fn(out.reshape((-1, vocab)), y.reshape((-1,)))
    loss.backward()
    mx.gluon.utils.clip_global_norm([p.grad() for p in params],
                                    clip * batch)
    trainer.step(batch)
    return loss, state


def lstm_lm_first_step(mx, ctx, cfg, x, y, seed=SEED):
    """The first step's loss and gradients, dropout 0, on ``ctx`` against
    a replay on the CPU from the same parameters: the largest distance of
    each over its largest magnitude."""
    res = {}
    for where in (ctx, mx.cpu()):
        with mx.Context(where):
            with mx.name.NameManager():
                net = lstm_lm_model(mx, cfg["vocab"], cfg["hidden"],
                                    cfg["layers"], 0.0)
            mx.random.seed(seed)
            net.initialize(mx.init.Uniform(cfg["init"]))
            if res:
                mx.convert.block_params_from_numpy(
                    net, res["params"], ctx=where)
            state = net.rnn.begin_state(x.shape[1])
            with mx.autograd.record():
                out, _ = net(mx.nd.array(x), state)
                loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                    out.reshape((-1, cfg["vocab"])),
                    mx.nd.array(y).reshape((-1,)))
            loss.backward()
            got = {"loss": loss.asnumpy(), "grads": {
                k: p.grad().asnumpy() for k, p in
                net.collect_params().items()}}
        if not res:
            res = dict(got, params={k: p.data().asnumpy() for k, p in
                                    net.collect_params().items()})
        else:
            res["replay"] = got
    grad_rel = {k: largest_rel(res["grads"][k], res["replay"]["grads"][k])
                for k in res["grads"]}
    return {"loss": float(res["loss"].mean()),
            "loss_rel": largest_rel(res["loss"], res["replay"]["loss"]),
            "grad_max_rel": max(grad_rel.values()),
            "worst_param": max(grad_rel, key=grad_rel.get)}


def lstm_lm_kinds(mx, net, trainer, loss_fn, params, x, y, state, cfg,
                  n=5):
    """Device time of the LM step's parts, each alone by the profiler
    (cuDNN's LSTM runs its products as cuBLAS GEMMs, so kernel names do
    not tell the LSTM's from the decoder's): the LSTM's training
    forward, its forward and backward, the decoder's forward and
    backward, the loss's, the clipping and per-array SGD
    (``Trainer.step``), in us."""
    emb = net.embedding(x).detach()
    hid = mx.nd.array(np.random.RandomState(SEED).randn(
        x.shape[0], x.shape[1], cfg["hidden"]).astype(np.float32),
        ctx=x.context)
    logits = net.decoder(hid).reshape((-1, cfg["vocab"])).detach()
    yf = y.reshape((-1,))

    def rnn_fwd():
        with mx.autograd.record():
            net.rnn(emb, state)

    def rnn_fwd_bwd():
        with mx.autograd.record():
            out, _ = net.rnn(emb, state)
            s = out.sum()
        s.backward()

    def decoder():
        with mx.autograd.record():
            s = net.decoder(hid).sum()
        s.backward()

    def loss():
        logits.attach_grad()
        with mx.autograd.record():
            v = loss_fn(logits, yf)
        v.backward()

    def clip():
        mx.gluon.utils.clip_global_norm([p.grad() for p in params],
                                        cfg["clip"] * cfg["batch"])

    def sgd():
        trainer.step(cfg["batch"])

    us = {}
    for name, fn in (("LSTM forward (cuDNN)", rnn_fwd),
                     ("LSTM forward+backward (cuDNN)", rnn_fwd_bwd),
                     ("decoder forward+backward (GEMM)", decoder),
                     ("loss forward+backward", loss),
                     ("clip_global_norm", clip),
                     ("Trainer.step (per-array SGD)", sgd)):
        us[name] = sum(device_times(fn, n=n).values())
    us["LSTM backward (cuDNN)"] = (us["LSTM forward+backward (cuDNN)"]
                                   - us["LSTM forward (cuDNN)"])
    return us


def lstm_lm(mx, ck, ctx, vocab=LSTM_LM["vocab"], hidden=LSTM_LM["hidden"],
            batch=LSTM_LM["batch"], steps=LSTM_LM["steps"],
            warmup=LSTM_LM_WARMUP, timed=LSTM_LM_TIMED,
            fixed=LSTM_LM_FIXED, seed=SEED):
    """Phase 19 (c): the medium LSTM LM trained by ``gluon.Trainer`` on
    ``ctx``: its first step held to the CPU (dropout 0), ``warmup`` +
    ``timed`` steps over the stream with the state carried and detached,
    then ``fixed`` steps on the first batch alone, whose loss must fall;
    on the card, the step's device busy time and its parts'."""
    cfg = dict(LSTM_LM, vocab=vocab, hidden=hidden, batch=batch,
               steps=steps)
    data = lm_stream(vocab, steps, batch, warmup + timed, seed)
    first = lstm_lm_first_step(mx, ctx, cfg, *data[0], seed=seed)
    device = torch.device("cuda", ctx.device_id) \
        if ctx.device_type == "gpu" else torch.device("cpu")
    ck.reset_kernel_calls()
    with mx.Context(ctx):
        with mx.name.NameManager():
            net = lstm_lm_model(mx, vocab, hidden, cfg["layers"],
                                cfg["dropout"])
        mx.random.seed(seed)
        net.initialize(mx.init.Uniform(cfg["init"]))
        params = [p for p in net.collect_params().values()
                  if p.grad_req != "null"]
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": cfg["lr"]})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        batches = [(mx.nd.array(x), mx.nd.array(y)) for x, y in data]
        state = net.rnn.begin_state(batch)
        losses, marks = [], []
        for i, (x, y) in enumerate(batches):
            if i == warmup:
                marks.append(_marker(device))
            loss, state = lm_train_step(mx, net, trainer, loss_fn, params,
                                        x, y, state, cfg["clip"], vocab,
                                        batch)
            losses.append(loss)
        marks.append(_marker(device))
        step_ms = _elapsed_ms(marks[0], marks[1]) / timed
        losses = [float(v.mean().asscalar()) for v in losses]
        x0, y0 = batches[0]
        fixed_losses = []
        for _ in range(fixed):
            loss, _ = lm_train_step(mx, net, trainer, loss_fn, params, x0,
                                    y0, net.rnn.begin_state(batch),
                                    cfg["clip"], vocab, batch)
            fixed_losses.append(float(loss.mean().asscalar()))
        out = {"first_step": first, "losses": losses,
               "fixed_losses": fixed_losses,
               "fixed_first": float(np.median(fixed_losses[:LSTM_LM_WINDOW])),
               "fixed_last": float(np.median(fixed_losses[-LSTM_LM_WINDOW:])),
               "step_ms": step_ms, "tokens_per_s": steps * batch / step_ms
               * 1e3, "launches": ck.kernel_calls(),
               "parameters": sum(int(np.prod(p.shape)) for p in params),
               "vs_cells": lstm_vs_cells(mx, ctx, hidden, hidden, batch,
                                         steps, seed)}
        if device.type == "cuda":
            x, y = batches[-1]

            def step():
                lm_train_step(mx, net, trainer, loss_fn, params, x, y,
                              state, cfg["clip"], vocab, batch)

            by_name = device_times(step, n=1)
            busy = sum(by_name.values())
            out.update(
                step_busy_us=busy,
                idle_share=max(0.0, 1 - busy / (step_ms * 1e3))
                if busy else None,
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
                parts_us=lstm_lm_kinds(mx, net, trainer, loss_fn, params,
                                       x, y, state, cfg))
    return out


def observability_phase(mx, ck, ctx, sym, n_sites, n_buckets, smi):
    """Phase 19 on ``ctx``: (a) ``telemetry_fit``, (b) ``telemetry_serve``,
    (c) ``lstm_lm``, each held to its limits (raises otherwise) and
    printed.  Returns the phase's JSON record."""
    import tempfile
    t19 = time.perf_counter()
    obs_dir = tempfile.TemporaryDirectory(
        prefix=".chip_smoke_obs_",
        dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        fit19 = telemetry_fit(mx, ck, ctx, sym, IMAGE,
                              workdir=obs_dir.name)
        srv19 = telemetry_serve(mx, ck, ctx, sym, IMAGE, n_sites,
                                workdir=obs_dir.name)
    finally:
        obs_dir.cleanup()
    total19 = fit19["steps"]
    want_fit = {"fused_sgd_momentum": n_buckets * total19,
                "fused_softmax_fwd": total19}
    fit_traced = {k: fit19["dump"]["launches"][k] for k in want_fit}
    if not fit19["weights_bitwise"] or fit19["step_lines"] != total19 \
            or fit19["compiles_first"] != 1 \
            or fit19["compiles_after_first"] != 0 \
            or fit19["counter"] != want_fit or fit_traced != want_fit \
            or not fit19["exposition_valid"] \
            or fit19["dump"]["fit.step"] != total19 \
            or not fit19["dump"]["counters"]:
        raise AssertionError(
            "telemetry on fit: weights on and off bitwise %s, %d step lines "
            "(expected %d), compiles %s then %s, kernel counter %s and "
            "device trace %s (expected %s), exposition valid %s, dump %s"
            % (fit19["weights_bitwise"], fit19["step_lines"], total19,
               fit19["compiles_first"], fit19["compiles_after_first"],
               fit19["counter"], fit_traced, want_fit,
               fit19["exposition_valid"], fit19["dump"]))
    fwd19 = srv19["batches"]
    want_srv = {"fused_scale_bias_relu": n_sites * fwd19,
                "fused_softmax_fwd": fwd19}
    srv_traced = {k: srv19["dump"]["launches"][k] for k in want_srv}
    if not srv19["stats_agree"] or srv19["misses"] != srv19["compiles"] \
            or srv19["counter"] != want_srv or srv_traced != want_srv \
            or srv19["dump"]["serving:batch"] != fwd19 \
            or srv19["dump"]["serving.request"] != srv19["requests"] \
            + srv19["warmup"] or not srv19["finite"]:
        raise AssertionError(
            "telemetry on serving: stats against the registry %s, cache "
            "misses %d against compiles %d, kernel counter %s and device "
            "trace %s (expected %s over %d forwards), dump %s, answers "
            "finite %s" % (srv19["agree"], srv19["misses"],
                           srv19["compiles"], srv19["counter"], srv_traced,
                           want_srv, fwd19, srv19["dump"], srv19["finite"]))
    lm19 = lstm_lm(mx, ck, ctx)
    first19 = lm19["first_step"]
    if not first19["loss_rel"] <= LSTM_LM_TOL \
            or not first19["grad_max_rel"] <= LSTM_LM_TOL \
            or not lm19["vs_cells"]["output"] <= FUSED_TOL \
            or not lm19["vs_cells"]["states"] <= FUSED_TOL \
            or not np.isfinite(lm19["losses"]).all() \
            or not lm19["fixed_last"] < lm19["fixed_first"]:
        raise AssertionError(
            "LSTM LM: first step against the CPU %s (limit %g), the LSTM "
            "layer against its unrolled cells %s (limit %g), losses %s, on "
            "the fixed batch %s" % (first19, LSTM_LM_TOL, lm19["vs_cells"],
                                    FUSED_TOL, lm19["losses"],
                                    lm19["fixed_losses"]))
    obs_line = {"card": smi, "fit": fit19, "serving": srv19,
                "lstm_lm": lm19, "fit_traced": fit_traced,
                "serving_traced": srv_traced,
                "seconds": time.perf_counter() - t19}
    print("telemetry on %s: ResNet-50 v1 Module.fit kvstore=tpu batch %d, "
          "%d warmup + %d timed steps, cuDNN deterministic: step ms with "
          "telemetry, the step log and tracing on %s, all off %s (runs %s); "
          "cost %.2f%%; with the profiler's device trace too %s; idle share "
          "%s; weights on and off bitwise %s; %d step lines, compiles %s then "
          "0; kernel counter %s = the device trace's launches; exposition "
          "%d bytes, valid; dump: %s" % (
              smi, BATCH, OBS_WARMUP, OBS_STEPS,
              ["%.2f" % t for t in fit19["step_ms"]["on"]],
              ["%.2f" % t for t in fit19["step_ms"]["off"]],
              list(OBS_RUNS), 100 * fit19["cost"],
              ["%.2f" % t for t in fit19["step_ms"]["profiled"]],
              fit19.get("idle_share"), fit19["weights_bitwise"],
              fit19["step_lines"], fit19["compiles_first"],
              fit19["counter"], fit19["exposition_bytes"],
              {k: v for k, v in fit19["dump"].items() if k != "launches"}),
          flush=True)
    print("serving telemetry on %s: %d requests from %d clients, %d "
          "forwards: stats() against the mxnet_serving_* families %s; cache "
          "misses %d = compiles %d; kernel counter a forward %s = the device "
          "trace's %s; dump %s" % (
              smi, srv19["requests"], CLIENTS, fwd19, srv19["agree"],
              srv19["misses"], srv19["compiles"],
              srv19["counter_per_forward"], srv_traced,
              {k: v for k, v in srv19["dump"].items() if k != "launches"}),
          flush=True)
    print("gluon LSTM LM on %s: Zaremba et al.'s medium model (vocab %d, 2 "
          "x LSTM %d, 35 steps, batch %d, dropout %g, %d parameters), "
          "gluon.Trainer SGD lr %g, clip_global_norm %g; %d warmup + %d "
          "timed steps: %.2f ms/step, %.0f tokens/s (CUDA events); device "
          "busy %s us, idle share %s; the parts alone (us) %s; first "
          "step (dropout 0) against the CPU: loss %.3g, gradients %.3g (%s; "
          "limit %g); LSTM against its unrolled cells %s; losses %s; on the "
          "first batch alone %s; launches %s; phase 19 %.1f s" % (
              smi, LSTM_LM["vocab"], LSTM_LM["hidden"], LSTM_LM["batch"],
              LSTM_LM["dropout"], lm19["parameters"], LSTM_LM["lr"],
              LSTM_LM["clip"], LSTM_LM_WARMUP, LSTM_LM_TIMED, lm19["step_ms"],
              lm19["tokens_per_s"], lm19.get("step_busy_us"),
              lm19.get("idle_share"),
              {k: round(v) for k, v in lm19.get("parts_us", {}).items()},
              first19["loss_rel"], first19["grad_max_rel"],
              first19["worst_param"], LSTM_LM_TOL, lm19["vs_cells"],
              ["%.3f" % v for v in lm19["losses"]],
              ["%.3f" % v for v in lm19["fixed_losses"]], lm19["launches"],
              obs_line["seconds"]), flush=True)

    return obs_line



# ---------------------------------------------------------------------------
# phase 20: the train-to-serve loop
# ---------------------------------------------------------------------------
TS_EPOCHS = 3               # epochs of the checkpointed fit
TS_STEPS = 3                # steps an epoch, one periodic save each
TS_KEEP = 2                 # the manager's keep_last
TS_TIMED = (3, 9, 2)        # timing fits: warmup, timed steps, turns
TS_CLIENTS = 4
TS_CANARY = 0.25            # canary_fraction
# canary completions before the gate decides, and its p99 bound against
# the baseline (the JAX package's defaults are 20 and 3.0: fewer
# completions keep the phase short, and the wider bound keeps one slow
# batch of a healthy version from rolling it back)
TS_CANARY_KNOBS = {"MXNET_SERVING_CANARY_MIN_REQUESTS": "8",
                   "MXNET_SERVING_CANARY_P99_FACTOR": "5",
                   "MXNET_SERVING_CANARY_TIMEOUT_S": "60",
                   "MXNET_SERVING_BROWNOUT_MAX_BATCH": "8"}
TS_QUEUE = 64               # queue depth: brownout at 48, out at 16
TS_BURST_FACTOR = 6         # the burst's rate over (b)'s sustained one
TS_BURST_MIN_RATE = 2000.0  # requests/s, above what ResNet-50 serves
TS_BURST_S = 1.5
TS_BURST_DEADLINE_MS = 400.0
TS_CHECK = 12               # serial requests held bitwise after a verdict
TS_LIVE = 16                # first live requests timed after a restart
TS_WAIT_S = 120.0           # bound on any wait of the phase
TS_MODEL = "resnet50"


def ts_iter(mx, ctx, batch, image, steps, seed=SEED, classes=CLASSES):
    """A seeded synthetic ``NDArrayIter`` of ``batch * steps`` samples,
    ``shuffle=True``, its arrays on ``ctx`` (it shuffles from the port's
    CPU generator at each reset)."""
    rng = np.random.RandomState(seed + 20)
    x = rng.uniform(-1, 1, (batch * steps,) + tuple(image)).astype(
        np.float32)
    y = rng.randint(0, classes, (batch * steps,)).astype(np.float32)
    with ctx:
        return mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=True)


def ts_manager(mx, directory, period_steps):
    """A ``CheckpointManager`` (async, ``keep_last=TS_KEEP``, a save every
    ``period_steps`` batches and none at epoch ends) whose ``save_module``
    records its staging ms on the host clock (the capture: queueing the
    copies to the host, which the caller does not wait for) and whether
    the writer took the save."""
    class StagingTimed(mx.checkpoint.CheckpointManager):
        def __init__(self):
            super().__init__(directory, keep_last=TS_KEEP, async_save=True,
                             period_steps=period_steps, period_epochs=0)
            self.staging_ms, self.accepted, self.refused = [], 0, 0

        def save_module(self, module, **kw):
            t = time.perf_counter()
            ok = super().save_module(module, **kw)
            self.staging_ms.append((time.perf_counter() - t) * 1e3)
            self.accepted += bool(ok)
            self.refused += not ok
            return ok

    return StagingTimed()


def ts_fit(mx, ctx, sym, image, batch, epochs, steps, mgr=None, on_save=None,
           warmup=0, seed=SEED, classes=CLASSES):
    """``Module.fit`` of ``sym`` (``kvstore="tpu"``, ``SGD_PARAMS``, Xavier
    from ``seed``) over ``ts_iter``, checkpointed by ``mgr``.  Each step
    is timed between markers on the device's timeline; ``on_save(mod)``
    runs where a periodic save was just handed off, outside the timed
    spans.  Returns the module, the iterator and the step ms past
    ``warmup``."""
    device = ctx.torch_device
    it = ts_iter(mx, ctx, batch, image, steps, seed, classes)
    mod = mx.mod.Module(sym, context=ctx)
    starts, ends = [], []

    def on_batch(param):
        ends.append(_marker(device))
        if on_save is not None and (param.nbatch + 1) % steps == 0:
            on_save(mod)
        starts.append(_marker(device))

    mx.random.seed(seed)
    first = _marker(device)
    mod.fit(it, num_epoch=epochs, kvstore="tpu", optimizer="sgd",
            optimizer_params=SGD_PARAMS,
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            eval_metric="acc", batch_end_callback=on_batch,
            checkpoint_manager=mgr)
    _sync(device)
    step_ms = [_elapsed_ms(a, b)
               for a, b in zip([first] + starts[:-1], ends)][warmup:]
    return mod, it, step_ms


def _ts_commits(mx):
    """Saves committed so far in this process
    (``mxnet_checkpoint_saves_total``, recorded whether telemetry is on
    or off)."""
    return mx.telemetry.counter("mxnet_checkpoint_saves_total").labels() \
        .value


def ts_timing(mx, ctx, sym, image, batch, workdir, timed=TS_TIMED,
              seed=SEED, classes=CLASSES):
    """Phase 20 (a), the cost: ``ts_fit`` of one epoch with a manager
    saving every ``TS_STEPS`` batches and without one, in turns.  Every
    save the writer took must commit."""
    warmup, steps, turns = timed
    commits0 = _ts_commits(mx)
    out = {"with": [], "without": [], "staging_ms": [], "accepted": 0,
           "refused": 0, "committed": 0}
    for turn in range(turns):
        for mode in ("with", "without"):
            mgr = ts_manager(mx, os.path.join(workdir, "timing-%d" % turn),
                             TS_STEPS) if mode == "with" else None
            mod, _it, ms = ts_fit(mx, ctx, sym, image, batch, 1,
                                  warmup + steps, mgr=mgr, warmup=warmup,
                                  seed=seed, classes=classes)
            out[mode].append(float(np.mean(ms)))
            if mgr is not None:
                if mgr.last_error() is not None:
                    raise AssertionError("a timing fit's save failed: %r"
                                         % mgr.last_error())
                out["staging_ms"] += mgr.staging_ms
                out["accepted"] += mgr.accepted
                out["refused"] += mgr.refused
            del mod
    out["committed"] = _ts_commits(mx) - commits0
    if out["committed"] != out["accepted"]:
        raise AssertionError("the writer took %d saves and committed %d"
                             % (out["accepted"], out["committed"]))
    out["step_ms_with"] = float(np.mean(out["with"]))
    out["step_ms_without"] = float(np.mean(out["without"]))
    out["cost"] = out["step_ms_with"] / out["step_ms_without"] - 1
    return out


class _LogTap(logging.Handler):
    """Keeps the messages of the records it sees."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _ts_wait(cond, what, timeout_s=TS_WAIT_S):
    deadline = time.perf_counter() + timeout_s
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError("phase 20 waited %.0f s for %s"
                                 % (timeout_s, what))
        time.sleep(0.01)


def _ts_version_params(mx, ctx, store, step):
    """``(symbol, arg_params, aux_params, sample shape, meta)`` of a
    committed checkpoint, the arrays on ``ctx``."""
    manifest, arrays, blobs = store.read(step)
    state = mx.checkpoint.TrainState.from_payload(arrays, blobs,
                                                  manifest["meta"])
    to = ctx.torch_device
    args = {k: mx.nd.NDArray(torch.from_numpy(np.array(v)).to(to))
            for k, v in state.arg_params.items()}
    auxs = {k: mx.nd.NDArray(torch.from_numpy(np.array(v)).to(to))
            for k, v in state.aux_params.items()}
    shape = tuple(state.meta["input_shapes"]["data"][1:])
    return mx.sym.load_json(state.symbol_json), args, auxs, shape, state


def _ts_requests(image, n, seed):
    """``n`` seeded requests of 1-3 rows."""
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (int(rng.randint(1, 4)),) + tuple(image))
            .astype(np.float32) for _ in range(n)]


def ts_loop(mx, ctx, sym, image, batch, workdir, epochs=TS_EPOCHS,
            steps=TS_STEPS, clients=TS_CLIENTS, seed=SEED, classes=CLASSES):
    """Phase 20 (a) and (b): the checkpointed fit with a ``ModelServer``
    beside it.  The server (buckets 1..``batch``, the warmup manifest,
    ``canary_fraction=TS_CANARY``) watches the manager's directory; at
    each periodic save the fit waits for the commit and for the watcher's
    verdict on that version (warmed at every bucket, then promoted
    directly or through the canary gate) while ``clients`` threads send
    requests of 1-3 rows at priorities 0-2.  Returns the module, its
    iterator, the running server and watcher, and the numbers."""
    from mxnet_tpu_torch.serving import ModelNotFound, ModelServer
    from mxnet_tpu_torch.serving.bucketing import shape_buckets
    ckdir = os.path.join(workdir, "ckpt")
    manifest = os.path.join(workdir, "warmup.json")
    mgr = ts_manager(mx, ckdir, steps)
    srv = ModelServer(buckets=shape_buckets(batch), queue_depth=TS_QUEUE,
                      cache_size=32, manifest_path=manifest,
                      canary_fraction=TS_CANARY, ctx=ctx,
                      default_timeout_ms=TS_WAIT_S * 1e3)
    srv.start()
    watcher = srv.watch_checkpoints(ckdir, TS_MODEL, poll_interval=0.05)
    stop, answered, errors, threads = threading.Event(), [], [], []
    verdicts, window = [], {}

    def client(k):
        rng = np.random.RandomState(seed + 100 + k)
        while not stop.is_set():
            x = rng.uniform(-1, 1, (int(rng.randint(1, 4)),)
                            + tuple(image)).astype(np.float32)
            try:
                out = srv.infer(TS_MODEL, {"data": x},
                                priority=int(rng.randint(0, 3)))[0]
                answered.append(out.shape == (x.shape[0], classes)
                                and bool(np.isfinite(out).all()))
            except Exception as exc:    # noqa: BLE001 — re-raised below
                errors.append(exc)
                return

    def on_save(mod):
        if not mgr.wait(TS_WAIT_S) or mgr.last_error() is not None:
            raise AssertionError("the save did not commit: %r"
                                 % mgr.last_error())
        step = mgr.latest_step()
        t0 = time.perf_counter()

        def decided():
            if errors:
                raise errors[0]
            desc = srv.registry.describe().get(TS_MODEL, {})
            return desc.get("default") == step and \
                srv.canary_status(TS_MODEL)["live"] is None

        _ts_wait(decided, "version %d to be promoted" % step)
        hist = srv.canary_status(TS_MODEL)["history"]
        verdicts.append({"step": step, "wait_s": time.perf_counter() - t0,
                         "canary": hist[-1] if hist and hist[-1][
                             "canary_version"] == step else None})
        if not threads:
            window["t0"], window["n0"] = time.perf_counter(), len(answered)
            threads.extend(threading.Thread(target=client, args=(k,),
                                            daemon=True)
                           for k in range(clients))
            for t in threads:
                t.start()

    tap = _LogTap()
    logging.getLogger().addHandler(tap)
    try:
        mod, it, step_ms = ts_fit(mx, ctx, sym, image, batch, epochs, steps,
                                  mgr=mgr, on_save=on_save, seed=seed,
                                  classes=classes)
        # sustained: the clients' answers over the fit with them beside it
        sustained = (len(answered) - window["n0"]) / (
            time.perf_counter() - window["t0"])
    finally:
        stop.set()
        for t in threads:
            t.join(TS_WAIT_S)
        logging.getLogger().removeHandler(tap)
    if errors:
        raise errors[0]
    failed_warmups = [m for m in tap.messages if "warmup of version" in m]
    steps_kept = mgr.steps()
    latest = mgr.latest_step()
    out = {"versions": [v["step"] for v in verdicts], "verdicts": verdicts,
           "step_ms": step_ms, "staging_ms": list(mgr.staging_ms),
           "saves_accepted": mgr.accepted, "saves_refused": mgr.refused,
           "retained": steps_kept, "answers": len(answered),
           "answers_ok": all(answered), "sustained_req_per_s": sustained,
           "failed_warmups": failed_warmups,
           "cache": srv.cache.stats()["per_model"].get(TS_MODEL),
           "manifest_buckets": srv.manifest.buckets_for(
               TS_MODEL, srv.registry.get(TS_MODEL).symbol_sha,
               backend=srv._backend)}
    canaries = [v["canary"] for v in verdicts[1:]]
    if out["versions"] != list(range(1, epochs + 1)) \
            or mgr.refused or steps_kept != list(
                range(latest - TS_KEEP + 1, latest + 1)) \
            or failed_warmups or not out["answers_ok"] or any(
                c is None or c["decision"] != "promoted" for c in canaries):
        raise AssertionError(
            "train-to-serve loop: versions %s, saves refused %d, retained "
            "%s, warmup failures %s, answers ok %s, canaries %s"
            % (out["versions"], mgr.refused, steps_kept, failed_warmups,
               out["answers_ok"], canaries))
    try:
        srv.registry.get(TS_MODEL, latest)
    except ModelNotFound:
        raise AssertionError("the newest version is not registered")
    return mod, it, mgr, srv, watcher, out


def ts_answers(srv, image, n=TS_CHECK, seed=SEED):
    """``n`` serial requests of 1-3 rows: ``(requests, answers)``."""
    xs = _ts_requests(image, n, seed)
    return xs, [srv.infer(TS_MODEL, {"data": x})[0] for x in xs]


def ts_bitwise(mx, ctx, store, step, image, batch, xs, answers):
    """Each answer against a ``Predictor`` over checkpoint ``step``'s
    weights at the answer's own bucket (``bucket_forwards``): every one
    bitwise equal: cuDNN may pick other engines at other batch sizes, so
    an answer is held to a forward at its own bucket."""
    sym, args, auxs, _shape, _ = _ts_version_params(mx, ctx, store, step)
    refs, buckets, _ = bucket_forwards(mx, ctx, sym, args, auxs, image,
                                       batch, xs)
    return {"requests": len(xs), "buckets": sorted(set(buckets)),
            "bitwise": all(np.array_equal(a.view(np.int32),
                                          r.view(np.int32))
                           for a, r in zip(answers, refs)),
            "finite": all(np.isfinite(a).all() for a in answers)}


def ts_poison(mx, ctx, mgr, srv, image, seed=SEED):
    """Phase 20 (b), the rollback: the newest checkpoint committed again
    with a NaN in its FC weight.  Serial requests until the gate decides;
    the verdict must be the non-finite sentinel on the first canary batch
    (the only non-finite answer), the version unloaded and the default
    left on the last good version, which answers every request after the
    verdict.  Returns the NaN version's step, the last good one, the
    requests and answers after the verdict and the numbers."""
    from mxnet_tpu_torch.serving import ModelNotFound
    good = mgr.latest_step()
    manifest, arrays, blobs = mgr.store.read(good)
    state = mx.checkpoint.TrainState.from_payload(arrays, blobs,
                                                  manifest["meta"])
    fc = next(k for k in state.arg_params if k.endswith("_weight")
              and k.startswith("fc"))
    w = np.array(state.arg_params[fc])
    w[0, 0] = np.nan
    state.arg_params[fc] = w
    t0 = time.perf_counter()
    mgr.save_state(state, block=True)
    bad = mgr.latest_step()
    t_commit = time.perf_counter()
    _ts_wait(lambda: srv.canary_status(TS_MODEL)["live"] is not None
             and srv.canary_status(TS_MODEL)["live"]["canary_version"]
             == bad, "the NaN version's canary")
    t_live = time.perf_counter()
    xs = _ts_requests(image, 400, seed + 40)
    nonfinite, sent = 0, 0
    for x in xs:
        if srv.canary_status(TS_MODEL)["live"] is None:
            break
        out = srv.infer(TS_MODEL, {"data": x})[0]
        nonfinite += not np.isfinite(out).all()
        sent += 1
    t_verdict = time.perf_counter()
    hist = srv.canary_status(TS_MODEL)["history"][-1]
    unloaded = False
    try:
        srv.registry.get(TS_MODEL, bad)
    except ModelNotFound:
        unloaded = True
    res = {"nan_step": bad, "good_step": good, "verdict": hist,
           "save_s": t_commit - t0, "to_canary_s": t_live - t_commit,
           "to_verdict_s": t_verdict - t_live,
           "requests_to_verdict": sent, "nonfinite_answers": nonfinite,
           "unloaded": unloaded,
           "default": srv.registry.get(TS_MODEL).version}
    if hist["canary_version"] != bad or hist["decision"] != "rolled_back" \
            or hist["reason"] != "nonfinite_outputs" \
            or hist["nonfinite_batches"] != 1 or hist["served"] != 0 \
            or nonfinite != 1 or not unloaded or res["default"] != good:
        raise AssertionError("the NaN version's canary: %s" % res)
    return res


def ts_burst(mx, srv, image, sustained, seed=SEED):
    """Phase 20 (c): requests of 1-3 rows at priorities 0, 1, 2 in turn,
    each with a ``TS_BURST_DEADLINE_MS`` deadline, submitted at
    ``max(TS_BURST_FACTOR * sustained, TS_BURST_MIN_RATE)`` a second for
    ``TS_BURST_S``; then the queue drains.  Every outcome is tallied by
    class on the client's side and held to ``stats()`` (the per-model
    sheds by class and reason, the rejections, the ledger) and ``stats()``
    to the registry's ``mxnet_serving_*`` families.  Returns the
    numbers."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import DeadlineExceeded, QueueFull
    pool = _ts_requests(image, 8, seed + 50)
    rate = max(TS_BURST_FACTOR * sustained, TS_BURST_MIN_RATE)
    n = int(rate * TS_BURST_S)
    before = srv.stats()
    snap0 = telemetry.snapshot()
    tally, futures, entered = {}, [], False

    def count(cls, what):
        tally[(cls, what)] = tally.get((cls, what), 0) + 1

    t0 = time.perf_counter()
    for i in range(n):
        delay = t0 + i / rate - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        cls = i % 3
        try:
            futures.append((cls, srv.infer_async(
                TS_MODEL, {"data": pool[i % len(pool)]},
                timeout_ms=TS_BURST_DEADLINE_MS, priority=cls)))
        except QueueFull as exc:
            count(cls, "rejected_brownout" if "brownout" in str(exc)
                  else "rejected")
        entered |= srv._brownout
    submit_s = time.perf_counter() - t0
    for cls, fut in futures:
        try:
            fut.result()
            count(cls, "served")
        except DeadlineExceeded as exc:
            msg = str(exc)
            count(cls, "doomed" if msg.startswith("shed:") else
                  "brownout_queue" if msg.startswith("brownout") else
                  "expired")
    _ts_wait(lambda: not srv.stats()["brownout"]["active"],
             "the brownout to end")
    after = srv.stats()
    snap1 = telemetry.snapshot()
    req0 = before["per_model"][TS_MODEL]["requests"]
    req1 = after["per_model"][TS_MODEL]["requests"]
    req = {k: req1[k] - req0[k] for k in req1}
    sheds = {}
    for rows, sign in ((after, 1), (before, -1)):
        for s in rows["per_model"][TS_MODEL]["sheds"]:
            key = (s["class"], s["reason"])
            sheds[key] = sheds.get(key, 0) + sign * s["count"]
    sheds = {k: v for k, v in sheds.items() if v}

    def registry_total(snap, name, **labels):
        return _total(snap, name, model=TS_MODEL, **labels)

    registry = {o: registry_total(snap1, "mxnet_serving_requests_total",
                                  outcome=o)
                - registry_total(snap0, "mxnet_serving_requests_total",
                                 outcome=o) for o in req}
    shed_registry = {}
    for (cls, reason) in set(sheds) | {(c, r) for c in range(3) for r in (
            "doomed", "brownout_reject", "brownout_queue")}:
        v = registry_total(snap1, "mxnet_serving_sheds_total",
                           cls=str(cls), reason=reason) \
            - registry_total(snap0, "mxnet_serving_sheds_total",
                             cls=str(cls), reason=reason)
        if v:
            shed_registry[(cls, reason)] = v
    client = {k: sum(v for (c, w), v in tally.items() if w == k)
              for k in ("served", "rejected", "rejected_brownout", "doomed",
                        "brownout_queue", "expired")}
    res = {
        "rate": rate, "submitted": n, "submit_s": submit_s,
        "submit_rate": n / submit_s, "sustained_req_per_s": sustained,
        "factor": n / submit_s / sustained if sustained else None,
        "entered": after["brownout"]["entered"]
        - before["brownout"]["entered"], "seen_active": entered,
        "left": not after["brownout"]["active"],
        "by_class": {"%d %s" % k: v for k, v in sorted(tally.items())},
        "client": client, "requests": req, "registry": registry,
        "sheds": {"%d %s" % k: v for k, v in sorted(sheds.items())},
        "occupancy": after["batches"]["occupancy"]}
    rejected_brownout = {c: tally.get((c, "rejected_brownout"), 0)
                         for c in range(3)}
    ok = (res["factor"] is not None and res["factor"] >= 4
          and res["entered"] >= 1 and res["left"]
          and tally.get((0, "served"), 0) > 0
          and req == registry
          and {k: v for k, v in sheds.items()} == shed_registry
          and req["rejected_queue_full"] == client["rejected"]
          + client["rejected_brownout"]
          and all(sheds.get((c, "brownout_reject"), 0)
                  == rejected_brownout[c] for c in range(3))
          and req["served"] == client["served"]
          and req["shed"] + req["expired"] == client["doomed"]
          + client["brownout_queue"] + client["expired"]
          and req["shed"] == sum(v for (c, r), v in sheds.items()
                                 if r != "brownout_reject")
          and req["submitted"] == req["served"] + req["failed"]
          + req["expired"] + req["shed"])
    if not ok:
        raise AssertionError("shedding and brownout: %s" % res)
    return res


def ts_worker_fault(mx, srv, image, seed=SEED):
    """Phase 20 (f), serving: one injected ``serving.worker`` fault fails
    only its batch's request; the next request is served."""
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.fault import FaultInjected
    x = _ts_requests(image, 1, seed + 60)[0]
    before = srv.stats()["per_model"][TS_MODEL]["requests"]
    failed = False
    with fault.active_plan({"rules": [{"site": "serving.worker",
                                       "kind": "raise", "times": 1}]}) as p:
        try:
            srv.infer(TS_MODEL, {"data": x})
        except FaultInjected:
            failed = True
        out = srv.infer(TS_MODEL, {"data": x})[0]
    after = srv.stats()["per_model"][TS_MODEL]["requests"]
    res = {"failed_batch": failed, "injected": p.injected_count(),
           "next_served": bool(np.isfinite(out).all()),
           "failed": after["failed"] - before["failed"],
           "served": after["served"] - before["served"]}
    if res != {"failed_batch": True, "injected": 1, "next_served": True,
               "failed": 1, "served": 1}:
        raise AssertionError("serving.worker fault: %s" % res)
    return res


def ts_restart_child(args):
    """One restarted server (a process of its own on the card): checkpoint
    ``step`` served on ``args["ctx"]`` with the warmup manifest, warmed
    from it when ``args["mode"] == "manifest"``, then ``TS_LIVE`` live
    requests timed one at a time.  Returns the numbers."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compile_cache
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.serving.bucketing import shape_buckets
    ctx = mx.gpu(0) if args["ctx"] == "gpu" else mx.cpu()
    device = ctx.torch_device
    torch.backends.cudnn.deterministic = True
    store = mx.checkpoint.CheckpointStore(args["ckdir"])
    sym, arg, aux, shape, _ = _ts_version_params(mx, ctx, store,
                                                 args["step"])
    srv = ModelServer(buckets=shape_buckets(args["batch"]),
                      manifest_path=args["manifest"], ctx=ctx,
                      default_timeout_ms=TS_WAIT_S * 1e3)
    srv.add_model(TS_MODEL, sym, arg, aux, {"data": (1,) + shape})
    # started first, as a replica comes up: the warmup goes through the
    # batcher thread, which then serves the live requests (each thread
    # makes its own cuDNN and cuBLAS handles at its first call)
    srv.start()
    t0 = time.perf_counter()
    warmed = srv.warmup_from_manifest() if args["mode"] == "manifest" \
        else []
    _sync(device)
    warm_s = time.perf_counter() - t0
    misses_warm = srv.cache.stats()["misses"]
    lat, finite = [], True
    try:
        for x in _ts_requests(shape, args["live"], SEED + 70):
            t = time.perf_counter()
            out = srv.infer(TS_MODEL, {"data": x})[0]
            lat.append((time.perf_counter() - t) * 1e3)
            finite &= bool(np.isfinite(out).all())
    finally:
        srv.stop()
    return {"mode": args["mode"], "warmed": [b for _n, _v, b in warmed],
            "warmup_s": warm_s, "misses_after_warmup": misses_warm,
            "misses_after_live": srv.cache.stats()["misses"],
            "latency_ms": lat, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "finite": finite,
            "compile_cache": compile_cache.stats(refresh=False)}


def ts_restart(mx, ctx, ckdir, step, manifest, batch, live=TS_LIVE,
               spawn=True):
    """Phase 20 (d): the server restarted on the same manifest, in a new
    process (``spawn``; in this one for a CPU rehearsal), once warmed from
    the manifest and once cold.  With the manifest: every recorded bucket
    bound before the first live request and no miss after, and in a new
    process on the card the compile cache loaded every kernel library it
    had (hits) and ran no ``nvcc``.  Returns both runs."""
    runs = {}
    for mode in ("manifest", "cold"):
        args = {"ckdir": ckdir, "step": step, "manifest": manifest,
                "batch": batch, "mode": mode, "live": live,
                "ctx": "gpu" if ctx.device_type == "gpu" else "cpu"}
        if not spawn:
            runs[mode] = ts_restart_child(args)
            continue
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "_ts_restart",
             json.dumps(args)], capture_output=True, text=True,
            timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError("the restarted server (%s) exited %d:\n%s"
                                 % (mode, proc.returncode,
                                    proc.stderr[-4000:]))
        runs[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(manifest) as f:
        recorded = sorted({e["bucket"] for e in json.load(f)["entries"]})
    m = runs["manifest"]
    cc = m["compile_cache"]
    ok = (m["warmed"] == recorded and m["misses_after_warmup"]
          == len(recorded) and m["misses_after_live"] == len(recorded)
          and m["finite"] and runs["cold"]["finite"]
          and runs["cold"]["misses_after_warmup"] == 0)
    if spawn and ctx.device_type == "gpu":
        ok &= cc["misses"] == 0 and cc["hits"] > 0 and cc["errors"] == 0
    if not ok:
        raise AssertionError("warm restart (manifest buckets %s): %s"
                             % (recorded, runs))
    return dict(runs, recorded=recorded)


def ts_resume(mx, ctx, mod, it, mgr, sym, image, batch, steps=TS_STEPS,
              seed=SEED, classes=CLASSES):
    """Phase 20 (e): the newest checkpoint restored by
    ``CheckpointManager.restore_latest`` into a fresh ``Module`` (another
    initialisation, the same optimizer) and two steps taken by it and by
    the module that wrote it, on the iterator each restores: weights,
    momentum and moving statistics bitwise or within ``CKPT_TOL`` of each
    tensor's largest."""
    device = ctx.torch_device

    def two_steps(m, source):
        for _ in range(2):
            m.forward_backward(source.next())
            m.update()
        _sync(device)
        return module_state(m)

    # the original: fit reset its iterator at the last epoch's end
    ref = two_steps(mod, it)
    it2 = ts_iter(mx, ctx, batch, image, steps, seed, classes)
    fresh = mx.mod.Module(sym, context=ctx)
    fresh.bind(it2.provide_data, it2.provide_label)
    mx.random.seed(seed + 1)
    fresh.init_params(mx.init.Xavier())
    fresh.init_optimizer(kvstore="tpu", optimizer="sgd",
                         optimizer_params=SGD_PARAMS)
    state, ms = _timed(device, lambda: mgr.restore_latest(
        fresh, train_data=it2))
    it2.reset()     # as fit resets it, from the restored generator
    got = two_steps(fresh, it2)
    res = dict(compare_states(got, ref), restore_ms=ms,
               step=mgr.latest_step(), epoch=state.epoch,
               nbatch=state.nbatch, fused=fresh._fused_exec_update)
    if not (res["bitwise"] or res["max_rel"] <= CKPT_TOL) \
            or not res["fused"]:
        raise AssertionError("resume against the uninterrupted run: %s"
                             % res)
    return res


def ts_commit_fault(mx, mod, mgr):
    """Phase 20 (f), checkpoints: one injected ``checkpoint.store.commit``
    failure fails that save only (counted, the writer's error, nothing
    committed) and the next save commits."""
    from mxnet_tpu_torch import fault
    before = mgr.steps()
    with fault.active_plan({"rules": [{"site": "checkpoint.store.commit",
                                       "kind": "io_error",
                                       "times": 1}]}) as p:
        mgr.save_module(mod, epoch=98)
        mgr.wait(TS_WAIT_S)
        err = mgr.last_error()
        mid = mgr.steps()
        mgr._async.clear_error()
        mgr.save_module(mod, epoch=99)
        mgr.wait(TS_WAIT_S)
    res = {"injected": p.injected_count(), "first_error":
           type(err).__name__ if err is not None else None,
           "after_first": mid == before,
           "second_committed": mgr.last_error() is None
           and mgr.latest_step() not in before}
    if res != {"injected": 1, "first_error": "OSError", "after_first": True,
               "second_committed": True}:
        raise AssertionError("checkpoint.store.commit fault: %s" % res)
    return res


def train_serve(mx, ctx, sym, image, batch, workdir, epochs=TS_EPOCHS,
                steps=TS_STEPS, timed=TS_TIMED, clients=TS_CLIENTS,
                live=TS_LIVE, spawn=True, seed=SEED, classes=CLASSES,
                counts=None, knob_values=None):
    """Phase 20 on ``ctx``: (a) the manager's cost on the fit
    (``ts_timing``) and the checkpointed fit with (b) the server beside
    it (``ts_loop``), the answers after the last promotion held bitwise
    (``ts_bitwise``), the NaN version rolled back (``ts_poison``); (c)
    the burst (``ts_burst``); (f) a ``serving.worker`` fault; (d) the
    warm restart (``ts_restart``); (e) the resume (``ts_resume``); (f) a
    ``checkpoint.store.commit`` fault.  ``counts()`` (the launch counts)
    is read over (a)'s loop, (b), (c) and (f)'s serving fault, with the
    telemetry registry reset and on.  ``knob_values`` overrides entries
    of ``TS_CANARY_KNOBS``.  Each part raises on failure.  Returns the
    numbers."""
    from mxnet_tpu_torch import telemetry
    t_start = time.perf_counter()
    with knobs(None, tuple(TS_CANARY_KNOBS)):
        os.environ.update(TS_CANARY_KNOBS, **(knob_values or {}))
        timing = ts_timing(mx, ctx, sym, image, batch, workdir, timed,
                           seed, classes)
        telemetry.reset()
        telemetry.enable()
        try:
            if counts is not None:
                counts(reset=True)
            mod, it, mgr, srv, watcher, loop = ts_loop(
                mx, ctx, sym, image, batch, workdir, epochs, steps, clients,
                seed, classes)
            try:
                good = mgr.latest_step()
                xs, promoted = ts_answers(srv, image, seed=seed + 30)
                poison = ts_poison(mx, ctx, mgr, srv, image, seed)
                ys, after = ts_answers(srv, image, seed=seed + 31)
                burst = ts_burst(mx, srv, image,
                                 loop["sustained_req_per_s"], seed)
                worker = ts_worker_fault(mx, srv, image, seed)
                _sync(ctx.torch_device)
                launches = counts() if counts is not None else None
                snap = telemetry.snapshot()
                forwards = srv.stats()["batches"]["count"]
            finally:
                watcher.stop()
                srv.stop()
        finally:
            telemetry.disable()
    sweep = mod._exec_group.execs[0]._sweep
    loop.update(
        fit_steps=epochs * steps, forwards=forwards, launches=launches,
        counter=_families(snap, "mxnet_pallas_kernel_calls_total", "kernel"),
        buckets=len(sweep["plan"]) if sweep is not None else 0,
        fused=mod._fused_exec_update,
        writer_mb_per_s=_ts_writer_rate(snap),
        warmup_seconds=_ts_warmups(snap))
    promoted = ts_bitwise(mx, ctx, mgr.store, good, image, batch, xs,
                          promoted)
    after = ts_bitwise(mx, ctx, mgr.store, good, image, batch, ys, after)
    if not (promoted["bitwise"] and after["bitwise"] and after["finite"]):
        raise AssertionError("served answers against a Predictor over the "
                             "checkpoint: after the last promotion %s, "
                             "after the rollback %s" % (promoted, after))
    mgr.store.delete(poison["nan_step"])
    restart = ts_restart(mx, ctx, mgr.store.root, good, srv.manifest.path,
                         batch, live, spawn)
    resume = ts_resume(mx, ctx, mod, it, mgr, sym, image, batch, steps,
                       seed, classes)
    commit = ts_commit_fault(mx, mod, mgr)
    return {"timing": timing, "loop": loop, "promoted": promoted,
            "poison": poison, "after_rollback": after, "burst": burst,
            "restart": restart, "resume": resume,
            "faults": {"serving.worker": worker,
                       "checkpoint.store.commit": commit},
            "seconds": time.perf_counter() - t_start}


def _ts_writer_rate(snap):
    """MB/s of the checkpoint writer (serialize, hash, write, fsync,
    commit) over the window: ``mxnet_checkpoint_bytes`` over the summed
    ``mxnet_checkpoint_save_seconds``."""
    hist = snap.get("mxnet_checkpoint_save_seconds", {"values": []})
    secs = sum(v["sum"] for v in hist["values"])
    return _total(snap, "mxnet_checkpoint_bytes") / 1e6 / secs \
        if secs else None


def _ts_warmups(snap):
    """``{mode: [count, seconds]}`` of ``mxnet_serving_warmup_seconds``."""
    hist = snap.get("mxnet_serving_warmup_seconds", {"values": []})
    return {v["labels"].get("mode"): [v["count"], v["sum"]]
            for v in hist["values"]}


def train_serve_phase(mx, ck, ctx, sym, n_sites, smi, workdir_parent=None):
    """Phase 20 on the card, cuDNN deterministic, in a temporary directory
    of the checkout removed at the end: ``train_serve`` on full-width
    ResNet-50 v1, its launches held through the kernel counter
    (``mxnet_pallas_kernel_calls_total``, equal to the wrappers' counts):
    K1b once a bucket and K2 once a step of the fit, K3 at ``n_sites``
    and K2 once a served forward.  Prints the phase's lines and returns
    its JSON record."""
    import tempfile
    workdir = tempfile.TemporaryDirectory(
        prefix=".chip_smoke_ts_", dir=workdir_parent or os.path.dirname(
            os.path.abspath(__file__)))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res = train_serve(
            mx, ctx, sym, IMAGE, BATCH, workdir.name,
            counts=lambda reset=False: ck.reset_kernel_calls() if reset
            else ck.kernel_calls())
    finally:
        torch.backends.cudnn.deterministic = saved
        workdir.cleanup()
    loop = res["loop"]
    steps, fwd, buckets = loop["fit_steps"], loop["forwards"], loop["buckets"]
    want = {"sgd_mom_sweep": buckets * steps,
            "softmax_lastaxis": steps + fwd,
            "scale_bias_relu": n_sites * fwd}
    labels = {"sgd_mom_sweep": "fused_sgd_momentum",
              "softmax_lastaxis": "fused_softmax_fwd",
              "scale_bias_relu": "fused_scale_bias_relu"}
    got = {k: loop["launches"].get(k, 0) for k in want}
    counter = {k: loop["counter"].get(labels[k], 0) for k in want}
    others = {k: v for k, v in loop["launches"].items()
              if k not in want and v}
    if got != want or counter != want or others or not loop["fused"] \
            or buckets < 1:
        raise AssertionError(
            "phase 20 launches over %d fit steps and %d served forwards: "
            "wrappers %s, kernel counter %s, expected %s (others %s)"
            % (steps, fwd, got, counter, want, others))
    res["card"] = smi
    t, b, r = res["timing"], res["burst"], res["restart"]
    print("train-to-serve on %s: ResNet-50 v1 Module.fit kvstore=tpu batch "
          "%d, %d epochs of %d steps, CheckpointManager(period_steps=%d, "
          "async, keep_last=%d), cuDNN deterministic: step ms with the "
          "manager %s, without %s (in turns; cost %.2f%%); staging ms "
          "(host clock) %s; "
          "writer %.0f MB/s; saves taken %d, refused %d, committed %d; "
          "versions %s promoted (waits %s s), retained %s; canaries %s"
          % (smi, BATCH, TS_EPOCHS, TS_STEPS, TS_STEPS, TS_KEEP,
             ["%.2f" % v for v in t["with"]],
             ["%.2f" % v for v in t["without"]], 100 * t["cost"],
             ["%.1f" % v for v in t["staging_ms"] + loop["staging_ms"]],
             loop["writer_mb_per_s"] or 0.0, t["accepted"], t["refused"],
             t["committed"], loop["versions"],
             ["%.2f" % v["wait_s"] for v in loop["verdicts"]],
             loop["retained"],
             [(v["canary"]["decision"], v["canary"]["routed"],
               v["canary"]["decision_latency_s"])
              for v in loop["verdicts"][1:]]), flush=True)
    print("hot swap on %s: %d client answers beside the fit (%.1f req/s "
          "sustained), warmups %s, cache %s; after the last promotion %s; "
          "NaN version %d rolled back after %d requests (%s, %d non-finite "
          "answer, decided %s s after the canary began; the save %.2f s, "
          "the watcher's read, warmup and staging %.2f s, the requests "
          "%.3f s), then %s" % (
              smi, loop["answers"], loop["sustained_req_per_s"],
              loop["warmup_seconds"], loop["cache"], res["promoted"],
              res["poison"]["nan_step"], res["poison"]["requests_to_verdict"],
              res["poison"]["verdict"]["reason"],
              res["poison"]["nonfinite_answers"],
              res["poison"]["verdict"]["decision_latency_s"],
              res["poison"]["save_s"], res["poison"]["to_canary_s"],
              res["poison"]["to_verdict_s"], res["after_rollback"]),
          flush=True)
    print("burst on %s: %d requests at %.0f/s (%.1fx the sustained rate), "
          "deadline %.0f ms: brownout entered %d, left; by class %s; sheds "
          "%s; stats = registry %s" % (
              smi, b["submitted"], b["submit_rate"], b["factor"],
              TS_BURST_DEADLINE_MS, b["entered"], b["by_class"], b["sheds"],
              b["requests"]), flush=True)
    print("warm restart on %s: manifest buckets %s; first %d live requests "
          "p50 %.2f ms, p99 %.2f ms with the manifest warmup (%.2f s, "
          "misses %d then %d; compile cache %s) and p50 %.2f ms, p99 %.2f "
          "ms cold; resume %s; faults %s; launches %s = counter; phase 20 "
          "%.1f s" % (
              smi, r["recorded"], TS_LIVE, r["manifest"]["p50_ms"],
              r["manifest"]["p99_ms"], r["manifest"]["warmup_s"],
              r["manifest"]["misses_after_warmup"],
              r["manifest"]["misses_after_live"],
              {k: r["manifest"]["compile_cache"][k]
               for k in ("hits", "misses", "errors")},
              r["cold"]["p50_ms"], r["cold"]["p99_ms"], res["resume"],
              res["faults"], got, res["seconds"]), flush=True)
    res["launches_train_serve"] = {
        "fit_steps": steps, "served_forwards": fwd,
        "sgd_mom_sweep": {"launches": got["sgd_mom_sweep"],
                          "per_fit_step": got["sgd_mom_sweep"] / steps},
        "softmax_lastaxis": {"launches": got["softmax_lastaxis"],
                             "per_fit_step": 1, "per_served_forward": 1},
        "scale_bias_relu": {"launches": got["scale_bias_relu"],
                            "per_served_forward": got["scale_bias_relu"]
                            / fwd}}
    return res


# ---------------------------------------------------------------------------
# phase 21: generative serving and the elastic fit
# ---------------------------------------------------------------------------
GEN_SLOTS = 8
GEN_MAX_LEN = 1024
GEN_PREFILL_BATCH = 4       # batch rungs 1, 2, 4: 3 x 11 grid cells
# bench_serving.py's generative leg at this width: a solo phase of waves of
# short class-0 requests, a mixed phase of the same waves beside one long
# class-1 generation, then steady state
GEN_SOLO = {"waves": 8, "requests": 4, "prompt": 12, "new": 16}
GEN_LONG = {"prompt": 32, "new": 512}
GEN_STEADY = {"prompt": 24, "new": 256, "steps": 1000}
GEN_CONVOY = 3.0            # mixed TTFT p99 over solo p99, at most
GEN_TIMED = 20              # decode steps timed by CUDA events
# (b): prompts held to the block's own greedy forward, 32 tokens each;
# where a served token first differs from the oracle's, the oracle's top
# two logits there must lie within this much of its largest |logit| (a
# near-tie, decided by fp32 rounding), and that prompt's comparison ends
GEN_CHECK = {"prompts": (5, 64, 200, 512), "new": 32}
GEN_NEAR_TIE = 1e-4
# one prefill and 8 decode steps on the card and on the CPU from the same
# weights and state: the same fp32 math in other summation orders, ~1e-6
# of each tensor's largest magnitude; TF32 (off at import) would give
# ~1e-3.  Tokens must be equal.
GEN_CPU = {"prompts": (5, 64), "steps": 8, "slots": 2}
GEN_CPU_TOL = 1e-4
GEN_WAIT_S = 300.0          # bound on any wait of the phase
# (c): phase 20's fit under fit(elastic=True): 2 epochs of 8 steps, a save
# every 2 steps, a SIGTERM at the first attempt's step 5, an error at the
# second attempt's step 8 (the plan's step is the attempt's own batch
# count, as fit publishes it)
ELASTIC = {"epochs": 2, "steps": 8, "period": 2, "sigterm": 5, "raise": 8}


def gen_prompt(n, vocab, seed):
    return np.random.RandomState(seed).randint(1, vocab, n).astype(np.int32)


def gen_server(mx, ctx, config=GPT2_SMALL, slots=GEN_SLOTS,
               max_len=GEN_MAX_LEN, prefill_batch=GEN_PREFILL_BATCH,
               seed=SEED):
    """The GPT-2-small-width ``TransformerLM`` (Xavier from ``seed``,
    fp32, as ``transformer_lm`` builds it) behind ``ModelServer.
    add_generative_model``, every grid cell warmed by
    ``warmup_generative``.  Returns ``(server, block, scheduler, warmup
    seconds, cells warmed)``."""
    lm = transformer_lm(mx, ctx, config, seed)
    srv = mx.serving.ModelServer(cache_size=64, ctx=ctx)
    sched = srv.add_generative_model("lm", lm, slots=slots, max_len=max_len,
                                     prefill_batch=prefill_batch)
    _sync(sched.model.device)
    t = time.perf_counter()
    cells = srv.warmup_generative()["lm"]
    _sync(sched.model.device)
    return srv, lm, sched, time.perf_counter() - t, cells


def _gen_results(streams, timeout=GEN_WAIT_S):
    return [s.result(timeout=timeout) for s in streams]


def gen_traffic(srv, sched, vocab, solo=GEN_SOLO, long=GEN_LONG,
                steady=GEN_STEADY, seed=SEED):
    """Phase 21 (a)'s traffic: ``solo["waves"]`` waves of
    ``solo["requests"]`` short class-0 requests; the same waves while one
    long class-1 generation runs; then rounds of a full pool of steady
    requests until ``steady["steps"]`` decode steps have run, with the
    executor cache's misses and ``compile_stats()`` read before and after
    them.  Returns the numbers."""
    def wave(k):
        return [srv.infer_stream(
            "lm", gen_prompt(solo["prompt"], vocab, seed + 1000 * k + i),
            max_new_tokens=solo["new"], priority=0, tenant="short")
            for i in range(solo["requests"])]

    solo_ttft = []
    for k in range(solo["waves"]):
        streams = wave(k)
        _gen_results(streams)
        solo_ttft += [s.ttft_s for s in streams]
    long_st = srv.infer_stream("lm", gen_prompt(long["prompt"], vocab, seed),
                               max_new_tokens=long["new"], priority=1,
                               tenant="long")
    mixed_ttft, waves = [], 0
    while not long_st.done():
        streams = wave(solo["waves"] + waves)
        _gen_results(streams)
        waves += 1
        mixed_ttft += [s.ttft_s for s in streams]
    long_tokens = len(long_st.result(timeout=GEN_WAIT_S))
    stats0 = sched.stats()
    miss0, compiles0 = srv.cache.misses, sched.model.compile_stats()
    t = time.perf_counter()
    tokens, rounds = 0, 0
    while sched.stats()["steps"] - stats0["steps"] < steady["steps"]:
        streams = [srv.infer_stream(
            "lm", gen_prompt(steady["prompt"], vocab, seed + 7 * rounds + i),
            max_new_tokens=steady["new"], priority=0, tenant="steady")
            for i in range(sched.slots)]
        tokens += sum(len(r) for r in _gen_results(streams))
        rounds += 1
    wall = time.perf_counter() - t
    stats1 = sched.stats()
    solo_ms = [v * 1e3 for v in solo_ttft]
    mixed_ms = [v * 1e3 for v in mixed_ttft]
    return {"solo_ttft_ms": solo_ms, "mixed_ttft_ms": mixed_ms,
            "solo_ttft_p50_ms": float(np.percentile(solo_ms, 50)),
            "solo_ttft_p99_ms": float(np.percentile(solo_ms, 99)),
            "mixed_ttft_p50_ms": float(np.percentile(mixed_ms, 50)),
            "mixed_ttft_p99_ms": float(np.percentile(mixed_ms, 99)),
            "mixed_waves": waves, "long_tokens": long_tokens,
            "steady_steps": stats1["steps"] - stats0["steps"],
            "steady_rounds": rounds, "steady_tokens": tokens,
            "steady_s": wall, "tokens_per_s": tokens / wall,
            "steady_misses": srv.cache.misses - miss0,
            "compile_stats": [compiles0, sched.model.compile_stats()],
            "per_token_median_ms": stats1["per_token_median_s"] * 1e3,
            "ledgers": sched.ledgers()}


def gen_state(gm, slots, vocab, seed=SEED):
    """A scratch ``DecodeState`` with every slot live at spread positions,
    for timing the decode step apart from the scheduler."""
    st = gm.make_state(slots)
    rng = np.random.RandomState(seed)
    for s in range(slots):
        st.occupy(s, 1 + (s * gm.max_len) // (slots + 1),
                  int(rng.randint(1, vocab)))
    return st


def gen_timing(gm, cache, vocab, slots=GEN_SLOTS, timed=GEN_TIMED,
               cell=(4, 32), seed=SEED):
    """The decode step of ``slots`` live slots: ms by CUDA events (the
    host clock on the CPU; the step ends by reading its tokens, so either
    spans its whole cost) and, on the card, its device busy time and idle
    share by the profiler; the same for one prefill at ``cell``."""
    device = gm.device
    st = gen_state(gm, slots, vocab, seed)
    gm.decode_step(st)
    times = []
    for _ in range(timed):
        a = _marker(device)
        gm.decode_step(st)
        times.append(_elapsed_ms(a, _marker(device)))
    toks = np.stack([gen_prompt(cell[1], vocab, seed + r)
                     for r in range(cell[0])])
    lens = np.full(cell[0], cell[1], np.int32)

    def prefill():
        out = gm.prefill(cache, cell, toks, lens)
        return out[0].cpu()

    prefill()
    pre = []
    for _ in range(max(3, timed // 4)):
        a = _marker(device)
        prefill()
        pre.append(_elapsed_ms(a, _marker(device)))
    out = {"decode_ms": float(np.median(times)),
           "decode_ms_all": times, "prefill_cell": list(cell),
           "prefill_ms": float(np.median(pre)), "slots": slots}
    if device.type == "cuda":
        for key, fn, ms in (("decode", lambda: gm.decode_step(st),
                             out["decode_ms"]),
                            ("prefill", prefill, out["prefill_ms"])):
            by_name = device_times(fn, n=1)
            busy = sum(by_name.values())
            out[key + "_busy_us"] = busy if busy > 0 else None
            out[key + "_idle_share"] = (max(0.0, 1 - busy / (ms * 1e3))
                                        if busy > 0 else None)
            out[key + "_by_kind"] = by_kind(by_name, LM_KINDS)
            out[key + "_kernels"] = len(by_name)
    return out


def gen_tokens_check(mx, ck, srv, lm, vocab, prompts=GEN_CHECK["prompts"],
                     new=GEN_CHECK["new"], near_tie=GEN_NEAR_TIE,
                     seed=SEED):
    """Phase 21 (b): each prompt served for ``new`` greedy tokens through
    ``infer_stream``, held to the block's own forward over the prompt and
    the served tokens (one forward a prompt: while the tokens agree, its
    argmax at each position IS the greedy oracle's next token).  At the
    first disagreement the oracle's top-two gap there must be under
    ``near_tie`` of its largest |logit|, and that prompt's comparison
    ends.  The oracle's kernel launches (K6a, and K7a or K5a by the
    length's route) are counted.  Raises on a real mismatch."""
    ctx = lm.embed.weight.data().context
    ps = [gen_prompt(n, vocab, seed + 31 * i) for i, n in enumerate(prompts)]
    streams = [srv.infer_stream("lm", p, max_new_tokens=new, tenant="check")
               for p in ps]
    served = _gen_results(streams)
    matched, ties, lengths = [], [], []
    ck.reset_kernel_calls()
    for p, got in zip(ps, served):
        seq = np.concatenate([p, np.asarray(got, np.int32)])
        lengths.append(len(seq))
        logits = lm(mx.nd.array(seq[None].astype(np.float32), ctx=ctx))
        logits = logits._data[0, len(p) - 1:len(p) - 1 + new]
        want = logits.argmax(dim=-1).cpu().numpy()
        n = 0
        while n < new and int(want[n]) == int(got[n]):
            n += 1
        matched.append(n)
        if n < new:
            row = logits[n]
            top2 = row.topk(2).values
            gap = float(top2[0] - top2[1])
            scale = float(row.abs().max())
            tie = {"prompt": len(p), "step": n, "gap": gap,
                   "largest": scale, "served": int(got[n]),
                   "oracle": int(want[n]),
                   "served_logit": float(row[int(got[n])])}
            ties.append(tie)
            if not gap < near_tie * scale or \
                    float(top2[0] - row[int(got[n])]) > near_tie * scale:
                raise AssertionError(
                    "generative tokens: prompt of %d tokens differs from "
                    "the block's greedy forward at step %d (%s), not a "
                    "near-tie" % (len(p), n, tie))
    return {"prompts": list(prompts), "new": new, "matched": matched,
            "near_ties": ties, "oracle_lengths": lengths,
            "oracle_launches": ck.kernel_calls()}


def _gen_host_spec(gm):
    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [host(v) for v in tree]
        return tree.detach().cpu()
    return {"config": dict(gm.config), "params": host(gm.params)}


def _rel(a, b):
    """max |a - b| over b's largest magnitude, in float64 on b's
    device."""
    b = b.detach().double()
    a = a.detach().to(b.device, torch.float64)
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def gen_cpu_check(mx, gm, vocab, prompts=GEN_CPU["prompts"],
                  steps=GEN_CPU["steps"], slots=GEN_CPU["slots"],
                  tol=GEN_CPU_TOL, seed=SEED):
    """Phase 21 (b): one prefill of ``prompts`` (one grid cell) and
    ``steps`` decode steps on the model's device and on the CPU from the
    same weights and the same state: first and decoded tokens equal,
    K/V histories and the cache within ``tol`` of each tensor's largest
    magnitude.  Raises otherwise."""
    cpu = mx.serving.GenerativeModel("lm-cpu", _gen_host_spec(gm),
                                     max_len=gm.max_len,
                                     prefill_batch=len(prompts),
                                     ctx=mx.cpu())
    cell = gm.pick_cell(len(prompts), max(prompts))
    toks = np.zeros(cell, np.int32)
    lens = np.ones(cell[0], np.int32)
    for r, n in enumerate(prompts):
        toks[r, :n] = gen_prompt(n, vocab, seed + 97 * r)
        lens[r] = n
    caches = [mx.serving.ExecutorCache(capacity=2, ctx=m.device)
              for m in (gm, cpu)]
    outs = [m.prefill(c, cell, toks, lens) for m, c in zip((gm, cpu), caches)]
    firsts = [o[0].cpu().numpy() for o in outs]
    res = {"cell": list(cell), "first_equal": bool(
        np.array_equal(firsts[0], firsts[1])),
        "k_hist": _rel(outs[0][1], outs[1][1]),
        "v_hist": _rel(outs[0][2], outs[1][2])}
    states = [m.make_state(slots) for m in (gm, cpu)]
    for m, st, (first, kh, vh) in zip((gm, cpu), states, outs):
        for r, n in enumerate(prompts):
            m.admit(st, r, kh[:, r], vh[:, r])
            st.occupy(r, n, int(firsts[0][r]))
    res["tokens_equal"], res["cache"] = [], []
    for _ in range(steps):
        nxt = [m.decode_step(st) for m, st in zip((gm, cpu), states)]
        live = list(range(len(prompts)))
        res["tokens_equal"].append(bool(np.array_equal(nxt[0][live],
                                                       nxt[1][live])))
        for st in states:
            for r in live:
                st.advance(r, int(nxt[0][r]))
        res["cache"].append(max(_rel(states[0].k, states[1].k),
                                _rel(states[0].v, states[1].v)))
    res["worst"] = max([res["k_hist"], res["v_hist"]] + res["cache"])
    if not (res["first_equal"] and all(res["tokens_equal"])
            and res["worst"] <= tol):
        raise AssertionError("generative prefill/decode on %s vs the CPU: "
                             "%s (limit %g)" % (gm.device, res, tol))
    return res


def gen_fault_check(mx, srv, sched, vocab, n=3, new=16, prompt=12,
                    seed=SEED):
    """Phase 21 (b): a plan at ``serving.decode.step`` for one tenant
    fails that stream alone; the other streams' tokens equal those of
    the same requests served without the plan.  Each run submits its
    requests inside the scheduler's lock, so both prefill them in one
    batch in the same rows."""
    prompts = [gen_prompt(prompt, vocab, seed + 500 + i) for i in range(n + 1)]

    def run(plan):
        with sched._cv:
            streams = [srv.infer_stream("lm", p, max_new_tokens=new,
                                        tenant="t%d" % i if i else "victim")
                       for i, p in enumerate(prompts)]
        if plan is None:
            return _gen_results(streams)
        with mx.fault.active_plan(plan) as armed:
            out = []
            for s in streams:
                try:
                    out.append(s.result(timeout=GEN_WAIT_S))
                except mx.fault.FaultInjected as exc:
                    out.append(exc)
            return out, armed.injected_count()

    base = run(None)
    got, injected = run({"rules": [{"site": "serving.decode.step",
                                    "kind": "raise", "times": 1,
                                    "where": {"tenant": "victim"}}]})
    res = {"injected": injected,
           "victim_failed": isinstance(got[0], mx.fault.FaultInjected),
           "others_equal": [g == b for g, b in zip(got[1:], base[1:])]}
    if injected != 1 or not res["victim_failed"] \
            or not all(res["others_equal"]):
        raise AssertionError("generative fault isolation: %s" % res)
    return res


def generative_phase(mx, ck, ctx, config=GPT2_SMALL, slots=GEN_SLOTS,
                     max_len=GEN_MAX_LEN, prefill_batch=GEN_PREFILL_BATCH,
                     solo=GEN_SOLO, long=GEN_LONG, steady=GEN_STEADY,
                     check=GEN_CHECK, cpu=GEN_CPU, timed=GEN_TIMED,
                     cell=(4, 32), seed=SEED):
    """Phase 21 (a) and (b): serving, its numbers and its checks.
    Returns the record."""
    t0 = time.perf_counter()
    vocab = config["vocab_size"]
    srv, lm, sched, warm_s, cells = gen_server(
        mx, ctx, config, slots, max_len, prefill_batch, seed)
    try:
        gm = sched.model
        grid = len(gm.grid())
        misses_warm = srv.cache.misses
        traffic = gen_traffic(srv, sched, vocab, solo, long, steady, seed)
        tokens = gen_tokens_check(mx, ck, srv, lm, vocab, check["prompts"],
                                  check["new"], seed=seed)
        faults = gen_fault_check(mx, srv, sched, vocab, seed=seed)
        led = sched.ledgers()
        stats = srv.stats()["generative"]["lm"]
    finally:
        srv.stop(drain=False)
    timing = gen_timing(gm, srv.cache, vocab, slots, timed, cell, seed)
    cpu_res = gen_cpu_check(mx, gm, vocab, cpu["prompts"], cpu["steps"],
                            cpu["slots"], seed=seed)
    res = {"config": dict(config), "slots": slots, "max_len": max_len,
           "prefill_batch": prefill_batch, "grid_cells": grid,
           "cells_warmed": cells, "warmup_s": warm_s,
           "misses_after_warmup": misses_warm,
           "kv_bytes": gm.kv_bytes_per_slot() * slots,
           "kv_bytes_per_slot": gm.kv_bytes_per_slot(),
           "weight_bytes": gm.param_bytes(), "traffic": traffic,
           "timing": timing, "tokens": tokens, "cpu": cpu_res,
           "faults": faults, "ledgers": led,
           "steps": stats["steps"], "seconds": None}
    bad = []
    if cells != grid or misses_warm != grid:
        bad.append("warmup bound %d cells (%d misses) of %d"
                   % (cells, misses_warm, grid))
    if traffic["mixed_ttft_p99_ms"] > GEN_CONVOY * traffic["solo_ttft_p99_ms"]:
        bad.append("convoy: mixed TTFT p99 %.2f ms over %g x solo p99 %.2f ms"
                   % (traffic["mixed_ttft_p99_ms"], GEN_CONVOY,
                      traffic["solo_ttft_p99_ms"]))
    if traffic["steady_misses"] or \
            traffic["compile_stats"][0] != traffic["compile_stats"][1]:
        bad.append("steady state bound %d cells, compile_stats %s"
                   % (traffic["steady_misses"], traffic["compile_stats"]))
    if traffic["steady_steps"] < steady["steps"] or traffic["long_tokens"] \
            != long["new"] or not traffic["mixed_waves"]:
        bad.append("traffic %s" % {k: traffic[k] for k in (
            "steady_steps", "long_tokens", "mixed_waves")})
    for tenant, c in led.items():
        if c["submitted"] != c["served"] + c["failed"] + c["expired"] \
                + c["shed"]:
            bad.append("ledger of %s unbalanced: %s" % (tenant, c))
    want_failed = {"victim": 1}
    for tenant, c in led.items():
        if c["failed"] != want_failed.get(tenant, 0) or c["expired"] \
                or c["shed"]:
            bad.append("tenant %s: %s" % (tenant, c))
    if bad:
        raise AssertionError("phase 21 generative serving: " + "; ".join(bad))
    res["seconds"] = time.perf_counter() - t0
    return res


def elastic_phase(mx, ck, ctx, sym, image, batch, workdir, epochs=None,
                  steps=None, period=None, sigterm=None, fail=None,
                  counts=None, seed=SEED, classes=CLASSES):
    """Phase 21 (c): phase 20's fit (``kvstore="tpu"``, ``SGD_PARAMS``,
    Xavier from ``seed``, a shuffled ``ts_iter``), cuDNN deterministic
    where the caller set it, run uninterrupted and then under
    ``fit(elastic=True)`` with a ``CheckpointManager`` saving every
    ``period`` steps and a plan that sends a SIGTERM at the first
    attempt's step ``sigterm`` and raises at the second's step ``fail``.
    The final weights, momentum and moving stats must be bitwise the
    uninterrupted run's; the plan must inject 2 faults, the supervisor
    retry twice and recover once; the sweep kernel must launch once a
    bucket for every step that ran, replays included.  Returns the
    numbers, with each fault's time to recover: from the last update
    before the fault to the first after the restore.  ``counts(reset=
    False)`` reads (or zeroes) the launch counts: the kernel wrappers'
    by default."""
    epochs = ELASTIC["epochs"] if epochs is None else epochs
    steps = ELASTIC["steps"] if steps is None else steps
    period = ELASTIC["period"] if period is None else period
    sigterm = ELASTIC["sigterm"] if sigterm is None else sigterm
    fail = ELASTIC["raise"] if fail is None else fail
    device = ctx.torch_device
    fit_kw = dict(num_epoch=epochs, kvstore="tpu", optimizer="sgd",
                  optimizer_params=SGD_PARAMS,
                  initializer=mx.init.Xavier(rnd_type="gaussian",
                                             factor_type="in", magnitude=2),
                  eval_metric="acc")

    def module(log):
        mod = mx.mod.Module(sym, context=ctx)
        update = mod.update

        def counted():
            update()
            log.append(time.perf_counter())
        mod.update = counted
        return mod

    if counts is None:
        def counts(reset=False):
            return ck.reset_kernel_calls() if reset else ck.kernel_calls()

    def calls():
        c = counts()
        return c.get("sgd_mom_sweep", 0), c.get("softmax_lastaxis", 0)

    t0 = time.perf_counter()
    oracle_log = []
    counts(reset=True)
    mx.random.seed(seed)
    oracle = module(oracle_log)
    oracle.fit(ts_iter(mx, ctx, batch, image, steps, seed, classes),
               **fit_kw)
    _sync(device)
    o_sweep, o_softmax = calls()
    want = module_state(oracle)
    del oracle

    failures = []

    class Catch(logging.Handler):
        def emit(self, record):
            if "recoverable failure" in record.getMessage():
                failures.append(time.perf_counter())

    catch = Catch()
    flog = logging.getLogger("mxnet_tpu_torch.fault")
    flog.addHandler(catch)
    before = {k: _total(mx.telemetry.snapshot(), k) for k in (
        "mxnet_fault_injected_total", "mxnet_fault_retries_total",
        "mxnet_fault_recoveries_total")}
    plan = {"rules": [
        {"site": "fit.step", "kind": "sigterm", "step": sigterm,
         "times": 1},
        {"site": "fit.step", "kind": "raise", "exc": "RuntimeError",
         "step": fail, "times": 1}]}
    saved_env = {k: os.environ.get(k) for k in (
        "MXNET_FAULT_BACKOFF_BASE_S", "MXNET_FAULT_BACKOFF_MAX_S")}
    os.environ["MXNET_FAULT_BACKOFF_BASE_S"] = "0.05"
    os.environ["MXNET_FAULT_BACKOFF_MAX_S"] = "0.1"
    log = []
    try:
        mgr = mx.checkpoint.CheckpointManager(
            workdir, keep_last=2, async_save=True, period_steps=period,
            period_epochs=0)
        counts(reset=True)
        mx.random.seed(seed)
        mod = module(log)
        with mx.fault.active_plan(plan) as armed:
            mod.fit(ts_iter(mx, ctx, batch, image, steps, seed, classes),
                    elastic=True, checkpoint_manager=mgr, **fit_kw)
        _sync(device)
        injected = armed.injected_count()
    finally:
        flog.removeHandler(catch)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sweep, softmax = calls()
    after = {k: _total(mx.telemetry.snapshot(), k) - before[k]
             for k in before}
    cmp = compare_states(module_state(mod), want)
    buckets = o_sweep // max(1, len(oracle_log))
    recover = []
    for t in failures:
        last = max([x for x in log if x < t], default=None)
        nxt = min([x for x in log if x > t], default=None)
        recover.append(None if last is None or nxt is None else nxt - last)
    res = {"epochs": epochs, "steps_per_epoch": steps, "period": period,
           "plan": plan["rules"], "uninterrupted_steps": len(oracle_log),
           "steps_run": len(log), "replayed": len(log) - len(oracle_log),
           "buckets": buckets, "launches": {"sgd_mom_sweep": sweep,
                                            "softmax_lastaxis": softmax},
           "oracle_launches": {"sgd_mom_sweep": o_sweep,
                               "softmax_lastaxis": o_softmax},
           "injected": injected, "counters": after,
           "recover_s": recover, "tensors": cmp["tensors"],
           "bitwise": cmp["bitwise"], "max_rel": cmp["max_rel"],
           "seconds": time.perf_counter() - t0}
    bad = []
    if not cmp["bitwise"]:
        bad.append("state not bitwise the uninterrupted fit's (%g)"
                   % cmp["max_rel"])
    if injected != 2 or after["mxnet_fault_injected_total"] != 2 \
            or after["mxnet_fault_retries_total"] != 2 \
            or after["mxnet_fault_recoveries_total"] != 1 \
            or len(failures) != 2:
        bad.append("faults: injected %d, counters %s, %d retries logged"
                   % (injected, after, len(failures)))
    if len(oracle_log) != epochs * steps or o_softmax != len(oracle_log) \
            or sweep != buckets * len(log) or softmax != len(log) \
            or (device.type == "cuda" and buckets < 1):
        bad.append("launches %s over %d steps run (%d buckets; the "
                   "uninterrupted fit %s over %d)"
                   % (res["launches"], len(log), buckets,
                      res["oracle_launches"], len(oracle_log)))
    if bad:
        raise AssertionError("phase 21 elastic fit: " + "; ".join(bad))
    return res


def generate_phase(mx, ck, ctx, sym, smi, workdir_parent=None):
    """Phase 21 on the card: generative serving (a, b), then the elastic
    fit (c) cuDNN deterministic in a temporary directory of the checkout
    removed at the end.  Prints the phase's lines and returns
    ``(generative record, elastic record)``."""
    import tempfile
    gen = generative_phase(mx, ck, ctx)
    gen["card"] = smi
    tr, ti = gen["traffic"], gen["timing"]
    print("generative serving on %s: TransformerLM %s fp32 through "
          "add_generative_model(slots=%d, max_len=%d, prefill_batch=%d): "
          "%d grid cells warmed in %.2f s; solo TTFT p50 %.2f ms, p99 %.2f "
          "ms; mixed (beside a %d-token generation, %d waves) p50 %.2f ms, "
          "p99 %.2f ms; steady %d steps, %d tokens in %.2f s: %.1f tokens/s; "
          "misses %d and compile_stats %s across them; decode step %.3f ms "
          "(CUDA events, %d slots), device busy %s us (idle share %s); "
          "prefill %s %.3f ms, busy %s us (idle %s); KV %.1f MB, weights "
          "%.1f MB" % (
              smi, json.dumps(gen["config"]), gen["slots"], gen["max_len"],
              gen["prefill_batch"], gen["cells_warmed"], gen["warmup_s"],
              tr["solo_ttft_p50_ms"], tr["solo_ttft_p99_ms"],
              tr["long_tokens"], tr["mixed_waves"], tr["mixed_ttft_p50_ms"],
              tr["mixed_ttft_p99_ms"], tr["steady_steps"],
              tr["steady_tokens"], tr["steady_s"], tr["tokens_per_s"],
              tr["steady_misses"], tr["compile_stats"][1], ti["decode_ms"],
              ti["slots"], ti.get("decode_busy_us"),
              ti.get("decode_idle_share"), tuple(ti["prefill_cell"]),
              ti["prefill_ms"], ti.get("prefill_busy_us"),
              ti.get("prefill_idle_share"), gen["kv_bytes"] / 1e6,
              gen["weight_bytes"] / 1e6), flush=True)
    tk, cpu = gen["tokens"], gen["cpu"]
    print("generative correctness on %s: prompts %s x %d greedy tokens "
          "matched the block's own forward for %s steps, near-ties %s; "
          "oracle launches %s; prefill %s and %d decode steps against the "
          "CPU: tokens equal, worst %.3g of the largest (limit %g); "
          "fault at serving.decode.step: %s; phase 21 (a, b) %.1f s" % (
              smi, tk["prompts"], tk["new"], tk["matched"],
              tk["near_ties"], {k: v for k, v in tk["oracle_launches"].items()
                                if v}, tuple(cpu["cell"]),
              len(cpu["cache"]), cpu["worst"], GEN_CPU_TOL, gen["faults"],
              gen["seconds"]), flush=True)
    workdir = tempfile.TemporaryDirectory(
        prefix=".chip_smoke_el_", dir=workdir_parent or os.path.dirname(
            os.path.abspath(__file__)))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        el = elastic_phase(mx, ck, ctx, sym, IMAGE, BATCH, workdir.name)
    finally:
        torch.backends.cudnn.deterministic = saved
        workdir.cleanup()
    el["card"] = smi
    print("elastic fit on %s: ResNet-50 v1 Module.fit(elastic=True) "
          "kvstore=tpu batch %d, %d epochs of %d steps, a save every %d, "
          "SIGTERM at step %d and an error at step %d: %d steps run for %d "
          "(%d replayed), injected %d, counters %s; %d tensors bitwise the "
          "uninterrupted fit's: %s; time to recover %s s; launches %s "
          "(%d buckets); %.1f s" % (
              smi, BATCH, el["epochs"], el["steps_per_epoch"], el["period"],
              ELASTIC["sigterm"], ELASTIC["raise"], el["steps_run"],
              el["uninterrupted_steps"], el["replayed"], el["injected"],
              el["counters"], el["tensors"], el["bitwise"],
              ["%.3f" % v if v is not None else None
               for v in el["recover_s"]], el["launches"], el["buckets"],
              el["seconds"]), flush=True)
    return gen, el



# ---------------------------------------------------------------------------
# phase 22: data-parallel training across GPUs
# ---------------------------------------------------------------------------
# rank processes: each joins a FileStore world, runs one function and
# pickles its return value; the parent gives the whole world this long
PAR_RANK_TIMEOUT_S = 600


def run_ranks(target, world, args=(), workdir=None, ctx="cpu",
              timeout=PAR_RANK_TIMEOUT_S, threads=None, env=None):
    """Run ``target`` (``"module:function"``, importable from the checkout
    or the tests) in ``world`` new processes, rank r calling
    ``function(rank, world, init_method, ctx, *args)`` with a
    ``file://`` store under ``workdir``; returns their return values in
    rank order.  Raises, naming the rank and the end of its output, if
    one exits non-zero or the world outlives ``timeout``; every process
    is gone when it returns or raises."""
    import pickle
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory(prefix=".chip_smoke_ranks_",
                                      dir=workdir or here)
    init_method = "file://" + os.path.join(tmp.name, "store")
    with open(os.path.join(tmp.name, "args.pkl"), "wb") as f:
        pickle.dump(tuple(args), f)
    mod, fn = target.split(":")
    boot = ("import sys, pickle, importlib, faulthandler\n"
            "faulthandler.enable()\n"
            "sys.path[:0] = %r\n"
            "d = %r\n"
            "args = pickle.load(open(d + '/args.pkl', 'rb'))\n"
            "out = getattr(importlib.import_module(%r), %r)(\n"
            "    int(sys.argv[1]), %d, %r, %r, *args)\n"
            "with open(d + '/out%%s.pkl' %% sys.argv[1], 'wb') as f:\n"
            "    pickle.dump(out, f)\n"
            % ([here, os.path.join(here, "tests")], tmp.name, mod, fn,
               world, init_method, ctx))
    penv = dict(os.environ, **(env or {}))
    if threads:
        penv["OMP_NUM_THREADS"] = str(threads)
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(tmp.name, "rank%d.log" % r), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", boot, str(r)], stdout=log,
                stderr=subprocess.STDOUT, env=penv, cwd=here))
        deadline = time.monotonic() + timeout
        live = list(range(world))
        failed = None
        while live and failed is None:
            for r in list(live):
                rc = procs[r].poll()
                if rc is None:
                    continue
                live.remove(r)
                if rc != 0:
                    failed = (r, "exited %d" % rc)
            if time.monotonic() > deadline and live:
                failed = (live[0], "outlived %d s" % timeout)
            time.sleep(0.05)
        if failed is not None:
            r, why = failed
            logs[r].seek(0)
            raise AssertionError("rank %d of %d (%s) %s:\n%s" % (
                r, world, target, why, logs[r].read()[-6000:]))
        out = []
        for r in range(world):
            with open(os.path.join(tmp.name, "out%d.pkl" % r), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
        tmp.cleanup()


def par_join(rank, world, init_method, ctx):
    """Join the world of :func:`run_ranks` as ``rank``: gloo on the CPU,
    NCCL on ``cuda:rank`` on the card.  Returns the package and the
    rank's context."""
    import mxnet_tpu_torch as mx
    on = mx.cpu() if ctx == "cpu" else mx.gpu(rank)
    with on:
        mx.parallel.init_distributed(init_method=init_method,
                                     num_processes=world, process_id=rank,
                                     ctx=on, timeout=120)
    return mx, on


def par_net(mx, kind="mlp", seed=42, ctx=None):
    """A small deterministic gluon net built the same way by either
    package (``mx`` is ``mxnet_tpu`` or ``mxnet_tpu_torch``): ``mlp`` is
    Dense(16, relu) -> Dense(8) on 12 features, ``drop`` puts a
    Dropout(0.5) between them, ``bn`` a BatchNorm; values from ``seed``,
    running variances positive."""
    nn = mx.gluon.nn
    with ctx or mx.cpu():
        with mx.name.NameManager():
            net = nn.HybridSequential()
            if kind == "mlp":
                net.add(nn.Dense(16, in_units=12, activation="relu"),
                        nn.Dense(8, in_units=16))
            elif kind == "drop":
                net.add(nn.Dense(16, in_units=12, activation="relu"),
                        nn.Dropout(0.5), nn.Dense(8, in_units=16))
            else:
                net.add(nn.Dense(16, in_units=12),
                        nn.BatchNorm(in_channels=16),
                        nn.Activation("relu"), nn.Dense(8, in_units=16))
        net.initialize(mx.init.Zero())
        r = np.random.RandomState(seed)
        for name, p in sorted(net.collect_params().items()):
            v = (r.randn(*p.shape) * 0.2).astype(np.float32)
            if name.endswith("running_var"):
                v = np.abs(v) + np.float32(1)
            p.set_data(mx.nd.array(v))
    return net


def par_data(batch=16, classes=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, 12).astype(np.float32),
            rng.randint(0, classes, batch).astype(np.float32))


def par_case_trainer(mx, case, ctx=None, devices=None):
    """The ``ParallelTrainer`` of one case dict (net, optimizer and its
    params, zero, width, compression, dtype, bucket caps) on ``devices``:
    by default the first ``width`` ranks (the tests give the JAX package
    its first ``width`` devices)."""
    net = par_net(mx, case.get("net", "mlp"), ctx=ctx)
    mesh = mx.parallel.make_mesh(devices=list(range(case["width"]))
                                 if devices is None else devices)
    return mx.parallel.ParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), case["opt"],
        dict(case["opt_params"]), mesh=mesh, zero=case["zero"],
        compression=case.get("compression"),
        compression_params=case.get("compression_params"),
        dtype=case.get("dtype"),
        bucket_bytes=case.get("bucket_bytes", 256),
        first_bucket_bytes=case.get("first_bucket_bytes", 128))


def par_case_run(mx, trainer, case):
    """Step ``trainer`` ``case["steps"]`` times on :func:`par_data`'s
    global batch; returns the losses, parameters, optimizer-state bytes,
    wire model and plan (None where this rank is outside the mesh)."""
    x, y = par_data(case.get("batch", 16))
    losses = []
    for _ in range(case.get("steps", 3)):
        loss = trainer.step(mx.nd.array(x), mx.nd.array(y))
        if loss is None:
            return None
        losses.append(float(loss.asnumpy()))
    return {"losses": losses,
            "params": {k: np.array(v.detach().cpu().numpy()
                                   if isinstance(v, torch.Tensor) else v)
                       for k, v in trainer.params.items()},
            "bytes": trainer.optimizer_state_bytes(),
            "comm": trainer.comm_stats(), "plan": trainer.plan_spec()}


def drill_trainer(mx, width, zero=2, ctx=None):
    """The JAX package's drill trainer (``mxnet_tpu/fault/drill.py``
    ``_build_trainer``) in the port: three Dense layers under the prefix
    ``net_``, values from seed 42, SGD with momentum, on the first
    ``width`` ranks."""
    nn = mx.gluon.nn
    with ctx or mx.cpu():
        mx.random.seed(0)
        net = nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(nn.Dense(32, in_units=16, activation="relu"),
                    nn.Dense(16, in_units=32, activation="relu"),
                    nn.Dense(4, in_units=16))
        net.initialize(mx.init.Zero())
        r = np.random.RandomState(42)
        for _, p in sorted(net.collect_params().items()):
            p.set_data(mx.nd.array((r.randn(*p.shape) * 0.2).astype(
                np.float32)))
        mesh = mx.parallel.make_mesh(dp=width, devices=list(range(width)))
        return mx.parallel.ParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9}, mesh=mesh, zero=zero,
            bucket_bytes=2048)


def drill_data(mx, ctx=None, batch=16):
    """The drill's batches, a pure function of the step (the JAX
    package's ``_drill_data_fn``)."""
    rng = np.random.RandomState(7)
    x = rng.randn(256, 16).astype(np.float32)
    y = rng.randint(0, 4, 256).astype(np.float32)

    def data_fn(step):
        i = (step * batch) % 256
        with ctx or mx.cpu():
            return mx.nd.array(x[i:i + batch]), mx.nd.array(y[i:i + batch])

    return data_fn


def elastic_width_rank(rank, world, init_method, ctx, directory, widths,
                       fault_step, steps):
    """``run_elastic`` over the drill trainer on ``widths[restart]`` of the
    world's ranks (sub-meshes of one world), an error injected at
    ``elastic.step`` ``fault_step``; returns the curve and each restore's
    ``(step, verdict)``."""
    mx, on = par_join(rank, world, init_method, ctx)
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.fault.backoff import BackoffPolicy
    from mxnet_tpu_torch.fault.elastic import ElasticSupervisor, run_elastic
    try:
        restores = []
        plan = {"rules": [{"site": "elastic.step", "kind": "raise",
                           "exc": "RuntimeError", "step": fault_step,
                           "times": 1}]}
        with on, fault.active_plan(plan):
            curve = run_elastic(
                lambda r: drill_trainer(mx, widths[min(r, len(widths) - 1)],
                                        ctx=on),
                drill_data(mx, on), steps, directory,
                supervisor=ElasticSupervisor(retries=2, backoff=BackoffPolicy(
                    retries=2, base_s=0.001, max_s=0.002, jitter=0.0)),
                on_restore=lambda s, v: restores.append((s, v)))
        return {"curve": curve, "restores": restores}
    finally:
        mx.parallel.distributed.shutdown()


def reshard_rank(rank, world, init_method, ctx, steps, more):
    """Resume across mesh width and ZeRO stage in one world: the drill
    net with Adam trained ``steps`` at width 4 zero=2, its state loaded
    at width 2 zero=1 (bitwise), then ``more`` steps of each; the
    restore verdicts of that state against other trainers.  Rank 0's
    record."""
    mx, on = par_join(rank, world, init_method, ctx)
    from mxnet_tpu_torch.checkpoint import (ParallelTrainerState,
                                            check_restore_compat)
    try:
        with on:
            x, y = par_data()
            a = par_case_trainer(mx, {"opt": "adam", "opt_params": {
                "learning_rate": 0.05}, "zero": 2, "width": 4}, ctx=on)
            for _ in range(steps):
                a.step(mx.nd.array(x), mx.nd.array(y))
            sd = a.state_dict()
            b = par_case_trainer(mx, {"opt": "adam", "opt_params": {
                "learning_rate": 0.05}, "zero": 1, "width": 2}, ctx=on)
            b.load_state_dict(sd)
            back = b.state_dict() if b.mesh.is_member else None
            la = [a.step(mx.nd.array(x), mx.nd.array(y))
                  for _ in range(more)]
            lb = [b.step(mx.nd.array(x), mx.nd.array(y))
                  for _ in range(more)]
            state = ParallelTrainerState.capture(a)
            verdicts = {}
            for key, case in (
                    ("w2-z1-adam", {"opt": "adam", "opt_params": {},
                                    "zero": 1, "width": 2}),
                    ("w4-z0-sgd", {"opt": "sgd", "opt_params": {
                        "momentum": 0.9}, "zero": 0, "width": 4}),
                    ("w2-z2-adam-bn", {"net": "bn", "opt": "adam",
                                       "opt_params": {}, "zero": 2,
                                       "width": 2})):
                verdicts[key] = check_restore_compat(
                    state, par_case_trainer(mx, case, ctx=on))
        if rank != 0:
            return None
        return {"state": sd, "back": back, "verdicts": verdicts,
                "losses_a": [float(v.asnumpy()) for v in la],
                "losses_b": [float(v.asnumpy()) for v in lb]}
    finally:
        mx.parallel.distributed.shutdown()


def dist_kv_rank(rank, world, init_method, ctx, hb_dir):
    """The JAX package's two-worker ``dist_sync`` assertions
    (``tests/test_dist_kvstore.py``'s worker) on one rank: rank 0's value
    broadcast at ``init``, pushes summed over the ranks, a per-device list
    merged first, an updater on the summed gradient, ``barrier``, and no
    dead node while every worker heartbeats.  Returns what it saw."""
    os.environ["MXNET_KVSTORE_HEARTBEAT_DIR"] = hb_dir
    mx, on = par_join(rank, world, init_method, ctx)
    try:
        with on:
            nd = mx.nd
            kv = mx.kv.create("dist_sync")
            seen = {"rank": kv.rank, "num_workers": kv.num_workers,
                    "type": type(kv).__name__}
            kv.init("w", nd.array(np.full((4, 3), float(rank + 1),
                                          np.float32)))
            out = nd.zeros((4, 3))
            kv.pull("w", out=out)
            seen["init"] = out.asnumpy()
            kv.push("w", nd.array(np.full((4, 3), float(rank + 1),
                                          np.float32)))
            kv.pull("w", out=out)
            seen["push"] = out.asnumpy()
            kv.push("w", [nd.ones((4, 3)), nd.ones((4, 3))])
            kv.pull("w", out=out)
            seen["list_push"] = out.asnumpy()
            kv._set_updater(lambda key, grad, weight:
                            weight.__isub__(0.1 * grad))
            kv.init("u", nd.zeros((2, 2)))
            kv.push("u", nd.ones((2, 2)) * (rank + 1))
            o2 = nd.zeros((2, 2))
            kv.pull("u", out=o2)
            seen["updater"] = o2.asnumpy()
            kv.barrier()
            seen["dead"] = kv.get_num_dead_node(timeout_sec=300)
            return seen
    finally:
        mx.parallel.distributed.shutdown()


def dist_fit_rank(rank, world, init_method, ctx, batch, steps, compression):
    """``Module.fit`` of an MLP under ``kvstore="dist_sync"`` on this
    rank's rows of each global batch; rank 0 also fits the whole global
    batches with ``kvstore="device"``.  Returns rank 0's weights of both,
    the optimizer's ``rescale_grad`` and every rank's digest."""
    mx, on = par_join(rank, world, init_method, ctx)
    import hashlib
    try:
        def fit(kvstore, r, w):
            rng = np.random.RandomState(5)
            x = rng.randn(batch * steps, 10).astype(np.float32)
            y = rng.randint(0, 4, batch * steps).astype(np.float32)
            local = batch // w
            idx = np.concatenate([np.arange(s * batch + r * local,
                                            s * batch + (r + 1) * local)
                                  for s in range(steps)])
            data = mx.sym.Variable("data")
            net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
            net = mx.sym.Activation(net, act_type="tanh", name="act")
            net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
            net = mx.sym.SoftmaxOutput(net, name="softmax")
            with on:
                it = mx.io.NDArrayIter(x[idx], y[idx], batch_size=local)
                mod = mx.mod.Module(net, context=on,
                                    compression_params=compression)
                mx.random.seed(3)
                mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
                        optimizer_params={"learning_rate": 0.5,
                                          "momentum": 0.9},
                        initializer=mx.init.Xavier())
                arg, _ = mod.get_params()
            return ({k: v.asnumpy() for k, v in arg.items()},
                    mod._optimizer.rescale_grad)

        dist, rescale = fit("dist_sync", rank, world)
        digest = hashlib.sha256(b"".join(
            dist[k].tobytes() for k in sorted(dist))).hexdigest()
        out = {"digest": digest, "rescale": rescale, "dist": dist}
        if rank == 0:
            out["device"], out["device_rescale"] = fit("device", 0, 1)
        return out
    finally:
        mx.parallel.distributed.shutdown()


def par_cases_rank(rank, world, init_method, ctx, cases):
    """A rank's side of the CPU tests: every case of ``cases`` in turn
    (each on the first ``width`` ranks of the world), the collective
    calls of each counted; returns rank 0's results (None on the others)
    and every rank's calls."""
    mx, on = par_join(rank, world, init_method, ctx)
    from mxnet_tpu_torch.parallel import collectives
    try:
        out = []
        for case in cases:
            collectives.reset_collective_calls()
            with on:
                tr = par_case_trainer(mx, case, ctx=on)
                res = par_case_run(mx, tr, case)
            if res is not None:
                res["calls"] = collectives.collective_calls()
                if case.get("state_dict"):
                    res["state_dict"] = tr.state_dict()
            out.append(res)
        return out if rank == 0 else None
    finally:
        mx.parallel.distributed.shutdown()


# ---------------------------------------------------------------------------
# phase 23: model-axis sharding (tp, fsdp, sp, pp, ep)
# ---------------------------------------------------------------------------
# the small shapes of the CPU tests, which hold each piece against the JAX
# package's on its virtual 8-device mesh (the inputs come from
# :func:`mp_inputs`, numpy from a seed, in both)
MP_SMALL_LM = {"vocab_size": 32, "units": 16, "hidden_size": 32,
               "num_layers": 1, "num_heads": 2, "max_len": 16}


def mp_inputs(case):
    """The numpy inputs of one attention, pipeline or experts case
    (``case["kind"]``), from ``case["seed"]``: the operands and the
    weights ``w`` of the loss ``sum(out * w)`` whose gradients are held."""
    r = np.random.RandomState(case.get("seed", 0))

    def rn(*shape, s=1.0):
        return (r.randn(*shape) * s).astype(np.float32)

    kind = case["kind"]
    if kind == "attn":
        b, t, h, d = case["b"], case["t"], case["h"], case["d"]
        hkv = case.get("hkv", h)
        return {"q": rn(b, t, h, d), "k": rn(b, t, hkv, d),
                "v": rn(b, t, hkv, d), "w": rn(b, t, h, d)}
    if kind == "pipe":
        s, d = case["pp"], case["d"]
        return {"w": rn(s, d, d, s=0.5), "b": rn(s, d, s=0.1),
                "x": rn(case["b"], d), "g": rn(case["b"], d)}
    if kind == "moe":
        e, d, f = case["e"], case["d"], case["f"]
        return {"x": rn(case["t"], d), "gate": rn(d, e),
                "w1": rn(e, d, f, s=0.3), "w2": rn(e, f, d, s=0.3),
                "g": rn(case["t"], d)}
    raise ValueError(kind)


def mp_stage(F):
    """One pipeline stage in the array namespace ``F`` (``torch`` or
    ``jax.numpy``): ``tanh(act @ w + b)``."""
    return lambda p, a: F.tanh(a @ p["w"] + p["b"])


def mp_expert(F):
    """One expert in ``F``: ``relu(tokens @ w1) @ w2``."""
    relu = torch.relu if F is torch else (lambda a: F.maximum(a, 0.0))
    return lambda p, x: relu(x @ p["w1"]) @ p["w2"]


def mp_net(mx, kind, seed=42, ctx=None):
    """:func:`par_net` (``"mlp"``, ``"bn"``), or ``"lm"``: a
    ``TransformerLM`` of ``MP_SMALL_LM``'s widths, causal, its values
    from ``seed`` (the same in either package: the names come from a
    fresh ``NameManager``, the values in sorted-name order)."""
    if kind != "lm":
        return par_net(mx, kind, seed=seed, ctx=ctx)
    from importlib import import_module
    tr = import_module(mx.__name__ + ".gluon.contrib.transformer")
    with ctx or mx.cpu():
        with mx.name.NameManager():
            lm = tr.TransformerLM(**MP_SMALL_LM)
        lm.initialize(mx.init.Zero())
        lm(mx.nd.array(np.zeros((1, 1), np.float32)))
        r = np.random.RandomState(seed)
        for name, p in sorted(lm.collect_params().items()):
            v = (r.randn(*p.shape) * 0.2).astype(np.float32)
            if name.endswith("gamma"):
                v += np.float32(1)
            p.set_data(mx.nd.array(v))
    return lm


def mp_data(kind, batch=8, seed=0):
    """The global batch of a trainer case: :func:`par_data`'s rows, or
    token ids and their next tokens for the LM."""
    if kind != "lm":
        return par_data(batch, seed=seed)
    ids = np.random.RandomState(seed).randint(
        0, MP_SMALL_LM["vocab_size"], (batch, 9)).astype(np.float32)
    return ids[:, :-1], ids[:, 1:]


def mp_trainer(mx, case, mesh, ctx=None):
    """The ``ParallelTrainer`` of a trainer case on ``mesh``."""
    net = mp_net(mx, case["net"], ctx=ctx)
    loss = LMTokenLoss(mx, MP_SMALL_LM["vocab_size"]) \
        if case["net"] == "lm" else mx.gluon.loss.SoftmaxCrossEntropyLoss()
    return mx.parallel.ParallelTrainer(
        net, loss, case["opt"], dict(case["opt_params"]), mesh=mesh,
        zero=case["zero"], bucket_bytes=case.get("bucket_bytes", 256),
        first_bucket_bytes=case.get("first_bucket_bytes", 128))


def mp_trainer_run(mx, trainer, case, calls=None):
    """Step a trainer case's trainer ``case["steps"]`` times on its fixed
    global batch; its losses, whole parameters, state bytes, wire model
    and plan (and ``calls()`` read right after the steps)."""
    x, y = mp_data(case["net"], case.get("batch", 8))
    losses = []
    for _ in range(case.get("steps", 3)):
        loss = trainer.step(mx.nd.array(x), mx.nd.array(y))
        losses.append(float(loss.asnumpy()))
    return {"losses": losses,
            "calls": calls() if calls is not None else None,
            "params": {k: np.array(v.detach().cpu().numpy()
                                   if isinstance(v, torch.Tensor) else v)
                       for k, v in trainer.params.items()},
            "bytes": trainer.optimizer_state_bytes(),
            "comm": trainer.comm_stats(), "plan": trainer.plan_spec()}


def _world_sum(ts):
    """Each tensor summed over every rank of the world (a rank's
    gradients are its share of the global ones)."""
    import torch.distributed as dist
    out = []
    for t in ts:
        t = t.detach().clone()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.all_reduce(t)
        out.append(t)
    return out


def mp_attention(mx, case, dev, world):
    """``ring_attention`` or ``ulysses_attention`` of an attention case
    over ``make_mesh(sp=case["sp"])``: the global output, and the
    gradients of ``sum(out * w)`` (each rank's loss divided by the
    world, summed over it)."""
    a = mp_inputs(case)
    mesh = mx.parallel.make_mesh(sp=case["sp"])
    fn = getattr(mx.parallel, case["fn"] + "_attention")
    q, k, v = (torch.tensor(a[n], device=dev, requires_grad=True)
               for n in ("q", "k", "v"))
    out = fn(q, k, v, mesh=mesh, causal=case["causal"])
    loss = (out * torch.tensor(a["w"], device=dev)).sum() / world
    loss.backward()
    grads = [g.cpu().numpy() for g in _world_sum([q.grad, k.grad, v.grad])]
    return {"out": out.detach().cpu().numpy(), "dq": grads[0],
            "dk": grads[1], "dv": grads[2]}


def mp_pipeline(mx, case, dev, world):
    """``pipeline_apply`` of a pipeline case over ``make_mesh(pp=...)``:
    the output and the gradients of the stacked parameters and of x."""
    a = mp_inputs(case)
    mesh = mx.parallel.make_mesh(pp=case["pp"])
    stages = [{"w": torch.tensor(a["w"][s], device=dev),
               "b": torch.tensor(a["b"][s], device=dev)}
              for s in range(case["pp"])]
    stacked = mx.parallel.stack_stages(stages)
    stacked = {k: v.detach().requires_grad_() for k, v in stacked.items()}
    x = torch.tensor(a["x"], device=dev, requires_grad=True)
    out = mx.parallel.pipeline_apply(mp_stage(torch), stacked, x, mesh,
                                     num_microbatches=case["m"])
    ((out * torch.tensor(a["g"], device=dev)).sum() / world).backward()
    gw, gb, gx = (g.cpu().numpy() for g in _world_sum(
        [stacked["w"].grad, stacked["b"].grad, x.grad]))
    return {"out": out.detach().cpu().numpy(), "dw": gw, "db": gb, "dx": gx}


def mp_moe(mx, case, dev, world):
    """``switch_moe`` of an experts case over ``make_mesh(ep=...)``: the
    output, the gradients of x, the gate and the experts, and how many
    tokens this rank dropped."""
    a = mp_inputs(case)
    mesh = mx.parallel.make_mesh(ep=case["ep"])
    t = {n: torch.tensor(a[n], device=dev, requires_grad=True)
         for n in ("x", "gate", "w1", "w2")}
    out = mx.parallel.switch_moe(
        t["x"], t["gate"], {"w1": t["w1"], "w2": t["w2"]}, mp_expert(torch),
        mesh, capacity_factor=case["cf"])
    ((out * torch.tensor(a["g"], device=dev)).sum() / world).backward()
    grads = [g.cpu().numpy() for g in _world_sum(
        [t[n].grad for n in ("x", "gate", "w1", "w2")])]
    res = {"out": out.detach().cpu().numpy()}
    res.update(zip(("dx", "dgate", "dw1", "dw2"), grads))
    res["dropped"] = int((np.abs(res["out"]).sum(-1) == 0).sum())
    return res


def mp_mesh(mx, case):
    """The mesh of ``case["mesh"]`` as this rank sees it: its shape, this
    rank's coordinates and the size of each axis's group (or the error
    ``make_mesh`` raised)."""
    import torch.distributed as dist
    try:
        mesh = mx.parallel.make_mesh(**case["mesh"])
    except mx.MXNetError as e:
        return {"error": str(e)}
    groups = {}
    for a in mesh.axis_names + (("dp", "fsdp"), None):
        g = mesh.group(a)
        groups[str(a)] = 1 if g is None else dist.get_world_size(g)
    return {"shape": dict(mesh.shape), "coords": mesh.coords,
            "devices": mesh.devices.tolist(), "groups": groups}


def mp_resume(mx, case, on):
    """The checkpoint case: a trainer on ``case["save"]`` (mesh, zero)
    takes ``case["steps"]`` steps and gives its state; each of
    ``case["loads"]`` restores it (and the JAX package's state
    ``case["jax_state"]``) and hands its state back, then steps on."""
    out = {}
    tr = mp_trainer(mx, dict(case, zero=case["save"][1]),
                    mx.parallel.make_mesh(**case["save"][0]), ctx=on)
    res = mp_trainer_run(mx, tr, case)
    out["saved"] = tr.state_dict()
    out["saved_losses"] = res["losses"]
    x, y = mp_data(case["net"])
    out["continued"] = [float(tr.step(mx.nd.array(x), mx.nd.array(y))
                              .asnumpy()) for _ in range(2)]
    del tr
    for i, (kw, zero) in enumerate(case["loads"]):
        for src in ("port", "jax"):
            state = out["saved"] if src == "port" else case["jax_state"]
            tz = mp_trainer(mx, dict(case, zero=zero),
                            mx.parallel.make_mesh(**kw), ctx=on)
            compat = mx.checkpoint.check_restore_compat(
                mx.checkpoint.ParallelTrainerState(
                    state["params"], state["slots"], state["scalars"],
                    state["residuals"], state["meta"]), tz)
            tz.load_state_dict(state)
            back = tz.state_dict()
            steps = [float(tz.step(mx.nd.array(x), mx.nd.array(y))
                           .asnumpy()) for _ in range(2)]
            out["load%d_%s" % (i, src)] = {"state": back, "losses": steps,
                                          "compat": compat}
            del tz
    return out


def mp_dropout(mx, case, on, rank):
    """A trainer of the ``drop`` net on ``case["mesh"]``, this rank's
    generator seeded with its rank: the units its Dropout dropped in each
    of ``case["steps"]`` steps, and whether the generator's state came
    back after each step."""
    from mxnet_tpu_torch.ops.registry import get_op
    mx.random.seed(rank)
    tr = mx.parallel.ParallelTrainer(
        mp_net(mx, "drop", ctx=on), mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        "sgd", {"learning_rate": 0.1},
        mesh=mx.parallel.make_mesh(**case["mesh"]))
    gen = mx.random.generator(on.torch_device)
    x, y = (mx.nd.array(a) for a in par_data(8))
    op = get_op("Dropout")
    real, out = op.fn, {"masks": [], "restored": []}

    def record(data, **attrs):
        res = real(data, **attrs)
        out["masks"].append(((res == 0) & (data != 0)).cpu().numpy())
        return res
    op.fn = record
    try:
        for _ in range(case["steps"]):
            before = gen.get_state()
            tr.step(x, y)
            out["restored"].append(torch.equal(before, gen.get_state()))
    finally:
        op.fn = real
    return out


def mp_cases_rank(rank, world, init_method, ctx, cases):
    """A rank's side of the model-axis CPU tests: every case of
    ``cases`` in turn (``kind``: mesh, attn, pipe, moe, trainer,
    resume, dropout, and chip: phase 23's :func:`mp_chip` at ``case["cfg"]``), the
    collective calls of each trainer case counted; returns this rank's
    results."""
    mx, on = par_join(rank, world, init_method, ctx)
    from mxnet_tpu_torch.parallel import collectives
    dev = on.torch_device
    try:
        out = []
        with on:
            for case in cases:
                kind = case["kind"]
                if kind == "mesh":
                    out.append(mp_mesh(mx, case))
                elif kind == "attn":
                    out.append(mp_attention(mx, case, dev, world))
                elif kind == "pipe":
                    out.append(mp_pipeline(mx, case, dev, world))
                elif kind == "moe":
                    out.append(mp_moe(mx, case, dev, world))
                elif kind == "trainer":
                    collectives.reset_collective_calls()
                    tr = mp_trainer(mx, case, mx.parallel.make_mesh(
                        **case["mesh"]), ctx=on)
                    out.append(mp_trainer_run(
                        mx, tr, case, collectives.collective_calls))
                    del tr
                elif kind == "resume":
                    out.append(mp_resume(mx, case, on))
                elif kind == "dropout":
                    out.append(mp_dropout(mx, case, on, rank))
                elif kind == "chip":
                    out.append(mp_chip(mx, on, rank, world, case["cfg"]))
                else:
                    raise ValueError(kind)
        return out
    finally:
        mx.parallel.distributed.shutdown()



# (a): the sweep kernels on every 1/n shard of the LM's buckets
PAR_SHARDS = (2, 4, 8)
# (b): GPT-2 small through ParallelTrainer, Adam, zero=2, on a fixed batch
PAR_ADAM = {"learning_rate": 1e-4}
PAR_SGD = {"learning_rate": 1e-4}
PAR_LM = {"warmup": 3, "timed": 10, "other": 2, "bf16": 3}
# the same step from one state by another ZeRO stage, by the plain sweep or
# by another world: the same fp32 arithmetic but for the order of the sums
# that the collectives take (each within 1e-6 of the largest weight)
PAR_TOL = 1e-6
# bf16's first loss from the fp32 state against fp32's: bf16 keeps 8 bits
# of each logit (2^-9 relative rounding), so the mean cross-entropy over
# 8192 tokens moves by a few 2^-9 of its value; 2^-6 is the band
PAR_BF16_TOL = 2 ** -6
# (c): ResNet-50 Module.fit, dist_sync against device, fixed batches
PAR_FIT = {"layers": LAYERS, "image": IMAGE, "batch": BATCH, "steps": 3}
# (d): run_elastic of a small net, an error injected at one step
PAR_ELASTIC = {"steps": 6, "fault": 3, "batch": 16,
               "opt": {"learning_rate": 0.1, "momentum": 0.9}}
PAR_KERNELS = ("sgd_sweep", "sgd_mom_sweep", "adam_sweep", "layernorm_fwd",
               "layernorm_bwd", "flash_attention_fwd",
               "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
               "softmax_lastaxis")


def lm_initialized(mx, ctx, config=GPT2_SMALL):
    """:func:`transformer_lm` after one forward of one token, which gives
    its deferred parameters their shapes (a trainer takes them as they
    are)."""
    lm = transformer_lm(mx, ctx, config)
    lm(mx.nd.array(np.zeros((1, 1), np.float32), ctx=ctx))
    return lm


def lm_names_shapes(mx, ctx, config=GPT2_SMALL):
    """``(names, shapes)`` of the LM's trainable parameters in
    registration order: what ``ParallelTrainer`` buckets."""
    lm = lm_initialized(mx, ctx, config)
    items = [(n, tuple(p.shape)) for n, p in lm.collect_params().items()
             if p.grad_req != "null"]
    return [n for n, _s in items], [s for _n, s in items]


def shard_sweeps(ck, dev, bw, flops, names, shapes, widths=PAR_SHARDS):
    """Phase 22 (a): for each n of ``widths``, the LM's padded fp32
    buckets as ``ParallelTrainer`` plans them (its default caps,
    ``pad_multiple=n``), each swept by K1a, K1b and K4 on its n shards one
    after another, bitwise against one launch over the whole bucket and
    against the plain mirror, the padded tails staying zero.  Each shard
    size is timed (CUDA events) beside its bound.  Returns ``{kernel:
    record}``."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.parallel.collectives import build_bucket_plan
    cap = config.get("MXNET_PARALLEL_BUCKET_BYTES")
    first = config.get("MXNET_PARALLEL_BUCKET_FIRST_BYTES")
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    out = {}
    for name, knum, n_slots, _line, ops in SWEEPS:
        fn, ref = getattr(ck, name), getattr(ck, name + "_ref")
        h = torch.tensor(sweep_hyper(name, False), dtype=torch.float32,
                         device=dev)
        rec = {"buckets": {}, "timed": [], "launches": 0}
        for n in widths:
            plan = build_bucket_plan(names, shapes, cap, first,
                                     pad_multiple=n)
            bad = torch.zeros((), dtype=torch.int64, device=dev)
            for b in plan:
                bufs = [torch.randn(b.padded_n, generator=gen, device=dev)
                        for _ in range(2 + n_slots)]
                if n_slots == 2:
                    bufs[3].abs_().mul_(0.01)
                for t in bufs:
                    t[b.n:] = 0
                whole = [t.clone() for t in bufs]
                parts = [t.clone() for t in bufs]
                plain = [t.clone() for t in bufs]
                fn(whole[0], whole[1], *whole[2:], h)
                ref(plain[0], plain[1], *plain[2:], h)
                s = b.padded_n // n
                for r in range(n):
                    fn(*[t[r * s:(r + 1) * s] for t in parts], h)
                    rec["launches"] += 1
                for a, w, q in zip(parts, whole, plain):
                    bad += (a.view(torch.int32) != w.view(torch.int32)).sum()
                    bad += (a.view(torch.int32) != q.view(torch.int32)).sum()
                    bad += (a[b.n:] != 0).sum()
            if int(bad.item()):
                raise AssertionError(
                    "phase 22 (a): %s %s on the %d-way shards of the LM's "
                    "%d buckets: %d words differ from the whole-bucket "
                    "launch or the plain mirror, or a padded tail moved"
                    % (knum, name, n, len(plan), int(bad.item())))
            rec["buckets"][n] = len(plan)
            sizes = sorted({b.padded_n for b in plan})
            for padded in (sizes[0], sizes[len(sizes) // 2], sizes[-1]):
                s = padded // n
                bufs = [torch.randn(s, generator=gen, device=dev)
                        for _ in range(2 + n_slots)]
                if n_slots == 2:
                    bufs[3].abs_().mul_(0.01)
                moved = 4 * s * (2 + 2 * n_slots + 1)
                bms, by = bound_ms(moved, ops * s, bw, flops)
                rec["timed"].append({
                    "n": n, "bucket": padded, "shard": s,
                    "ms": time_ms(lambda b=bufs: fn(b[0], b[1], *b[2:], h)),
                    "plain_ms": time_ms(
                        lambda b=bufs: ref(b[0], b[1], *b[2:], h)),
                    "bound_ms": bms, "bound_by": by})
        out[name] = dict(rec, knum=knum)
    return out


class LMTokenLoss:
    """The LM's cross-entropy per token (a ``ParallelTrainer`` loss): the
    (B, T, V) logits and (B, T) labels flattened."""

    def __init__(self, mx, vocab):
        self.ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        self.vocab = vocab

    def __call__(self, out, y):
        return self.ce(out.reshape((-1, self.vocab)), y.reshape((-1,)))


def _par_snapshot(trainer):
    return {k: v.detach().clone() for k, v in trainer.params.items()}


def _par_dev(got, ref):
    """``(bitwise, max |got - ref| over the largest |ref|)`` of two
    ``{name: tensor}`` dicts."""
    same = all(torch.equal(got[k], ref[k]) for k in ref)
    big = max(float(v.abs().max()) for v in ref.values())
    worst = max(float((got[k] - ref[k]).abs().max()) for k in ref)
    return same, worst / max(big, 1e-30)


def _par_launches(ck, mx):
    """This process's launches by kernel since the last reset, and the
    same through ``mxnet_pallas_kernel_calls_total`` by label."""
    snap = mx.telemetry.snapshot()
    return ck.kernel_calls(), _families(
        snap, "mxnet_pallas_kernel_calls_total", "kernel")


def _par_reset(ck, mx, collectives):
    ck.reset_kernel_calls()
    collectives.reset_collective_calls()
    mx.telemetry.reset()
    mx.telemetry.enable()


# the device events of a collective: NCCL's kernels (``ncclDevKernel_
# ReduceScatter_...``) and the process group's ``nccl:<op>`` records; a
# one-rank communicator launches no kernel (it copies) and records nothing
# for an in-place all-reduce
NCCL_KINDS = {"AllReduce": "all_reduce", "all_reduce": "all_reduce",
              "ReduceScatter": "reduce_scatter",
              "reduce_scatter": "reduce_scatter",
              "AllGather": "all_gather", "all_gather": "all_gather",
              "Broadcast": "broadcast", "broadcast": "broadcast"}


def _nccl_kinds(prof):
    """``({kind: NCCL kernels}, {kind: nccl:<op> records}, NCCL kernels'
    device us, {name: count})`` of the device events in a profile whose
    name holds "nccl"."""
    kernels = dict.fromkeys(set(NCCL_KINDS.values()), 0)
    records = dict(kernels)
    us, names = 0.0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or "nccl" not in e.name.lower():
            continue
        names[e.name[:80]] = names.get(e.name[:80], 0) + 1
        record = e.name.startswith("nccl:")
        if not record:
            us += _device_us(e)
        kind = next((k for frag, k in NCCL_KINDS.items()
                     if frag in e.name), None)
        if kind is not None:
            (records if record else kernels)[kind] += 1
    return kernels, records, us, names


def _par_profile(trainer, x, y, dev):
    """One step under the profiler: the collectives it issued, the NCCL
    kernels the trace holds by kind and by name, their device time and
    the compute kernels' busy time."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.parallel import collectives
    collectives.reset_collective_calls()
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.step(x, y)
        _sync(dev)
    nccl, records, nccl_us, names = _nccl_kinds(prof)
    # NCCL kernels run beside the compute on their own stream (and spin
    # while they wait for the peers): the compute's busy time leaves them
    # out
    busy = sum(_device_us(e) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "nccl" not in e.name.lower())
    return {"calls": collectives.collective_calls(), "nccl_kernels": nccl,
            "nccl_records": records, "nccl_us": nccl_us,
            "nccl_names": names, "busy_us": busy}


def par_fit(mx, on, sym, image, batch, steps, kvstore, rank=0, world=1,
            seed=SEED, classes=CLASSES):
    """``Module.fit`` of ``sym`` (SGD_PARAMS, Xavier from ``seed``, no
    shuffle) for ``steps`` global batches of ``batch`` rows, this rank
    taking its contiguous ``batch / world`` rows of each."""
    rng = np.random.RandomState(seed + 22)
    x = rng.uniform(-1, 1, (batch * steps,) + tuple(image)).astype(
        np.float32)
    y = rng.randint(0, classes, (batch * steps,)).astype(np.float32)
    local = batch // world
    idx = np.concatenate([np.arange(s * batch + rank * local,
                                    s * batch + (rank + 1) * local)
                          for s in range(steps)])
    with on:
        it = mx.io.NDArrayIter(x[idx], y[idx], batch_size=local)
    mod = mx.mod.Module(sym, context=on)
    mx.random.seed(seed)
    mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
            optimizer_params=SGD_PARAMS,
            initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                       magnitude=2))
    arg, _aux = mod.get_params()
    return {k: v._data.detach().clone() for k, v in arg.items()}


def par_elastic(mx, on, workdir, cfg=PAR_ELASTIC):
    """Phase 22 (d): ``run_elastic`` of :func:`par_net` (SGD with
    momentum, zero=2, small buckets) over a pool of batches that is a
    function of the step, uninterrupted and with an error injected at
    ``elastic.step`` ``cfg["fault"]``; returns both curves and the
    restores seen."""
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.fault.backoff import BackoffPolicy
    from mxnet_tpu_torch.fault.elastic import ElasticSupervisor, run_elastic
    pool_x, pool_y = par_data(batch=256, seed=7)
    b = cfg["batch"]

    def data_fn(step):
        i = (step * b) % 256
        return (mx.nd.array(pool_x[i:i + b], ctx=on),
                mx.nd.array(pool_y[i:i + b], ctx=on))

    buckets = []

    def factory(restart):
        del restart
        tr = mx.parallel.ParallelTrainer(
            par_net(mx, "mlp", ctx=on),
            mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(cfg["opt"]),
            zero=2, bucket_bytes=256, first_bucket_bytes=128)
        buckets.append(len(tr.bucket_plan))
        return tr

    def supervisor(retries):
        return ElasticSupervisor(retries=retries, backoff=BackoffPolicy(
            retries=retries, base_s=0.01, max_s=0.05, jitter=0.0))

    oracle = run_elastic(factory, data_fn, cfg["steps"],
                         os.path.join(workdir, "el_oracle"),
                         supervisor=supervisor(0))
    restores = []
    plan = {"rules": [{"site": "elastic.step", "kind": "raise",
                       "exc": "RuntimeError", "step": cfg["fault"],
                       "times": 1}]}
    with fault.active_plan(plan):
        got = run_elastic(factory, data_fn, cfg["steps"],
                          os.path.join(workdir, "el_fault"),
                          supervisor=supervisor(2),
                          on_restore=lambda s, v: restores.append(s))
    return {"oracle": oracle, "curve": got, "restores": restores,
            "exact": got == oracle, "buckets": buckets[0]}


def par_lm_rank(rank, world, init_method, ctx, cfg):
    """A rank of phase 22 (b)-(d): see :func:`par_lm`."""
    mx, on = par_join(rank, world, init_method, ctx)
    try:
        with on:
            return par_lm(mx, on, rank, world, cfg)
    finally:
        mx.parallel.distributed.shutdown()


def par_lm(mx, on, rank, world, cfg):
    """Phase 22 on one rank of a ``world``.  Every mode takes the first
    step from the seeded state, which a world of one saves into
    ``cfg["step1"]`` and a wider world holds to it; mode "step1" stops
    there, mode "full" goes on:

    (b) the LM (``cfg["config"]``, the global batch ``cfg["batch"]`` x
    ``cfg["t"]``) through ``ParallelTrainer`` with Adam at zero=2: warmup
    and timed steps (CUDA events), the loss falling, the launches and
    collectives of those steps, one profiled step; from the state after
    them, the kernel step against the plain sweep's, two steps of zero=0
    and zero=1 against zero=2's, SGD steps (K1a), bf16 steps;
    (c) ``cfg["fit"]``'s ResNet ``Module.fit`` under dist_sync against
    device; (d) the zero=2 state saved through a ``CheckpointManager`` and
    restored at zero=0, and :func:`par_elastic`.  Returns this rank's
    record (rank 0's is the phase's)."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.parallel import collectives
    dev = on.torch_device
    cuda = dev.type == "cuda"
    config = cfg["config"]
    out = {"rank": rank, "world": world}
    lm = lm_initialized(mx, on, config)
    x, y = lm_batch(mx, on, config["vocab_size"], cfg["batch"], cfg["t"])
    loss_fn = LMTokenLoss(mx, config["vocab_size"])
    Trainer = mx.parallel.ParallelTrainer
    tr = Trainer(lm, loss_fn, "adam", PAR_ADAM, zero=2)
    nb = len(tr.bucket_plan)
    out["buckets"] = nb
    out["comm"] = tr.comm_stats()
    out["opt_bytes"] = tr.optimizer_state_bytes()
    _par_reset(ck, mx, collectives)
    losses = [tr.step(x, y)]
    if cfg.get("step1") and rank == 0:
        got = _par_snapshot(tr)
        if world == 1:
            torch.save({k: v.cpu() for k, v in got.items()}, cfg["step1"])
        else:
            ref = {k: v.to(dev) for k, v in
                   torch.load(cfg["step1"]).items()}
            out["world_vs_1"] = _par_dev(got, ref)
        del got
    if cfg["mode"] == "step1":
        out["loss1"] = float(losses[0].asnumpy())
        if cuda:
            out["profiled"] = _par_profile(tr, x, y, dev)
        return out
    steps = cfg["warmup"] + cfg["timed"]
    for _ in range(cfg["warmup"] - 1):
        losses.append(tr.step(x, y))
    _sync(dev)
    t0 = _marker(dev)
    for _ in range(cfg["timed"]):
        losses.append(tr.step(x, y))
    t1 = _marker(dev)
    out["step_ms"] = _elapsed_ms(t0, t1) / cfg["timed"]
    out["losses"] = [float(v.asnumpy()) for v in losses]
    out["tokens_per_s"] = cfg["batch"] * cfg["t"] / out["step_ms"] * 1e3
    calls, counter = _par_launches(ck, mx)
    snap = mx.telemetry.snapshot()
    out["collective_counter"] = {
        kind: _total(snap, "mxnet_collective_ops_total", kind=kind)
        for kind in ("all_reduce", "reduce_scatter", "all_gather")}
    out["collective_calls"] = collectives.collective_calls()
    out["launches"] = {"lm_adam": {"steps": steps, "calls": calls,
                                   "counter": counter}}
    if cuda:
        out["profiled"] = _par_profile(tr, x, y, dev)
    state = tr.state_dict()
    # the kernel step against the plain sweep's, from one state
    tr.load_state_dict(state)
    first = tr.step(x, y)
    kernel = _par_snapshot(tr)
    tr.load_state_dict(state)
    with knobs("0", FUSED_OPT):
        tr.step(x, y)
    out["kernel_vs_plain"] = _par_dev(_par_snapshot(tr), kernel)
    out["fp32_first_loss"] = float(first.asnumpy())
    # two steps of each ZeRO stage from that state.  The first step's
    # gradients differ between the stages only by the order of the
    # reduction's sums (ulps on more than one rank); its updates move a
    # few ReLU inputs across zero, and the second step's gradients then
    # differ by whole terms there (PR 20: 6.1e-6 of the largest weight on
    # four cards).  The other stages replay zero=2's ReLU decisions, as
    # phase 12 does, so what is held is the stage's arithmetic
    tr.load_state_dict(state)
    with relu_decisions() as rec:
        for _ in range(cfg["other"]):
            tr.step(x, y)
    z2 = _par_snapshot(tr)
    workdir = cfg["workdir"]
    mgr = mx.checkpoint.CheckpointManager(os.path.join(workdir, "ckpt"),
                                          async_save=False)
    t = time.perf_counter()
    out["ckpt_saved"] = tr.save_checkpoint(mgr, step=1)
    out["ckpt_save_s"] = time.perf_counter() - t
    saved = tr.state_dict()
    del tr
    out["zero_vs_2"] = {}
    for zero in (0, 1):
        tz = Trainer(lm, loss_fn, "adam", PAR_ADAM, zero=zero)
        if zero == 0:
            t = time.perf_counter()
            out["ckpt_restored"] = tz.restore_checkpoint(mgr)
            out["ckpt_restore_s"] = time.perf_counter() - t
            back = tz.state_dict()
            out["ckpt_bitwise"] = all(
                np.array_equal(back[k][n], saved[k][n])
                for k in ("params", "residuals") for n in saved[k]) and all(
                np.array_equal(back["slots"][s][n], saved["slots"][s][n])
                for s in saved["slots"] for n in saved["slots"][s]) and all(
                np.array_equal(back["scalars"][s], saved["scalars"][s])
                for s in saved["scalars"])
            del back
        tz.load_state_dict(state)
        with relu_decisions(rec.masks) as replay:
            for _ in range(cfg["other"]):
                tz.step(x, y)
        out["zero_vs_2"][zero] = _par_dev(_par_snapshot(tz), z2)
        out.setdefault("relu_flips", {})[zero] = [replay.flips,
                                                  replay.total]
        del tz
    del saved, z2, kernel, rec
    # SGD (K1a) and bf16
    _par_reset(ck, mx, collectives)
    ts = Trainer(lm, loss_fn, "sgd", PAR_SGD, zero=2)
    sgd = [float(ts.step(x, y).asnumpy()) for _ in range(cfg["other"])]
    out["launches"]["lm_sgd"] = {"steps": cfg["other"], "losses": sgd,
                                 "calls": _par_launches(ck, mx)[0]}
    del ts
    _par_reset(ck, mx, collectives)
    tb = Trainer(lm, loss_fn, "adam", PAR_ADAM, zero=2, dtype="bfloat16")
    tb.load_state_dict(state)
    bf = [float(tb.step(x, y).asnumpy()) for _ in range(cfg["bf16"])]
    out["launches"]["lm_bf16"] = {"steps": cfg["bf16"],
                                  "calls": _par_launches(ck, mx)[0]}
    out["bf16_losses"] = bf
    del tb, state, lm
    if cuda:
        torch.cuda.empty_cache()
    # (c) dist_sync against device
    fit = cfg["fit"]
    sym = resnet_symbol(fit["layers"], fit["image"])
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _par_reset(ck, mx, collectives)
        dist = par_fit(mx, on, sym, fit["image"], fit["batch"],
                       fit["steps"], "dist_sync", rank, world)
        out["launches"]["fit"] = {"steps": fit["steps"],
                                  "calls": _par_launches(ck, mx)[0]}
        import hashlib
        digest = hashlib.sha256()
        for k in sorted(dist):
            digest.update(dist[k].cpu().numpy().tobytes())
        out["fit_digest"] = digest.hexdigest()
        if rank == 0:
            ref = par_fit(mx, on, sym, fit["image"], fit["batch"],
                          fit["steps"], "device")
            out["fit_vs_device"] = _par_dev(dist, ref)
    finally:
        torch.backends.cudnn.deterministic = saved_det
    # (d) the elastic loop
    _par_reset(ck, mx, collectives)
    out["elastic"] = par_elastic(mx, on, workdir)
    # the uninterrupted run's steps, then the faulted run's (the error
    # fires before its step runs, and the restore replays from there)
    out["launches"]["elastic"] = {"steps": 2 * PAR_ELASTIC["steps"],
                                  "calls": _par_launches(ck, mx)[0]}
    return out


def par_checks(rec, nb_lm, ranks, on_card=True):
    """Phase 22 (b)-(d)'s checks on rank 0's record ``rec`` (``ranks``:
    every rank's); returns the failures (empty: the phase holds).  The
    launch counts hold only where the kernels launch (on the card)."""
    bad = []
    comm = rec["comm"]["kinds"]
    steps = rec["launches"]["lm_adam"]["steps"]
    loss = rec["losses"]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        bad.append("the LM's loss on the fixed batch went %s" % loss)
    for what, (same, dev) in [("the kernel step against the plain "
                               "sweep's", rec["kernel_vs_plain"])] + [
            ("zero=%d's two steps against zero=2's" % z, v)
            for z, v in sorted(rec["zero_vs_2"].items())] + (
            [("world %d's first step against world 1's" % rec["world"],
              rec["world_vs_1"])] if "world_vs_1" in rec else []):
        if not (same or dev <= PAR_TOL):
            bad.append("%s: %.3g of the largest weight" % (what, dev))
    for kind in ("all_reduce", "reduce_scatter", "all_gather"):
        want = comm[kind]["ops"] * steps
        if rec["collective_counter"][kind] != want:
            bad.append("mxnet_collective_ops_total{kind=%s} %s over %d "
                       "steps; the wire model says %d" % (
                           kind, rec["collective_counter"][kind], steps,
                           want))
        issued = rec["collective_calls"][kind]
        extra = steps if kind == "all_reduce" else 0  # the global loss
        if issued != want + extra:
            bad.append("%d %s calls over %d steps; expected %d" % (
                issued, kind, steps, want + extra))
    prof = rec.get("profiled")
    if prof is not None:
        # the counters a step against the trace: NCCL's kernels on more
        # than one rank (the global loss's all-reduce besides the wire
        # model's), the nccl:<op> records of a one-rank communicator
        many = rec["world"] > 1
        trace = prof["nccl_kernels" if many else "nccl_records"]
        want = {k: comm[k]["ops"] + int(many and k == "all_reduce")
                for k in ("all_reduce", "reduce_scatter", "all_gather")}
        if any(trace[k] != n for k, n in want.items()):
            bad.append("the profiled step's %s %s against the collective "
                       "counters' %s a step" % (
                           "NCCL kernels" if many else "nccl records",
                           trace, want))
    bf, f1 = rec["bf16_losses"], rec["fp32_first_loss"]
    if not (np.isfinite(bf).all()
            and abs(bf[0] - f1) <= PAR_BF16_TOL * abs(f1)):
        bad.append("bf16's first loss %.6f against fp32's %.6f (band "
                   "%.3g relative)" % (bf[0], f1, PAR_BF16_TOL))
    if not (rec["ckpt_saved"] and rec["ckpt_restored"] == 1
            and rec["ckpt_bitwise"]):
        bad.append("the zero=2 checkpoint restored at zero=0: saved %s, "
                   "restored %s, bitwise %s" % (
                       rec["ckpt_saved"], rec["ckpt_restored"],
                       rec["ckpt_bitwise"]))
    if len({r["fit_digest"] for r in ranks}) != 1:
        bad.append("the dist_sync replicas differ after the fit")
    if rec["world"] == 1 and not (rec["fit_vs_device"][0]
                                  or rec["fit_vs_device"][1] <= PAR_TOL):
        bad.append("dist_sync against device: %.3g of the largest weight"
                   % rec["fit_vs_device"][1])
    el = rec["elastic"]
    if not (el["exact"] and el["restores"] == [PAR_ELASTIC["fault"]]):
        bad.append("run_elastic: curve %s against %s, restores %s" % (
            el["curve"], el["oracle"], el["restores"]))
    if on_card:
        runs = rec["launches"]
        per_step = {"layernorm_fwd": 25, "layernorm_bwd": 25,
                    "flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
                    "flash_attention_bwd_dkv": 12}
        want = [("lm_adam", "adam_sweep", nb_lm * steps)] + [
            ("lm_adam", k, v * steps) for k, v in per_step.items()] + [
            ("lm_sgd", "sgd_sweep", nb_lm * runs["lm_sgd"]["steps"]),
            ("fit", "softmax_lastaxis", runs["fit"]["steps"]),
            ("elastic", "sgd_mom_sweep",
             el["buckets"] * runs["elastic"]["steps"])]
        for run, kernel, n in want:
            if runs[run]["calls"][kernel] != n:
                bad.append("%s: %d %s launches, expected %d" % (
                    run, runs[run]["calls"][kernel], kernel, n))
        calls, counter = runs["lm_adam"]["calls"], runs["lm_adam"]["counter"]
        from mxnet_tpu_torch.ops.cuda_kernels import _TELEMETRY_LABEL
        by_label = {}
        for k, v in calls.items():
            if v:
                by_label[_TELEMETRY_LABEL[k]] = \
                    by_label.get(_TELEMETRY_LABEL[k], 0) + v
        if by_label != {k: v for k, v in counter.items() if v}:
            bad.append("mxnet_pallas_kernel_calls_total %s against the "
                       "wrappers' counts %s" % (counter, by_label))
    return bad


def par_launches(rec):
    """``{kernel: {run: launches, ..., "total": n}}`` over phase 22's main
    path runs."""
    out = {}
    for run, r in rec["launches"].items():
        for k in PAR_KERNELS:
            n = r["calls"].get(k, 0)
            if n:
                d = out.setdefault(k, {"total": 0})
                d[run] = n
                d["total"] += n
    return out


def parallel_phase(mx, ck, dev, bw, flops, smi, workdir_parent=None):
    """Phase 22 on the card: (a) :func:`shard_sweeps` here; (b)-(d) in a
    world of ``torch.cuda.device_count()`` ranks over NCCL (worlds of 1
    and 2 first where there are more cards, for the first step's
    comparison).  Prints the phase's lines; returns its record."""
    import tempfile
    t0 = time.perf_counter()
    names, shapes = lm_names_shapes(mx, mx.gpu(0))
    torch.cuda.empty_cache()
    shards = shard_sweeps(ck, dev, bw, flops, names, shapes)
    t_a = time.perf_counter() - t0
    for name, r in shards.items():
        print("phase 22 (a) %s %s on every 1/n shard of the LM's padded "
              "buckets (%s) bitwise the whole-bucket launch and the plain "
              "mirror, tails zero, %d shard launches; %s" % (
                  r["knum"], name, ", ".join(
                      "n=%d: %d buckets" % kv for kv in r["buckets"].items()),
                  r["launches"], "; ".join(
                      "n=%d shard of %d: %.4f ms (plain %.4f), bound %.4f"
                      % (j["n"], j["bucket"], j["ms"], j["plain_ms"],
                         j["bound_ms"]) for j in r["timed"])), flush=True)
    world = torch.cuda.device_count()
    if world == 1:
        print("phase 22: one card, so (b)-(d) run a world of one rank over "
              "NCCL; the multi-rank run is held to the JAX package's 2- "
              "and 4-device meshes on the CPU over gloo "
              "(tests/test_torch_parallel.py)", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.TemporaryDirectory(prefix=".chip_smoke_par_",
                                          dir=workdir_parent or here)
    cfg = dict(PAR_LM, mode="full", config=GPT2_SMALL, batch=LM_BATCH,
               t=LM_T[0], fit=PAR_FIT, workdir=workdir.name)
    target = "chip_smoke:par_lm_rank"
    try:
        steps1 = {}
        if world >= 2:
            cfg["step1"] = os.path.join(workdir.name, "step1.pt")
            steps1[1] = run_ranks(target, 1, (dict(cfg, mode="step1"),),
                                  ctx="gpu", workdir=workdir.name)[0]
            if world >= 4:
                steps1[2] = run_ranks(target, 2, (dict(cfg, mode="step1"),),
                                      ctx="gpu", workdir=workdir.name)[0]
        t = time.perf_counter()
        ranks = run_ranks(target, world, (cfg,), ctx="gpu",
                          workdir=workdir.name)
        t_b = time.perf_counter() - t
    finally:
        workdir.cleanup()
    rec = ranks[0]
    bad = par_checks(rec, rec["buckets"], ranks)
    if 2 in steps1 and not (steps1[2]["world_vs_1"][0]
                            or steps1[2]["world_vs_1"][1] <= PAR_TOL):
        bad.append("world 2's first step against world 1's: %.3g"
                   % steps1[2]["world_vs_1"][1])
    prof = rec["profiled"]
    print("phase 22 (b) on %s, NCCL %s: GPT-2-small-width TransformerLM "
          "fp32 through "
          "ParallelTrainer(adam, zero=2) on %d rank(s), global batch %d x "
          "%d, %d buckets: %.2f ms/step (CUDA events, %d timed after %d), "
          "%.0f tokens/s; loss %.4f -> %.4f; collectives a step %s "
          "(calls %s); the profiled step: compute busy %.0f us, NCCL %.0f us "
          "in kernels %s; kernel step vs plain sweep %s; zero=0/1 vs zero=2 "
          "%s (ReLU inputs flipped against zero=2's decisions %s); SGD (K1a) "
          "losses %s; bf16 first loss %.5f vs fp32 %.5f" % (
              smi, torch.cuda.nccl.version(),
              rec["world"], LM_BATCH, LM_T[0], rec["buckets"],
              rec["step_ms"], PAR_LM["timed"], PAR_LM["warmup"],
              rec["tokens_per_s"], rec["losses"][0], rec["losses"][-1],
              {k: v["ops"] for k, v in rec["comm"]["kinds"].items()},
              rec["collective_calls"], prof["busy_us"], prof["nccl_us"],
              prof["nccl_kernels"], rec["kernel_vs_plain"],
              rec["zero_vs_2"], rec["relu_flips"],
              rec["launches"]["lm_sgd"]["losses"],
              rec["bf16_losses"][0], rec["fp32_first_loss"]), flush=True)
    el = rec["elastic"]
    print("phase 22 (c, d) on %s: ResNet-%d Module.fit dist_sync batch %d, "
          "%d steps against device: %s%s, replicas %s; checkpoint zero=2 -> "
          "zero=0 bitwise %s (save %.2f s, restore %.2f s); run_elastic "
          "with an error at step %d: curve exact %s, restored at %s; "
          "(a) %.1f s, (b)-(d) %.1f s" % (
              smi, PAR_FIT["layers"], PAR_FIT["batch"], PAR_FIT["steps"],
              rec.get("fit_vs_device"), "" if rec["world"] == 1 else
              " (held at one rank only: on more, each rank's BatchNorm "
              "takes its own rows' moments, as the reference's dist_sync "
              "does)", "equal" if len(
                  {r["fit_digest"] for r in ranks}) == 1 else "differ",
              rec["ckpt_bitwise"], rec["ckpt_save_s"],
              rec["ckpt_restore_s"], PAR_ELASTIC["fault"], el["exact"],
              el["restores"], t_a, t_b), flush=True)
    if bad:
        raise AssertionError("phase 22: " + "; ".join(bad))
    return {"card": smi, "world": rec["world"],
            "shard_sweeps": shards, "lm": rec,
            "first_step_worlds": steps1,
            "launches_parallel": par_launches(rec),
            "seconds": time.perf_counter() - t0}


# -- phase 23 on the card -----------------------------------------------------
# (a): GPT-2 small through ParallelTrainer (Adam, zero=2) on these meshes of
# four cards (on another count of cards, the one mesh of them all over dp)
MP_MESHES = ({"dp": 2, "tp": 2}, {"dp": 1, "fsdp": 4}, {"dp": 2, "sp": 2})
MP_WARMUP = 2
MP_TIMED = 5
# a mesh's first SGD update from the seeded state against the dp-only
# trainer's: the same fp32 sums in other orders, held to 1e-5 of the
# largest update.  The probe's learning rate makes the update (lr x the
# gradient, up to ~20) dwarf the weights, so the parameters' change is
# the gradient to its own rounding: at PAR_SGD's 1e-4 the change is
# ~2e-7, and a one-ulp difference in a weight's rounding is 1.7% of it
MP_TOL = 1e-5
MP_PROBE_SGD = {"learning_rate": 1e4}
# each timed Adam run's losses against the dp-only trainer's, step for
# step, relative to the loss: the same sums in other orders (the meshes
# agreed within 6e-7 of each other over 7 steps on four H100s); a wrong
# block of a gradient moves the loss by far more after a step
MP_LOSS_TOL = 1e-5
# (b) the LM's forward under sp over every card at this length (batch 1),
# Ulysses at (B, T, H, D) and the ring at a length that pads; (c) the
# pipeline of TransformerEncoderCells at (B, T, units), M microbatches;
# (d) the experts: E FFNs D -> F -> D over T tokens, at a capacity factor
# that keeps every token and one that drops some
MP_CFG = {"warmup": MP_WARMUP, "timed": MP_TIMED, "batch": LM_BATCH,
          "t": LM_T[0], "sp_t": 8192, "ulysses": (8, 4096, 12, 64),
          "ring_t": 4093, "pipe": {"batch": 8, "t": 1024, "m": 8},
          "moe": {"e": 8, "tokens": 8192, "f": 3072, "cf": (4.0, 0.5)}}
# the pieces against their one-rank forms (local_attention, the sequential
# apply, the same routing on one rank): the same fp32 arithmetic in other
# orders and shapes, of the largest value held
MP_ATTN_TOL = 1e-5
MP_KERNELS = ("adam_sweep", "layernorm_fwd", "layernorm_bwd",
              "flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "bias_softmax", "softmax_bwd",
              "softmax_lastaxis")
# the kernels that four cards must launch on the phase's main path
MP_MUST_LAUNCH = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv", "layernorm_fwd",
                  "layernorm_bwd", "adam_sweep")


def moe_reference(x, gate_w, params, expert_fn, ep, capacity_factor):
    """``switch_moe``'s semantics on one rank, routed token by token in
    plain Python: the tokens in order, each of the ``ep`` source blocks
    with its own capacity; a token goes to the first expert of its
    largest gate probability and takes the next slot of that expert's
    queue from its block, or is dropped (zero) once the queue holds the
    capacity; each kept token's output is its expert's scaled by its
    gate probability (differentiable).  Each expert runs over the queues
    of every source at once, zero rows in the empty slots, as the rank
    that holds it does: the same GEMM shapes, so no ReLU input within
    rounding of zero flips between the two."""
    T, D = x.shape
    E = gate_w.shape[1]
    t_local = T // ep
    C = max(int(capacity_factor * t_local / E), 1)
    # each source block's gate as its rank computes it (the same GEMM)
    probs = torch.cat([torch.softmax(x[s * t_local:(s + 1) * t_local]
                                     @ gate_w, dim=-1) for s in range(ep)])
    zero = T                       # the index of a zero row
    queues = [[zero] * (ep * C) for _ in range(E)]
    filled = [[0] * E for _ in range(ep)]
    expert, row_of = [], []
    for t, p in enumerate(probs.detach().cpu().tolist()):
        src, e = t // t_local, 0
        for i in range(1, E):
            if p[i] > p[e]:
                e = i
        n = filled[src][e]
        filled[src][e] = n + 1
        expert.append(e)
        if n < C:
            queues[e][src * C + n] = t
            row_of.append(e * ep * C + src * C + n)
        else:
            row_of.append(E * ep * C)
    xz = torch.cat([x, x.new_zeros((1, D))])
    ys = [expert_fn({k: v[e] for k, v in params.items()},
                    xz[torch.tensor(queues[e], device=x.device)])
          for e in range(E)]
    ys = torch.cat(ys + [x.new_zeros((1, D))])
    dev = x.device
    gate = probs[torch.arange(T, device=dev),
                 torch.tensor(expert, device=dev)]
    return ys[torch.tensor(row_of, device=dev)] * gate[:, None]


def _seeded(dev, shapes, seed=SEED, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev) * scale for s in shapes]


def mp_sp_attention(mx, fn, mesh, dev, b, t, h, d, world, rank,
                    window=contextlib.nullcontext()):
    """``fn`` (ring or Ulysses) at (b, t, h, d) causal over ``mesh``,
    forward and backward (inside ``window``), against ``local_attention``
    on one rank: the errors of the output and of dq, dk, dv (rank 0's;
    None elsewhere)."""
    q, k, v, w = _seeded(dev, [(b, t, h, d)] * 4)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    with window:
        out = fn(*leaves, mesh=mesh, causal=True)
        ((out * w).sum() / world).backward()
    grads = _world_sum([a.grad for a in leaves])
    if rank != 0:
        return None
    ref = [a.clone().requires_grad_() for a in (q, k, v)]
    want = mx.parallel.local_attention(*ref, causal=True)
    (want * w).sum().backward()
    errs = {n: _rel(g, r.grad)
            for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
    return dict(errs, out=_rel(out, want))


def mp_pipeline_chip(mx, on, dev, cfg, world, rank, config=GPT2_SMALL,
                     window=contextlib.nullcontext()):
    """``pipeline_apply`` of ``world`` stages, each one
    ``TransformerEncoderCell`` of ``config``'s widths (causal), at
    ``cfg``'s shape and microbatches, forward and backward (inside
    ``window``), against the sequential apply of each microbatch: the
    errors of the output and of the gradients of the stacked parameters
    and of x (rank 0's)."""
    from mxnet_tpu_torch.gluon.contrib.transformer import \
        TransformerEncoderCell
    units, hidden, heads = (config[k] for k in ("units", "hidden_size",
                                                 "num_heads"))
    cells = []
    for s in range(world):
        mx.random.seed(SEED + s)
        cell = TransformerEncoderCell(units, hidden, heads, causal=True)
        cell.initialize(mx.init.Xavier(), ctx=on)
        cell(mx.nd.array(np.zeros((1, 8, units), np.float32), ctx=on))
        cells.append(cell)
    names = [n[len(cells[0].prefix):] for n in cells[0].collect_params()]
    stacked = {n: torch.stack([c.collect_params()[c.prefix + n].data()._data
                               for c in cells]).detach() for n in names}
    full = [cells[0].prefix + n for n in names]
    apply_fn = mx.parallel.pure_block_apply(cells[0], full, True)

    def stage(p, act):
        return apply_fn({f: p[n] for f, n in zip(full, names)}, None, act)

    b, t = cfg["batch"], cfg["t"]
    x, g = _seeded(dev, [(b, t, units)] * 2, seed=SEED + 23)
    leaves = {n: v.clone().requires_grad_() for n, v in stacked.items()}
    xr = x.clone().requires_grad_()
    mesh = mx.parallel.make_mesh(pp=world)
    with window:
        out = mx.parallel.pipeline_apply(stage, leaves, xr, mesh,
                                         num_microbatches=cfg["m"])
        ((out * g).sum() / world).backward()
    grads = _world_sum([leaves[n].grad for n in names] + [xr.grad])
    if rank != 0:
        return None
    # the sequential apply, microbatch by microbatch: the pipeline's GEMM
    # shapes, so no ReLU input within rounding of zero flips between the
    # two (a flip moves a weight's gradient by percents; phase 12)
    ref = {n: v.clone().requires_grad_() for n, v in stacked.items()}
    xs = x.clone().requires_grad_()
    acts = []
    for act in xs.chunk(cfg["m"]):
        for s in range(world):
            act = stage({n: v[s] for n, v in ref.items()}, act)
        acts.append(act)
    act = torch.cat(acts)
    (act * g).sum().backward()
    return {"out": _rel(out, act), "dx": _rel(grads[-1], xs.grad),
            "dparams": max(_rel(gp, ref[n].grad)
                           for n, gp in zip(names, grads))}


def mp_moe_chip(mx, dev, cfg, world, rank, units=GPT2_SMALL["units"],
                counted=lambda cf: contextlib.nullcontext()):
    """``switch_moe`` with ep over every card, E FFN experts, at each
    capacity factor of ``cfg``, forward and backward (inside
    ``counted(cf)``), against :func:`moe_reference`: per factor the
    errors of the output and the gradients, and the tokens dropped."""
    E, T, F, D = cfg["e"], cfg["tokens"], cfg["f"], units
    x, gate, w1, w2, g = _seeded(dev, [(T, D), (D, E), (E, D, F), (E, F, D),
                                       (T, D)], seed=SEED + 24, scale=0.05)
    x, gate, g = x * 20, gate * 20, g * 20

    def expert(p, tok):
        return torch.relu(tok @ p["w1"]) @ p["w2"]

    mesh = mx.parallel.make_mesh(ep=world)
    res = {}
    for cf in cfg["cf"]:
        t = [a.clone().requires_grad_() for a in (x, gate, w1, w2)]
        with counted(cf):
            out = mx.parallel.switch_moe(t[0], t[1],
                                         {"w1": t[2], "w2": t[3]}, expert,
                                         mesh, capacity_factor=cf)
            ((out * g).sum() / world).backward()
        grads = _world_sum([a.grad for a in t])
        if rank != 0:
            continue
        r = [a.clone().requires_grad_() for a in (x, gate, w1, w2)]
        want = moe_reference(r[0], r[1], {"w1": r[2], "w2": r[3]}, expert,
                             world, cf)
        (want * g).sum().backward()
        res[cf] = {"out": _rel(out, want),
                   "grads": max(_rel(a, b.grad)
                                for a, b in zip(grads, r)),
                   "dropped": int((want.detach().abs().sum(-1) == 0).sum())}
    return res


def _mp_gather_rows(t, mesh):
    """The boolean ``t`` of every rank of ``mesh``'s batch axes, joined
    along dim 0 in rank order (a collective)."""
    from mxnet_tpu_torch.parallel.collectives import _gather_dim
    group = mesh.group(("dp", "fsdp"))
    if group is None:
        return t
    return _gather_dim(t.to(torch.uint8).contiguous(), 0, group).bool()


def _mp_update(trainer, init):
    """``{name: value - init}``: what the trainer's steps moved each
    parameter by (a collective: every rank reads the whole values)."""
    return {k: v.detach() - init[k] for k, v in trainer.params.items()}


def mp_chip_rank(rank, world, init_method, ctx, cfg):
    """A rank of phase 23: see :func:`mp_chip`."""
    mx, on = par_join(rank, world, init_method, ctx)
    try:
        with on:
            return mp_chip(mx, on, rank, world, cfg)
    finally:
        mx.parallel.distributed.shutdown()


@contextlib.contextmanager
def _mp_counted(ck, out, run):
    """The launches of the main-path call run inside: the counts set to 0
    on entry and read into ``out["launches"][run]`` on exit."""
    ck.reset_kernel_calls()
    yield
    out["launches"][run] = ck.kernel_calls()


def mp_chip(mx, on, rank, world, cfg):
    """Phase 23 on one rank of a ``world``, the kernel launches of each
    main-path call counted from zero just before it and read just after
    (set-up forwards and references run outside those windows):

    (a) the LM (``cfg["config"]``, the global batch ``cfg["batch"]`` x
    ``cfg["t"]``) through ``ParallelTrainer`` with Adam at zero=2 on each
    mesh of ``cfg["meshes"]``: warmup and timed steps (CUDA events), one
    profiled step; on more than one rank first the update of one SGD step
    (``MP_PROBE_SGD``) from the seeded state against the dp-only
    trainer's, with the dp-only step's ReLU decisions replayed on each
    rank's rows, as phase 22 does (SGD's update is the gradient; Adam's
    first step moves a weight whose gradient is rounding noise by +-lr
    whatever the noise's size, so it would hold the sums' order, not the
    mesh's arithmetic), and the Adam run's losses against the dp-only
    trainer's, step for step;
    (b) the LM at ``cfg["sp_t"]`` (batch 1) under ``mesh_scope`` of an sp
    mesh over the world (its attention through the ring) against its
    dense forward; Ulysses at ``cfg["ulysses"]`` and the ring at
    ``cfg["ring_t"]``, causal, forward and backward, against
    ``local_attention``;
    (c) :func:`mp_pipeline_chip`; (d) :func:`mp_moe_chip`.
    Returns this rank's record (rank 0's holds the comparisons)."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.parallel import collectives
    dev = on.torch_device
    cuda = dev.type == "cuda"
    config = cfg["config"]
    out = {"rank": rank, "world": world, "launches": {}, "trainers": {}}
    lm = lm_initialized(mx, on, config)
    x, y = lm_batch(mx, on, config["vocab_size"], cfg["batch"], cfg["t"])
    loss_fn = LMTokenLoss(mx, config["vocab_size"])
    Trainer = mx.parallel.ParallelTrainer
    # (a)
    ref = init = masks = adam = None
    steps = cfg["warmup"] + cfg["timed"]
    if world > 1:
        init = {k: p.data()._data.detach().clone()
                for k, p in lm.collect_params().items()}
        tr = Trainer(lm, loss_fn, "sgd", MP_PROBE_SGD, zero=2)
        with relu_decisions() as dec:
            tr.step(x, y)
        ref = _mp_update(tr, init)
        # every rank's ReLU decisions, whole batch (rank order is row
        # order), for the meshes to replay on their own rows
        masks = [_mp_gather_rows(m, tr.mesh) for m in dec.masks]
        del tr, dec
        # the dp-only trainer's Adam losses, for the meshes' timed runs
        tr = Trainer(lm, loss_fn, "adam", PAR_ADAM, zero=2)
        adam = [float(tr.step(x, y).asnumpy()) for _ in range(steps)]
        del tr
    for kw in cfg["meshes"]:
        name = "x".join("%s%d" % kv for kv in kw.items()) or "dp%d" % world
        mesh = mx.parallel.make_mesh(**kw)
        rec = {"mesh": kw}
        if ref is not None:
            tr = Trainer(lm, loss_fn, "sgd", MP_PROBE_SGD, zero=2,
                         mesh=mesh)
            rows = mx.parallel.batch_sharded(mesh, axes=("dp", "fsdp"))
            with relu_decisions([rows.local(m) for m in masks]) as replay:
                tr.step(x, y)
            rec["vs_dp"] = _par_dev(_mp_update(tr, init), ref)
            rec["relu_flips"] = [replay.flips, replay.total]
            del tr
        tr = Trainer(lm, loss_fn, "adam", PAR_ADAM, zero=2, mesh=mesh)
        rec.update(comm=tr.comm_stats(),
                   opt_bytes=tr.optimizer_state_bytes(),
                   sharded=sum(1 for p in tr.plan_spec()["params"]
                               if any(p["spec"])))
        _par_reset(ck, mx, collectives)
        with _mp_counted(ck, out, "trainer_" + name):
            losses = [tr.step(x, y) for _ in range(cfg["warmup"])]
            _sync(dev)
            t0 = _marker(dev)
            for _ in range(cfg["timed"]):
                losses.append(tr.step(x, y))
            t1 = _marker(dev)
        rec["step_ms"] = _elapsed_ms(t0, t1) / cfg["timed"]
        rec["tokens_per_s"] = cfg["batch"] * cfg["t"] / rec["step_ms"] * 1e3
        rec["losses"] = [float(v.asnumpy()) for v in losses]
        if adam is not None:
            rec["losses_vs_dp"] = max(abs(a - b) / abs(b) for a, b in
                                      zip(rec["losses"], adam))
        rec["collective_calls"] = collectives.collective_calls()
        rec["steps"] = len(losses)
        if cuda:
            rec["profiled"] = _par_profile(tr, x, y, dev)
        out["trainers"][name] = rec
        del tr
        if cuda:
            torch.cuda.empty_cache()
    del ref, init, masks, lm
    # (b)
    mesh = mx.parallel.make_mesh(sp=world)
    lm8 = lm_initialized(mx, on, dict(config, max_len=cfg["sp_t"]))
    ids = lm_tokens(mx, on, config["vocab_size"], 1, cfg["sp_t"])
    with torch.no_grad():
        with _mp_counted(ck, out, "lm_sp_forward"), \
                mx.parallel.mesh_scope(mesh):
            ring = lm8(ids)._data
        if rank == 0:
            dense = lm8(ids)._data
            out["lm_sp"] = {"err": _rel(ring, dense),
                            "finite": bool(torch.isfinite(ring).all())}
            del dense
    del lm8, ring
    b, t, h, d = cfg["ulysses"]
    out["ulysses"] = mp_sp_attention(
        mx, mx.parallel.ulysses_attention, mesh, dev, b, t, h, d, world,
        rank, _mp_counted(ck, out, "ulysses"))
    out["ring"] = mp_sp_attention(
        mx, mx.parallel.ring_attention, mesh, dev, b, cfg["ring_t"], h, d,
        world, rank, _mp_counted(ck, out, "ring"))
    if cuda:
        torch.cuda.empty_cache()
    # (c), (d)
    out["pipeline"] = mp_pipeline_chip(mx, on, dev, cfg["pipe"], world,
                                       rank, config,
                                       _mp_counted(ck, out, "pipeline"))
    out["moe"] = mp_moe_chip(
        mx, dev, cfg["moe"], world, rank, config["units"],
        lambda cf: _mp_counted(ck, out, "moe_cf%g" % cf))
    ck.reset_kernel_calls()
    return out


def mp_launches(rec):
    """``{kernel: {run: launches, ..., "total": n}}`` over phase 23's main
    path runs (rank 0's counts)."""
    out = {}
    for run, calls in rec["launches"].items():
        for k in MP_KERNELS:
            n = calls.get(k, 0)
            if n:
                d = out.setdefault(k, {"total": 0})
                d[run] = n
                d["total"] += n
    return out


def mp_checks(rec, on_card=True):
    """Phase 23's checks on rank 0's record; returns the failures (empty:
    the phase holds).  The launches hold only on the card, and the
    kernels every one of them must launch only on four cards (on fewer,
    the one-rank meshes run the same kernels, counted all the same)."""
    bad = []
    for name, r in rec["trainers"].items():
        loss = r["losses"]
        if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
            bad.append("(a) %s: the loss on the fixed batch went %s"
                       % (name, loss))
        if "vs_dp" in r and not (r["vs_dp"][0] or r["vs_dp"][1] <= MP_TOL):
            bad.append("(a) %s: the first SGD update against dp=%d's: %.3g "
                       "of the largest" % (name, rec["world"],
                                           r["vs_dp"][1]))
        if "losses_vs_dp" in r and not r["losses_vs_dp"] <= MP_LOSS_TOL:
            bad.append("(a) %s: the Adam losses against dp=%d's: %.3g of "
                       "the loss" % (name, rec["world"], r["losses_vs_dp"]))
    lm = rec["lm_sp"]
    if not (lm["finite"] and lm["err"] <= MP_ATTN_TOL):
        bad.append("(b) the LM under sp against its dense forward: %s" % lm)
    for what in ("ulysses", "ring"):
        for k, v in rec[what].items():
            if not v <= MP_ATTN_TOL:
                bad.append("(b) %s %s: %.3g" % (what, k, v))
    for k, v in rec["pipeline"].items():
        if not v <= MP_ATTN_TOL:
            bad.append("(c) pipeline %s against the sequential apply: %.3g"
                       % (k, v))
    for cf, r in rec["moe"].items():
        if not (r["out"] <= MP_ATTN_TOL and r["grads"] <= MP_ATTN_TOL):
            bad.append("(d) switch_moe at capacity factor %g: %s" % (cf, r))
        if (r["dropped"] > 0) != (cf < 1):
            bad.append("(d) capacity factor %g dropped %d tokens"
                       % (cf, r["dropped"]))
    if on_card:
        launched = mp_launches(rec)
        must = MP_MUST_LAUNCH if rec["world"] >= 4 else ()
        for k in must:
            if not launched.get(k, {}).get("total"):
                bad.append("kernel %s was not launched on phase 23's main "
                           "path" % k)
    return bad


def mp_kernel_shapes(mx, ck, dev):
    """K7a, K7b and K7c at the per-rank shape four ranks' Ulysses step of
    GPT-2 small sees, (8 x 12/4, 1024, 64) causal (``local_attention``
    with 3 heads), against the plain route (``impl="einsum"``): the
    errors of o, dq, dk, dv over the largest value, and the launches of
    the kernel route."""
    b, t, h, d = 8, 1024, GPT2_SMALL["num_heads"] // 4, 64
    q, k, v, w = _seeded(dev, [(b, t, h, d)] * 4, seed=SEED + 25)
    res = {}
    ck.reset_kernel_calls()
    routes = {}
    for impl in ("flash", "einsum"):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        o = mx.parallel.local_attention(*leaves, causal=True, impl=impl)
        (o * w).sum().backward()
        routes[impl] = [o] + [a.grad for a in leaves]
        if impl == "flash":
            res["launches"] = ck.kernel_calls()
    for n, a, bb in zip(("o", "dq", "dk", "dv"), routes["flash"],
                        routes["einsum"]):
        res[n] = _rel(a, bb)
    res["shape"] = (b * h, t, d)
    ck.reset_kernel_calls()
    return res


def model_parallel_phase(mx, ck, dev, smi, workdir_parent=None):
    """Phase 23 on the card: K7a/K7b/K7c at Ulysses's per-rank shape here,
    then :func:`mp_chip` in a world of ``torch.cuda.device_count()`` ranks
    over NCCL.  Prints the phase's lines; returns its record."""
    import tempfile
    t0 = time.perf_counter()
    kern = mp_kernel_shapes(mx, ck, dev)
    bad = ["K7a/K7b/K7c at %s: %s %.3g" % (kern["shape"], n, kern[n])
           for n in ("o", "dq", "dk", "dv") if not kern[n] <= MP_ATTN_TOL]
    print("phase 23 K7a/K7b/K7c at Ulysses's per-rank shape %s causal fp32 "
          "(GPT-2 small, sp=4) against the plain route: o %.3g, dq %.3g, "
          "dk %.3g, dv %.3g of the largest value; launches %s" % (
              kern["shape"], kern["o"], kern["dq"], kern["dk"], kern["dv"],
              {k: v for k, v in kern["launches"].items() if v}), flush=True)
    world = torch.cuda.device_count()
    if world == 1:
        print("phase 23: one card, so every entry point runs at a mesh of "
              "one rank (held to local_attention, the sequential apply and "
              "the one-rank routing); the multi-rank runs are held to the "
              "JAX package on the CPU over gloo "
              "(tests/test_torch_model_parallel.py) and by this phase on a "
              "machine with four cards", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.TemporaryDirectory(prefix=".chip_smoke_mp_",
                                          dir=workdir_parent or here)
    cfg = dict(MP_CFG, config=GPT2_SMALL,
               meshes=MP_MESHES if world == 4 else ({},))
    try:
        t = time.perf_counter()
        ranks = run_ranks("chip_smoke:mp_chip_rank", world, (cfg,),
                          ctx="gpu", workdir=workdir.name)
        t_run = time.perf_counter() - t
    finally:
        workdir.cleanup()
    rec = ranks[0]
    bad += mp_checks(rec)
    for name, r in rec["trainers"].items():
        prof = r["profiled"]
        print("phase 23 (a) on %s, NCCL %s: GPT-2-small-width TransformerLM "
              "fp32 through ParallelTrainer(adam, zero=2) on %s (%d sharded "
              "parameters), global batch %d x %d: %.2f ms/step (CUDA events, "
              "%d timed after %d), %.0f tokens/s; loss %.4f -> %.4f; first "
              "SGD update against dp=%d's %s; Adam losses against dp=%d's "
              "%s of the loss; wire model a step %s; calls "
              "a step %s; the profiled step: compute busy %.0f us, NCCL "
              "%.0f us in kernels %s" % (
                  smi, torch.cuda.nccl.version(), name, r["sharded"],
                  cfg["batch"], cfg["t"], r["step_ms"], cfg["timed"],
                  cfg["warmup"], r["tokens_per_s"], r["losses"][0],
                  r["losses"][-1], world, "%s (ReLU inputs flipped "
                  "against dp=%d's decisions %s)" % (
                      r["vs_dp"], world, r["relu_flips"])
                  if "vs_dp" in r else "(one rank)", world,
                  "%.3g" % r["losses_vs_dp"] if "losses_vs_dp" in r
                  else "(one rank)",
                  {k: v["ops"] for k, v in r["comm"]["kinds"].items()},
                  {k: v // r["steps"] for k, v in
                   r["collective_calls"].items()}, prof["busy_us"],
                  prof["nccl_us"], prof["nccl_kernels"]), flush=True)
    print("phase 23 (b-d) on %s over %d rank(s): the LM at T %d under sp=%d "
          "against its dense forward %s; Ulysses at %s causal %s; the ring "
          "at T %d causal %s; the pipeline of %d TransformerEncoderCells at "
          "%s, M %d, against the sequential apply %s; switch_moe ep=%d E=%d "
          "over %d tokens against the one-rank routing %s; %.1f s" % (
              smi, world, cfg["sp_t"], world, rec["lm_sp"],
              cfg["ulysses"], rec["ulysses"], cfg["ring_t"], rec["ring"],
              world, (cfg["pipe"]["batch"], cfg["pipe"]["t"],
                      GPT2_SMALL["units"]), cfg["pipe"]["m"],
              rec["pipeline"], world, cfg["moe"]["e"], cfg["moe"]["tokens"],
              rec["moe"], t_run), flush=True)
    launches = mp_launches(rec)
    print("launches_model_parallel: %s" % json.dumps(launches), flush=True)
    if bad:
        raise AssertionError("phase 23: " + "; ".join(bad))
    return {"card": smi, "world": world, "kernel_shapes": kern,
            "trainers": rec["trainers"], "lm_sp": rec["lm_sp"],
            "ulysses": rec["ulysses"], "ring": rec["ring"],
            "pipeline": rec["pipeline"], "moe": rec["moe"],
            "launches_model_parallel": launches,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 24: the asynchronous and multi-process rest of multi-GPU: the fleet
# front door over ResNet-50 replicas, Module.fit on dist_async, Module on a
# list of contexts, and the fault drills on the card
# ---------------------------------------------------------------------------
FLEET = {"layers": LAYERS, "image": IMAGE, "max_batch": BATCH,
         "replicas": 3,        # replica processes on one card
         "requests": 256,      # a wave
         "clients": 8,
         "async_workers": 2,   # dist_async worker processes on one card
         "async_batch": 32, "async_warmup": 2, "async_timed": 6,
         "mc_batch": 32, "mc_warmup": 2, "mc_timed": 10,
         "soak_s": 10.0, "soak_min_faults": 80, "timeout": 600}
# the front door's weather in the second wave: the transport rules of the
# fleet soak's main plan (partition on requests, slow links, lost acks,
# receive-side reordering)
FLEET_WAVE2_PLAN = {
    "seed": 24,
    "rules": [
        {"site": "transport.send", "kind": "partition", "p": 0.03,
         "times": 0, "where": {"kind": "infer"}},
        {"site": "transport.send", "kind": "slow_link", "delay_s": 0.002,
         "p": 0.12, "times": 0},
        {"site": "transport.send.ack", "kind": "lost_ack", "p": 0.06,
         "times": 0},
        {"site": "transport.recv", "kind": "reorder", "p": 0.06,
         "times": 0},
    ],
}
# dist_async's SGD: phase 5's without momentum (each worker's rate is
# this over the workers).  The server applies each worker's push as one
# update, and a worker's gradient is a few pushes stale; staleness acts
# as added momentum (Mitliagkas et al. 2016, arXiv:1605.09774), and with
# 0.9 on top the workers' losses rose on the card
# (tests/test_torch_dist_async.py shows the same in both packages' stores)
ASYNC_SGD = {"learning_rate": 0.02, "momentum": 0.0, "wd": 1e-4}
# each dist_async worker's weather: lost acks on its push link
ASYNC_PLAN = {"rules": [{"site": "transport.send.ack", "kind": "lost_ack",
                         "p": 0.02, "times": 0}]}


def fleet_weights(mx, sym, cfg, ctx):
    """Phase 4's He weights from the seed with the classifier calibrated
    on a fixed batch (:func:`he_params`, :func:`calibrate_fc`)."""
    arg, aux = he_params(sym, cfg["image"], SEED)
    args, auxs = mx.convert.params_from_numpy(arg, aux, ctx, symbol=sym)
    x = np.random.RandomState(SEED + 24).randn(
        2, *cfg["image"]).astype(np.float32)
    calibrate_fc(mx, sym, args, auxs, ctx, x)
    return args, auxs


def _wait_json(path, deadline, what, procs=()):
    """The record a process writes at ``path``, once it is there; raises
    when one of ``procs`` exits non-zero first or ``deadline`` passes."""
    from mxnet_tpu_torch.fault.drill import _read_json
    while True:
        rec = _read_json(path)
        if rec:
            return rec
        for p in procs:
            if p.poll() not in (None, 0):
                raise AssertionError("%s: a process exited %s before %s "
                                     "appeared" % (what, p.returncode, path))
        if time.monotonic() > deadline:
            raise AssertionError("%s: %s never appeared" % (what, path))
        time.sleep(0.05)


def fleet_replica_main(cfg):
    """``python3 chip_smoke.py _fleet_replica <json>``: one fleet replica,
    the port's ``replica_loop`` around a ``ModelServer`` (buckets 1 to
    ``max_batch``) over ResNet with the weights the phase wrote.  Writes
    a ready file once warm and, when told to stop, the kernels it
    launched and the forwards it ran after warmup."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.fault.drill import _write_json
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.parallel.transport import SpoolTransport
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.serving.fleet import replica_loop
    torch.backends.cudnn.deterministic = True
    ctx = mx.Context(cfg["ctx"], cfg["device"])
    sym = resnet_symbol(cfg["layers"], cfg["image"])
    saved = mx.nd.load(cfg["weights"], ctx=ctx)
    args = {k[4:]: v for k, v in saved.items() if k.startswith("arg:")}
    auxs = {k[4:]: v for k, v in saved.items() if k.startswith("aux:")}
    srv = ModelServer(max_batch=cfg["max_batch"], batch_wait_ms=2.0,
                      queue_depth=256, default_timeout_ms=120000.0, ctx=ctx)
    srv.add_model("resnet", sym, args, auxs,
                  {"data": (1,) + tuple(cfg["image"])})
    srv.start()
    srv.warmup("resnet")
    before = srv.stats()["batches"]["count"]
    ck.reset_kernel_calls()
    transport = SpoolTransport(cfg["root"], cfg["rank"], cfg["world"])
    _write_json(cfg["ready"], {"rank": cfg["rank"], "pid": os.getpid()})
    try:
        replica_loop(srv, transport)
    finally:
        srv.stop()
        st = srv.stats()
        _write_json(cfg["report"], {
            "calls": ck.kernel_calls(),
            "forwards": st["batches"]["count"] - before,
            "occupancy": st["batches"]["occupancy"]})
    return 0


def _spawn_replica(cfg, rid, device, workdir, world, weights):
    """Start one replica process of :func:`fleet_replica_main` under the
    drill's replica weather; returns ``(handle, ready path, report
    path)``."""
    from mxnet_tpu_torch.fault.drill import _replica_plan
    from mxnet_tpu_torch.serving.fleet import ReplicaHandle
    here = os.path.dirname(os.path.abspath(__file__))
    child = dict(cfg, rank=rid, world=world, device=device,
                 root=os.path.join(workdir, "fleet"), weights=weights,
                 ready=os.path.join(workdir, "ready%d.json" % rid),
                 report=os.path.join(workdir, "report%d.json" % rid))
    env = dict(os.environ, MXNET_FAULT_PLAN=json.dumps(_replica_plan(rid)),
               PYTHONPATH=os.pathsep.join([here] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    log = open(os.path.join(workdir, "replica%d.log" % rid), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"),
         "_fleet_replica", json.dumps(child)], env=env, cwd=here,
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return ReplicaHandle(rid, proc=proc), child["ready"], child["report"]


def _clients(infer, xs, n_clients, on_done=None):
    """Send ``xs`` from ``n_clients`` threads through ``infer``; returns
    the answers (or the exception of each failed request), the latencies
    in ms and the wall time."""
    n = len(xs)
    answers, lats = [None] * n, [0.0] * n

    def client(k):
        for i in range(k, n, n_clients):
            t = time.perf_counter()
            try:
                answers[i] = infer(xs[i])
            except Exception as exc:    # noqa: BLE001 — counted, raised below
                answers[i] = exc
            lats[i] = (time.perf_counter() - t) * 1e3
            if on_done is not None:
                on_done()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return answers, lats, time.perf_counter() - t0


def _pcts(lats):
    return float(np.percentile(lats, 50)), float(np.percentile(lats, 99))


def fleet_front_door(mx, ck, sym, cfg, n_sites, workdir):
    """Phase 24 (a): the front door over ResNet replica processes: a wave
    of requests with one replica SIGKILLed a third in, a second wave under
    network weather; the ledger, the answers against a Predictor at each
    request's bucket, and each surviving replica's launches."""
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.io import pad_batch
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.serving.bucketing import pick_bucket, shape_buckets
    from mxnet_tpu_torch.serving.fleet import FleetFrontDoor
    on_card = cfg["ctx"] == "gpu"
    ncard = torch.cuda.device_count() if on_card else 1
    devices = list(range(ncard)) if ncard >= 4 else [0] * cfg["replicas"]
    world = len(devices) + 1
    ctx = mx.Context(cfg["ctx"], 0)
    torch.backends.cudnn.deterministic = True
    args, auxs = fleet_weights(mx, sym, cfg, ctx)
    weights = os.path.join(workdir, "weights.params")
    mx.nd.save(weights, dict([("arg:" + k, v) for k, v in args.items()]
                             + [("aux:" + k, v) for k, v in auxs.items()]))
    rng = np.random.RandomState(SEED + 240)
    waves = [[rng.randn(rng.randint(1, 4), *cfg["image"]).astype(np.float32)
              for _ in range(cfg["requests"])] for _ in range(2)]
    t0 = time.monotonic()
    spawned = [_spawn_replica(cfg, rid, dev, workdir, world, weights)
               for rid, dev in enumerate(devices, start=1)]
    handles = [s[0] for s in spawned]
    fd = FleetFrontDoor(os.path.join(workdir, "fleet"), world,
                        request_timeout_s=120.0, health_interval_s=0.2)
    try:
        for h, ready, _ in spawned:
            _wait_json(ready, t0 + cfg["timeout"], "fleet replica %d" % h.rid,
                       [h.proc])
            fd.add_replica(h)
        start_s = time.monotonic() - t0

        def infer(x):
            return fd.infer("resnet", {"data": x})[0]

        # wave 1: SIGKILL the last replica once a third is answered
        done, kill = [0], {}
        lock = threading.Lock()

        def on_done():
            with lock:
                done[0] += 1
                if done[0] == cfg["requests"] // 3 and not kill:
                    kill["t"] = time.monotonic()
                    kill["resub0"] = fd.stats()["resubmitted"]
                    handles[-1].proc.kill()
                elif kill and "first_resubmitted_s" not in kill \
                        and fd.stats()["resubmitted"] > kill["resub0"]:
                    kill["first_resubmitted_s"] = time.monotonic() - kill["t"]

        a1, l1, w1 = _clients(infer, waves[0], cfg["clients"], on_done)
        st1 = fd.stats()
        # wave 2 under the front door's network weather (the replicas
        # carry theirs from their start)
        plan = fault.FaultPlan(FLEET_WAVE2_PLAN)
        with fault.active_plan(plan):
            a2, l2, w2 = _clients(infer, waves[1], cfg["clients"])
        injected = plan.stats()["injected"]
        st = fd.stats()
        balanced = fd.ledger_balanced()
        # each live replica stops on its message and writes its report
        for h, _, report in spawned:
            if h.alive():
                fd._transport.send(h.rid, "stop", meta={"id": "stop"})
        for h, _, report in spawned[:-1]:
            _wait_json(report, time.monotonic() + 60, "replica report")
    finally:
        fd.close()
        for h in handles:
            if h.proc.poll() is None:
                try:
                    h.proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    h.proc.wait()
    failed = [a for a in a1 + a2 if isinstance(a, Exception)]
    if failed or not balanced or st["submitted"] != 2 * cfg["requests"] \
            or st["served"] != st["submitted"]:
        raise AssertionError("phase 24 (a): %d of %d requests failed (%s), "
                             "ledger %s balanced %s" % (
                                 len(failed), 2 * cfg["requests"],
                                 failed[:1], {k: st[k] for k in (
                                     "submitted", "served", "failed",
                                     "expired")}, balanced))
    if "first_resubmitted_s" not in kill:
        raise AssertionError("phase 24 (a): no request was resubmitted after "
                             "the SIGKILL: %s" % st)
    # each surviving replica: 33 K3 and 1 K2 a forward, nothing else (on
    # the CPU the wrappers run their plain versions and count nothing)
    launches, forwards = {}, 0
    for h, _, report in spawned[:-1]:
        rec = _wait_json(report, time.monotonic() + 60, "replica report")
        want = dict.fromkeys(rec["calls"], 0)
        if on_card:
            want.update(scale_bias_relu=n_sites * rec["forwards"],
                        softmax_lastaxis=rec["forwards"])
        if rec["calls"] != want:
            raise AssertionError("phase 24 (a): replica %d launched %s over "
                                 "%d forwards; expected %s" % (
                                     h.rid, rec["calls"], rec["forwards"],
                                     want))
        forwards += rec["forwards"]
        for k, v in rec["calls"].items():
            launches[k] = launches.get(k, 0) + v
    # every answer against a Predictor of the same rows at its bucket
    buckets = shape_buckets(cfg["max_batch"])
    preds, bitwise, worst = {}, 0, 0.0
    for x, got in zip(waves[0] + waves[1], a1 + a2):
        b = pick_bucket(x.shape[0], buckets)
        if b not in preds:
            preds[b] = mx.Predictor.from_parts(
                sym, args, auxs, {"data": (b,) + x.shape[1:]}, ctx=ctx)
        ref = preds[b].forward(data=pad_batch([x], b)[0]).get_output(
            0).asnumpy()[:x.shape[0]]
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError("phase 24 (a): an answer of shape %s "
                                 "(finite %s) for %s" % (
                                     got.shape, np.isfinite(got).all(),
                                     ref.shape))
        err = float(np.abs(got - ref).max())
        bitwise += int(err == 0.0)
        worst = max(worst, err)
    if worst > CROSS_SHAPE_TOL:
        raise AssertionError("phase 24 (a): an answer %g from the Predictor "
                             "(limit %g)" % (worst, CROSS_SHAPE_TOL))
    # the same traffic straight into one in-process ModelServer
    srv = ModelServer(max_batch=cfg["max_batch"], batch_wait_ms=2.0,
                      queue_depth=256, default_timeout_ms=120000.0, ctx=ctx)
    srv.add_model("resnet", sym, args, auxs,
                  {"data": (1,) + tuple(cfg["image"])})
    srv.start()
    try:
        srv.warmup("resnet")
        d1, dl, dw = _clients(
            lambda x: srv.infer("resnet", {"data": x})[0], waves[0],
            cfg["clients"])
    finally:
        srv.stop()
    if any(isinstance(a, Exception) for a in d1):
        raise AssertionError("phase 24 (a): the in-process server failed")
    p50, p99 = _pcts(l1 + l2)
    dp50, dp99 = _pcts(dl)
    return {
        "replicas": len(devices), "devices": devices,
        "replica_start_s": start_s,
        "requests": 2 * cfg["requests"], "clients": cfg["clients"],
        "wave1": {"req_per_s": cfg["requests"] / w1,
                  "p50_ms": _pcts(l1)[0], "p99_ms": _pcts(l1)[1]},
        "wave2": {"req_per_s": cfg["requests"] / w2,
                  "p50_ms": _pcts(l2)[0], "p99_ms": _pcts(l2)[1],
                  "faults_injected": len(injected)},
        "req_per_s": 2 * cfg["requests"] / (w1 + w2),
        "p50_ms": p50, "p99_ms": p99,
        "direct": {"req_per_s": cfg["requests"] / dw, "p50_ms": dp50,
                   "p99_ms": dp99},
        "kill_to_first_resubmitted_s": kill["first_resubmitted_s"],
        "ledger": {k: st[k] for k in (
            "submitted", "served", "failed", "expired", "resubmitted",
            "retried", "duplicates_dropped", "ejections", "readmissions")},
        "ledger_wave1": {k: st1[k] for k in ("resubmitted", "ejections")},
        "replica_status": {str(r): list(v)
                           for r, v in st["replicas"].items()},
        "transport": st["transport"],
        "answers_bitwise": bitwise, "answers_max_abs_err": worst,
        "forwards": forwards, "launches": launches,
    }


def _launch_env(world, rank):
    """``tools/launch.py``'s environment for worker ``rank`` of ``world``
    (its ``worker_env``, with no servers)."""
    import argparse
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "_launch", os.path.join(here, "tools", "launch.py"))
    launch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(launch)
    return launch.worker_env(argparse.Namespace(
        root_uri="127.0.0.1", root_port=9091, num_workers=world,
        num_servers=0, env_worker=[], env=[]), rank)


def async_worker_rank(rank, world, init_method, ctx, cfg, spool):
    """Phase 24 (b)'s worker ``rank`` (a rank of :func:`run_ranks`): one
    worker of ``Module.fit(kvstore="dist_async")`` under
    ``tools/launch.py``'s ``DMLC_*`` environment, with a lost-ack rule on
    its push link.  Rank 0 is the coordinator: once every worker has
    fitted it drains the spool, stops the server thread and holds the
    server's weights to a plain per-array SGD replay of the pushes the
    server applied, in arrival order, from the initial weights; the other
    ranks then pull every weight and return its digest.  The ranks meet
    through a ``FileStore`` on ``init_method``'s file (no process group)."""
    import hashlib
    from datetime import timedelta
    # the environment first: the port reads its fault plan at import
    os.environ.update(_launch_env(world, rank))
    os.environ.update(MXNET_KVSTORE_ASYNC_DIR=spool,
                      MXNET_FAULT_PLAN=json.dumps(dict(ASYNC_PLAN,
                                                       seed=240 + rank)))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    meet = torch.distributed.FileStore(init_method[len("file://"):], world)
    meet.set_timeout(timedelta(seconds=cfg["timeout"]))
    telemetry.enable()
    on = mx.Context(ctx, cfg["devices"][rank])
    dev = on.torch_device
    sym = resnet_symbol(cfg["layers"], cfg["image"])
    total = cfg["async_warmup"] + cfg["async_timed"]
    # every worker's batch is the same fixed one, so each push lowers the
    # one loss that each worker reads
    it = synthetic_iter(mx, on, cfg["async_batch"], cfg["image"], total)
    label = it.next().label[0]._data
    it.reset()
    mod = mx.mod.Module(sym, context=on)
    kv = mx.kv.create("dist_async")
    # the reference rescales dist_async by one worker's batch, so each of
    # the world's pushes a step is a whole step: the rate is split
    lr, wd = ASYNC_SGD["learning_rate"] / world, ASYNC_SGD["wd"]
    rescale = 1.0 / cfg["async_batch"]
    replay = {}
    if rank == 0:
        kv_init, kv_set_optimizer = kv.init, kv.set_optimizer

        def init(key, value):
            kv_init(key, value)
            with kv._lock:
                replay.update({k: v._data.clone()
                               for k, v in kv._store.items()})

        def set_optimizer(optimizer):
            kv_set_optimizer(optimizer)
            update = kv._updater

            def apply(key, grad, weight):
                # the server thread, under the store's lock
                w = replay[key]
                decay = wd if str(key).endswith(("_weight", "_gamma")) \
                    else 0.0
                replay[key] = w - lr * (grad._data * rescale + decay * w)
                update(key, grad, weight)

            kv._updater = apply

        kv.init, kv.set_optimizer = init, set_optimizer
    marks, probs = [], {}

    def on_batch(param):
        if param.nbatch in (0, total - 1):
            probs[param.nbatch] = mod.get_outputs()[0]._data.clone()
        marks.append(_marker(dev))

    def digest(arrays):
        h = hashlib.sha256()
        for k in sorted(arrays):
            h.update(arrays[k].tobytes())
        return h.hexdigest()

    mx.random.seed(SEED)
    ck.reset_kernel_calls()
    mod.fit(it, num_epoch=1, kvstore=kv, optimizer="sgd",
            optimizer_params=dict(ASYNC_SGD, learning_rate=lr),
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=on_batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    calls = ck.kernel_calls()
    snap = telemetry.snapshot()

    def fam(name, op, field):
        for v in snap.get(name, {"values": []})["values"]:
            if dict(v["labels"]).get("op") == op:
                return v[field] if field else v["value"]
        return 0

    names = mod._exec_group.param_names
    rec = {"rank": rank, "calls": calls, "keys": len(names),
           "steps": total, "rescale_grad": mod._optimizer.rescale_grad,
           "step_ms": _elapsed_ms(marks[cfg["async_warmup"] - 1], marks[-1])
           / cfg["async_timed"],
           "ce_first": cross_entropy(probs[0], label),
           "ce_last": cross_entropy(probs[total - 1], label),
           "push_s": fam("mxnet_kvstore_op_seconds", "push", "sum"),
           "pushes": fam("mxnet_kvstore_op_seconds", "push", "count"),
           "pull_s": fam("mxnet_kvstore_op_seconds", "pull", "sum"),
           "pulls": fam("mxnet_kvstore_op_seconds", "pull", "count"),
           "push_bytes": fam("mxnet_kvstore_bytes_total", "push", None),
           "transport": kv._transport.stats()}
    if rank == 0:
        meet.wait(["fit%d" % r for r in range(1, world)])
        expected = world * total * len(names)
        drained = kv.wait_to_drain(timeout=cfg["timeout"])
        deadline = time.monotonic() + cfg["timeout"]
        while kv._transport.stats()["received"] < expected \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        # the server thread ends after the batch it is applying
        kv._stop.set()
        kv._server.join(timeout=60)
        with kv._lock:
            window = [i for _, i in kv._applied_log]
            server = {k: kv._store[k]._data for k in names}
            errs = [float((server[k] - replay[k]).abs().max())
                    for k in names]
            bitwise = sum(bool(torch.equal(server[k], replay[k]))
                          for k in names)
            scale = max(float(v.abs().max()) for v in server.values())
            server = {k: v.cpu().numpy() for k, v in server.items()}
        rec["server"] = {
            "drained": drained, "expected": expected,
            "transport": kv._transport.stats(),
            "window": len(window), "window_unique": len(set(window)),
            "digest": digest(server),
            "replay": {"arrays": len(names), "bitwise": bitwise,
                       "max_abs_err": max(errs), "largest": scale}}
        meet.set("server", "1")
        meet.wait(["pulled%d" % r for r in range(1, world)])
    else:
        meet.set("fit%d" % rank, "1")
        meet.wait(["server"])
        outs = {k: mx.nd.zeros(kv._store[k].shape, ctx=on) for k in names}
        for k in names:
            kv.pull(k, out=outs[k])
        rec["digest"] = digest({k: v.asnumpy() for k, v in outs.items()})
        meet.set("pulled%d" % rank, "1")
    kv.close()
    return rec


def async_fit(cfg, workdir):
    """Phase 24 (b): ``Module.fit(kvstore="dist_async")`` on ResNet in
    :func:`async_worker_rank` processes (2 workers on one card, one a
    card on four), ``ASYNC_SGD`` with the rate split over the workers."""
    ncard = torch.cuda.device_count() if cfg["ctx"] == "gpu" else 1
    n = ncard if ncard >= 4 else cfg["async_workers"]
    devices = list(range(n)) if ncard >= 4 else [0] * n
    t0 = time.monotonic()
    workers = run_ranks("chip_smoke:async_worker_rank", n,
                        (dict(cfg, devices=devices),
                         os.path.join(workdir, "async_spool")),
                        workdir=workdir, ctx=cfg["ctx"],
                        timeout=cfg["timeout"])
    wall = time.monotonic() - t0
    server = workers[0]["server"]
    total = workers[0]["steps"]
    bad = []
    tr = server["transport"]
    if not server["drained"] or tr["received"] != server["expected"]:
        bad.append("the server applied %d pushes of %d (drained %s)" % (
            tr["received"], server["expected"], server["drained"]))
    if server["window_unique"] != server["window"]:
        bad.append("a push applied twice in the log's window")
    rp = server["replay"]
    if rp["bitwise"] != rp["arrays"] \
            and rp["max_abs_err"] > 1e-6 * rp["largest"]:
        bad.append("the server's weights are off the SGD replay of its "
                   "pushes: %s" % rp)
    for w in workers[1:]:
        if w["digest"] != server["digest"]:
            bad.append("worker %d's pulled weights differ from the "
                       "server's" % w["rank"])
    for w in workers:
        if w["rescale_grad"] != 1.0 / cfg["async_batch"]:
            bad.append("worker %d's fit rescaled by %r, not one worker's "
                       "batch" % (w["rank"], w["rescale_grad"]))
        want = dict.fromkeys(w["calls"], 0)
        if cfg["ctx"] == "gpu":
            want["softmax_lastaxis"] = total
        if w["calls"] != want:
            bad.append("worker %d launched %s; expected %s" % (
                w["rank"], w["calls"], want))
        if not w["ce_last"] < w["ce_first"]:
            bad.append("worker %d's cross-entropy went %.4f -> %.4f (all: "
                       "%s)" % (w["rank"], w["ce_first"], w["ce_last"],
                                [(v["ce_first"], v["ce_last"])
                                 for v in workers]))
    if bad:
        raise AssertionError("phase 24 (b): " + "; ".join(bad))
    push_s = sum(w["push_s"] for w in workers)
    return {
        "workers": n, "devices": devices, "wall_s": wall,
        "steps": total, "keys": workers[0]["keys"],
        "applied": tr["received"], "expected": server["expected"],
        "duplicates_dropped": tr["duplicates_dropped"],
        "resent": sum(w["transport"]["resent"] for w in workers),
        "replay": rp,
        "step_ms": [w["step_ms"] for w in workers],
        "images_per_s": sum(cfg["async_batch"] / w["step_ms"] * 1e3
                            for w in workers),
        "push_s": [w["push_s"] for w in workers],
        "pull_s": [w["pull_s"] for w in workers],
        "pushes": [w["pushes"] for w in workers],
        "pulls": [w["pulls"] for w in workers],
        "spool_mb_per_s": sum(w["push_bytes"] for w in workers) / 1e6
        / push_s if push_s else None,
        "ce": [(w["ce_first"], w["ce_last"]) for w in workers],
        "launches": {"softmax_lastaxis": sum(
            w["calls"].get("softmax_lastaxis", 0) for w in workers)},
        "launches_per_worker_step": 1,
    }


def multi_context_fit(mx, ck, sym, cfg, ctxs):
    """Phase 24 (c): ``Module(context=ctxs)`` with ``kvstore="device"``.
    The first step against an oracle (one single-context executor a
    slice, forward and backward on its rows, the gradients summed in the
    store's order, the same per-array SGD); then timed steps."""
    batch = cfg["mc_batch"]
    total = cfg["mc_warmup"] + cfg["mc_timed"]
    devs = [c.torch_device for c in ctxs]
    torch.backends.cudnn.deterministic = True
    it = synthetic_iter(mx, ctxs[0], batch, cfg["image"], total + 1)
    mod = mx.mod.Module(sym, context=ctxs)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(SEED)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=SGD_PARAMS)
    group = mod._exec_group
    names, slices = group.param_names, group.slices
    arg0, aux0 = mod.get_params()
    arg0 = {k: v.asnumpy() for k, v in arg0.items()}
    aux0 = {k: v.asnumpy() for k, v in aux0.items()}
    first = it.next()
    # the oracle: one executor a slice, on that slice's context
    oracle = []
    for c, s in zip(ctxs, slices):
        rows = s.stop - s.start
        exe = sym.simple_bind(ctx=c, grad_req={n: "write" for n in names},
                              data=(rows,) + tuple(cfg["image"]),
                              softmax_label=(rows,))
        exe.copy_params_from({k: mx.nd.array(v, ctx=c)
                              for k, v in arg0.items()},
                             {k: mx.nd.array(v, ctx=c)
                              for k, v in aux0.items()})
        exe.forward(is_train=True, data=first.data[0][s].as_in_context(c),
                    softmax_label=first.label[0][s].as_in_context(c))
        exe.backward()
        oracle.append(exe)
    opt = mx.optimizer.create("sgd", sym=sym,
                              param_idx2name=dict(enumerate(names)),
                              rescale_grad=1.0 / batch, **SGD_PARAMS)
    updater = mx.optimizer.get_updater(opt)
    want_w = {}
    for n in names:
        g = oracle[0].grad_dict[n]._data
        for exe in oracle[1:]:
            g = g + exe.grad_dict[n]._data.to(g.device)
        w = mx.nd.array(arg0[n], ctx=ctxs[0])
        updater(n, mx.nd.NDArray(g), w)
        want_w[n] = w
    ck.reset_kernel_calls()
    mod.forward_backward(first)
    mod.update()
    for d in set(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    first_calls = ck.kernel_calls()
    pairs = [(group.param_arrays[j][i], want_w[n])
             for j, n in enumerate(names) for i in range(len(ctxs))]
    states = mod._kvstore._updater.states
    pairs += [(states[n], updater.states[n]) for n in names]
    pairs += [(group.aux_arrays[j][i], oracle[i].aux_dict[a])
              for j, a in enumerate(group.aux_names)
              for i in range(len(ctxs))]
    bitwise, worst = 0, 0.0
    for got, ref in pairs:
        g = got._data.detach().float().cpu()
        r = ref._data.detach().float().cpu()
        if torch.equal(g, r):
            bitwise += 1
            continue
        worst = max(worst, float(((g - r).abs() / r.abs().clamp_min(
            1e-30)).max()))
    if worst > 1e-6:
        raise AssertionError("phase 24 (c): the first step is %g relative "
                             "from the oracle (%d of %d tensors bitwise)"
                             % (worst, bitwise, len(pairs)))
    on_card = devs[0].type == "cuda"
    want = dict.fromkeys(first_calls, 0)
    if on_card:
        want["softmax_lastaxis"] = len(ctxs)
    if first_calls != want:
        raise AssertionError("phase 24 (c): the first step launched %s; "
                             "expected %s" % (first_calls, want))
    torch.backends.cudnn.deterministic = False
    label = first.label[0]._data
    marks, ce = [], []
    ck.reset_kernel_calls()
    for step in range(total):
        mod.forward_backward(it.next())
        mod.update()
        if step in (0, total - 1):
            ce.append(cross_entropy(mod.get_outputs()[0]._data, label))
        marks.append(_marker(devs[0]))
    for d in set(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    calls = ck.kernel_calls()
    want = dict.fromkeys(calls, 0)
    if on_card:
        want["softmax_lastaxis"] = len(ctxs) * total
    if calls != want:
        raise AssertionError("phase 24 (c): %d steps launched %s; expected "
                             "%s" % (total, calls, want))
    step_ms = _elapsed_ms(marks[cfg["mc_warmup"] - 1], marks[-1]) \
        / cfg["mc_timed"]
    return {"contexts": [str(c) for c in ctxs], "batch": batch,
            "slices": [[s.start, s.stop] for s in slices],
            "first_step": {"tensors": len(pairs), "bitwise": bitwise,
                           "max_rel": worst},
            "step_ms": step_ms, "images_per_s": batch / step_ms * 1e3,
            "ce": ce, "launches": calls,
            "launches_per_step": {"softmax_lastaxis": len(ctxs)}}


def fleet_drills(cfg, workdir):
    """Phase 24 (d): the fleet network soak of the linear model, and the
    fused-sweep parity drill in a world of one rank a card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.fault import drill
    ctx = mx.Context(cfg["ctx"], 0)
    t = time.monotonic()
    soak = drill.fleet_network_soak(
        duration_s=cfg["soak_s"], clients=4, replicas=3,
        min_faults=cfg["soak_min_faults"],
        tmpdir=os.path.join(workdir, "soak"), ctx=ctx)
    soak_s = time.monotonic() - t
    world = torch.cuda.device_count() if cfg["ctx"] == "gpu" else 2
    t = time.monotonic()
    par = drill.fused_sweep_parity_drill(
        tmpdir=os.path.join(workdir, "parity"), world=world, ctx=ctx,
        timeout=cfg["timeout"])
    par_s = time.monotonic() - t
    return {"soak": {k: soak[k] for k in (
                "duration_s", "serving", "training", "checkpoints",
                "faults_injected")}, "soak_wall_s": soak_s,
            "parity": par, "parity_wall_s": par_s}


def fleet_phase(mx, ck, sym, n_sites, smi, cfg=FLEET, workdir_parent=None):
    """Phase 24: (a)-(d) above, each raising on failure.  Prints its lines
    and returns its record (``launches_fleet`` for K3 and K2,
    ``launches_async`` and ``launches_multi_context`` for K2,
    ``launches_drill`` for K1a, K1b and K4)."""
    import tempfile
    cfg = dict(cfg)
    cfg.setdefault("ctx", "gpu")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    workdir = tempfile.TemporaryDirectory(prefix=".chip_smoke_fleet_",
                                          dir=workdir_parent or here)
    try:
        fl = fleet_front_door(mx, ck, sym, cfg, n_sites, workdir.name)
        t_a = time.perf_counter() - t0
        print("phase 24 (a) on %s: FleetFrontDoor over %d ResNet-%d replica "
              "processes on %s, buckets 1-%d: %d requests of 1-3 rows from %d "
              "clients, %.2f req/s, p50 %.2f ms, p99 %.2f ms (wave 1 %.2f "
              "req/s, wave 2 under network weather %.2f req/s, %d faults); "
              "the same wave into one in-process ModelServer %.2f req/s, p50 "
              "%.2f ms, p99 %.2f ms; SIGKILL to the first resubmitted answer "
              "%.3f s; ledger %s; answers bitwise %d/%d, max |dp| %g; "
              "survivors' launches %s over %d forwards; replicas up in %.1f s"
              % (smi, fl["replicas"], cfg["layers"], fl["devices"],
                 cfg["max_batch"], fl["requests"], fl["clients"],
                 fl["req_per_s"], fl["p50_ms"], fl["p99_ms"],
                 fl["wave1"]["req_per_s"], fl["wave2"]["req_per_s"],
                 fl["wave2"]["faults_injected"], fl["direct"]["req_per_s"],
                 fl["direct"]["p50_ms"], fl["direct"]["p99_ms"],
                 fl["kill_to_first_resubmitted_s"], fl["ledger"],
                 fl["answers_bitwise"], fl["requests"],
                 fl["answers_max_abs_err"], fl["launches"], fl["forwards"],
                 fl["replica_start_s"]), flush=True)
        t = time.perf_counter()
        af = async_fit(cfg, workdir.name)
        t_b = time.perf_counter() - t
        print("phase 24 (b) on %s: Module.fit(kvstore=dist_async) ResNet-%d "
              "fp32, %d workers on %s, batch %d a worker, SGD %s (the rate over "
              "the workers), %d warmup "
              "+ %d timed steps: step ms %s (CUDA events), %.1f images/s in "
              "all; "
              "push s %s, pull s %s; spool %.1f MB/s; %d/%d pushes applied "
              "once each (%d resends absorbed); the server's weights against "
              "the SGD replay of its pushes: %d/%d arrays bitwise, max |dw| "
              "%g; cross-entropy %s; %.1f s"
              % (smi, cfg["layers"], af["workers"], af["devices"],
                 cfg["async_batch"], ASYNC_SGD, cfg["async_warmup"],
                 cfg["async_timed"],
                 ["%.1f" % v for v in af["step_ms"]], af["images_per_s"],
                 ["%.2f" % v for v in af["push_s"]],
                 ["%.2f" % v for v in af["pull_s"]],
                 af["spool_mb_per_s"] or 0.0, af["applied"], af["expected"],
                 af["duplicates_dropped"], af["replay"]["bitwise"],
                 af["replay"]["arrays"], af["replay"]["max_abs_err"],
                 [("%.3f" % a, "%.3f" % b) for a, b in af["ce"]], t_b),
              flush=True)
        ncard = torch.cuda.device_count() if cfg["ctx"] == "gpu" else 1
        if cfg["ctx"] == "cpu":
            ctxs = [mx.cpu(0), mx.cpu(0)]
        else:
            ctxs = [mx.gpu(i) for i in range(ncard)] if ncard >= 4 \
                else [mx.gpu(0), mx.gpu(0)]
        t = time.perf_counter()
        mc = multi_context_fit(mx, ck, sym, cfg, ctxs)
        t_c = time.perf_counter() - t
        print("phase 24 (c) on %s: Module(context=%s) ResNet-%d fp32, "
              "kvstore=device, global batch %d split %s: first step vs one "
              "executor a slice, gradients summed, the same SGD: %d/%d tensors "
              "bitwise (weights, momentum, each context's moving stats), max "
              "relative %g; %.2f ms/step, %.1f images/s (CUDA events, %d "
              "timed after %d); launches %s; cross-entropy %s; %.1f s"
              % (smi, mc["contexts"], cfg["layers"], mc["batch"],
                 mc["slices"], mc["first_step"]["bitwise"],
                 mc["first_step"]["tensors"], mc["first_step"]["max_rel"],
                 mc["step_ms"], mc["images_per_s"], cfg["mc_timed"],
                 cfg["mc_warmup"], mc["launches"], mc["ce"], t_c), flush=True)
        t = time.perf_counter()
        dr = fleet_drills(cfg, workdir.name)
        t_d = time.perf_counter() - t
    finally:
        workdir.cleanup()
    soak = dr["soak"]
    print("phase 24 (d) on %s: fleet_network_soak %.1f s, 3 linear replicas: "
          "%s requests, ledger %s, %s faults by kind %s, gradients %d acked, "
          "%d applied; fused_sweep_parity_drill over %s: bitwise %s, "
          "launches %s; (a) %.1f s, (b) %.1f s, (c) %.1f s, (d) %.1f s"
          % (smi, soak["duration_s"], soak["serving"]["requests"],
             soak["serving"]["fleet_ledger"], soak["faults_injected"]["total"],
             soak["faults_injected"]["by_kind"], soak["training"]["acked"],
             soak["training"]["applied"], dr["parity"]["mesh"],
             dr["parity"]["bitwise_equal_vs_per_array"],
             dr["parity"]["launches"], t_a, t_b, t_c, t_d), flush=True)
    drill_calls = dr["parity"]["launches"]
    return {
        "card": smi, "seconds": time.perf_counter() - t0,
        "front_door": fl, "dist_async": af, "multi_context": mc,
        "drills": dr,
        "launches_fleet": {
            "scale_bias_relu": {"total": fl["launches"].get(
                "scale_bias_relu", 0), "forwards": fl["forwards"],
                "per_forward": n_sites},
            "softmax_lastaxis": {"total": fl["launches"].get(
                "softmax_lastaxis", 0), "forwards": fl["forwards"],
                "per_forward": 1}},
        "launches_async": {"total": af["launches"]["softmax_lastaxis"],
                           "per_worker_step": 1, "workers": af["workers"],
                           "steps": af["steps"]},
        "launches_multi_context": {
            "total": mc["launches"].get("softmax_lastaxis", 0),
            "per_step": len(ctxs), "steps": cfg["mc_warmup"]
            + cfg["mc_timed"]},
        "launches_drill": {k: drill_calls.get(k, 0) for k in (
            "sgd_sweep", "sgd_mom_sweep", "adam_sweep")},
    }


# ---------------------------------------------------------------------------
# phase 25: sparse storage at Avazu's and MovieLens-10M's widths
# ---------------------------------------------------------------------------
SPARSE = {
    # (a) example/sparse/linear_classification.py's flow at the
    # num_features that MXNet's example/sparse/linear_classification gives
    # LIBSVM's avazu-app; 15 stored values a row (one a hashed field)
    "features": 1_000_001, "fields": 15, "head": 500, "head_frac": 0.8,
    "batch": 8192, "batches": 16, "epochs": 2, "lr": 30.0, "bias_lr": 0.5,
    "init_scale": 0.01,
    # (b) example/recommenders/matrix_fact.py's MFBlock at MovieLens-10M's
    # id ranges (71,567 users and a largest movie id of 65,133, plus row 0)
    # and its count of ratings (10,000,054), one pass in whole batches;
    # ratings fall on as many ids as MovieLens-10M rates (69,878 users,
    # 10,681 movies), drawn from the seed
    "users": 71_568, "items": 65_134, "rated_users": 69_878,
    "rated_items": 10_681, "dim": 128, "mf_batch": 4096,
    "mf_ratings": 10_000_000, "mf_val": 65_536, "mf_lr": 0.002,
    "mf_init": 0.05, "mf_evals": 4,
    # the steps held to the port on the CPU, and the untimed first steps
    "twin_steps": 2, "warmup": 2,
}
SPARSE_TWIN_TOL = 1e-6     # of the largest value: index_add_ sums in
                           # another order on the card
SPARSE_MEM_LIMIT = 1 << 30  # (a)'s device memory; a dense batch is 32.8 GB
SPARSE_ACC = 0.8           # the example's own bar


def avazu_like(cfg, seed=SEED):
    """Phase 25 (a)'s synthetic data: ``batches * batch`` rows of one
    stored 1.0 a field, each of the ``fields`` fields a range of its own
    of the features (a head of ``head`` frequent features drawn with
    probability ``head_frac``, else any feature of the field), labelled 1
    where the planted weights of the head features sum above 0.  Returns
    ``(columns (rows, fields) int64, labels float32)``."""
    rng = np.random.RandomState(seed + 25)
    n, fields, head = cfg["batch"] * cfg["batches"], cfg["fields"], \
        cfg["head"]
    width = cfg["features"] // fields
    pick = np.where(rng.rand(n, fields) < cfg["head_frac"],
                    rng.randint(0, head, (n, fields)),
                    rng.randint(0, width, (n, fields)))
    cols = (pick + np.arange(fields) * width).astype(np.int64)
    planted = np.zeros(cfg["features"], np.float32)
    for f in range(fields):
        planted[f * width:f * width + head] = rng.randn(head)
    return cols, (planted[cols].sum(axis=1) > 0).astype(np.float32)


def write_libsvm(path, cols, labels):
    """A libsvm file: ``label idx:1 ...`` a row."""
    with open(path, "w") as f:
        for c, y in zip(cols.tolist(), labels.tolist()):
            f.write("%d %s\n" % (y, " ".join("%d:1" % i for i in c)))


def parse_libsvm_np(path, fields):
    """``(indptr, indices, values, labels)`` of a libsvm file of
    ``fields`` stored values a line, by numpy alone (apart from
    ``io.LibSVMIter``)."""
    with open(path) as f:
        tok = np.array(f.read().replace(":", " ").split(), dtype=np.float64)
    tok = tok.reshape(-1, 1 + 2 * fields)
    return (np.arange(tok.shape[0] + 1, dtype=np.int64) * fields,
            tok[:, 1::2].astype(np.int64).reshape(-1),
            tok[:, 2::2].astype(np.float32).reshape(-1),
            tok[:, 0].astype(np.float32))


def sparse_linear(mx, ctx, cfg, path, steps=None, record=0, parsed=None):
    """Phase 25 (a) on ``ctx``: ``io.LibSVMIter`` -> a CSR batch ->
    ``row_sparse_pull`` of the batch's unique columns from a ``local``
    store -> ``nd.sparse.dot(csr, weight)`` -> the logistic error ->
    ``nd.sparse.dot(csr, err, transpose_a=True).tostype("row_sparse")``
    pushed into the store, whose SGD takes the lazy row update; the
    bias by its own rate on the card.  ``steps`` cuts the run; the first
    ``record`` steps' pulled rows, scores and store come back; with
    ``parsed`` (``parse_libsvm_np``), each batch of the first epoch is
    held to it exactly.  Returns a record."""
    nd = mx.nd
    F, B = cfg["features"], cfg["batch"]
    init = (np.random.RandomState(SEED + 26).randn(F, 1)
            * cfg["init_scale"]).astype(np.float32)
    total = steps if steps is not None else cfg["epochs"] * cfg["batches"]
    with ctx:
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(F,),
                              batch_size=B)
        kv = mx.kv.create("local")
        kv.init("weight", nd.array(init))
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=cfg["lr"]))
        weight = nd.sparse.zeros("row_sparse", (F, 1))
        bias = nd.zeros((1, 1))
    recs, step_s, acc, exact = [], [], [], 0
    step = 0
    for epoch in range(cfg["epochs"]):
        it.reset()
        with ctx:
            correct = nd.zeros((1,))
        seen = 0
        for batch in it:
            if step == total:
                break
            _sync(ctx.torch_device)
            t = time.perf_counter()
            csr, label = batch.data[0], batch.label[0].reshape((-1, 1))
            row_ids = nd.NDArray(torch.unique(csr.indices._data))
            kv.row_sparse_pull("weight", out=weight, row_ids=row_ids)
            score = nd.broadcast_add(nd.sparse.dot(csr, weight), bias)
            prob = nd.sigmoid(score)
            diff = prob - label
            grad = nd.sparse.dot(csr, diff / B, transpose_a=True) \
                .tostype("row_sparse")
            kv.push("weight", grad)
            bias = nd.broadcast_sub(
                bias, (diff.mean() * cfg["bias_lr"]).reshape((1, 1)))
            correct = correct + ((prob > 0.5) == label).sum()
            _sync(ctx.torch_device)
            step_s.append(time.perf_counter() - t)
            seen += B - batch.pad
            if step < record:
                with ctx:
                    store = nd.zeros((F, 1))
                kv.pull("weight", out=store)
                recs.append({"pulled_ids": weight.indices.asnumpy(),
                             "pulled": weight.data.asnumpy(),
                             "score": score.asnumpy(),
                             "store": store.asnumpy()})
            if parsed is not None and epoch == 0:
                ip, ix, vals, labels = parsed
                lo, n = step * B, B - batch.pad
                got = (csr.indptr.asnumpy(), csr.indices.asnumpy(),
                       csr.data.asnumpy(), batch.label[0].asnumpy()[:n])
                want = (ip[lo:lo + n + 1] - ip[lo],
                        ix[ip[lo]:ip[lo + n]], vals[ip[lo]:ip[lo + n]],
                        labels[lo:lo + n])
                if not all(g.dtype == w.dtype and np.array_equal(
                        g[:len(w)] if k == 0 else g, w)
                        for k, (g, w) in enumerate(zip(got, want))):
                    raise AssertionError(
                        "phase 25 (a): batch %d's CSR differs from the "
                        "numpy parse of the file" % step)
                exact += 1
            step += 1
        acc.append(float(correct.asscalar()) / max(seen, 1))
    with ctx:
        store = nd.zeros((F, 1))
    kv.pull("weight", out=store)
    return {"steps": step, "step_s": step_s, "accuracy_by_epoch": acc,
            "records": recs, "store": store.asnumpy(), "init": init,
            "batches_exact": exact}


def mf_ratings(cfg, n, seed):
    """``n`` ratings from matrix_fact.py's planted model
    (``synthetic_ratings``: rank 8, noise 0.1) on ``rated_users`` of the
    ``users`` ids and ``rated_items`` of the ``items`` ids, each drawn
    from the seed; ids as float32, as the example feeds them."""
    rng = np.random.RandomState(seed)
    U = rng.randn(cfg["users"], 8) / math.sqrt(8)
    V = rng.randn(cfg["items"], 8) / math.sqrt(8)
    rated_u = rng.choice(cfg["users"], cfg["rated_users"], replace=False)
    rated_i = rng.choice(cfg["items"], cfg["rated_items"], replace=False)
    users = rated_u[rng.randint(0, cfg["rated_users"], n)]
    items = rated_i[rng.randint(0, cfg["rated_items"], n)]
    ratings = (U[users] * V[items]).sum(1) + 0.1 * rng.randn(n)
    return (users.astype(np.float32), items.astype(np.float32),
            ratings.astype(np.float32))


def mf_block(mx, cfg):
    """matrix_fact.py's ``MFBlock``: score(u, i) = <U_u, V_i> + b_u + c_i
    over four ``Embedding(sparse_grad=True)`` tables."""
    nn = mx.gluon.nn

    class MFBlock(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.user = nn.Embedding(cfg["users"], cfg["dim"],
                                         sparse_grad=True)
                self.item = nn.Embedding(cfg["items"], cfg["dim"],
                                         sparse_grad=True)
                self.user_bias = nn.Embedding(cfg["users"], 1,
                                              sparse_grad=True)
                self.item_bias = nn.Embedding(cfg["items"], 1,
                                              sparse_grad=True)

        def hybrid_forward(self, F, users, items):
            score = (self.user(users) * self.item(items)).sum(axis=1)
            return score + self.user_bias(users).reshape((-1,)) \
                + self.item_bias(items).reshape((-1,))

    with mx.name.NameManager():
        return MFBlock()


def sparse_mf(mx, ctx, cfg, steps=None, record=0, evals=None):
    """Phase 25 (b) on ``ctx``: ``MFBlock`` (weights Normal(0, mf_init)
    from the seed) under ``gluon.Trainer("adam")`` with ``L2Loss``, one
    pass over ``mf_ratings`` ratings in batches of ``mf_batch``; the
    validation RMSE on ``mf_val`` held-out ratings ``evals`` times along
    the way.  The first ``record`` steps' weights come back.  Returns a
    record, with the rows no batch looked up held bitwise in the weights
    and both Adam states."""
    nd = mx.nd
    n_train = cfg["mf_ratings"]
    users, items, ratings = mf_ratings(cfg, n_train + cfg["mf_val"],
                                       SEED + 27)
    B = cfg["mf_batch"]
    total = n_train // B if steps is None else steps
    evals = cfg["mf_evals"] if evals is None else evals
    net = mf_block(mx, cfg)
    rng = np.random.RandomState(SEED + 28)
    names = ("user", "item", "user_bias", "item_bias")
    blocks = [getattr(net, k) for k in names]
    init = [rng.normal(0, cfg["mf_init"], b.weight.shape).astype(np.float32)
            for b in blocks]
    with ctx:
        net.initialize(mx.init.Zero())
        for b, w in zip(blocks, init):
            b.weight.set_data(nd.array(w))
        net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": cfg["mf_lr"]})
        loss_fn = mx.gluon.loss.L2Loss()
        du, di, dr = (nd.array(a) for a in (users, items, ratings))
    order = [list(net.collect_params().values()).index(b.weight)
             for b in blocks]

    def rmse():
        se = 0.0
        for s in range(n_train, n_train + cfg["mf_val"], 65536):
            e = min(s + 65536, n_train + cfg["mf_val"])
            d = net(du[s:e], di[s:e]) - dr[s:e]
            se += float((d * d).sum().asscalar())
        return math.sqrt(se / cfg["mf_val"])

    at = sorted({int(round(k * total / (evals - 1)))
                 for k in range(evals)}) if evals > 1 else []
    curve, recs, step_s = [], [], []
    for step in range(total):
        if step in at:
            curve.append((step, rmse()))
        _sync(ctx.torch_device)
        t = time.perf_counter()
        s = step * B
        with mx.autograd.record():
            loss = loss_fn(net(du[s:s + B], di[s:s + B]),
                           dr[s:s + B]).mean()
        loss.backward()
        trainer.step(1)
        _sync(ctx.torch_device)
        step_s.append(time.perf_counter() - t)
        if step < record:
            recs.append([b.weight.data().asnumpy() for b in blocks])
    if total in at:
        curve.append((total, rmse()))
    seen_u = np.unique(users[:total * B].astype(np.int64))
    seen_i = np.unique(items[:total * B].astype(np.int64))
    held = {}
    for k, (b, w, seen) in enumerate(zip(blocks, init, (seen_u, seen_i,
                                                         seen_u, seen_i))):
        untouched = np.setdiff1d(np.arange(w.shape[0]), seen)
        mean, var = trainer._updater.states[order[k]]
        now = b.weight.data().asnumpy()
        held[names[k]] = {
            "untouched_rows": int(untouched.size),
            "weight_bitwise": bool(np.array_equal(now[untouched],
                                                  w[untouched])),
            "states_zero": bool(
                not mean.asnumpy()[untouched].any()
                and not var.asnumpy()[untouched].any()),
            "touched_moved": bool(not np.array_equal(now[seen], w[seen]))}
    return {"steps": total, "step_s": step_s, "rmse": curve,
            "records": recs, "held": held}


def _step_stats(step_s, warmup):
    timed = step_s[warmup:] or step_s
    return 1e3 * float(np.mean(timed)), 1e3 * float(np.median(timed))


def sparse_phase(mx, ck, smi, cfg=SPARSE, ctx=None, twin_ctx=None,
                 workdir_parent=None):
    """Phase 25: (a) sparse linear classification at Avazu's width and (b)
    matrix factorization at MovieLens-10M's id ranges on ``ctx`` (the
    card), each with its first ``twin_steps`` steps held to the port on
    ``twin_ctx`` (the CPU).  Raises on failure; prints its lines and
    returns its record."""
    import tempfile
    ctx = ctx or mx.gpu(0)
    twin_ctx = twin_ctx or mx.cpu()
    on_card = ctx.device_type == "gpu"
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    twin = cfg["twin_steps"]
    workdir = tempfile.TemporaryDirectory(prefix=".chip_smoke_sparse_",
                                          dir=workdir_parent or here)
    try:
        path = os.path.join(workdir.name, "avazu_like.libsvm")
        cols, labels = avazu_like(cfg)
        write_libsvm(path, cols, labels)
        parsed = parse_libsvm_np(path, cfg["fields"])
        t_data = time.perf_counter() - t0
        ck.reset_kernel_calls()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(ctx.torch_device)
            base = torch.cuda.memory_allocated(ctx.torch_device)
        t = time.perf_counter()
        lin = sparse_linear(mx, ctx, cfg, path, record=twin, parsed=parsed)
        t_a = time.perf_counter() - t
        calls_a = {k: v for k, v in ck.kernel_calls().items() if v}
        peak = (torch.cuda.max_memory_allocated(ctx.torch_device) - base) \
            if on_card else None
        ref = sparse_linear(mx, twin_ctx, cfg, path, steps=twin,
                            record=twin)
    finally:
        workdir.cleanup()
    ids_equal = all(np.array_equal(c["pulled_ids"], r["pulled_ids"])
                    for c, r in zip(lin["records"], ref["records"]))
    if not ids_equal:
        raise AssertionError("phase 25 (a): the card pulled other rows "
                             "than the CPU in the first %d steps" % twin)
    errs = {k: max(_rel(torch.from_numpy(c[k]), torch.from_numpy(r[k]))
                   for c, r in zip(lin["records"], ref["records"]))
            for k in ("pulled", "score", "store")}
    named = np.unique(parsed[1])
    untouched = np.setdiff1d(np.arange(cfg["features"]), named)
    bitwise = bool(np.array_equal(lin["store"][untouched],
                                  lin["init"][untouched]))
    ms, ms_med = _step_stats(lin["step_s"], cfg["warmup"])
    a = {"features": cfg["features"], "batch": cfg["batch"],
         "stored_per_row": cfg["fields"], "batches": cfg["batches"],
         "epochs": cfg["epochs"], "steps": lin["steps"],
         "batches_exact": lin["batches_exact"],
         "twin_steps": twin, "twin_ids_equal": ids_equal,
         "twin_max_rel": errs, "untouched_rows": int(untouched.size),
         "untouched_bitwise": bitwise,
         "accuracy_by_epoch": lin["accuracy_by_epoch"],
         "device_peak_bytes": peak, "launches": calls_a,
         "step_ms": ms, "step_ms_median": ms_med,
         "rows_per_s": cfg["batch"] / (ms / 1e3), "seconds": t_a,
         "data_seconds": t_data}
    print("phase 25 (a) on %s: sparse linear classification, LibSVMIter at "
          "%d features, batch %d, %d stored a row, %d batches x %d epochs: "
          "%d/%d batches' CSR exact to the numpy parse; first %d steps vs "
          "the port on the CPU: pulled ids equal %s, max rel pulled %.3g, "
          "scores %.3g, store %.3g; %d rows no batch named, bitwise %s; "
          "accuracy by epoch %s; device memory peak %s MB; %.3f ms/step "
          "(median %.3f), %.0f rows/s; launches %s; %.1f s (data %.1f s)"
          % (smi, cfg["features"], cfg["batch"], cfg["fields"],
             cfg["batches"], cfg["epochs"], lin["batches_exact"],
             cfg["batches"], twin, ids_equal, errs["pulled"], errs["score"],
             errs["store"], untouched.size, bitwise,
             ["%.4f" % v for v in lin["accuracy_by_epoch"]],
             "%.1f" % (peak / 2**20) if peak is not None else "n/a", ms,
             ms_med, a["rows_per_s"], calls_a, t_a, t_data), flush=True)
    if not all(v <= SPARSE_TWIN_TOL for v in errs.values()):
        raise AssertionError("phase 25 (a): the card's first %d steps lie "
                             "%s from the CPU's" % (twin, errs))
    if lin["batches_exact"] != cfg["batches"]:
        raise AssertionError("phase 25 (a): %d of %d batches held to the "
                             "parse" % (lin["batches_exact"], cfg["batches"]))
    if not bitwise:
        raise AssertionError("phase 25 (a): a row no batch named moved")
    if not lin["accuracy_by_epoch"][-1] > SPARSE_ACC:
        raise AssertionError("phase 25 (a): accuracy %.4f, not above %g"
                             % (lin["accuracy_by_epoch"][-1], SPARSE_ACC))
    if peak is not None and not peak < SPARSE_MEM_LIMIT:
        raise AssertionError("phase 25 (a): %d bytes of device memory"
                             % peak)
    if calls_a:
        raise AssertionError("phase 25 (a): kernels launched %s" % calls_a)

    # (b): the kernel counter read through telemetry
    was = mx.telemetry.enabled()
    mx.telemetry.reset()
    mx.telemetry.enable()
    ck.reset_kernel_calls()
    t = time.perf_counter()
    try:
        mf = sparse_mf(mx, ctx, cfg, record=twin)
        snap = mx.telemetry.snapshot()
    finally:
        mx.telemetry.enable(was)
    t_b = time.perf_counter() - t
    calls_b = {k: v for k, v in ck.kernel_calls().items() if v}
    counter = _families(snap, "mxnet_pallas_kernel_calls_total", "kernel")
    sweeps = {k: counter.get(k, 0) for k in ("fused_sgd",
                                              "fused_sgd_momentum",
                                              "fused_adam")}
    mref = sparse_mf(mx, twin_ctx, cfg, steps=twin, record=twin, evals=0)
    merr = max(_rel(torch.from_numpy(c), torch.from_numpy(r))
               for cs, rs in zip(mf["records"], mref["records"])
               for c, r in zip(cs, rs))
    ms_b, ms_b_med = _step_stats(mf["step_s"], cfg["warmup"])
    curve = mf["rmse"]
    b = {"users": cfg["users"], "items": cfg["items"], "dim": cfg["dim"],
         "batch": cfg["mf_batch"], "steps": mf["steps"],
         "optimizer": "adam", "lr": cfg["mf_lr"], "twin_steps": twin,
         "twin_max_rel": merr, "held": mf["held"], "rmse": curve,
         "counter_sweeps": sweeps, "launches": calls_b,
         "step_ms": ms_b, "step_ms_median": ms_b_med,
         "ratings_per_s": cfg["mf_batch"] / (ms_b / 1e3), "seconds": t_b}
    print("phase 25 (b) on %s: MFBlock (4 x Embedding(sparse_grad=True)) "
          "%d x %d and %d x %d, gluon.Trainer adam lr %g, batch %d, %d "
          "steps: first %d steps vs the port on the CPU max rel %.3g; rows "
          "no batch looked up %s; validation RMSE %s; "
          "mxnet_pallas_kernel_calls_total sweeps %s, launches %s; %.3f "
          "ms/step (median %.3f), %.0f ratings/s; %.1f s"
          % (smi, cfg["users"], cfg["dim"], cfg["items"], cfg["dim"],
             cfg["mf_lr"], cfg["mf_batch"], mf["steps"], twin, merr,
             {k: (v["untouched_rows"], v["weight_bitwise"],
                  v["states_zero"]) for k, v in mf["held"].items()},
             ["%d: %.4f" % c for c in curve], sweeps, calls_b, ms_b,
             ms_b_med, b["ratings_per_s"], t_b), flush=True)
    if not merr <= SPARSE_TWIN_TOL:
        raise AssertionError("phase 25 (b): the card's first %d steps lie "
                             "%g from the CPU's" % (twin, merr))
    for k, v in mf["held"].items():
        if not (v["weight_bitwise"] and v["states_zero"]
                and v["touched_moved"]):
            raise AssertionError("phase 25 (b): %s: %s" % (k, v))
    if len(curve) < 2 or not all(b2 < a2 for (_, a2), (_, b2) in
                                 zip(curve, curve[1:])):
        raise AssertionError("phase 25 (b): the validation RMSE did not "
                             "fall: %s" % curve)
    if any(sweeps.values()) or calls_b:
        raise AssertionError("phase 25 (b): kernel launches %s, counter %s"
                             % (calls_b, sweeps))
    return {"card": smi, "seconds": time.perf_counter() - t0,
            "linear_classification": a, "matrix_factorization": b}


SPARSE_PULL_W0 = np.arange(24, dtype=np.float32).reshape(6, 4)


def sparse_pull_rank(rank, world, init_method, ctx):
    """``row_sparse_pull`` on ``dist_sync``, rank ``rank`` of a world of
    :func:`run_ranks`: every rank inits (rank 0's value wins), pushes
    ``rank + 1`` everywhere under SGD lr 0.5, then pulls the rows
    ``[rank, 4, rank]`` into a row-sparse and a dense out.  Returns the
    row-sparse out's ids and rows and the dense out."""
    mx, on = par_join(rank, world, init_method, ctx)
    try:
        with on:
            nd = mx.nd
            kv = mx.kv.create("dist_sync")
            kv.init("w", nd.array(SPARSE_PULL_W0 * (rank + 1)))
            kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
            kv.push("w", nd.array(np.full((6, 4), rank + 1, np.float32)))
            ids = nd.array([rank, 4, rank])
            rs = nd.sparse.zeros("row_sparse", (6, 4))
            dense = nd.zeros((6, 4))
            kv.row_sparse_pull("w", out=[rs, dense], row_ids=ids)
            return (rs.indices.asnumpy(), rs.data.asnumpy(),
                    dense.asnumpy())
    finally:
        mx.parallel.distributed.shutdown()


def sparse_async_rank(rank, world, init_method, ctx, spool):
    """``row_sparse_pull`` on ``dist_async``, worker ``rank`` under
    ``tools/launch.py``'s environment: the coordinator (rank 0) sets SGD
    lr 0.5 on its server, every other worker pushes ``rank + 1``
    everywhere; once the server has applied them, each worker pulls the
    rows ``[rank, 4]`` (the others' read from the spool).  Returns the
    ids and rows.  The ranks meet through a ``FileStore`` on
    ``init_method``'s file."""
    from datetime import timedelta
    os.environ.update(_launch_env(world, rank))
    os.environ["MXNET_KVSTORE_ASYNC_DIR"] = spool
    import mxnet_tpu_torch as mx
    meet = torch.distributed.FileStore(init_method[len("file://"):], world)
    meet.set_timeout(timedelta(seconds=60))
    with mx.cpu():
        nd = mx.nd
        kv = mx.kv.create("dist_async")
        try:
            kv.init("w", nd.array(SPARSE_PULL_W0))
            if rank == 0:
                kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
                meet.set("updater", "1")
                deadline = time.time() + 60
                while len(kv._applied_log) < world - 1:
                    if time.time() > deadline:
                        raise AssertionError("the server applied %d of %d "
                                             "pushes" % (len(
                                                 kv._applied_log),
                                                 world - 1))
                    time.sleep(0.01)
                meet.set("applied", "1")
            else:
                meet.get("updater")
                kv.push("w", nd.array(np.full((6, 4), rank + 1,
                                              np.float32)))
                meet.get("applied")
            rs = nd.sparse.zeros("row_sparse", (6, 4))
            kv.row_sparse_pull("w", out=rs, row_ids=nd.array([rank, 4]))
            out = (rs.indices.asnumpy(), rs.data.asnumpy())
            meet.set("pulled%d" % rank, "1")
            if rank == 0:
                for r in range(world):
                    meet.get("pulled%d" % r)
            return out
        finally:
            kv.close()


# ---------------------------------------------------------------------------
# phase 26: the detection and ROI operators at SSD300's and VGG16 Faster
# R-CNN's widths, and the deformable pair at Deformable R-FCN's res5 width
# ---------------------------------------------------------------------------
VGG16 = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
         (512, 512, 512))
SSD300 = {
    # MXNet 1.2 example/ssd symbol_factory.get_config("vgg16_reduced", 300)
    # (Liu et al. 2016): VGG16-reduced body, heads on relu4_3 (L2
    # normalised, scale 20), relu7 and four extra blocks (mid, out, stride,
    # pad), 8,732 anchors
    "image": 300, "batch": 32, "classes": 21, "vgg": VGG16, "fc": 1024,
    "extras": ((256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 1, 0),
               (128, 256, 1, 0)),
    "sizes": ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
              (0.71, 0.79), (0.88, 0.961)),
    "ratios": ((1, 2, 0.5),) + ((1, 2, 0.5, 3, 1 / 3),) * 3
    + ((1, 2, 0.5),) * 2,
    "steps": (8 / 300, 16 / 300, 32 / 300, 64 / 300, 100 / 300, 1.0),
    "anchors": 8732, "boxes": (1, 8), "label_rows": 16,
    "warmup": 3, "timed": 10,
    "sgd": {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4},
    "target": {"overlap_threshold": 0.5, "negative_mining_ratio": 3.0,
               "variances": (0.1, 0.1, 0.2, 0.2)},
    "nms": 0.45, "topk": 400, "oracle_images": 4, "decode_reps": 3,
}
FRCNN = {
    # MXNet 1.2 example/rcnn, VGG16 end to end, the test config (Ren et al.
    # 2015): conv5_3 at stride 16 (38 x 63 at 600 x 1000), RPN 3x3 512 and
    # 2A/4A 1x1 heads, A 9, MultiProposal 6000 -> 300 at 0.7, ROIPooling 7x7
    # at 1/16, fc6/fc7 4096, 21 + 84 outputs, per-class NMS at 0.3
    "images": 4, "height": 600, "width": 1000, "classes": 21, "vgg": VGG16,
    "rpn": 512, "scales": (8, 16, 32), "ratios": (0.5, 1, 2), "stride": 16,
    "pre": 6000, "post": 300, "rpn_nms": 0.7, "min_size": 16, "pooled": 7,
    "fc": 4096, "nms": 0.3, "sample_ratio": 2, "check_rois": 8, "reps": 3,
}
DEFORM = {
    # Deformable R-FCN's res5 (Dai et al. 2017): a 3x3 512 -> 512
    # deformable convolution, dilate 2, on a 38 x 63 map; position-sensitive
    # pooling of 300 ROIs, 21 classes, 7 x 7 groups and bins, trans_std 0.1
    "height": 38, "width": 63, "channels": 512, "dilate": 2, "rois": 300,
    "classes": 21, "group": 7, "pooled": 7, "trans_std": 0.1,
    "image": (600, 1000), "stride": 16, "reps": 3,
}
DET_TOL = 1e-5      # of the largest value: the card against the port on the
                    # CPU (fp32 sums in another order: cuBLAS, atomics)
DET_BOX_TOL = 1e-6  # |box coordinate| (in [0, 1]) against the numpy oracle:
                    # numpy's expf and the card's differ by an ulp


@contextlib.contextmanager
def no_tf32():
    """fp32 convolutions and matmuls without TF32 for the body."""
    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = was


def vgg_stages(mx, widths, ceil=True):
    """VGG16's conv1_1 ... conv5_3 (3x3, ReLU) as one ``nn.Sequential`` a
    block, each but the first led by a 2x2 max pool (``ceil_mode``)."""
    nn = mx.gluon.nn
    stages = []
    for i, block in enumerate(widths):
        seq = nn.Sequential()
        if i:
            seq.add(nn.MaxPool2D(2, 2, ceil_mode=ceil))
        for w in block:
            seq.add(nn.Conv2D(w, 3, padding=1, activation="relu"))
        stages.append(seq)
    return stages


def ssd_net(mx, cfg):
    """SSD in the pattern of example/ssd/train.py's ``SSDNet`` (a forward
    returning anchors, (B, classes, N) class scores and (B, N*4) offsets)
    with MXNet 1.2 example/ssd's VGG16-reduced body: conv1_1-conv4_3,
    then pool4, conv5_*, pool5 3x3 s1 p1, fc6 3x3 dilation 6 and fc7 1x1,
    then ``cfg["extras"]``; heads (3x3 convs) on relu4_3 (L2 normalised
    by channel, times a learned scale set to 20), relu7 and each extra
    block, anchors from ``MultiBoxPrior`` with each map's sizes, ratios
    and steps."""
    nn = mx.gluon.nn
    classes = cfg["classes"]
    anchors_per_cell = [len(s) + len(r) - 1
                        for s, r in zip(cfg["sizes"], cfg["ratios"])]

    class SSD(mx.gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                vgg = vgg_stages(mx, cfg["vgg"])
                self.stages = nn.Sequential()
                first = nn.Sequential()
                for seq in vgg[:4]:
                    first.add(seq)
                self.stages.add(first)
                second = nn.Sequential()
                second.add(vgg[4], nn.MaxPool2D(3, 1, padding=1),
                           nn.Conv2D(cfg["fc"], 3, padding=6, dilation=6,
                                     activation="relu"),
                           nn.Conv2D(cfg["fc"], 1, activation="relu"))
                self.stages.add(second)
                for mid, out, stride, pad in cfg["extras"]:
                    seq = nn.Sequential()
                    seq.add(nn.Conv2D(mid, 1, activation="relu"),
                            nn.Conv2D(out, 3, strides=stride, padding=pad,
                                      activation="relu"))
                    self.stages.add(seq)
                self.norm_scale = self.params.get(
                    "norm_scale", shape=(1, cfg["vgg"][3][-1], 1, 1),
                    init=mx.init.Constant(20.0))
                self.cls_heads = nn.Sequential()
                self.loc_heads = nn.Sequential()
                for a in anchors_per_cell:
                    self.cls_heads.add(nn.Conv2D(a * classes, 3, padding=1))
                    self.loc_heads.add(nn.Conv2D(a * 4, 3, padding=1))

        def forward(self, x):
            B = x.shape[0]
            anchors, cls, loc = [], [], []
            feat = x
            for i in range(len(self.stages)):
                feat = self.stages[i](feat)
                head_in = feat
                if i == 0:
                    head_in = mx.nd.L2Normalization(feat, mode="channel") \
                        * self.norm_scale.data(feat.context)
                step = cfg["steps"][i]
                anchors.append(mx.nd.contrib.MultiBoxPrior(
                    feat, sizes=cfg["sizes"][i], ratios=cfg["ratios"][i],
                    steps=(step, step)))
                cls.append(self.cls_heads[i](head_in).transpose(
                    (0, 2, 3, 1)).reshape((B, -1, classes)))
                loc.append(self.loc_heads[i](head_in).transpose(
                    (0, 2, 3, 1)).reshape((B, -1)))
            return (mx.nd.concat(*anchors, dim=1),
                    mx.nd.concat(*cls, dim=1).transpose((0, 2, 1)),
                    mx.nd.concat(*loc, dim=1))

    return SSD()


def ssd_example_net(mx, num_classes=2, num_anchors=3):
    """example/ssd/train.py's own ``SSDNet``: a 32x32 input, two conv +
    pool stages to an 8x8 map, one class and one offset head, anchors
    sizes (0.3, 0.6) x ratios (1, 2), clipped."""
    nn = mx.gluon.nn

    class SSDNet(mx.gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.body = nn.Sequential()
                self.body.add(nn.Conv2D(16, 3, padding=1, activation="relu"),
                              nn.MaxPool2D(2),
                              nn.Conv2D(32, 3, padding=1, activation="relu"),
                              nn.MaxPool2D(2))
                self.cls_head = nn.Conv2D(num_anchors * num_classes, 3,
                                          padding=1)
                self.loc_head = nn.Conv2D(num_anchors * 4, 3, padding=1)

        def forward(self, x):
            feat = self.body(x)
            anchors = mx.nd.contrib.MultiBoxPrior(
                feat, sizes=(0.3, 0.6), ratios=(1.0, 2.0), clip=True)
            B = x.shape[0]
            cls_pred = self.cls_head(feat).transpose((0, 2, 3, 1)).reshape(
                (B, -1, num_classes)).transpose((0, 2, 1))
            loc_pred = self.loc_head(feat).transpose((0, 2, 3, 1)).reshape(
                (B, -1))
            return anchors, cls_pred, loc_pred

    return SSDNet()


def ssd_example_batch(rng, batch, img=32):
    """example/ssd/train.py's ``make_batch``: one bright rectangle an
    image; labels (B, 1, 5) [cls, x1, y1, x2, y2] in [0, 1]."""
    x = rng.rand(batch, 1, img, img).astype(np.float32) * 0.1
    labels = np.zeros((batch, 1, 5), np.float32)
    for i in range(batch):
        w, h = rng.randint(8, 20), rng.randint(8, 20)
        x0, y0 = rng.randint(0, img - w), rng.randint(0, img - h)
        x[i, 0, y0:y0 + h, x0:x0 + w] += 1.0
        labels[i, 0] = [0, x0 / img, y0 / img, (x0 + w) / img,
                        (y0 + h) / img]
    return x, labels


def ssd_batch(cfg, seed=SEED):
    """Synthetic detection data at ``cfg``'s widths: ``batch`` images of
    ``image`` x ``image``, each holding ``boxes`` (lo, hi) rectangles of
    the ``classes - 1`` foreground classes (a colour a class) on noise;
    labels (B, label_rows, 5) [cls, x1, y1, x2, y2] in [0, 1], padded with
    rows of -1."""
    rng = np.random.RandomState(seed + 26)
    n, s = cfg["batch"], cfg["image"]
    fg = cfg["classes"] - 1
    colors = rng.uniform(-1, 1, (fg, 3)).astype(np.float32)
    x = (rng.rand(n, 3, s, s) * 0.2).astype(np.float32)
    labels = np.full((n, cfg["label_rows"], 5), -1.0, np.float32)
    for i in range(n):
        for j in range(rng.randint(cfg["boxes"][0], cfg["boxes"][1] + 1)):
            w, h = rng.randint(s // 10, s // 2, 2)
            x0, y0 = rng.randint(0, s - w), rng.randint(0, s - h)
            c = rng.randint(fg)
            x[i, :, y0:y0 + h, x0:x0 + w] += colors[c][:, None, None]
            labels[i, j] = [c, x0 / s, y0 / s, (x0 + w) / s, (y0 + h) / s]
    return x, labels


def ssd_loss(mx, net, x, label, target):
    """example/ssd/train.py's loss: ``MultiBoxTarget`` with ``target``,
    softmax cross-entropy over the anchors mining keeps (rescaled to their
    mean) plus smooth L1 over the positives' offsets (over their count).
    Returns (loss, (loc_target, loc_mask, cls_target), cls_pred)."""
    ctx = x.context
    anchors, cls_pred, loc_pred = net(x)
    loc_t, loc_mask, cls_t = mx.nd.contrib.MultiBoxTarget(
        anchors, label, cls_pred, **target)
    keep = cls_t >= 0
    sample_weight = keep.astype("float32").expand_dims(axis=-1)
    n_kept = mx.nd.maximum(keep.astype("float32").sum(),
                           mx.nd.ones((1,), ctx=ctx))
    n_anchors = float(cls_t.shape[1])
    l_cls = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
        cls_pred.transpose((0, 2, 1)),
        mx.nd.maximum(cls_t, mx.nd.zeros_like(cls_t)),
        sample_weight).sum() * n_anchors / n_kept
    n_pos = mx.nd.maximum(loc_mask.sum() / 4.0, mx.nd.ones((1,), ctx=ctx))
    l_loc = mx.nd.smooth_l1((loc_pred - loc_t) * loc_mask,
                            scalar=1.0).sum() / n_pos
    return l_cls + l_loc, (loc_t, loc_mask, cls_t), cls_pred


def ssd_step(mx, net, trainer, x, label, target):
    """One training step of example/ssd/train.py: the loss recorded, its
    backward, ``trainer.step(1)``; returns the loss (not read)."""
    with mx.autograd.record():
        loss, _, _ = ssd_loss(mx, net, x, label, target)
    loss.backward()
    trainer.step(1)
    return loss


def ssd_decode(mx, net, x, **attrs):
    """example/ssd/train.py's decode: softmax over the class axis, then
    ``MultiBoxDetection`` with ``attrs``."""
    anchors, cls_pred, loc_pred = net(x)
    return mx.nd.contrib.MultiBoxDetection(
        mx.nd.softmax(cls_pred, axis=1), loc_pred, anchors, **attrs)


def detection_oracle(cls_prob, loc_pred, anchors, nms_threshold=0.5,
                     nms_topk=-1, threshold=0.01, background_id=0,
                     clip=True, force_suppress=False,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """``MultiBoxDetection`` of one image in numpy float32, from the JAX
    package's contract (mxnet_tpu/ops/contrib.py:358-413) with the
    sequential greedy loop: cls_prob (classes, N), loc_pred (N*4), anchors
    (N, 4) -> (N, 6) rows, the kept first by descending score (stable),
    the rest -1."""
    f32 = np.float32
    C, N = cls_prob.shape
    p = np.where((np.arange(C) == background_id)[:, None], -np.inf,
                 cls_prob)
    cls_id = p.argmax(0)
    score = p.max(0).astype(f32)
    loc = loc_pred.reshape(N, 4)
    ax1, ay1, ax2, ay2 = anchors.T
    acx, acy = (ax1 + ax2) * f32(0.5), (ay1 + ay2) * f32(0.5)
    aw, ah = ax2 - ax1, ay2 - ay1
    vx, vy, vw, vh = (f32(v) for v in variances)
    cx = loc[:, 0] * vx * aw + acx
    cy = loc[:, 1] * vy * ah + acy
    w = np.exp(loc[:, 2] * vw) * aw
    h = np.exp(loc[:, 3] * vh) * ah
    hw, hh = w * f32(0.5), h * f32(0.5)
    boxes = np.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1).astype(f32)
    if clip:
        boxes = np.clip(boxes, f32(0), f32(1))
    valid = score > f32(threshold)
    order = np.argsort(-np.where(valid, score, -np.inf), kind="stable")
    keep = valid[order].copy()
    if nms_topk > 0:
        keep[nms_topk:] = False
    b, ids = boxes[order], cls_id[order]
    area = (np.maximum(b[:, 2] - b[:, 0], f32(0))
            * np.maximum(b[:, 3] - b[:, 1], f32(0)))
    for i in range(N):
        if not keep[i]:
            continue
        o = b[i + 1:]
        iw = np.maximum(np.minimum(b[i, 2], o[:, 2])
                        - np.maximum(b[i, 0], o[:, 0]), f32(0))
        ih = np.maximum(np.minimum(b[i, 3], o[:, 3])
                        - np.maximum(b[i, 1], o[:, 1]), f32(0))
        inter = iw * ih
        union = area[i] + area[i + 1:] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(union > 0, inter / union, f32(0))
        sup = iou > f32(nms_threshold)
        if not force_suppress:
            sup &= ids[i + 1:] == ids[i]
        keep[i + 1:] &= ~sup
    kept = order[keep]
    out = np.full((N, 6), -1.0, f32)
    cid = cls_id[kept]
    out[:len(kept), 0] = np.where(cid > background_id, cid - 1, cid)
    out[:len(kept), 1] = score[kept]
    out[:len(kept), 2:] = boxes[kept]
    return out


def detections_match(got, want, tol=DET_BOX_TOL):
    """(equal, largest box difference) of two (N, 6) detection arrays:
    the same rows kept, ids and scores bitwise, boxes within ``tol``."""
    same = np.array_equal(got[:, :2], want[:, :2])
    diff = float(np.abs(got[:, 2:].astype(np.float64) - want[:, 2:]).max()) \
        if got.size else 0.0
    return same and diff <= tol, diff


def mining_flips(cls_a, cls_b, prob_a, prob_b, ignore=-1.0, ulps=4):
    """Compare two ``MultiBoxTarget`` cls_targets (B, N) whose
    hard-negative mining ranked background probabilities ``prob_a`` and
    ``prob_b`` (B, N), computed by two softmax implementations.  Every
    difference must be a mining flip: an anchor negative (0) on one side
    and ignored on the other, each swapped against one of the other side,
    with the two anchors' probabilities within ``ulps`` float32 spacings
    of each other on both sides and each anchor's probability within as
    much between the sides.  Returns (flips, bad): the flips counted, the
    differences that are no such flip."""
    flips, bad = 0, 0
    for a, b, pa, pb in zip(cls_a, cls_b, prob_a, prob_b):
        diff = np.flatnonzero(a != b)
        if not diff.size:
            continue
        only_a = diff[(a[diff] == 0) & (b[diff] == ignore)]
        only_b = diff[(b[diff] == 0) & (a[diff] == ignore)]
        bad += diff.size - only_a.size - only_b.size
        if only_a.size != only_b.size:
            bad += abs(only_a.size - only_b.size)
            continue
        tol_a = ulps * np.spacing(np.float32(np.abs(pa).max()))
        tol_b = ulps * np.spacing(np.float32(np.abs(pb).max()))
        for i, j in zip(np.sort(only_a), np.sort(only_b)):
            near = (abs(float(pa[i]) - float(pa[j])) <= tol_a
                    and abs(float(pb[i]) - float(pb[j])) <= tol_b
                    and abs(float(pa[i]) - float(pb[i])) <= max(tol_a, tol_b)
                    and abs(float(pa[j]) - float(pb[j])) <= max(tol_a, tol_b))
            flips += 2 if near else 0
            bad += 0 if near else 2
    return flips, bad


def _count_syncs(fn):
    """``fn()`` under torch's sync debug mode "warn": the number of times
    it made the host wait for the card."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _peak_reset(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(ctx.torch_device)
        return torch.cuda.memory_allocated(ctx.torch_device)
    return None


def _peak(ctx, base):
    if ctx.device_type != "gpu":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(ctx.torch_device) - base


def _timed_ms(device, fn, reps):
    """Each of ``reps`` calls of ``fn`` timed by CUDA events (the host
    clock on the CPU), after one untimed call; (median ms, all, last
    result)."""
    out = fn()
    times = []
    for _ in range(reps):
        a = _marker(device)
        out = fn()
        times.append(_elapsed_ms(a, _marker(device)))
    return float(np.median(times)), times, out


def ssd_detection(mx, ctx, cfg=SSD300, cpu=None, seed=SEED, profile=True):
    """Phase 26 (a): example/ssd/train.py's flow at ``cfg``'s widths on
    ``ctx``: ``warmup`` + ``timed`` training steps on one fixed batch
    (gluon ``Trainer`` SGD), its host syncs and device profile, the
    targets held to the port on ``cpu``, then the decode at ``nms_topk``
    ``topk`` and -1, ``oracle_images`` images held to ``detection_oracle``.
    Returns the record (``failures`` lists what failed)."""
    from mxnet_tpu_torch.ops import contrib as tcontrib
    cpu = cpu or mx.cpu()
    device = ctx.torch_device
    on_card = device.type == "cuda"
    failures = []
    t0 = time.perf_counter()
    torch.manual_seed(seed)
    x_np, lab_np = ssd_batch(cfg, seed)
    net = ssd_net(mx, cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    x = mx.nd.array(x_np, ctx=ctx)
    label = mx.nd.array(lab_np, ctx=ctx)
    anchors, cls_pred, loc_pred = net(x)
    n_anchors = anchors.shape[1]
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(cfg["sgd"]))
    base = _peak_reset(ctx)
    losses, marks = [], []
    for _ in range(cfg["warmup"] + cfg["timed"]):
        a = _marker(device)
        losses.append(ssd_step(mx, net, trainer, x, label, cfg["target"]))
        marks.append((a, _marker(device)))
    step_ms = [_elapsed_ms(a, b) for a, b in marks[cfg["warmup"]:]]
    peak = _peak(ctx, base)
    losses = [float(v.asnumpy().sum()) for v in losses]
    ms = float(np.median(step_ms))
    rec = {"anchors": n_anchors, "batch": cfg["batch"],
           "image": cfg["image"], "classes": cfg["classes"],
           "step_ms": ms, "step_ms_all": step_ms,
           "images_per_s": cfg["batch"] / (ms / 1e3),
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "device_peak_bytes": peak}
    if not losses[-1] < losses[0]:
        failures.append("the loss on the fixed batch did not fall: %s"
                        % losses)
    if on_card:
        rec["host_syncs_per_step"] = _count_syncs(
            lambda: ssd_step(mx, net, trainer, x, label, cfg["target"]))
        if profile:
            by_name = device_times(
                lambda: ssd_step(mx, net, trainer, x, label, cfg["target"]),
                n=1)
            busy = sum(by_name.values())
            rec["busy_us"] = busy if busy > 0 else None
            rec["idle_share"] = (max(0.0, 1 - busy / (ms * 1e3))
                                 if busy > 0 else None)
            rec["top_kernels"] = sorted(
                by_name.items(), key=lambda kv: -kv[1])[:6]
    # the targets on ctx against the port on the CPU, same inputs
    with mx.autograd.pause():
        anchors, cls_pred, _ = net(x)
    target = dict(cfg["target"])
    got = mx.nd.contrib.MultiBoxTarget(anchors, label, cls_pred, **target)
    ref = mx.nd.contrib.MultiBoxTarget(
        mx.nd.array(anchors.asnumpy(), ctx=cpu),
        mx.nd.array(lab_np, ctx=cpu),
        mx.nd.array(cls_pred.asnumpy(), ctx=cpu), **target)
    mask_equal = np.array_equal(got[1].asnumpy(), ref[1].asnumpy())
    prob_bg = torch.softmax(cls_pred._data, dim=1)[:, 0].cpu().numpy()
    prob_ref = torch.softmax(torch.from_numpy(cls_pred.asnumpy()),
                             dim=1)[:, 0].numpy()
    flips, bad = mining_flips(got[2].asnumpy(), ref[2].asnumpy(), prob_bg,
                              prob_ref)
    loc_err = _rel(got[0]._data.cpu(), ref[0]._data)
    rec.update(target_loc_mask_equal=mask_equal, target_mining_flips=flips,
               target_cls_other=bad, target_loc_rel=loc_err,
               positives=int(got[1].asnumpy().sum() / 4),
               negatives=int((got[2].asnumpy() == 0).sum()))
    if not mask_equal or bad or not loc_err <= DET_TOL:
        failures.append("MultiBoxTarget on %s against the CPU: loc_mask "
                        "equal %s, %d cls differences no mining flip, loc "
                        "%.3g" % (ctx, mask_equal, bad, loc_err))
    # the decode, timed, and held to the numpy oracle
    for key, topk in (("topk", cfg["topk"]), ("all", -1)):
        attrs = {"nms_threshold": cfg["nms"], "nms_topk": topk}
        with mx.autograd.pause():
            anchors, cls_pred, loc_pred = net(x)
            cls_prob = mx.nd.softmax(cls_pred, axis=1)
        for k in tcontrib.NMS_COUNTS:
            tcontrib.NMS_COUNTS[k] = 0
        dms, dall, dets = _timed_ms(device, lambda: mx.nd.contrib
                                    .MultiBoxDetection(cls_prob, loc_pred,
                                                       anchors, **attrs),
                                    cfg["decode_reps"])
        counts = {k: v / (cfg["decode_reps"] + 1)
                  for k, v in tcontrib.NMS_COUNTS.items()}
        dets = dets.asnumpy()
        cp, lp, an = (cls_prob.asnumpy(), loc_pred.asnumpy(),
                      anchors.asnumpy()[0])
        worst, equal = 0.0, True
        for i in range(min(cfg["oracle_images"], cfg["batch"])):
            ok, d = detections_match(dets[i], detection_oracle(
                cp[i], lp[i], an, nms_threshold=cfg["nms"], nms_topk=topk))
            equal &= ok
            worst = max(worst, d)
        rec["decode_%s" % key] = {
            "nms_topk": topk, "ms": dms, "ms_all": dall,
            "kept_per_image": float((dets[:, :, 0] >= 0).sum(1).mean()),
            "nms_steps_per_call": counts["steps"],
            "host_reads_per_call": counts["host_reads"],
            "oracle_equal": equal, "oracle_box_diff": worst}
        if not equal:
            failures.append("MultiBoxDetection (nms_topk %d) differs from "
                            "the numpy oracle (boxes %.3g)" % (topk, worst))
    rec["seconds"] = time.perf_counter() - t0
    rec["failures"] = failures
    return rec


def frcnn_net(mx, cfg):
    """Faster R-CNN's VGG16 network (MXNet 1.2 example/rcnn, end to end):
    ``features`` is conv1_1-conv5_3 (pools in ceil mode, stride 16) and
    the RPN (3x3 ``rpn`` conv, ReLU, 2A scores and 4A offsets, 1x1);
    ``head`` is fc6 and fc7 (ReLU) then the class scores and the
    class-specific offsets."""
    nn = mx.gluon.nn
    A = len(cfg["scales"]) * len(cfg["ratios"])

    class FasterRCNN(mx.gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.body = nn.Sequential()
                for seq in vgg_stages(mx, cfg["vgg"]):
                    self.body.add(seq)
                self.rpn_conv = nn.Conv2D(cfg["rpn"], 3, padding=1,
                                          activation="relu")
                self.rpn_cls = nn.Conv2D(2 * A, 1)
                self.rpn_box = nn.Conv2D(4 * A, 1)
                self.fc6 = nn.Dense(cfg["fc"], activation="relu")
                self.fc7 = nn.Dense(cfg["fc"], activation="relu")
                self.cls_score = nn.Dense(cfg["classes"])
                self.bbox_pred = nn.Dense(4 * cfg["classes"])

        def features(self, x):
            f = self.body(x)
            r = self.rpn_conv(f)
            return f, self.rpn_cls(r), self.rpn_box(r)

        def head(self, pooled):
            h = self.fc7(self.fc6(pooled))
            return self.cls_score(h), self.bbox_pred(h)

    return FasterRCNN()


def rpn_probs(mx, rpn_cls):
    """The RPN's two-way softmax over (B, 2A, H, W) scores laid out class
    major ([bg x A, fg x A]), as MultiProposal takes them."""
    B, A2, H, W = rpn_cls.shape
    return mx.nd.softmax(rpn_cls.reshape((B, 2, (A2 // 2) * H, W)),
                         axis=1).reshape((B, A2, H, W))


def frcnn_decode(mx, rois, cls_score, bbox_pred, classes, images, post):
    """Per-class detections (images * (classes - 1), post, 6) rows [class,
    score, x1, y1, x2, y2]: each ROI's offsets for a class applied to the
    ROI (``exp`` clipped at +-4, as example/rcnn/train_end2end.py)."""
    prob = mx.nd.softmax(cls_score, axis=-1)              # (R, classes)
    box = rois.slice_axis(axis=1, begin=1, end=5)
    rw = box.slice_axis(axis=1, begin=2, end=3) - \
        box.slice_axis(axis=1, begin=0, end=1)
    rh = box.slice_axis(axis=1, begin=3, end=4) - \
        box.slice_axis(axis=1, begin=1, end=2)
    rcx = box.slice_axis(axis=1, begin=0, end=1) + rw / 2
    rcy = box.slice_axis(axis=1, begin=1, end=2) + rh / 2
    d = bbox_pred.reshape((-1, classes, 4))
    cx = rcx + d.slice_axis(axis=2, begin=0, end=1).reshape((-1, classes)) \
        * rw
    cy = rcy + d.slice_axis(axis=2, begin=1, end=2).reshape((-1, classes)) \
        * rh
    w = mx.nd.exp(mx.nd.clip(d.slice_axis(axis=2, begin=2, end=3).reshape(
        (-1, classes)), -4, 4)) * rw
    h = mx.nd.exp(mx.nd.clip(d.slice_axis(axis=2, begin=3, end=4).reshape(
        (-1, classes)), -4, 4)) * rh
    cid = mx.nd.broadcast_to(mx.nd.arange(classes, ctx=rois.context)
                             .reshape((1, classes)), shape=prob.shape)
    rows = mx.nd.stack(cid, prob, cx - w / 2, cy - h / 2, cx + w / 2,
                       cy + h / 2, axis=-1)               # (R, classes, 6)
    rows = rows.reshape((images, post, classes, 6)).transpose((0, 2, 1, 3))
    return rows.slice_axis(axis=1, begin=1, end=classes).reshape(
        (-1, post, 6))


def frcnn_detection(mx, ctx, cfg=FRCNN, cpu=None, seed=SEED):
    """Phase 26 (b): example/rcnn's ``detect`` flow at VGG16 end to end's
    widths on ``ctx``: features and RPN, ``_contrib_MultiProposal``,
    ``ROIPooling`` and the head, per-class ``box_nms``; ``ROIAlign`` on the
    same ROIs; one backward of a scalar loss through the ROI head to
    conv5_3 for each; the gradient of ``check_rois`` ROIs held to the port
    on ``cpu``.  Returns the record (``failures`` lists what failed)."""
    cpu = cpu or mx.cpu()
    device = ctx.torch_device
    failures = []
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 27)
    B, S = cfg["images"], cfg["stride"]
    x_np = rng.uniform(-1, 1, (B, 3, cfg["height"], cfg["width"])) \
        .astype(np.float32)
    torch.manual_seed(seed)
    net = frcnn_net(mx, cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    x = mx.nd.array(x_np, ctx=ctx)
    info = mx.nd.array(np.tile(np.array(
        [[cfg["height"], cfg["width"], 1.0]], np.float32), (B, 1)), ctx=ctx)
    prop_attrs = dict(rpn_pre_nms_top_n=cfg["pre"],
                      rpn_post_nms_top_n=cfg["post"], threshold=cfg["rpn_nms"],
                      rpn_min_size=cfg["min_size"], scales=cfg["scales"],
                      ratios=cfg["ratios"], feature_stride=S)
    pool_attrs = dict(pooled_size=(cfg["pooled"], cfg["pooled"]),
                      spatial_scale=1.0 / S)
    base = _peak_reset(ctx)
    with mx.autograd.pause():
        feat, rpn_cls, rpn_box = net.features(x)
        probs = rpn_probs(mx, rpn_cls)
        prop_ms, prop_all, rois = _timed_ms(
            device, lambda: mx.nd.contrib.MultiProposal(
                probs, rpn_box, info, **prop_attrs), cfg["reps"])
        pooled = mx.nd.ROIPooling(feat, rois, **pool_attrs)
        cls_score, bbox_pred = net.head(pooled)
        dets = frcnn_decode(mx, rois, cls_score, bbox_pred, cfg["classes"],
                            B, cfg["post"])
        nms_ms, _, kept = _timed_ms(device, lambda: mx.nd.contrib.box_nms(
            dets, overlap_thresh=cfg["nms"]), cfg["reps"])
    kept = kept.asnumpy()
    rec = {"images": B, "map": list(feat.shape), "anchors":
           int(rpn_cls.shape[1] // 2 * rpn_cls.shape[2] * rpn_cls.shape[3]),
           "rois": int(rois.shape[0]), "proposal_ms": prop_ms,
           "proposal_ms_all": prop_all, "class_nms_ms": nms_ms,
           "detections_kept": int((kept[:, :, 0] >= 0).sum())}
    r_np = rois.asnumpy()
    if not (np.isfinite(r_np).all() and np.isfinite(kept).all()):
        failures.append("non-finite proposals or detections")
    if not np.array_equal(r_np[:, 0], np.repeat(np.arange(B), cfg["post"])):
        failures.append("the ROIs' batch indices are not 0..%d in order"
                        % (B - 1))
    rng_w = np.random.RandomState(seed + 28)
    wc = mx.nd.array(rng_w.uniform(-1, 1, (rois.shape[0], cfg["classes"]))
                     .astype(np.float32), ctx=ctx)
    wb = mx.nd.array(rng_w.uniform(-1, 1, (rois.shape[0], 4 * cfg["classes"]))
                     .astype(np.float32), ctx=ctx)
    fd = mx.nd.array(feat.asnumpy(), ctx=ctx)
    twin = frcnn_net(mx, cfg)
    twin.initialize(mx.init.Zero(), ctx=cpu)
    twin.features(mx.nd.zeros((1, 3, 2 * S, 2 * S), ctx=cpu))
    twin.head(mx.nd.zeros((1, cfg["vgg"][-1][-1], cfg["pooled"],
                           cfg["pooled"]), ctx=cpu))
    mx.convert.block_params_from_numpy(
        twin, {k: v.data().asnumpy()
               for k, v in net.collect_params().items()}, ctx=cpu)
    for key, op, attrs in (
            ("roi_pooling", mx.nd.ROIPooling, pool_attrs),
            ("roi_align", mx.nd.contrib.ROIAlign,
             dict(pool_attrs, sample_ratio=cfg["sample_ratio"]))):
        fwd_ms, _, out = _timed_ms(device, lambda: op(fd, rois, **attrs),
                                   cfg["reps"])
        fd.attach_grad()
        g = mx.nd.array(np.random.RandomState(seed + 29).uniform(
            -1, 1, out.shape).astype(np.float32), ctx=ctx)

        def roi_backward():
            with mx.autograd.record():
                o = op(fd, rois, **attrs)
            o.backward(g)
            return fd.grad

        bwd_all = []
        roi_backward()
        for _ in range(cfg["reps"]):
            with mx.autograd.record():
                o = op(fd, rois, **attrs)
            a = _marker(device)
            o.backward(g)
            bwd_all.append(_elapsed_ms(a, _marker(device)))

        def head_loss(net_, f, r, wc_, wb_):
            with mx.autograd.record():
                c, b = net_.head(op(f, r, **attrs))
                loss = (c * wc_).sum() + (b * wb_).sum()
            loss.backward()
            return f.grad

        a = _marker(device)
        head_loss(net, fd, rois, wc, wb)
        head_ms = _elapsed_ms(a, _marker(device))
        # check_rois ROIs on ctx and through the port on the CPU
        n = cfg["check_rois"]
        got = head_loss(net, fd, rois[:n], wc[:n], wb[:n]).asnumpy()
        fc = mx.nd.array(fd.asnumpy(), ctx=cpu)
        fc.attach_grad()
        want = head_loss(twin, fc, mx.nd.array(r_np[:n], ctx=cpu),
                         mx.nd.array(wc.asnumpy()[:n], ctx=cpu),
                         mx.nd.array(wb.asnumpy()[:n], ctx=cpu)).asnumpy()
        err = _rel(torch.from_numpy(got), torch.from_numpy(want))
        rec[key] = {"forward_ms": fwd_ms, "backward_ms":
                    float(np.median(bwd_all)), "backward_ms_all": bwd_all,
                    "head_step_ms": head_ms, "check_rois": n,
                    "grad_rel_cpu": err, "shape": list(out.shape)}
        if not err <= DET_TOL:
            failures.append("%s: the gradient of %d ROIs lies %.3g from the "
                            "CPU's" % (key, n, err))
        fd = mx.nd.array(feat.asnumpy(), ctx=ctx)
    rec["device_peak_bytes"] = _peak(ctx, base)
    rec["seconds"] = time.perf_counter() - t0
    rec["failures"] = failures
    return rec


def deform_detection(mx, ctx, cfg=DEFORM, cpu=None, seed=SEED):
    """Phase 26 (c): the deformable pair at ``cfg``'s widths, batch 1, on
    ``ctx``: each forward and backward (d sum(out * w) by data, offsets or
    trans, and weight) timed and held to the port on ``cpu``.  Returns the
    record (``failures`` lists what failed)."""
    cpu = cpu or mx.cpu()
    device = ctx.torch_device
    failures = []
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 30)
    H, W, C = cfg["height"], cfg["width"], cfg["channels"]
    u = lambda *s, a=1.0: rng.uniform(-a, a, s).astype(np.float32)  # noqa
    ih, iw = cfg["image"]
    lo = rng.uniform(0, 1, (cfg["rois"], 2)) * [iw * 0.8, ih * 0.8]
    size = rng.uniform(32, 400, (cfg["rois"], 2))
    rois = np.concatenate([np.zeros((cfg["rois"], 1)), lo,
                           np.minimum(lo + size, [iw - 1, ih - 1])], 1) \
        .astype(np.float32)
    od, grp, pooled = cfg["classes"], cfg["group"], cfg["pooled"]
    d = cfg["dilate"]
    cases = (
        ("deformable_convolution", mx.nd.contrib.DeformableConvolution,
         [u(1, C, H, W), u(1, 18, H, W, a=2.0),
          u(C, C, 3, 3, a=float(np.sqrt(3.0 / (9 * C)))), u(C)],
         dict(kernel=(3, 3), dilate=(d, d), pad=(d, d), num_filter=C)),
        ("deformable_psroi_pooling",
         mx.nd.contrib.DeformablePSROIPooling,
         [u(1, od * grp * grp, H, W), rois, u(cfg["rois"], 2, grp, grp)],
         dict(spatial_scale=1.0 / cfg["stride"], output_dim=od,
              group_size=grp, pooled_size=pooled,
              trans_std=cfg["trans_std"])))
    rec = {}
    for key, op, ins, attrs in cases:
        diff = [i for i, a in enumerate(ins) if a is not rois]

        def run(on, times=None):
            arrs = [mx.nd.array(a, ctx=on) for a in ins]
            for i in diff:
                arrs[i].attach_grad()
            wt = mx.nd.array(np.random.RandomState(seed + 31).uniform(
                -1, 1, op(*arrs, **attrs).shape).astype(np.float32), ctx=on)
            a = _marker(on.torch_device)
            with mx.autograd.record():
                out = op(*arrs, **attrs)
            b = _marker(on.torch_device)
            out.backward(wt)
            c = _marker(on.torch_device)
            if times is not None:
                times.append((_elapsed_ms(a, b), _elapsed_ms(b, c)))
            return [out.asnumpy()] + [arrs[i].grad.asnumpy() for i in diff]

        times = []
        for _ in range(cfg["reps"] + 1):
            got = run(ctx, times)
        want = run(cpu)
        errs = [_rel(torch.from_numpy(g), torch.from_numpy(w))
                for g, w in zip(got, want)]
        rec[key] = {"forward_ms": float(np.median([t[0] for t in times[1:]])),
                    "backward_ms": float(np.median([t[1]
                                                    for t in times[1:]])),
                    "output": list(got[0].shape), "rel_cpu": errs}
        if not (all(e <= DET_TOL for e in errs)
                and all(np.isfinite(g).all() for g in got)):
            failures.append("%s: output and gradients lie %s from the "
                            "CPU's" % (key, errs))
    rec["seconds"] = time.perf_counter() - t0
    rec["failures"] = failures
    return rec


def detection_phase(mx, ck, smi, ssd=SSD300, frcnn=FRCNN, deform=DEFORM,
                    ctx=None, cpu=None):
    """Phase 26: (a) SSD300, (b) Faster R-CNN VGG16, (c) the deformable
    pair, fp32 without TF32, on ``ctx`` (the card), each held to the port
    on ``cpu``; the kernel counter over all three.  Raises on failure;
    prints its lines and returns its record."""
    ctx = ctx or mx.gpu(0)
    cpu = cpu or mx.cpu()
    t0 = time.perf_counter()
    ck.reset_kernel_calls()
    with no_tf32():
        a = ssd_detection(mx, ctx, ssd, cpu)
        b = frcnn_detection(mx, ctx, frcnn, cpu)
        c = deform_detection(mx, ctx, deform, cpu)
    calls = {k: v for k, v in ck.kernel_calls().items() if v}
    print("phase 26 (a) on %s: SSD300 (VGG16-reduced, %d anchors, %d "
          "classes) batch %d at %d px, gluon.Trainer SGD: %.3f ms/step "
          "(median of %d, CUDA events), %.1f images/s, loss %.4f -> %.4f on "
          "one batch; host syncs a step %s; device busy %s us, idle share "
          "%s; peak %s MB; MultiBoxTarget against the CPU: loc_mask equal "
          "%s, mining flips %d, other cls differences %d, loc %.3g "
          "(%d positives, %d negatives); decode nms_topk %d: %.3f ms (%.1f "
          "NMS steps, %.1f host reads a call, %.1f kept an image), "
          "nms_topk -1: %.3f ms (%.1f steps, %.1f reads, %.1f kept); the "
          "numpy oracle on %d images: equal %s / %s (boxes %.2g / %.2g)"
          % (smi, a["anchors"], ssd["classes"], a["batch"], a["image"],
             a["step_ms"], ssd["timed"], a["images_per_s"], a["loss_first"],
             a["loss_last"], a.get("host_syncs_per_step"), a.get("busy_us"),
             a.get("idle_share"), _mb_or_na(a["device_peak_bytes"]),
             a["target_loc_mask_equal"], a["target_mining_flips"],
             a["target_cls_other"], a["target_loc_rel"], a["positives"],
             a["negatives"], ssd["topk"], a["decode_topk"]["ms"],
             a["decode_topk"]["nms_steps_per_call"],
             a["decode_topk"]["host_reads_per_call"],
             a["decode_topk"]["kept_per_image"], a["decode_all"]["ms"],
             a["decode_all"]["nms_steps_per_call"],
             a["decode_all"]["host_reads_per_call"],
             a["decode_all"]["kept_per_image"], ssd["oracle_images"],
             a["decode_topk"]["oracle_equal"], a["decode_all"]["oracle_equal"],
             a["decode_topk"]["oracle_box_diff"],
             a["decode_all"]["oracle_box_diff"]), flush=True)
    print("phase 26 (b) on %s: Faster R-CNN VGG16, %d images of %dx%d, map "
          "%s, %d anchors an image: MultiProposal %d -> %d at %.1f: %.3f ms; "
          "%d ROIs; per-class box_nms %.3f ms (%d kept); ROIPooling forward "
          "%.3f ms, backward %.3f ms, through the head %.3f ms, %d ROIs' "
          "gradient vs the CPU %.3g; ROIAlign forward %.3f ms, backward "
          "%.3f ms, through the head %.3f ms, vs the CPU %.3g; peak %s MB"
          % (smi, b["images"], frcnn["height"], frcnn["width"], b["map"],
             b["anchors"], frcnn["pre"], frcnn["post"], frcnn["rpn_nms"],
             b["proposal_ms"], b["rois"], b["class_nms_ms"],
             b["detections_kept"], b["roi_pooling"]["forward_ms"],
             b["roi_pooling"]["backward_ms"],
             b["roi_pooling"]["head_step_ms"], frcnn["check_rois"],
             b["roi_pooling"]["grad_rel_cpu"], b["roi_align"]["forward_ms"],
             b["roi_align"]["backward_ms"], b["roi_align"]["head_step_ms"],
             b["roi_align"]["grad_rel_cpu"],
             _mb_or_na(b["device_peak_bytes"])), flush=True)
    print("phase 26 (c) on %s: DeformableConvolution %d -> %d 3x3 dilate %d "
          "on %dx%d: forward %.3f ms, backward %.3f ms, vs the CPU %s; "
          "DeformablePSROIPooling %d ROIs, %d classes, %dx%d: forward %.3f "
          "ms, backward %.3f ms, vs the CPU %s; kernel launches %s; phase 26 "
          "%.1f s" % (
              smi, deform["channels"], deform["channels"], deform["dilate"],
              deform["height"], deform["width"],
              c["deformable_convolution"]["forward_ms"],
              c["deformable_convolution"]["backward_ms"],
              ["%.2g" % e for e in c["deformable_convolution"]["rel_cpu"]],
              deform["rois"], deform["classes"], deform["pooled"],
              deform["pooled"], c["deformable_psroi_pooling"]["forward_ms"],
              c["deformable_psroi_pooling"]["backward_ms"],
              ["%.2g" % e for e in c["deformable_psroi_pooling"]["rel_cpu"]],
              calls, time.perf_counter() - t0), flush=True)
    bad = a["failures"] + b["failures"] + c["failures"]
    if bad:
        raise AssertionError("phase 26: " + "; ".join(bad))
    return {"card": smi, "seconds": time.perf_counter() - t0,
            "launches": calls, "ssd300": a, "faster_rcnn": b,
            "deformable": c}


def _mb_or_na(nbytes):
    return "%.1f" % (nbytes / 2**20) if nbytes is not None else "n/a"



def main():
    if sys.argv[1:2] == ["_fleet_replica"]:
        # phase 24 (a)'s replica, in a process of its own
        return fleet_replica_main(json.loads(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["_ts_restart"]:
        # phase 20 (d)'s restarted server, in a process of its own
        print(json.dumps(ts_restart_child(json.loads(sys.argv[2])),
                         default=str))
        return 0
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bw, flops, tf32, bf16 = card_rates(kind)
    dev = torch.device("cuda", 0)
    print("device: %s | %s | torch %s, CUDA %s | cudnn.allow_tf32=%s "
          "cuda.matmul.allow_tf32=%s | peak %.3g B/s, %.3g fp32 FLOP/s, "
          "%.3g TF32 FLOP/s, %.3g bf16 FLOP/s" % (
              kind, smi, torch.__version__, torch.version.cuda,
              torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32, bw, flops, tf32, bf16),
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    report = _build.build_all(verbose=True)
    for name in _build.SOURCES:
        _build.library(name)
    print("build: %.1f s for %s" % (time.perf_counter() - t0,
                                    sorted(report) or "nothing (fresh)"))
    for name, out in sorted(report.items()):
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))
    hmma = hmma_counts(_build)
    print("tensor cores: cuobjdump -sass of libmxtt_flash_attention.so: %s "
          "%s" % (HMMA_BF16, "; ".join(
              "%s %s: %d" % (k, v["function"], v["count"])
              for k, v in hmma.items())), flush=True)
    sass_wide = k2_wide_counts(_build)
    print("K2 past 1024 columns: cuobjdump -sass of libmxtt_softmax.so: %s"
          % "; ".join("%s %s: %s" % (dtype, v["function"], ", ".join(
              "%s %d" % (op, v[key]) for key, op in K2_WIDE_SASS))
              for dtype, v in sass_wide.items()), flush=True)

    # 3. kernels against their plain versions
    sym = resnet_symbol(LAYERS, IMAGE)
    sites = k3_sites(mx, sym, BATCH, IMAGE)
    if len(sites) != 33:
        raise AssertionError("the peephole found %d BatchNorm->ReLU sites "
                             "in ResNet-50 v1; expected 33" % len(sites))
    if sys.argv[1:] == ["observability"]:
        # phase 19 alone, in a process with no earlier profiler session
        # (ResNet-50's fused step has two buckets, as phase 5 finds)
        obs_line = observability_phase(mx, ck, mx.gpu(0), sym, len(sites),
                                       2, smi)
        print(json.dumps({"observability": obs_line}, default=str))
        return 0
    if sys.argv[1:] == ["generate"]:
        # phase 21 alone
        gen_line, el_line = generate_phase(mx, ck, mx.gpu(0), sym, smi)
        print(json.dumps({"generative": gen_line}, default=str))
        print(json.dumps({"elastic": el_line}, default=str))
        print("nvidia-smi: %s" % smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["parallel"]:
        # phase 22 alone
        par_line = parallel_phase(mx, ck, dev, bw, flops, smi)
        print(json.dumps({"parallel": par_line}, default=str))
        print("nvidia-smi: %s" % smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["model_parallel"]:
        # phase 23 alone
        mp_line = model_parallel_phase(mx, ck, dev, smi)
        print(json.dumps({"model_parallel": mp_line}, default=str))
        print("nvidia-smi: %s" % smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["fleet"]:
        # phase 24 alone
        fleet_line = fleet_phase(mx, ck, sym, len(sites), smi)
        print(json.dumps({"fleet": fleet_line}, default=str))
        print("nvidia-smi: %s" % smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["sparse"]:
        # phase 25 alone
        sparse_line = sparse_phase(mx, ck, smi)
        print(json.dumps({"sparse": sparse_line}, default=str))
        print("nvidia-smi: %s" % smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["detection"]:
        # phase 26 alone
        det_line = detection_phase(mx, ck, smi)
        print(json.dumps({"detection": det_line}, default=str))
        print("nvidia-smi: %s" % smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["train_serve"]:
        # phase 20 alone
        ts_line = train_serve_phase(mx, ck, mx.gpu(0), sym, len(sites), smi)
        print(json.dumps({"train_serve": ts_line}, default=str))
        print("nvidia-smi: %s" % smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    k3, k3_jobs = check_k3(ck, sites, dev, bw, flops)
    k2, k2_jobs = check_k2(ck, dev, bw, flops, BATCH)
    k2["sass_wide"] = sass_wide
    for rec, jobs in ((k3, k3_jobs), (k2, k2_jobs)):
        time_jobs(rec, jobs, "call_ms", time_ms)
    print("kernels checked: K3 bitwise equal at %d sites x fp32/bf16 x "
          "relu on/off; K2 within 1e-6 (fp32) and one bf16 rounding at "
          "(%d, 1000), (1, 1000), (8, 1000), (7, 1), C 100/256/500 at 6 rows, "
          "(3, 1024), (3, 1025), (5, 999), (5, 4097), logits x1e4, "
          "C 99/100/255/256/511/512/999/1000/1024 at 1024-2048 rows, "
          "past 1024 columns %s, a NaN in one row of %s, and the timed "
          "(98304, 1024) and %s" % (
              len(sites), BATCH, ", ".join("%s x%g" % c
                                          for c in K2_WIDE_CASES),
              ", ".join(map(str, K2_NAN_CASES)),
              ", ".join(map(str, K2_WIDE_TIMED))), flush=True)

    # 4. the serving path
    res = serve(mx, ck, mx.gpu(0), sym, IMAGE, len(sites))
    for rec, name in ((k3, "scale_bias_relu"), (k2, "softmax_lastaxis")):
        rec["launches"] = res["launches"][name]
        rec["launches_per_forward"] = rec["launches"] / res["forwards"]

    # 5. the training path: Module.fit through the fused step
    mod, tr = train(mx, ck, mx.gpu(0), sym, IMAGE, BATCH, TRAIN_STEPS,
                    TRAIN_WARMUP)
    nb, steps = len(tr["buckets"]), tr["steps"]
    want = dict.fromkeys(tr["calls"], 0)
    want.update(sgd_mom_sweep=nb * steps, softmax_lastaxis=steps)
    if not tr["fused"] or tr["kernel"] != "sgd_mom_sweep" \
            or tr["calls"] != want:
        raise AssertionError("training: fused step %s (%s), launches %s; "
                             "expected %s" % (tr["fused"], tr["kernel"],
                                              tr["calls"], want))
    if not tr["ce_last"] < tr["ce_first"]:
        raise AssertionError("training: the cross-entropy on the fixed batch "
                             "went from %.4f to %.4f" % (tr["ce_first"],
                                                         tr["ce_last"]))
    print("training on %s: ResNet-50 v1 fp32, Module.fit kvstore=tpu, batch "
          "%d, SGD lr %g momentum %g wd %g; %d warmup + %d timed steps: "
          "%.2f ms/step, %.1f images/s (CUDA events); buckets %s; launches "
          "%s; cross-entropy on the batch %.4f -> %.4f"
          % (smi, BATCH, SGD_PARAMS["learning_rate"], SGD_PARAMS["momentum"],
             SGD_PARAMS["wd"], TRAIN_WARMUP, TRAIN_STEPS, tr["step_ms"],
             tr["images_per_s"], tr["buckets"], tr["calls"], tr["ce_first"],
             tr["ce_last"]), flush=True)
    train_batch = synthetic_iter(mx, mx.gpu(0), BATCH, IMAGE, 1).next()
    arg_params, aux_params = mod.get_params()
    arg_params = {k: v.copy() for k, v in arg_params.items()}
    aux_params = {k: v.copy() for k, v in aux_params.items()}
    # the same step with MXNET_PALLAS_FUSED_OPT=0 (per-array updates, no
    # sweep kernel), in turns with the kernels: 0, kernels, 0
    ab = {None: [tr["step_ms"]], "0": []}
    for mode in ("0", None, "0"):
        with knobs(mode, FUSED_OPT):
            ab[mode].append(train(
                mx, ck, mx.gpu(0), sym, IMAGE, BATCH, TRAIN_STEPS,
                TRAIN_WARMUP, arg_params=arg_params,
                aux_params=aux_params)[1]["step_ms"])
    print("training step ms, sweep kernels %s vs MXNET_PALLAS_FUSED_OPT=0 "
          "%s (runs in the order kernels, 0, kernels, 0)"
          % (["%.2f" % t for t in ab[None]], ["%.2f" % t for t in ab["0"]]),
          flush=True)

    # 6. parity: the kernel step against the per-array step
    par = parity(mx, ck, mx.gpu(0), sym, IMAGE, BATCH, arg_params,
                 aux_params)
    if not (par["bitwise"] or par["max_rel"] <= 1e-6):
        raise AssertionError("parity: sweep vs per-array step differ by "
                             "%g relative" % par["max_rel"])
    print("parity (2 steps from one state, cudnn.deterministic): %d tensors "
          "(weights, momentum, moving stats), bitwise equal: %s, max "
          "relative difference %g" % (par["tensors"], par["bitwise"],
                                      par["max_rel"]), flush=True)

    # 7. the other optimizer paths
    other, other_mods = {}, {}
    for kname, opt_name, params in (
            ("adam_sweep", "adam", {"learning_rate": 1e-3, "wd": 1e-4}),
            ("sgd_sweep", "sgd", {"learning_rate": 0.02, "wd": 1e-4})):
        mod_o, res_o = train(mx, ck, mx.gpu(0), sym, IMAGE, BATCH,
                             OTHER_STEPS, TRAIN_WARMUP, optimizer=opt_name,
                             optimizer_params=params, arg_params=arg_params,
                             aux_params=aux_params)
        n_o = len(res_o["buckets"]) * res_o["steps"]
        if res_o["kernel"] != kname or res_o["calls"][kname] != n_o \
                or n_o <= 0:
            raise AssertionError("%s path: kernel %s, launches %s" % (
                opt_name, res_o["kernel"], res_o["calls"]))
        other[kname] = res_o
        other_mods[opt_name] = mod_o
        print("%s path on %s: %d warmup + %d timed steps: %.2f ms/step, "
              "%.1f images/s (CUDA events; SGD momentum %.2f ms/step); "
              "launches %s; cross-entropy %.4f -> %.4f"
              % (opt_name, smi, TRAIN_WARMUP, OTHER_STEPS, res_o["step_ms"],
                 res_o["images_per_s"], tr["step_ms"], res_o["calls"],
                 res_o["ce_first"], res_o["ce_last"]), flush=True)

    # 8. the sweep kernels against their plain versions
    sweeps, sweep_jobs = check_sweeps(ck, dev, bw, flops, tr["buckets"])
    for name, rec in sweeps.items():
        time_jobs(rec, sweep_jobs[name], "call_ms", time_ms)
        src = tr if name == "sgd_mom_sweep" else other[name]
        rec["launches"] = src["calls"][name]
        rec["launches_per_forward"] = rec["launches"] / src["steps"]
    print("kernels checked: K1a, K1b, K4 bitwise equal at buckets %s and n "
          "1, 3, 4097, aligned and misaligned, clip on and off"
          % tr["buckets"], flush=True)
    k2["launches_training"] = tr["calls"]["softmax_lastaxis"]

    # 9. the transformer kernels against their plain versions
    k6a, k6a_jobs = check_k6a(ck, dev, bw, flops)
    k7a, k7a_jobs = check_k7a(ck, dev, bw, flops, bf16)
    k7a["hmma_bf16_dp64"] = hmma["K7a"]["count"]
    k5a, k5a_jobs = check_k5a(ck, dev, bw, flops)
    for rec, jobs in ((k6a, k6a_jobs), (k7a, k7a_jobs), (k5a, k5a_jobs)):
        time_jobs(rec, jobs, "call_ms", time_ms)
    print("kernels checked: K6a within 1e-5 (fp32) and one bf16 rounding at "
          "C 768, 37, 1000; K7a within 1e-5 at (96, 1024, 64) causal and "
          "full, T 8/64/1024 x D 32/64/128, T 1/127/129/1000 x D 64/128 and "
          "D 8-512 (72, 200, 320 and 512 among them) at T 200, bf16 (p "
          "rounded before p v) within one rounding of o plus one of its "
          "largest term at T 64 and of the sum of its terms at T 1024; "
          "K5a within 1e-6 (fp32) and one bf16 rounding at (96, 1020, 1020), "
          "causal bias and none, and at C %s at (2, 3, C), (3, 343, C) and "
          "(5, 205, C) (row 1 masked entirely), C 100/256/512/1020 one "
          "element off their alignment" % (SOFTMAX_EDGE_C,), flush=True)

    # 10. the transformer path: GPT-2-small widths, both attention routes
    lm = transformer_lm(mx, mx.gpu(0))
    n_layers, vocab = GPT2_SMALL["num_layers"], GPT2_SMALL["vocab_size"]
    lm_res = {}
    for t, attn in ((LM_T[0], "flash_attention_fwd"),
                    (LM_T[1], "bias_softmax")):
        tokens = lm_tokens(mx, mx.gpu(0), vocab, LM_BATCH, t)
        logits, r = lm_forward(ck, lm, tokens)
        want = dict.fromkeys(r["calls"], 0)
        want.update({"layernorm_fwd": 2 * n_layers + 1, attn: n_layers})
        if r["calls"] != want:
            raise AssertionError("transformer at T=%d: launches %s; expected "
                                 "%s" % (t, r["calls"], want))
        if r["shape"] != (LM_BATCH, t, vocab) or not r["finite"]:
            raise AssertionError("transformer at T=%d: logits %s, finite: %s"
                                 % (t, r["shape"], r["finite"]))
        r["dev"], r["mag"] = logits_deviation(ck, lm, tokens, logits)
        r["dev_tf32"], _ = logits_deviation(ck, lm, tokens, logits,
                                            tf32=True)
        del logits
        if not r["dev"] <= LOGIT_TOL < r["dev_tf32"]:
            raise AssertionError(
                "transformer at T=%d: logits vs the plain fp32 forward %.3g "
                "of the largest (limit %g); the TF32 plain forward %.3g, "
                "which the limit must reject" % (t, r["dev"], LOGIT_TOL,
                                                 r["dev_tf32"]))
        r["tokens"] = tokens
        lm_res[t] = r
        print("transformer on %s: TransformerLM %s fp32, hybridized, batch "
              "%d, T=%d (%s route): forward %.2f ms, %.0f tokens/s (CUDA "
              "events, median of 3); launches %s; logits vs the plain fp32 "
              "forward: max |d| %.3g of the largest |logit| %.3f (limit "
              "%g); the same plain forward with TF32 matmuls: %.3g"
              % (smi, json.dumps(GPT2_SMALL), LM_BATCH, t,
                 "flash" if attn == "flash_attention_fwd" else "einsum + K5a",
                 r["fwd_ms"], r["tokens_per_s"], r["calls"], r["dev"],
                 r["mag"], LOGIT_TOL, r["dev_tf32"]), flush=True)
    k6a["launches"] = sum(r["calls"]["layernorm_fwd"] for r in lm_res.values())
    k6a["launches_per_forward"] = k6a["launches"] / len(lm_res)
    for rec, t, name in ((k7a, LM_T[0], "flash_attention_fwd"),
                         (k5a, LM_T[1], "bias_softmax")):
        rec["launches"] = rec["launches_per_forward"] = \
            lm_res[t]["calls"][name]

    # 11. the backward kernels against their plain versions
    k6b, k6b_jobs = check_k6b(ck, dev, bw, flops, bf16)
    (k7b, k7c), (k7b_jobs, k7c_jobs) = check_k7bc(ck, dev, bw, flops, tf32)
    k7b["hmma_bf16_dp64"] = hmma["K7b"]["count"]
    k7c["hmma_bf16_dp64"] = hmma["K7c"]["count"]
    k5b, k5b_jobs = check_k5b(ck, dev, bw, flops)
    bwd_recs = ((k6b, k6b_jobs), (k7b, k7b_jobs), (k7c, k7c_jobs),
                (k5b, k5b_jobs))
    for rec, jobs in bwd_recs:
        time_jobs(rec, jobs, "call_ms", time_ms)
    print("kernels checked: K6b within 1e-5 of the largest |dx| (fp32) and "
          "one bf16 rounding at (8192, 768) and %d edge cases (K6B_EDGE: "
          "the vector layout's instances and one chunk past each, C 37, "
          "1020, 1025, 9000, operands off their alignment, 8191, 1031 and "
          "3 rows); K7b and K7c within "
          "1e-5 of the largest at (96, 1024, 64) causal and full, T "
          "1/7/15/17/63/65/1020, Tq != Tk and D 8-512 (every instance, 320 "
          "and 512 chunked), bf16 within one rounding; K5b within "
          "1e-5 of the largest at (96, 1020, 1020), causal and unmasked, "
          "and at K5a's edge cases, bf16 within one rounding, masked "
          "columns exactly 0" % len(K6B_EDGE), flush=True)

    # 12. the transformer training path: GPT-2-small widths, both routes
    attn_fwd = {LM_T[0]: ("flash_attention_fwd", "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv"),
                LM_T[1]: ("bias_softmax", "softmax_bwd")}
    train_res = {}
    for t in LM_T:
        base = torch.cuda.memory_allocated(dev)
        tlm = transformer_lm(mx, mx.gpu(0))
        x, y = lm_batch(mx, mx.gpu(0), vocab, LM_BATCH, t)
        trainer, loss_fn, r = lm_train(mx, ck, tlm, x, y)
        want = dict.fromkeys(r["calls"], 0)
        want.update({"layernorm_fwd": 2 * n_layers + 1,
                     "layernorm_bwd": 2 * n_layers + 1})
        want.update(dict.fromkeys(attn_fwd[t], n_layers))
        if r["calls"] != want:
            raise AssertionError("training at T=%d: launches %s in one step; "
                                 "expected %s" % (t, r["calls"], want))
        if r["zero_grads"] or not r["grad_dev"] <= GRAD_TOL:
            raise AssertionError(
                "training at T=%d: gradients vs the plain torch step with "
                "the same ReLU decisions %.3g of each parameter's largest "
                "(limit %g); zero gradients: %s"
                % (t, r["grad_dev"], GRAD_TOL, r["zero_grads"]))
        if not r["losses"][-1] < r["losses"][0]:
            raise AssertionError("training at T=%d: the loss on the batch "
                                 "went %s" % (t, r["losses"]))
        r["mem_gb"] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        train_res[t] = r
        print("transformer training on %s: TransformerLM GPT-2 small widths "
              "fp32, hybridized, batch %d, T=%d, Adam lr %g: %d warmup + %d "
              "timed steps: %.2f ms/step, %.0f tokens/s (CUDA events); "
              "launches in one step %s; %d parameters, all with nonzero "
              "gradients, within %.3g of each one's largest of the plain "
              "torch step with the same ReLU decisions (limit %g); %d of %d "
              "ReLU inputs take the other side in the plain forward, and "
              "with its own decisions the plain step is %.3g away; against "
              "float64 plain torch: kernel path %.3g, plain fp32 path %.3g; "
              "loss %s; peak memory of the training steps %.2f GB"
              % (smi, LM_BATCH, t, LM_ADAM["learning_rate"], LM_TRAIN_WARMUP,
                 LM_TRAIN_STEPS, r["step_ms"], r["tokens_per_s"], r["calls"],
                 r["n_params"], r["grad_dev"], GRAD_TOL, r["relu_flips"],
                 r["relu_inputs"], r["grad_dev_own_relu"],
                 r["kernel_vs_f64"], r["plain_vs_f64"],
                 ["%.4f" % v for v in r["losses"]], r["mem_gb"]), flush=True)
        r["run"] = (tlm, trainer, loss_fn, x, y)    # profiled at the end
    k6b["launches"] = sum(r["calls"]["layernorm_bwd"]
                          for r in train_res.values())
    k6b["launches_per_forward"] = k6b["launches"] / len(train_res)
    for rec, t, name in ((k7b, LM_T[0], "flash_attention_bwd_dq"),
                         (k7c, LM_T[0], "flash_attention_bwd_dkv"),
                         (k5b, LM_T[1], "softmax_bwd")):
        rec["launches"] = rec["launches_per_forward"] = \
            train_res[t]["calls"][name]

    # 13. checkpoints: ResNet-50 through Module.fit's checkpoint files,
    # served from them and resumed from them; the transformer through
    # gluon's parameter and trainer-state files.  cuDNN deterministic for
    # this phase only, so a resumed run can equal the uninterrupted one.
    import tempfile
    t13 = time.perf_counter()
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(
                prefix=".chip_smoke_ckpt_",
                dir=os.path.dirname(os.path.abspath(__file__))) as workdir:
            prefix = os.path.join(workdir, "r50")
            ck_mod, ck_ref, ck_a = ckpt_fit(mx, mx.gpu(0), sym, IMAGE, BATCH,
                                            CKPT_STEPS, prefix)
            ck_b = ckpt_serve(mx, ck, mx.gpu(0), ck_mod, prefix, 2, IMAGE,
                              BATCH)
            want = dict.fromkeys(ck_b["calls"], 0)
            want.update(scale_bias_relu=len(sites), softmax_lastaxis=1)
            if ck_b["calls"] != want or not (
                    ck_b["bitwise"] or ck_b["max_rel"] <= CKPT_TOL):
                raise AssertionError(
                    "checkpoint served: launches %s (expected %s), %g of "
                    "the largest from the module's forward (limit %g)"
                    % (ck_b["calls"], want, ck_b["max_rel"], CKPT_TOL))
            del ck_mod
            resumed, ck_calls = ckpt_resume(mx, ck, mx.gpu(0), prefix, IMAGE,
                                            BATCH, CKPT_STEPS)
            ck_c = compare_states(resumed, ck_ref)
            cold, _ = ckpt_resume(mx, ck, mx.gpu(0), prefix, IMAGE, BATCH,
                                  CKPT_STEPS, states=False)
            ck_c["cold_max_rel"] = compare_states(cold, ck_ref)["max_rel"]
            del resumed, cold, ck_ref
            want = dict.fromkeys(ck_calls, 0)
            want.update(sgd_mom_sweep=len(tr["buckets"]) * CKPT_STEPS,
                        softmax_lastaxis=CKPT_STEPS)
            ck_c["calls"] = ck_calls
            if ck_calls != want or not (
                    ck_c["bitwise"] or ck_c["max_rel"] <= CKPT_TOL) \
                    or not ck_c["cold_max_rel"] > CKPT_TOL:
                raise AssertionError(
                    "checkpoint resume: launches %s (expected %s), %g of "
                    "the largest from the uninterrupted run (limit %g), "
                    "%g without the momentum (must exceed it)"
                    % (ck_calls, want, ck_c["max_rel"], CKPT_TOL,
                       ck_c["cold_max_rel"]))
            print("checkpoints on %s: ResNet-50 Module.fit 2 epochs of %d "
                  "steps, module_checkpoint(save_optimizer_states=True): "
                  ".params %.1f MB, .states %.1f MB, saves %s ms (%.0f "
                  "MB/s); nd.load of the .params onto the card %.1f ms "
                  "(%.0f MB/s), load_optimizer_states %.1f ms (%.0f MB/s); "
                  "ModelServer.load_model %.1f ms, a bucket-%d batch vs the "
                  "module's forward: bitwise %s, max rel %.3g, launches %s; "
                  "Module.load + fit(begin_epoch=1) vs the uninterrupted "
                  "run: %d tensors bitwise %s, max rel %.3g, launches %s; "
                  "without the momentum: max rel %.3g"
                  % (smi, CKPT_STEPS, ck_a["params_mb"], ck_a["states_mb"],
                     ["%.1f" % t for t in ck_a["save_ms"]],
                     ck_a["save_mb_per_s"], ck_a["load_params_ms"],
                     ck_a["load_params_mb_per_s"], ck_a["load_states_ms"],
                     ck_a["load_states_mb_per_s"], ck_b["load_ms"], BATCH,
                     ck_b["bitwise"], ck_b["max_rel"], ck_b["calls"],
                     ck_c["tensors"], ck_c["bitwise"], ck_c["max_rel"],
                     ck_calls, ck_c["cold_max_rel"]), flush=True)
            tlm, trainer, _, x, y = train_res[LM_T[0]]["run"]
            ck_d = ckpt_lm(mx, ck, tlm, trainer, x, y, GPT2_SMALL, workdir)
    finally:
        torch.backends.cudnn.deterministic = saved_det
    ck_seconds = time.perf_counter() - t13
    want = dict.fromkeys(ck_d["calls"], 0)
    want.update({"layernorm_fwd": 2 * n_layers + 1,
                 "layernorm_bwd": 2 * n_layers + 1})
    want.update(dict.fromkeys(attn_fwd[LM_T[0]], n_layers))
    if ck_d["calls"] != want or not ck_d["logits_bitwise"] \
            or not ck_d["adam_loaded_bitwise"] or not (
                ck_d["sgd_step_bitwise"]
                or ck_d["sgd_step_max_rel"] <= CKPT_TOL) or not (
                ck_d["adam_mv_bitwise"]
                or ck_d["adam_mv_max_rel"] <= CKPT_TOL):
        raise AssertionError("transformer checkpoint: %s" % ck_d)
    print("checkpoints on %s: TransformerLM GPT-2 small widths after phase "
          "12 at T=%d: save_parameters %.1f MB in %.1f ms (%.0f MB/s), "
          "save_states SGD %.1f MB + Adam %.1f MB in %.1f ms; fresh model "
          "load_parameters %.1f ms (%.0f MB/s), load_states %.1f ms; logits "
          "bitwise %s; Adam m, v as loaded bitwise %s; one SGD-momentum "
          "step each: losses %s, weights bitwise %s (max rel %.3g), "
          "launches %s; one Adam step each: m, v bitwise %s (max rel %.3g); "
          "phase 13 took %.1f s"
          % (smi, LM_T[0], ck_d["params_mb"], ck_d["save_params_ms"],
             ck_d["save_params_mb_per_s"], ck_d["sgd_states_mb"],
             ck_d["adam_states_mb"], ck_d["save_states_ms"],
             ck_d["load_params_ms"], ck_d["load_params_mb_per_s"],
             ck_d["load_states_ms"], ck_d["logits_bitwise"],
             ck_d["adam_loaded_bitwise"], ck_d["losses"],
             ck_d["sgd_step_bitwise"], ck_d["sgd_step_max_rel"],
             ck_d["calls"], ck_d["adam_mv_bitwise"],
             ck_d["adam_mv_max_rel"], ck_seconds), flush=True)
    for rec, launches in (
            (k3, ck_b["calls"]["scale_bias_relu"]),
            (k2, ck_b["calls"]["softmax_lastaxis"] + ck_calls[
                "softmax_lastaxis"]),
            (sweeps["sgd_mom_sweep"], ck_calls["sgd_mom_sweep"])) + tuple(
            (r, ck_d["calls"][n]) for r, n in (
                (k6a, "layernorm_fwd"), (k6b, "layernorm_bwd"),
                (k7a, "flash_attention_fwd"), (k7b, "flash_attention_bwd_dq"),
                (k7c, "flash_attention_bwd_dkv"))):
        rec["launches_checkpoints"] = launches

    # 14. the operator library on the card against the CPU, and
    # Inception-BN trained and served at full width
    t14 = time.perf_counter()
    sweep = op_sweep(mx, mx.gpu(0), mx.cpu())
    if sweep["failed"]:
        raise AssertionError("op sweep: %d of %d checks outside their band: "
                             "%s" % (len(sweep["failed"]), sweep["checks"],
                                     sweep["failed"][:10]))
    rnd = random_sweep(mx, mx.gpu(0))
    if rnd["failed"]:
        raise AssertionError("samplers on the card: %s" % rnd["failed"])
    fbr = fused_bn_relu_once(mx, ck, mx.gpu(0))
    if fbr["launches"] != 1 or not fbr["bitwise"]:
        raise AssertionError("nd.contrib.fused_bn_relu: %s" % fbr)
    ops_line = {"ops": {
        "card": smi, "cases": sweep["cases"], "checks": sweep["checks"],
        "bitwise": sweep["bitwise"], "within_band": sweep["within"],
        "worst": sweep["worst"], "worst_by_limit": sweep["worst_by_limit"],
        "sweep_seconds": sweep["seconds"],
        "random_checks": rnd["checks"], "random_draws": RANDOM_DRAWS,
        "random_seconds": rnd["seconds"], "fused_bn_relu": fbr,
        "seconds": time.perf_counter() - t14}}
    print("operator library on %s: %d cases, %d checks (forward, inputs "
          "after, backward) against the CPU: %d bitwise, %d within their "
          "band; %d sampler checks over %d draws; fused_bn_relu %s; %.1f s"
          % (smi, sweep["cases"], sweep["checks"], sweep["bitwise"],
             sweep["within"], rnd["checks"], RANDOM_DRAWS, fbr,
             ops_line["ops"]["seconds"]), flush=True)
    t14b = time.perf_counter()
    inc_mod, inc = inception_phase(mx, ck, mx.gpu(0))
    inc_batch = synthetic_iter(mx, mx.gpu(0), BATCH, IMAGE, 1).next()
    print("inception-bn on %s: %d parameters, %d BatchNorm->ReLU sites; "
          "Module.fit kvstore=tpu batch %d: %d warmup + %d timed steps: "
          "%.2f ms/step, %.1f images/s (CUDA events); launches a step %s; "
          "cross-entropy %.4f -> %.4f; peak memory %.2f GB; served %d "
          "answers over %d forwards, against a Predictor at their own "
          "bucket bitwise %s, max rel %.3g (against the module's %d-row "
          "forward: bitwise %s, max rel %.3g); a bucket-%d "
          "forward %.2f ms, launches %s"
          % (smi, inc["params"], inc["sites"], BATCH, inc["warmup"],
             inc["steps"], inc["step_ms"], inc["images_per_s"],
             inc["launches_step"], inc["ce_first"], inc["ce_last"],
             inc["peak_mem_gb"], inc["serve"]["answers"],
             inc["serve"]["forwards"], inc["serve"]["bitwise"],
             inc["serve"]["max_rel"], BATCH,
             inc["serve"]["cross_shape_bitwise"],
             inc["serve"]["cross_shape_max_rel"], BATCH,
             inc["serve"]["fwd_ms"],
             inc["launches_forward"]), flush=True)
    inc["seconds_fit_and_serve"] = time.perf_counter() - t14b
    # this path's kernels against their plain versions at its own shapes
    # (K2 runs here at (BATCH, 1000) rows, as phase 3 checked it)
    inc_sites = inc.pop("site_shapes")
    check_k3(ck, inc_sites, dev, bw, flops)
    check_sweeps(ck, dev, bw, flops, inc["bucket_sizes"])
    print("kernels checked at Inception-BN's shapes: K3 bitwise equal at "
          "its %d sites (%d shapes) x fp32/bf16 x relu on/off; K1a, K1b, "
          "K4 bitwise equal at its buckets %s and n 1, 3, 4097, aligned "
          "and misaligned, clip on and off" % (
              len(inc_sites), len({shp for _, shp in inc_sites}),
              inc["bucket_sizes"]), flush=True)
    k3["launches_inception"] = {
        "per_forward": inc["launches_forward"]["scale_bias_relu"],
        "served": inc["serve"]["calls"]["scale_bias_relu"],
        "fused_bn_relu_op": fbr["launches"]}
    k2["launches_inception"] = {
        "per_step": inc["launches_step"]["softmax_lastaxis"],
        "per_forward": inc["launches_forward"]["softmax_lastaxis"]}
    sweeps["sgd_mom_sweep"]["launches_inception"] = {
        "per_step": inc["launches_step"]["sgd_mom_sweep"],
        "buckets": inc["buckets"]}

    # 15. bf16 mixed precision: ResNet-50 through Module(compute_dtype)
    # and the fused step, its bf16 eval forward, the bf16-cast transformer
    # forward and step, and fp16 multi-precision SGD
    t15 = time.perf_counter()
    fit15 = mixed_fit(mx, ck, mx.gpu(0), sym, IMAGE)
    total15 = TRAIN_WARMUP + TRAIN_STEPS
    want = dict.fromkeys(fit15["calls"], 0)
    want.update(sgd_mom_sweep=len(fit15["buckets"]) * total15,
                softmax_lastaxis=total15)
    want_dt = {"sgd_mom_sweep": {"float32": want["sgd_mom_sweep"]},
               "softmax_lastaxis": {"float32": total15}}
    first = fit15["first_step"]
    bf16_ops = {k: set(v) for k, v in fit15["compute_dtypes"].items()} == {
        "conv2d": {"bfloat16/bfloat16"}, "linear": {"bfloat16/bfloat16"}}
    if not fit15["fused"] or fit15["kernel"] != "sgd_mom_sweep" \
            or fit15["calls"] != want or fit15["dtypes"] != want_dt \
            or not bf16_ops or not fit15["masters_fp32"] \
            or not fit15["ce_last"] < fit15["ce_first"] \
            or not first["max_by_largest_update"] <= MIXED_STEP_TOL \
            or not first["aux"] <= 1e-6:
        raise AssertionError(
            "mixed precision fit: fused %s (%s), launches %s (expected "
            "%s), dtypes %s (expected %s), convolution and FC operands %s "
            "(expected bf16), fp32 masters %s, cross-entropy %.4f -> "
            "%.4f, first step vs knobs 0 %s (limit %g)"
            % (fit15["fused"], fit15["kernel"], fit15["calls"], want,
               fit15["dtypes"], want_dt, fit15["compute_dtypes"],
               fit15["masters_fp32"],
               fit15["ce_first"], fit15["ce_last"], first, MIXED_STEP_TOL))
    ev15 = mixed_eval(mx, ck, mx.gpu(0), fit15["module"], IMAGE)
    want = dict.fromkeys(ev15["calls"], 0)
    want.update(scale_bias_relu=len(sites), softmax_lastaxis=1)
    want_dt = {"scale_bias_relu": {"bfloat16": len(sites)},
               "softmax_lastaxis": {"float32": 1}}
    if ev15["calls"] != want or ev15["dtypes"] != want_dt \
            or not ev15["finite"] \
            or not ev15["max_by_largest"] <= BF16_EVAL_TOL \
            or not ev15["kernel_vs_fp32"] <= 2 * ev15["plain_vs_fp32"]:
        raise AssertionError(
            "mixed precision eval forward: launches %s (expected %s), "
            "dtypes %s (expected %s), logits vs knobs 0 %.3g of the "
            "largest (limit %g), vs fp32 %.3g (limit twice knobs 0 vs fp32, "
            "%.3g), finite %s" % (ev15["calls"], want, ev15["dtypes"],
                                  want_dt,
                    ev15["max_by_largest"], BF16_EVAL_TOL,
                    ev15["kernel_vs_fp32"], ev15["plain_vs_fp32"],
                    ev15["finite"]))
    print("mixed precision on %s: ResNet-50 v1 Module(compute_dtype="
          "\"bfloat16\").fit kvstore=tpu batch %d, SGD lr %g momentum %g "
          "wd %g; %d warmup + %d timed steps: %.2f ms/step, %.1f images/s "
          "(CUDA events; fp32 phase 5: %.2f ms, %.1f images/s); launches "
          "%s, operand dtypes %s; the first step's convolution and FC "
          "operands (data/weight) %s; masters, moving stats, momentum and "
          "buckets fp32: %s; cross-entropy %.4f -> %.4f; peak memory the "
          "fit adds %.2f GB; the first step vs every knob 0 (cuDNN "
          "deterministic): weights %.3g, momentum %.3g of each tensor's "
          "largest update, moving stats %.3g (limit %g); bucket-%d bf16 "
          "eval forward %.2f ms, launches %s, dtypes %s, probabilities %s, "
          "logits %s, vs knobs 0 %.3g of the largest logit %.3f (limit "
          "%g); vs the fp32 forward %.3g, knobs 0 vs the fp32 forward %.3g "
          "(limit twice that)"
          % (smi, BATCH, SGD_PARAMS["learning_rate"],
             SGD_PARAMS["momentum"], SGD_PARAMS["wd"], TRAIN_WARMUP,
             TRAIN_STEPS, fit15["step_ms"], fit15["images_per_s"],
             tr["step_ms"], tr["images_per_s"], fit15["calls"],
             fit15["dtypes"], fit15["compute_dtypes"],
             fit15["masters_fp32"], fit15["ce_first"],
             fit15["ce_last"], fit15["peak_mem_gb"], first["weights"],
             first["momentum"], first["aux"], MIXED_STEP_TOL, BATCH,
             ev15["fwd_ms"], ev15["calls"], ev15["dtypes"], ev15["dtype"],
             ev15["logits_dtype"], ev15["max_by_largest"],
             ev15["largest_logit"], BF16_EVAL_TOL, ev15["kernel_vs_fp32"],
             ev15["plain_vs_fp32"]), flush=True)
    lmf, lmt, lm15 = lm_mixed(mx, ck, mx.gpu(0))
    want = dict.fromkeys(lmf["calls"], 0)
    want.update(layernorm_fwd=2 * n_layers + 1,
                flash_attention_fwd=n_layers)
    want_dt = {"layernorm_fwd": {"bfloat16": 2 * n_layers + 1},
               "flash_attention_fwd": {"bfloat16": n_layers}}
    lmf["limit"] = max(LM_BF16_LOGIT_TOL, 2 * lmf["dev_plain_fp32"])
    if lmf["calls"] != want or lmf["dtypes"] != want_dt \
            or not lmf["finite"] or lmf["logits_dtype"] != "bfloat16" \
            or not lmf["dev"] <= lmf["limit"]:
        raise AssertionError(
            "bf16 transformer forward: launches %s (expected %s), dtypes %s "
            "(expected %s), logits %s finite %s, vs the knobs-0 bf16 "
            "forward %.3g of the largest (limit %g)"
            % (lmf["calls"], want, lmf["dtypes"], want_dt,
               lmf["logits_dtype"], lmf["finite"], lmf["dev"],
               lmf["limit"]))
    want = dict.fromkeys(lmt["calls"], 0)
    want.update({"layernorm_fwd": 2 * n_layers + 1,
                 "layernorm_bwd": 2 * n_layers + 1})
    want.update(dict.fromkeys(attn_fwd[LM_T[0]], n_layers))
    want_dt = {k: {"bfloat16": v} for k, v in want.items() if v}
    if lmt["calls"] != want or lmt["dtypes"] != want_dt \
            or lmt["zero_grads"] or lmt["grad_dtypes"] != ["bfloat16"] \
            or lmt["param_dtypes"] != ["bfloat16"] \
            or not lmt["grad_dev_by_band"] <= 1.0 \
            or not lmt["losses"][-1] < lmt["losses"][0]:
        raise AssertionError(
            "bf16 transformer step: launches %s (expected %s), dtypes %s "
            "(expected %s), zero gradients %s, gradient and parameter "
            "dtypes %s %s, gradients vs the knobs-0 step %.3g of their "
            "bands, losses %s" % (
                lmt["calls"], want, lmt["dtypes"], want_dt,
                lmt["zero_grads"], lmt["grad_dtypes"], lmt["param_dtypes"],
                lmt["grad_dev_by_band"], lmt["losses"]))
    print("mixed precision on %s: TransformerLM GPT-2 small widths "
          "cast(\"bfloat16\"), hybridized, batch %d, T=%d: forward %.2f "
          "ms, %.0f tokens/s (fp32 phase 10: %.2f ms), launches %s, dtypes "
          "%s; logits vs the knobs-0 bf16 forward %.3g of the largest "
          "(limit %g), vs the fp32 plain forward of the same parameters: "
          "kernel path %.3g, knobs-0 path %.3g; Adam lr %g step: launches "
          "%s, dtypes %s; gradients %s, all nonzero, vs the knobs-0 step "
          "with the same ReLU decisions (%d of %d inputs flip) %.3g of "
          "their bands (widest %.3g); against float64 plain torch: kernel "
          "path %.3g, knobs-0 path %.3g; %d warmup + %d timed steps: %.2f "
          "ms/step, %.0f tokens/s (fp32 phase 12: %.2f ms); loss %s"
          % (smi, LM_BATCH, LM_T[0], lmf["fwd_ms"], lmf["tokens_per_s"],
             lm_res[LM_T[0]]["fwd_ms"], lmf["calls"], lmf["dtypes"],
             lmf["dev"], lmf["limit"], lmf["dev_kernel_fp32"],
             lmf["dev_plain_fp32"], LM_ADAM["learning_rate"], lmt["calls"],
             lmt["dtypes"], lmt["grad_dtypes"], lmt["relu_flips"],
             lmt["relu_inputs"], lmt["grad_dev_by_band"],
             lmt["widest_band"], lmt["kernel_vs_f64"], lmt["plain_vs_f64"],
             1, LM_TRAIN_STEPS, lmt["step_ms"], lmt["tokens_per_s"],
             train_res[LM_T[0]]["step_ms"],
             ["%.4f" % v for v in lmt["losses"]]), flush=True)
    mp_card = fp16_multi_precision(mx, mx.gpu(0))
    mp_cpu = fp16_multi_precision(mx, mx.cpu())
    moved = {k: max(np.abs(mp_cpu["master"][k] - mp_cpu["start"][k]).max(),
                    1e-30) for k in mp_cpu["master"]}
    mp_dev = max(float(np.abs(mp_card["master"][k] - mp_cpu["master"][k])
                       .max() / moved[k]) for k in moved)
    # a weight may also take the other side of one fp16 rounding (2^-10
    # of its magnitude) where its masters straddle a rounding boundary
    mp_weights_ok = all(bool((
        np.abs(mp_card["weight"][k] - mp_cpu["weight"][k])
        <= FP16_TOL * moved[k] + np.abs(mp_cpu["weight"][k]) * 2.0 ** -10)
        .all()) for k in moved)
    if mp_card["weights"] != {"float16"} or mp_card["masters"] \
            != {"float32"} or not mp_card["losses"][-1] < \
            mp_card["losses"][0] or not mp_dev <= FP16_TOL \
            or not mp_weights_ok:
        raise AssertionError(
            "fp16 multi-precision: weights %s, masters %s, losses %s, "
            "masters vs the CPU run %.3g of the largest movement (limit "
            "%g), weights within it and one fp16 rounding: %s"
            % (mp_card["weights"], mp_card["masters"], mp_card["losses"],
               mp_dev, FP16_TOL, mp_weights_ok))
    print("mixed precision on %s: gluon MLP cast(\"float16\"), Trainer sgd "
          "multi_precision momentum 0.9, %d steps: weights %s, masters %s, "
          "loss %s (CPU %s); masters vs the CPU run %.3g of each one's "
          "largest movement (limit %g), fp16 weights within it and one "
          "fp16 rounding"
          % (smi, FP16_STEPS, sorted(mp_card["weights"]),
             sorted(mp_card["masters"]),
             ["%.4f" % v for v in mp_card["losses"]],
             ["%.4f" % v for v in mp_cpu["losses"]], mp_dev, FP16_TOL),
          flush=True)
    mixed_line = {"card": smi, "resnet50": {
        k: fit15[k] for k in ("step_ms", "images_per_s", "calls", "dtypes",
                              "compute_dtypes", "masters_fp32", "ce_first",
                              "ce_last",
                              "peak_mem_gb", "first_step", "buckets")},
        "resnet50_fp32_phase5": {"step_ms": tr["step_ms"],
                                 "images_per_s": tr["images_per_s"]},
        "resnet50_eval": {k: v for k, v in ev15.items()},
        "transformer_forward": {k: lmf[k] for k in (
            "fwd_ms", "tokens_per_s", "calls", "dtypes", "dev", "limit",
            "dev_kernel_fp32", "dev_plain_fp32")},
        "transformer_step": {k: lmt[k] for k in (
            "step_ms", "tokens_per_s", "calls", "dtypes", "losses",
            "grad_dev_by_band", "widest_band", "relu_flips", "relu_inputs",
            "kernel_vs_f64", "plain_vs_f64")},
        "fp16_multi_precision": {"losses": mp_card["losses"],
                                 "cpu_losses": mp_cpu["losses"],
                                 "masters_vs_cpu": mp_dev},
        "bands": {"first_step": MIXED_STEP_TOL, "eval_logits": BF16_EVAL_TOL,
                  "lm_logits": LM_BF16_LOGIT_TOL,
                  "lm_grads": LM_BF16_GRAD_TOL, "fp16": FP16_TOL}}
    for rec, launches in (
            (sweeps["sgd_mom_sweep"], {"per_step": fit15["calls"][
                "sgd_mom_sweep"] / total15, "dtype": "float32 masters"}),
            (k2, {"per_step": fit15["calls"]["softmax_lastaxis"] / total15,
                  "per_eval_forward": ev15["calls"]["softmax_lastaxis"],
                  "dtype": "float32 (SoftmaxOutput upcasts bf16 logits, as "
                           "the JAX op does)"}),
            (k3, {"per_eval_forward": ev15["calls"]["scale_bias_relu"],
                  "dtype": "bfloat16"}),
            (k6a, {"per_forward": lmf["calls"]["layernorm_fwd"],
                   "per_step": lmt["calls"]["layernorm_fwd"],
                   "dtype": "bfloat16"}),
            (k6b, {"per_step": lmt["calls"]["layernorm_bwd"],
                   "dtype": "bfloat16"}),
            (k7a, {"per_forward": lmf["calls"]["flash_attention_fwd"],
                   "per_step": lmt["calls"]["flash_attention_fwd"],
                   "dtype": "bfloat16"}),
            (k7b, {"per_step": lmt["calls"]["flash_attention_bwd_dq"],
                   "dtype": "bfloat16"}),
            (k7c, {"per_step": lmt["calls"]["flash_attention_bwd_dkv"],
                   "dtype": "bfloat16"})):
        rec["launches_mixed"] = launches
    bf16_jobs = bf16_instances(ck, dev, bw, bf16, sites)
    fit15_mod = fit15.pop("module")
    mixed_line["seconds"] = time.perf_counter() - t15

    # 16. the training-loop API: the fourteen per-array optimizers against
    # the CPU, one Module.fit through the new metrics, monitor and
    # callbacks, the monitor's taps bitwise, and the engine
    t16 = time.perf_counter()
    loop_opt = loop_optimizers(mx, ck, mx.gpu(0), sym, IMAGE)
    bad = loop_failures(loop_opt)
    if bad:
        raise AssertionError("training-loop optimizers: " + "; ".join(bad))
    t16b = time.perf_counter()
    loop_mod, loop = loop_fit(mx, ck, mx.gpu(0), sym, IMAGE)
    n16 = LOOP_FIT_EPOCHS * LOOP_FIT_BATCHES
    want = dict.fromkeys(loop["calls"], 0)
    want.update(softmax_lastaxis=n16 + LOOP_FIT_EPOCHS,
                scale_bias_relu=len(sites) * LOOP_FIT_EPOCHS)
    n_metrics = len(loop["metric_names"])
    logs = (loop["log_speed"], loop["log_train"], loop["log_progress"],
            loop["log_validation"])
    want_logs = (LOOP_FIT_EPOCHS, n16 * n_metrics, n16,
                 2 * LOOP_FIT_EPOCHS * n_metrics)
    watched = ["conv0_weight", "fc1_bias", "fc1_weight"]
    if loop["calls"] != want or loop["fused"] \
            or not loop["metric_max_rel"] <= LOOP_METRIC_TOL \
            or loop["monitor_windows"] != n16 \
            or any(n != watched for n in loop["monitor_names"]) \
            or not loop["monitor_finite"] or logs != want_logs:
        raise AssertionError(
            "training-loop fit: launches %s (expected %s), fused %s, "
            "metrics %.3g from numpy's (limit %g), monitor windows %d "
            "(expected %d) of %s (expected %s each), finite %s, log lines "
            "(speed, train, progress, validation) %s (expected %s)"
            % (loop["calls"], want, loop["fused"], loop["metric_max_rel"],
               LOOP_METRIC_TOL, loop["monitor_windows"], n16,
               loop["monitor_names"], watched, loop["monitor_finite"], logs,
               want_logs))
    loop["seconds_fit_and_check"] = time.perf_counter() - t16b
    mon16 = loop_monitor_bitwise(mx, loop_mod, mx.gpu(0), IMAGE)
    del loop_mod
    if not (mon16["bitwise_on_vs_off"] and mon16["bitwise_off_vs_off"]):
        raise AssertionError("training-loop monitor: %s steps with every "
                             "node tapped against none, not bitwise: %s"
                             % (mon16["steps"], mon16))
    eng16 = loop_engine(mx, mx.gpu(0))
    if not all(eng16["naive_idle"].values()) \
            or eng16["raised_at_waitall"] is not True \
            or eng16["raised_again"]:
        raise AssertionError("training-loop engine: %s" % eng16)
    loop_line = {"card": smi, "optimizers": loop_opt, "fit": loop,
                 "monitor": mon16, "engine": eng16,
                 "seconds": time.perf_counter() - t16}
    # K2 a step: the set of the per-array steps' counts ({1} when each
    # launched it once); a fit's eval forwards: what the fit launched
    # past its training steps, per epoch's eval batch
    per_step = sorted({r["launches"].get("softmax_lastaxis", 0)
                       for r in loop_opt.values()})
    k2["launches_training_loop"] = {
        "per_step": per_step[0] if len(per_step) == 1 else per_step,
        "per_eval_forward": (loop["calls"]["softmax_lastaxis"] - n16)
        / LOOP_FIT_EPOCHS}
    k3["launches_training_loop"] = {
        "per_eval_forward": loop["calls"]["scale_bias_relu"]
        / LOOP_FIT_EPOCHS}
    print("training loop on %s: ResNet-50 v1 fp32 batch %d, kvstore=tpu, "
          "each of %d optimizers with a PolyScheduler against the CPU's "
          "replay of the same update: weights within %.3g, states within "
          "%.3g of the largest (limit %g), SGLD's noise mean %.2f standard "
          "errors, std %.4f of sqrt(lr); K2 once and no sweep a step; step "
          "ms (CUDA events) %s; Module.fit nag x %d epochs x %d batches: "
          "metrics within %.3g of numpy's, monitor %d windows of %s, all "
          "finite; every node tapped (%d records a step) vs none, %d steps "
          "from one state: bitwise %s (none vs none %s), step %.2f ms on "
          "vs %.2f off; naive(): stream idle after each op %s; a worker's "
          "orphaned exception raised at nd.waitall() %s, again %s; %.1f s"
          % (smi, BATCH, len(loop_opt),
             max(r["weights"] for r in loop_opt.values()),
             max(r["states_max_rel"] for r in loop_opt.values()), LOOP_TOL,
             loop_opt["sgld"]["sgld"]["mean_in_se"],
             loop_opt["sgld"]["sgld"]["std_by_sqrt_lr"],
             {k: round(r["step_ms"], 2) for k, r in loop_opt.items()},
             LOOP_FIT_EPOCHS, LOOP_FIT_BATCHES, loop["metric_max_rel"],
             loop["monitor_windows"], watched, mon16["records_a_step_on"],
             mon16["steps"], mon16["bitwise_on_vs_off"],
             mon16["bitwise_off_vs_off"], mon16["step_ms_on"],
             mon16["step_ms_off"], eng16["naive_idle"],
             eng16["raised_at_waitall"], eng16["raised_again"],
             loop_line["seconds"]), flush=True)

    # 17. the data pipeline and the module family: (a) ResNet-50 from a
    # .rec through ImageRecordIter into Module.fit; (b) the bucketed LSTM
    # LM through BucketingModule; (c) K2 at the LM's logits
    import tempfile
    t17 = time.perf_counter()
    # the records stay for phase 18, which removes them
    rec_dir = tempfile.TemporaryDirectory(
        prefix=".chip_smoke_rec_",
        dir=os.path.dirname(os.path.abspath(__file__)))
    rec_mod, rec_batch, rec17 = rec_pipeline(mx, ck, mx.gpu(0), sym,
                                           rec_dir.name)
    nb17 = len(rec17["buckets"])
    want = dict.fromkeys(rec17["calls"], 0)
    want.update(sgd_mom_sweep=nb17 * rec17["batches"],
                softmax_lastaxis=rec17["batches"] + REC_IMAGES
                // REC_EVAL_PARTS // BATCH,
                scale_bias_relu=len(sites) * (REC_IMAGES // REC_EVAL_PARTS
                                              // BATCH))
    if rec17["calls"] != want or not rec17["fused"] \
            or rec17["batches"] != REC_IMAGES // BATCH \
            or rec17["bitwise_batches"] != rec17["batches"] \
            or rec17["replay_batches"] != rec17["batches"] \
            or rec17["wrappers"]["bitwise"] != rec17["wrappers"]["batches"] \
            or rec17["wrappers"]["batches"] != 3 \
            or not rec17["ce_last"] < rec17["ce_first"] \
            or not rec17["data_on"].startswith("cuda"):
        raise AssertionError(
            "records: launches %s (expected %s), fused %s, %d batches, "
            "bitwise equal to the host replay %d of %d, wrappers %s, "
            "cross-entropy %.4f -> %.4f, batches on %s"
            % (rec17["calls"], want, rec17["fused"], rec17["batches"],
               rec17["bitwise_batches"], rec17["replay_batches"],
               rec17["wrappers"], rec17["ce_first"], rec17["ce_last"],
               rec17["data_on"]))
    rec17["seconds"] = time.perf_counter() - t17
    print("records on %s: %d JPEGs (%.1f MB, written in %.2f s); the reader "
          "alone %.1f images/s (%d threads, %d cores); ResNet-50 v1 fp32 "
          "Module.fit from the .rec, kvstore=tpu, %d batches: %.2f ms/step, "
          "%.1f images/s over the last %d (CUDA events; the fixed batch of "
          "phase 5: %.2f ms/step); launches %s; batches bitwise equal to the "
          "host replay: %d of %d; PrefetchingIter(ResizeIter) %s; "
          "cross-entropy %.4f -> %.4f; %.1f s"
          % (smi, rec17["records"], rec17["rec_mb"], rec17["write_s"],
             rec17["reader_images_per_s"], rec17["preprocess_threads"],
             rec17["cpu_count"], rec17["batches"], rec17["step_ms"],
             rec17["images_per_s"], rec17["timed_batches"], tr["step_ms"],
             rec17["calls"], rec17["bitwise_batches"], rec17["replay_batches"],
             rec17["wrappers"], rec17["ce_first"], rec17["ce_last"],
             rec17["seconds"]), flush=True)
    t17b = time.perf_counter()
    sym_gen = lm_sym_gen(mx)
    with mx.gpu(0):
        bucket_it = mx.rnn.BucketSentenceIter(
            lm_corpus(), BUCKET_BATCH, buckets=list(BUCKET_KEYS),
            invalid_label=0)
    grads17 = bucket_first_grads(
        mx, mx.gpu(0), sym_gen, bucket_it, BUCKET_KEYS, BUCKET_BATCH,
        lm_params(sym_gen, max(BUCKET_KEYS), BUCKET_BATCH))
    bucket_mod, lm17 = bucket_fit(mx, ck, mx.gpu(0), sym_gen, bucket_it)
    want = dict.fromkeys(lm17["calls"], 0)
    want.update(softmax_lastaxis=lm17["batches"])
    shared17 = bucket_shared(mx, mx.gpu(0), bucket_mod, bucket_it,
                             max(BUCKET_KEYS),
                             min(BUCKET_KEYS))
    fused17 = [fused_vs_unrolled(mx, mx.gpu(0), "lstm", False, BUCKET_LAYERS,
                                 BUCKET_HIDDEN, BUCKET_EMBED, BUCKET_BATCH,
                                 max(BUCKET_KEYS)),
               fused_vs_unrolled(mx, mx.gpu(0), "gru", False, BUCKET_LAYERS,
                                 BUCKET_HIDDEN, BUCKET_EMBED, BUCKET_BATCH,
                                 max(BUCKET_KEYS)),
               fused_vs_unrolled(mx, mx.gpu(0), "lstm", True, BUCKET_LAYERS,
                                 BUCKET_HIDDEN, BUCKET_EMBED, BUCKET_BATCH,
                                 max(BUCKET_KEYS))]
    fused_worst = max(max(f["output"], f["data_grad"], f["param_grad"])
                      for f in fused17)
    if lm17["calls"] != want or lm17["fused_exec"] \
            or lm17["batches"] != BUCKET_EPOCHS * BUCKET_BATCHES \
            * len(BUCKET_KEYS) \
            or lm17["buckets_bound"] != list(BUCKET_KEYS) \
            or not max(grads17.values()) <= BUCKET_GRAD_TOL \
            or not lm17["ce_last"] < lm17["ce_first"] \
            or not (shared17["same_arrays"] and shared17["bitwise"]
                    and shared17["moved"] == shared17["params"]) \
            or not fused_worst <= FUSED_TOL:
        raise AssertionError(
            "bucketed LM: launches %s (expected %s), executor fusion %s, "
            "%d batches, buckets %s, first-step gradients %s (limit %g), "
            "cross-entropy %.4f -> %.4f, shared weights %s, fused RNN vs "
            "unrolled %s (limit %g)"
            % (lm17["calls"], want, lm17["fused_exec"], lm17["batches"],
               lm17["buckets_bound"], grads17, BUCKET_GRAD_TOL,
               lm17["ce_first"], lm17["ce_last"], shared17, fused17,
               FUSED_TOL))
    lm17.update(first_step_grad_max_rel=grads17, shared=shared17,
                fused_vs_unrolled=fused17,
                seconds=time.perf_counter() - t17b)
    print("bucketed LSTM LM on %s: vocab %d, 2 x LSTM %d, embed %d, batch "
          "%d, buckets %s, Adam lr %g, kvstore=tpu, %d epochs of %d "
          "batches: step ms by bucket %s, %.0f tokens/s (last epoch, CUDA "
          "events); K2 %d launches (one a step); first-step gradients "
          "against the CPU %s (limit %g); cross-entropy %.4f -> %.4f; after "
          "a step in bucket %d bucket %d's executor holds the same arrays "
          "%s, bitwise %s, %d of %d moved; the RNN op (cuDNN) against its "
          "unrolled cells %s; %.1f s"
          % (smi, BUCKET_VOCAB, BUCKET_HIDDEN, BUCKET_EMBED, BUCKET_BATCH,
             list(BUCKET_KEYS), BUCKET_ADAM["learning_rate"], BUCKET_EPOCHS,
             lm17["batches"] // BUCKET_EPOCHS,
             {k: round(v, 2) for k, v in lm17["step_ms_by_bucket"].items()},
             lm17["tokens_per_s"], lm17["calls"]["softmax_lastaxis"],
             {k: "%.2g" % v for k, v in grads17.items()}, BUCKET_GRAD_TOL,
             lm17["ce_first"], lm17["ce_last"], max(BUCKET_KEYS),
             min(BUCKET_KEYS), shared17["same_arrays"], shared17["bitwise"],
             shared17["moved"], shared17["params"],
             ["%s%s %.2g" % (f["mode"], " bi" if f["bidirectional"] else "",
                             max(f["output"], f["data_grad"],
                                 f["param_grad"])) for f in fused17],
             lm17["seconds"]), flush=True)
    lm17_batch = _bucket_batch(mx, mx.gpu(0), bucket_it, max(BUCKET_KEYS))
    import time_variants
    parent_k2 = time_variants.k2_parent_library(
        os.path.join(_build.BUILD_DIR, "variants"))
    k2_lm_err, k2_lm_jobs = check_k2_lm(
        ck, dev, bw, flops,
        lambda x: time_variants.k2_call(parent_k2, x))
    time_k2_lm(k2_lm_jobs, "call_ms", time_ms)
    k2["launches_data_pipeline"] = {
        "records_fit": rec17["calls"]["softmax_lastaxis"],
        "bucketed_lm": lm17["calls"]["softmax_lastaxis"],
        "bucketed_lm_per_step": lm17["calls"]["softmax_lastaxis"]
        / lm17["batches"]}
    k1b = sweeps["sgd_mom_sweep"]
    k1b["launches_data_pipeline"] = rec17["calls"]["sgd_mom_sweep"]
    k3["launches_data_pipeline"] = rec17["calls"]["scale_bias_relu"]
    data_line = {"card": smi, "records": {k: v for k, v in rec17.items()
                                          if k != "ce"},
                 "bucketed_lm": lm17, "seconds": time.perf_counter() - t17}
    print("phase 17: %.1f s" % data_line["seconds"], flush=True)

    # 18. gluon's image path: (a) model-zoo ResNet-50 v1 trained by
    # gluon.Trainer from a DataLoader over phase 17's records, (b) its
    # first step held to the CPU, (c) an eval forward held to the CPU and
    # the loss on a fixed batch, (d) symbols/resnet.py's ResNet-50 served
    # through SymbolBlock.imports against a Predictor
    t18 = time.perf_counter()
    gnet, gtrainer, gloss, gbatch, g18 = gluon_train(
        mx, ck, mx.gpu(0), os.path.join(rec_dir.name, "train.rec"), IMAGE,
        BATCH)
    g18["symbol_block"] = gluon_symbol_block(mx, ck, mx.gpu(0), sym, IMAGE,
                                             BATCH, rec_dir.name)
    rec_dir.cleanup()
    first, sb = g18["first_step"], g18["symbol_block"]
    want_sb = {"scale_bias_relu": len(sites) * GLUON_SERVE,
               "softmax_lastaxis": GLUON_SERVE}
    if g18["parameters"] != 25629032 \
            or g18["parameter_arrays_updated"] != 193 \
            or not first["weights_max_rel"] <= LOOP_TOL \
            or not first["momentum_max_rel"] <= LOOP_TOL \
            or not first["running_stats_max_rel"] <= LOOP_TOL \
            or first["batchnorms"] != 53 \
            or not g18["eval_logits_max_rel"] <= CROSS_SHAPE_TOL \
            or not g18["ce_last"] < g18["ce_first"] \
            or not g18["data_on"].startswith("cuda") \
            or sb["bitwise"] != sb["forwards"] or sb["launches"] != want_sb:
        raise AssertionError(
            "gluon: %d parameters, %d arrays updated (expected 25629032 "
            "and 193), first step against the CPU: weights %.3g, momentum "
            "%.3g, running stats %.3g at %d BatchNorms (limit %g); eval "
            "logits %.3g (limit %g); cross-entropy on the fixed batch %.4f "
            "-> %.4f; batches on %s; SymbolBlock bitwise %d of %d, "
            "launches %s (expected %s)"
            % (g18["parameters"], g18["parameter_arrays_updated"],
               first["weights_max_rel"], first["momentum_max_rel"],
               first["running_stats_max_rel"], first["batchnorms"],
               LOOP_TOL, g18["eval_logits_max_rel"], CROSS_SHAPE_TOL,
               g18["ce_first"], g18["ce_last"], g18["data_on"],
               sb["bitwise"], sb["forwards"], sb["launches"], want_sb))
    k3["launches_gluon"] = sb["launches_per_forward"]["scale_bias_relu"]
    k2["launches_gluon"] = sb["launches_per_forward"]["softmax_lastaxis"]
    g18.update(card=smi, seconds=time.perf_counter() - t18,
               cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
               matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    print("gluon on %s: model-zoo ResNet-50 v1 (%d parameters, %d arrays "
          "updated a step), Xavier, hybridize(), gluon.Trainer SGD lr %g "
          "momentum %g, batch %d from a DataLoader over the .rec (%d "
          "threads, RandomResizedCrop, flip, ToTensor, Normalize); %d "
          "warmup + %d timed steps: %.2f ms/step (CUDA events, the loader's "
          "wait included: %.2f ms a batch on the host), %.1f images/s; "
          "first step against the CPU's replay: weights %.3g, momentum "
          "%.3g, running stats of %d BatchNorms %.3g (limit %g); eval "
          "logits against the CPU %.3g (limit %g); then %d steps on the "
          "first batch alone: cross-entropy, median of the first and last "
          "%d, %.4f -> %.4f (%s); SymbolBlock of symbols/resnet.py "
          "ResNet-50 against a Predictor at batch %d: bitwise %d of %d, "
          "launches a forward %s; TF32 cudnn %s matmul %s; %.1f s"
          % (smi, g18["parameters"], g18["parameter_arrays_updated"],
             GLUON_SGD["learning_rate"], GLUON_SGD["momentum"], BATCH,
             g18["workers"], g18["warmup"], g18["steps"], g18["step_ms"],
             g18["loader_wait_ms"], g18["images_per_s"],
             first["weights_max_rel"], first["momentum_max_rel"],
             first["batchnorms"], first["running_stats_max_rel"], LOOP_TOL,
             g18["eval_logits_max_rel"], CROSS_SHAPE_TOL, len(g18["ce"]),
             GLUON_LOSS_WINDOW, g18["ce_first"], g18["ce_last"],
             ", ".join("%.3f" % c for c in g18["ce"]), BATCH,
             sb["bitwise"], sb["forwards"],
             sb["launches_per_forward"], g18["cudnn_allow_tf32"],
             g18["matmul_allow_tf32"], g18["seconds"]), flush=True)

    # device time of each kernel (the profiler last: its hooks slow the
    # host for the rest of the process)
    # K6b's bf16 operands (37.7 MB) fit in the L2 cache, where back-to-back
    # launches would find them; it is timed as the step finds them, in
    # device memory
    recs = [(k3, k3_jobs), (k2, k2_jobs)] + [
        (sweeps[name], sweep_jobs[name]) for name, *_ in SWEEPS] + [
        (k6a, k6a_jobs), (k7a, k7a_jobs), (k5a, k5a_jobs)] + list(bwd_recs)
    def time_all(timer, cold):
        for rec, jobs in recs:
            time_jobs(rec, jobs, "ms", (lambda fn: cold(fn, dev))
                      if rec is k6b else timer)
        for rec, knum in ((k3, "K3"), (k6a, "K6a"), (k7b, "K7b"),
                          (k7c, "K7c")):
            jobs = bf16_jobs[knum]
            rec["bf16"] = {"shape": jobs[0]["shape"] if len(jobs) == 1 else
                           "%d sites of a bucket-%d forward" % (
                               sum(j["count"] for j in jobs), BATCH),
                           "bound_ms": sum(j["count"] * j["bound_ms"]
                                           for j in jobs)}
            time_jobs(rec["bf16"], jobs, "ms", timer)
        time_k2_lm(k2_lm_jobs, "ms", timer)

    # every time by one timer: the profiler's, or, where one of its
    # sessions records no device time (one did, on the H100, in the bf16
    # jobs of a run whose earlier sessions had all recorded), CUDA events
    # for all
    timer, cold = device_ms, device_ms_cold
    try:
        time_all(timer, cold)
    except RuntimeError as exc:
        print("device times by CUDA events instead (%s)" % exc)
        timer, cold = time_ms, time_cold_ms
        time_all(timer, cold)
    # K6b against aten's dx-only LayerNorm backward, three more times each
    # in turns, at the main path's shape, fp32 and bf16, all by K6b's
    # timer above (the L2 cache overwritten before each launch)
    k6b["repeats_timer"] = cold.__name__
    for job in k6b_jobs:
        pre = "" if job["dtype"] == "float32" else job["dtype"] + "_"
        reps = {"ms_repeats": [], "library_ms_repeats": []}
        for _ in range(3):
            for key, fn in (("ms_repeats", ""), ("library_ms_repeats",
                                                  "library_")):
                reps[key].append(cold(job["fns"][fn], dev))
        for key, vals in reps.items():
            k6b[pre + key] = vals
    # after the profiler: with these steps before it, its kernel sessions
    # traced no device time (a bare set and reset of the mode does not do
    # that; the cause is not known)
    for opt_name, mod_o in other_mods.items():
        steps_without_sync(mod_o, train_batch)
        print("%s path: 2 more steps with sync debug mode 'error' did not "
              "wait on the card" % opt_name, flush=True)
    del other_mods
    mixed_prof = step_profile(fit15_mod, train_batch, fit15["step_ms"])
    mixed_line["resnet50"].update(
        idle_share=mixed_prof["idle_share"] if mixed_prof else None,
        step_busy_us=mixed_prof["busy_us"] if mixed_prof else None,
        step_by_kind_us=mixed_prof["by_kind"] if mixed_prof else None)
    del fit15_mod
    rec_prof = step_profile(rec_mod, rec_batch, rec17["step_ms"])
    data_line["records"].update(
        idle_share=rec_prof["idle_share"] if rec_prof else None,
        step_busy_us=rec_prof["busy_us"] if rec_prof else None,
        step_by_kind_us=rec_prof["by_kind"] if rec_prof else None)
    del rec_mod
    gluon_prof = gluon_profile(mx, gnet, gtrainer, gloss, gbatch, BATCH,
                               g18["step_ms"])
    g18.update(
        idle_share=gluon_prof["idle_share"] if gluon_prof else None,
        step_busy_us=gluon_prof["busy_us"] if gluon_prof else None,
        optimizer_us=gluon_prof["optimizer_us"] if gluon_prof else None,
        optimizer_share_of_busy=gluon_prof["optimizer_share_of_busy"]
        if gluon_prof else None,
        step_by_kind_us=gluon_prof["by_kind"] if gluon_prof else None)
    del gnet, gtrainer
    lm_prof = step_profile(bucket_mod, lm17_batch,
                           lm17["step_ms_by_bucket"][max(BUCKET_KEYS)])
    data_line["bucketed_lm"].update(
        idle_share_largest_bucket=lm_prof["idle_share"] if lm_prof
        else None,
        step_busy_us_largest_bucket=lm_prof["busy_us"] if lm_prof else None,
        step_by_kind_us_largest_bucket=lm_prof["by_kind"] if lm_prof
        else None)
    del bucket_mod
    k2["lm"] = [{k: v for k, v in j.items() if k != "fns"}
                for j in k2_lm_jobs]
    inc_prof = step_profile(inc_mod, inc_batch, inc["step_ms"])
    inc["idle_share"] = inc_prof["idle_share"] if inc_prof else None
    inc["step_busy_us"] = inc_prof["busy_us"] if inc_prof else None
    inc["step_by_kind_us"] = inc_prof["by_kind"] if inc_prof else None
    steps_without_sync(inc_mod, inc_batch)
    print("inception-bn: 2 more steps with sync debug mode 'error' did not "
          "wait on the card", flush=True)
    del inc_mod
    # 19. telemetry, tracing and the profiler on the two main paths, and
    # gluon.rnn's medium LSTM LM (after the timing phases, as the
    # sync-debug steps: the profiler's sessions slow the host for the rest
    # of the process)
    obs_line = observability_phase(mx, ck, mx.gpu(0), sym, len(sites),
                                   len(tr["buckets"]), smi)
    fit19, srv19 = obs_line["fit"], obs_line["serving"]
    fit_traced = obs_line["fit_traced"]
    srv_traced = obs_line["serving_traced"]
    total19 = fit19["steps"]
    sweeps["sgd_mom_sweep"]["launches_observability"] = {
        "per_fit_step": fit19["counter"]["fused_sgd_momentum"] / total19,
        "device_trace": fit_traced["fused_sgd_momentum"]}
    k2["launches_observability"] = {
        "per_fit_step": fit19["counter"]["fused_softmax_fwd"] / total19,
        "per_served_forward": srv19["counter_per_forward"][
            "fused_softmax_fwd"],
        "device_trace": fit_traced["fused_softmax_fwd"]
        + srv_traced["fused_softmax_fwd"]}
    k3["launches_observability"] = {
        "per_served_forward": srv19["counter_per_forward"][
            "fused_scale_bias_relu"],
        "device_trace": srv_traced["fused_scale_bias_relu"]}
    # 20. the train-to-serve loop
    ts_line = train_serve_phase(mx, ck, mx.gpu(0), sym, len(sites), smi)
    ts_launches = ts_line["launches_train_serve"]
    for rec, name in ((sweeps["sgd_mom_sweep"], "sgd_mom_sweep"),
                      (k2, "softmax_lastaxis"), (k3, "scale_bias_relu")):
        rec["launches_train_serve"] = dict(
            ts_launches[name], fit_steps=ts_launches["fit_steps"],
            served_forwards=ts_launches["served_forwards"])
    # 21. generative serving and the elastic fit
    gen_line, el_line = generate_phase(mx, ck, mx.gpu(0), sym, smi)
    oracle = gen_line["tokens"]["oracle_launches"]
    n_oracle = len(gen_line["tokens"]["oracle_lengths"])
    for rec, name in ((k6a, "layernorm_fwd"), (k7a, "flash_attention_fwd"),
                      (k5a, "bias_softmax")):
        rec["launches_generative"] = {
            "oracle_forwards": n_oracle, "oracle_lengths":
            gen_line["tokens"]["oracle_lengths"],
            "launches": oracle.get(name, 0)}
    for rec, name in ((sweeps["sgd_mom_sweep"], "sgd_mom_sweep"),
                      (k2, "softmax_lastaxis")):
        rec["launches_elastic"] = {
            "steps_run": el_line["steps_run"],
            "uninterrupted_steps": el_line["uninterrupted_steps"],
            "launches": el_line["launches"][name]}
    # 22. data-parallel training across GPUs
    par_line = parallel_phase(mx, ck, dev, bw, flops, smi)
    for rec, name in ((sweeps["sgd_sweep"], "sgd_sweep"),
                      (sweeps["sgd_mom_sweep"], "sgd_mom_sweep"),
                      (sweeps["adam_sweep"], "adam_sweep"),
                      (k6a, "layernorm_fwd"), (k6b, "layernorm_bwd"),
                      (k7a, "flash_attention_fwd"),
                      (k7b, "flash_attention_bwd_dq"),
                      (k7c, "flash_attention_bwd_dkv"),
                      (k2, "softmax_lastaxis")):
        rec["launches_parallel"] = par_line["launches_parallel"][name]
    # 23. model-axis sharding
    mp_line = model_parallel_phase(mx, ck, dev, smi)
    for rec, name in ((sweeps["adam_sweep"], "adam_sweep"),
                      (k6a, "layernorm_fwd"), (k6b, "layernorm_bwd"),
                      (k7a, "flash_attention_fwd"),
                      (k7b, "flash_attention_bwd_dq"),
                      (k7c, "flash_attention_bwd_dkv"),
                      (k5a, "bias_softmax"), (k5b, "softmax_bwd"),
                      (k2, "softmax_lastaxis")):
        rec["launches_model_parallel"] = mp_line[
            "launches_model_parallel"].get(name, {"total": 0})
    # 24. the asynchronous and multi-process rest of multi-GPU
    fleet_line = fleet_phase(mx, ck, sym, len(sites), smi)
    for rec, name in ((k3, "scale_bias_relu"), (k2, "softmax_lastaxis")):
        rec["launches_fleet"] = fleet_line["launches_fleet"][name]
    k2["launches_async"] = fleet_line["launches_async"]
    k2["launches_multi_context"] = fleet_line["launches_multi_context"]
    for name in ("sgd_sweep", "sgd_mom_sweep", "adam_sweep"):
        sweeps[name]["launches_drill"] = fleet_line["launches_drill"][name]
    # 25. sparse storage at Avazu's and MovieLens-10M's widths
    sparse_line = sparse_phase(mx, ck, smi)
    # 26. the detection and ROI ops at SSD300's and Faster R-CNN's widths
    det_line = detection_phase(mx, ck, smi)
    for job in k7a_jobs:
        job["tflops"] = job["ops"] / job["ms"] / 1e9
    k7a["tflops"] = k7a_jobs[0]["tflops"]
    for rec, jobs in ((k7b, k7b_jobs), (k7c, k7c_jobs)):
        rec["tflops"] = jobs[0]["ops"] / jobs[0]["ms"] / 1e9
    k7a["extra"] = [dict(e, tflops=j["tflops"])
                    for e, j in zip(k7a["extra"], k7a_jobs[1:])]
    for knum, rec in (("K2", k2), ("K7a", k7a)):
        for job in [rec] + rec["extra"]:
            desc = str(job["shape"]) + (" %s causal=%s" % (
                job["dtype"], job["causal"]) if "dtype" in job else "")
            print("%s %s device: kernel %.4f ms, library %.4f ms, bound "
                  "%.4f ms (%s)%s" % (
                      knum, desc, job["ms"], job["library_ms"],
                      job["bound_ms"], job["bound_by"],
                      ", %.1f TFLOP/s" % job["tflops"] if "tflops" in job
                      else ""))
    for job in k2_lm_jobs:
        print("K2 %s (the bucketed LM's logits, %.1f launches a step) "
              "device: kernel %.4f ms, the parent's strided form %.4f ms, "
              "plain %.4f ms, torch.softmax %.4f ms, bound %.4f ms (%s); "
              "per call: kernel %.4f ms, the parent's %.4f ms, plain %.4f "
              "ms, torch.softmax %.4f ms" % (
                  job["shape"], k2["launches_data_pipeline"][
                      "bucketed_lm_per_step"], job["ms"], job["parent_ms"],
                  job["plain_ms"], job["library_ms"], job["bound_ms"],
                  job["bound_by"], job["call_ms"], job["parent_call_ms"],
                  job["plain_call_ms"], job["library_call_ms"]))
    for job in k3_jobs:
        print("K3 %-20s x%-2d device: kernel %.4f ms, plain %.4f ms, bound "
              "%.4f ms; per call: kernel %.4f ms, plain %.4f ms"
              % ((job["shape"], job["count"]) + tuple(
                  job[k] for k in ("ms", "plain_ms", "bound_ms", "call_ms",
                                   "plain_call_ms"))))
    for name, knum, *_ in SWEEPS:
        for job in sweep_jobs[name]:
            print("%s %s bucket of %d: device kernel %.4f ms, plain %.4f ms, "
                  "bound %.4f ms; per call: kernel %.4f ms, plain %.4f ms"
                  % (knum, name, job["n"], job["ms"], job["plain_ms"],
                     job["bound_ms"], job["call_ms"], job["plain_call_ms"]))
    for knum, rec in (("K6a", k6a), ("K7a", k7a), ("K5a", k5a),
                      ("K6b", k6b), ("K7b", k7b), ("K7c", k7c),
                      ("K5b", k5b)):
        print("%s %s device: kernel %.4f ms, plain %.4f ms, library %.4f ms, "
              "bound %.4f ms (%s)%s%s; per call: kernel %.4f ms, plain %.4f "
              "ms, library %.4f ms"
              % (knum, rec["shape"], rec["ms"], rec["plain_ms"],
                 rec["library_ms"], rec["bound_ms"], rec["bound_by"],
                 ", on the fp32 CUDA cores %.4f ms" % rec[
                     "bound_cuda_cores_ms"] if "bound_cuda_cores_ms" in rec
                 else "",
                 ", %.1f TFLOP/s" % rec["tflops"] if "tflops" in rec else "",
                 rec["call_ms"], rec["plain_call_ms"],
                 rec["library_call_ms"]))
    print("K6b against aten's dx-only backward at %s, three times each in "
          "turns (%s): fp32 %s against %s ms, bound %.5f; bf16 %s against "
          "%s ms, bound %.5f" % (
              k6b_jobs[0]["shape"], k6b["repeats_timer"],
              ["%.5f" % v for v in k6b["ms_repeats"]],
              ["%.5f" % v for v in k6b["library_ms_repeats"]],
              k6b_jobs[0]["bound_ms"],
              ["%.5f" % v for v in k6b["bfloat16_ms_repeats"]],
              ["%.5f" % v for v in k6b["bfloat16_library_ms_repeats"]],
              k6b_jobs[1]["bound_ms"]))
    print("K7b + K7c device: %.4f ms against %.4f ms for SDPA's fp32 "
          "backward (%.2fx)" % (k7b["ms"] + k7c["ms"], k7b["library_ms"],
                                (k7b["ms"] + k7c["ms"]) / k7b["library_ms"]))
    k7a_bf16 = next(j for j in k7a_jobs if j["dtype"] == "bfloat16")
    print("bf16 on %s: K7a %s causal %.4f ms against SDPA bf16 %.4f ms "
          "(%.2fx), bound %.4f ms, %d %s; K7c %.4f ms (%d %s), K7b %.4f ms "
          "(%d %s), "
          "K7b + K7c %.4f ms against SDPA's bf16 backward %.4f ms (%.2fx), "
          "bounds %.4f and %.4f ms"
          % (smi, k7a_bf16["shape"], k7a_bf16["ms"], k7a_bf16["library_ms"],
             k7a_bf16["ms"] / k7a_bf16["library_ms"], k7a_bf16["bound_ms"],
             k7a["hmma_bf16_dp64"], HMMA_BF16, k7c["bf16"]["ms"],
             k7c["hmma_bf16_dp64"], HMMA_BF16, k7b["bf16"]["ms"],
             k7b["hmma_bf16_dp64"], HMMA_BF16,
             k7b["bf16"]["ms"] + k7c["bf16"]["ms"],
             k7b["bf16"]["library_ms"],
             (k7b["bf16"]["ms"] + k7c["bf16"]["ms"])
             / k7b["bf16"]["library_ms"], k7b["bf16"]["bound_ms"],
             k7c["bf16"]["bound_ms"]))
    print(json.dumps({"checkpoints": {
        "card": smi, "seconds": ck_seconds,
        "resnet50": dict(ck_a, serve=ck_b, resume=ck_c),
        "transformer": ck_d}}, default=str))
    print(json.dumps(ops_line, default=str))
    print(json.dumps({"mixed_precision": mixed_line}, default=str))
    inc["serve"] = {k: v for k, v in inc["serve"].items()
                    if k not in ("calls", "fwd_calls")}
    print(json.dumps({"inception_bn": dict(inc, card=smi)}, default=str))
    print(json.dumps({"training_loop": loop_line}, default=str))
    print(json.dumps({"data_pipeline": data_line}, default=str))
    print(json.dumps({"gluon": g18}, default=str))
    print(json.dumps({"observability": obs_line}, default=str))
    print(json.dumps({"train_serve": ts_line}, default=str))
    print(json.dumps({"generative": gen_line}, default=str))
    print(json.dumps({"elastic": el_line}, default=str))
    print(json.dumps({"parallel": par_line}, default=str))
    print(json.dumps({"model_parallel": mp_line}, default=str))
    print(json.dumps({"fleet": fleet_line}, default=str))
    print(json.dumps({"sparse": sparse_line}, default=str))
    print(json.dumps({"detection": det_line}, default=str))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_per_forward", "call_ms", "plain_call_ms",
            "library_call_ms")
    print(json.dumps({"kernels": [
        {k: rec[k] for k in keys + tuple(
            x for x in ("launches_training", "launches_checkpoints",
                        "launches_inception", "launches_mixed",
                        "launches_training_loop",
                        "launches_data_pipeline", "launches_gluon",
                        "launches_observability", "launches_train_serve",
                        "launches_generative", "launches_elastic",
                        "launches_parallel", "launches_model_parallel",
                        "launches_fleet", "launches_async",
                        "launches_multi_context", "launches_drill",
                        "lm", "bf16",
                        "ms_repeats", "library_ms_repeats",
                        "bfloat16_ms_repeats", "bfloat16_library_ms_repeats",
                        "repeats_timer",
                        "library_note", "tflops", "hmma_bf16_dp64",
                        "bound_note", "bound_cuda_cores_ms",
                        "bound_cuda_cores_by", "sass_wide", "extra")
            if x in rec)}
        for rec, _ in recs]}))
    print("serving on %s: ResNet-50 v1 fp32, buckets %s, warmup %.1f s; "
          "%d requests (%d rows) from %d clients in %.3f s: %.2f req/s, "
          "%.1f rows/s, p50 %.2f ms, p99 %.2f ms; bucket-%d forward %.2f ms "
          "(kernels) vs %.2f ms (knobs 0); %d forwards, launches %s; "
          "vs knobs-0 Predictor: argmax equal %d/%d, max |dp| %.3g "
          "(top-1 p mean %.3f, min %.3f); occupancy %s"
          % (smi, res["buckets"], res["warmup_s"], res["requests"],
             res["rows"], res["clients"], res["wall_s"], res["req_per_s"],
             res["rows_per_s"], res["p50_ms"], res["p99_ms"], BATCH,
             res["fwd_ms"], res["fwd_ms_knobs0"], res["forwards"],
             res["launches"], res["argmax_equal"], res["requests"],
             res["max_abs_dp"], res["top_p_mean"], res["top_p_min"],
             json.dumps(res["occupancy"])), flush=True)
    print(profile_forward(res["predictor"], res["batch_input"],
                          res["fwd_ms"]))
    print(profile_step(mod, train_batch, tr["step_ms"]))
    print("bf16 (phase 15): " + profile_step(None, None, fit15["step_ms"],
                                             mixed_prof))
    print("from records (phase 17): " + profile_step(
        None, None, rec17["step_ms"], rec_prof))
    print("gluon (phase 18): " + profile_step(
        None, None, g18["step_ms"], gluon_prof))
    print("bucketed LM at T %d (phase 17): " % max(BUCKET_KEYS)
          + profile_step(None, None, lm17["step_ms_by_bucket"][
              max(BUCKET_KEYS)], lm_prof))
    for r in lm_res.values():
        print(profile_lm(lm, r["tokens"], r["fwd_ms"]))
    for r in train_res.values():
        print(profile_lm_train(mx, *r["run"], r["step_ms"]))
    print("bf16 (phase 15): " + profile_lm(lm15[0], lm15[3], lmf["fwd_ms"]))
    print("bf16 (phase 15): " + profile_lm_train(mx, *lm15, lmt["step_ms"]))
    print("nvidia-smi: %s" % smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
