#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``colbert_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``colbert_tpu_torch/csrc`` (one nvcc
per source, all at once) and drives the port's paths, exact flat serving,
retriever training and ANN serving with the sq, pq4 and pq codecs (sq also
by the token-major probe; ragged corpora over stride buckets, the host-RAM
table, the packed dedup), at full BERT-base width, the second stage
(mining, the cross-encoder's training and reranking) at macbert-large
width, and the flash-attention path and remat, with random weights from a
seed:

* phase 1: kernels K1 (fused scan + group max) and K2 (full score matrix)
  against their plain PyTorch versions on the card, at B=144 queries x 16
  views x 768 dims: 20,000 docs x 16 rows (bf16 table, fp32 and bf16
  stored scores; int8 table), 200,000 docs x 16 rows bf16 (4.9 GB, bf16
  stored scores) and 1,001 docs x 37 rows (a ragged last group), each on
  the kernel route ``flat_scan_plan`` picks ("wgmma" for 16 rows a doc
  and 16 views, else "staged"; the route's launch counter is checked).
  Times K1 and K2 at 20,000 docs, K1 over the int8 table and over the
  200,000 docs, each with its share of the 989 TFLOP/s bf16 peak, and, as
  information, cuBLAS's bf16 product + amax + sum over the same table (a
  yardstick the port never calls).  Limits: fp32 scores within 1e-4; bf16
  stored scores within one bf16 ulp of the value (a last-bit fp32
  difference can flip the rounding), or within the fp32 limit near zero,
  where the fp32 summation-order error (~3e-5 at these widths) exceeds a
  bf16 ulp.
* phase 1b: K1 and K2 at ColBERT dims that are not multiples of 16 (the
  TPU kernels take any dim), at phase 1's shape on route "wgmma": bf16 at
  312 (TinyBERT-4L-zh's dim = hidden: a 624-byte row, the tensor map) and
  100 (a 200-byte row, which no tensor map describes: the producers'
  copies), int8 at 312 (a 312-byte row: the copies); each against its plain
  version under phase 1's limits, timed as phase 1 times them beside the
  bound, the plain version and, for bf16, the cuBLAS yardstick; then K1, K2
  and K4 at dim 128 on route "wgmma" against their plain versions.
* phase 2: the CLI's ``encode`` over a 20,000-doc synthetic Chinese corpus,
  ``serve`` in a background thread, three requests of 144 questions at
  top-100 through ``RetrievalClient``, ``evaluate --remote``, and the same
  requests through the unfused route (``serve.flat_fused_topk=false``).
  Every answer must hold 100 valid, descending triples whose scores equal
  the plain version's top-100 over the same table and query encodings
  within 1e-4 (tie-insensitive), and each kernel must have launched in
  the run: K1 once per served batch, every launch on the "wgmma" route.
* phase 3: kernels K3 (all-pairs MaxSim, fp32) and K9 (dropout) against
  their plain PyTorch versions on the card.  K3 at the trainer's eval
  shape (34 queries x 16 views against 340 docs x 16 rows x 768), with
  multiview off (32 query tokens, 384 doc tokens, token masks) and with a
  ragged doc count, each on the route ``maxsim_plan`` picks ("tf32" for
  16 x 16 rows: three TF32 tensor-core products; else "staged") and on
  route "staged" (the first design); limit 1e-4 absolute; both timed at
  the eval shape through the wrapper and as a launch alone on the masked
  inputs, with the TF32 bound and the fp32 CUDA-core bound.  K9 on both
  routes ("packed", the default, and the first design, "simple") on the
  attention probabilities of a training step, (68, 12, 384, 384) bf16, at
  the cross-encoder's two sites, its attention probabilities (20, 16, 384,
  384) bf16 and its hidden states (20, 384, 1024) bf16, at that last shape
  in fp32 and fp16, on an fp32 tensor with an odd element count, and on
  subnormals, +-0, +-inf and NaN in each dtype: forward and backward
  bit-equal to the plain version's Philox stream (NaN by position), the
  keep fraction within 5 sigma of (256 - thr) / 256; the three bf16 shapes
  timed on the host clock a call, K9 and ``F.dropout`` on an input that
  records a graph as the models call them (without one as an aside), and
  on the card alone, both routes in turns, beside ``F.dropout`` and the
  ``copy_`` of the same bytes, cold (inputs and outputs rotated over twice
  the L2 and more) and hot (the same input each call, an aside); the cold
  time against the bound: the larger of the bytes read and written over
  3.35 TB/s and route "packed"'s instructions (counted in its loop's SASS,
  ``cuobjdump -sass``) over the INT32 pipe's and the schedulers' rates.
* phase 4: the CLI's ``train`` at BERT-base width, batch 34, multiview
  16/16, dropout 0.1 (the default byte impl): 7 steps over synthetic
  Chinese questions with positives and hard negatives, an evaluation on a
  dev set at steps 3 and 6 (two eval batches, the second padded), a
  checkpoint at each, then ``train --resume`` from step 6 for one step.
  Every loss must be finite, the resumed step's loss equal the straight
  run's, K9 launch (1 + 3 layers) x 2 passes x 2 (forward, backward) times
  per step, every launch on route "packed", and K3 once per eval batch,
  every K3 launch on route "tf32".  Then the full-depth repeat check: one
  train step's forward and backward at phase 4's configuration (12 layers,
  explicit attention) three times on the same batch and parameters, every
  gradient and the loss bit-equal (the lookup's backward included: no
  process-wide deterministic flag).
* phase 5, ANN serving with the sq codec at the JAX package's sq cell
  (nprobe 128, candidate depth 512, 8 rows per (token, list), 128 hot
  lists, 4,096 candidates, top-100):
  (c) at the end of phase 2, on its encoded corpus: ``build-index``
  (K = 4,096 lists, sq_dim 64), ``serve`` with ``serve.mode=ann``, four
  requests of 144 questions (the last repeats the first at the smallest
  nprobe, doubling from 128, at which lists overflow their slots: K7's
  work; K7 on both routes over that request's plan, as in 5a, after the
  counted run), ``evaluate --remote``, a local ``evaluate`` with
  ``serve.rerank_dtype=int8``, and the first request through that int8
  service.  Every answer (the socket's and the int8 service's) must hold
  100 valid, descending triples whose scores equal the exact MaxSim of the
  returned pids over the served table within 1e-4; (d) K4 must launch once
  per bf16 batch, K5 once per int8 batch, every launch on the rerank's
  "wgmma" route, K6 and K7 once per batch, every K6 and K7 launch on route
  "mma";
  (b) ``build-index`` over the JAX bench's 20,000-doc generator
  (``bench.py:51-65``, seed 0), recall@100 of ANN search from topic-drawn
  query reps against the fp32 exact oracle (at least 0.98), the batch's
  time per stage (probe, dedup, rerank, top-k), and one batch served with
  ``serve.rerank_dtype=float32`` (an fp32 table, no K4/K5 launch): its
  scores within 1e-4 of an fp32 MaxSim of its pids, recall@100 >= 0.98;
  every K6 and K7 launch of the served batches on route "mma";
  (a) on that batch's inputs: the histogram of K6's filled slots (list
  rows and members a slot: median, p99, max), K6 on route "mma" and on
  route "staged" (the first design; also the longest slot alone on both)
  and K7 (the batch's 128 most-probed lists, their probing tokens as
  members) on route "mma" over the members and over every token and on
  route "staged" (every token), each against its plain version, scores
  within 1e-5 and rows equal except at near ties (K6/K7: at the entries a
  probe reads; the tensor-core routes against the plain version's
  top-(r+1), an exact tie of it excused only where the rows' fp64 sums
  differ), with both of K7's bounds
  (member pairs, every token's pairs); K7 on the served plan (no hot list
  at nprobe 128) on both routes, timed; K4 (bf16) and K5 (int8)
  on route "wgmma" over the 144 x 4,096 candidates and in a low-reuse case
  (the same candidates over a 200,000-doc table, p -> 10p + b mod 10),
  within 1e-4 with -inf exactly at the -1 candidates, each timed with its
  schedule, the schedule alone, and the first design (route "staged") on
  the same inputs, with the device-memory and L2 bytes each design moves;
  and on the serving candidates at 48 and 64 query rows (a "wgmma" launch
  a 16-row chunk), against the plain version, timed beside the bound.
* phase 6, the pq4 and pq codecs and the token-major sq probe at the same
  operating point (pq4: m 128 x 4 bits; pq: m 64 x 8 bits; 10 PQ k-means
  iterations):
  (c) at the end of phase 5c, on phase 2's encoded corpus: ``build-index``
  with the pq4 codec, ``serve`` over the socket, two requests of 144
  questions and ``evaluate --remote``, then one request through a service
  of phase 5c's sq index with ``serve.probe_impl=token``.  Every answer
  must hold 100 valid, descending triples whose scores equal the exact
  MaxSim of the returned pids within 1e-4; K8 must launch once per pq4
  batch, every launch on route "onehot", K10 once for the token-probe
  batch, on route "fused", K4 once per batch;
  (a) on phase 5b's corpus, ``build-index`` with the pq4 and the pq codec
  and phase 5b's sq index served with the token-major probe (and the
  batched one, for reference): recall@100 against the fp32 oracle over
  2 x 144 queries about two topics each (8 tokens around each; at least
  0.95 each; with one topic per query, as phase 5b's, an exact top-512 per
  token falls on a few docs, so the token-major probes keep fewer than 100
  candidates for some queries: reported as information), build seconds
  and the batch's time per stage, every K6 launch on route "mma", every
  K8 launch on route "onehot", every K10 launch on route "fused";
  (b) on the first batch's inputs: K6 on both routes as in 5a; K8 (2,304
  tokens x 128 probed lists) on route "onehot" and on route "lookup" (the
  first design), with the histogram of its probed lists (members, rows),
  route "onehot"'s work list against its plain version, the bound (the
  one-hot product on the tensor cores; route "lookup"'s own, its
  shared-memory lookups, beside it) and route "lookup"'s clock64 phase
  split (``scripts/pq4_scan_variants.py``, one more nvcc); and K10
  (2,304 tokens x 128 windows, top-512): route "fused" bit-equal to route
  "staged" + ``_window_topk``, the rows a token scores, the token probe's
  parts timed apart on both routes (coarse GEMM + top-nprobe, windows,
  ``sq_query``, the staged scan, ``_window_topk``, route "fused") and both
  routes' bounds; each kernel against its plain version, scores within
  1e-5 and rows (K8: against the plain version's top-(r+1), an exact tie
  of it excused only where the rows' fp64 sums differ; K10: against the
  plain version's top-513, an exact tie of it excused where the kernel's
  scores of the two rows differ) equal except at near ties.

* phase 7, the second stage, at the end of phase 2 on its encoded corpus
  served flat in process (its retriever, ``serve.mode=flat``), with the
  cross-encoder at macbert-large width (``configs/dureader.yaml:11-17``:
  24 layers, hidden 1,024, 16 heads, FFN 4,096, bf16, ``ce_maxlen`` 384)
  and ``ce_train`` at the reference's batch (4 questions x (1 + 4
  negatives)): ``mine --topk 50 --keep-old 10 --distill-out`` over 128
  questions (64 of phase 2's topic-word questions and 64 passages asked
  as questions, 15 old negatives each); its files must equal
  ``gen_iter_train_dev`` and ``gen_distill_data`` over the same service's
  results (teacher scores within 1e-4), every question keep its 10 old
  negatives first and no old negative be a positive (the fresh ones may
  hold it: the reference's generator does not filter them; counted).
  ``train-ce`` for 7 steps on the mined file (an evaluation on 16 dev
  questions and a checkpoint at steps 3 and 6, the final save at 7), then
  ``train-ce --resume`` from step 6: its loss and every parameter after
  step 7 bit-equal to the straight run's, and the (shape, dtype) of every
  dropout site's input in that step exactly the two phase 3 held K9 at; ``train-ce`` with
  ``ce_train.distill_weight=0.5`` on the ``--distill-out`` file; then
  ``evaluate --rerank-ce`` over 16 questions (top-100 retrieved, reranked
  by the last checkpoint), and one question through the same two stages
  against the argsort of its CE scores computed again.  Every loss must be
  finite, K9 launch 2 x (1 + 3 x 24) = 146 times a CE step, every launch
  on route "packed", and K1 once per retrieval batch; prints the CE's
  ms/step over steps 3-6 on the host clock, the host's time inside K9's
  calls in the resumed step, its peak device memory and the rerank's ms a
  question.

* phase 8, the flash-attention path (``model.attention_impl="flash"``:
  kernels K11 forward, K12 dK/dV and K13 dQ, ``csrc/flash_attention.cu``)
  and ``model.remat``:
  (a) after phase 3: K11-K13 against their plain versions (the JAX
  kernels' order) at the retriever's doc pass (68, 12, 384, 64) bf16 with
  the synthetic corpus's doc lengths, the CE's (20, 16, 384, 64), the
  encode batch (384, 12, 384, 64), a batch with no padding and one padded
  at 129 and 257, in the models' layout (heads-major views of (B, L, nh,
  hd)): o, dq, dk and dv within 2 bf16 ulps of each element's head vector
  (its row's largest magnitude, floored at 2^-10 of the tensor's largest
  entry) and at most 1e-3 of the elements beyond 2 ulps of their own
  magnitude (a p or ds that rounds the other way at a bf16 boundary moves
  its row by ~2^-8 of one term); two runs bit-equal; the same of K11, K12
  and K13 on each route ("wgmma", every call's; "simple", the first design,
  on request), and the backward's rows kernel: di bit-equal to its order in
  torch and within fp32 rounding of ``flash_di``, 1 / l bit-equal.  At the
  first three shapes each kernel (each route) timed cold (input sets in
  turn past the L2) and hot, three times in turn (the medians kept), beside
  its bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s), the rows
  kernel beside ``flash_di``, and the forward and forward + backward
  beside the plain version, the port's explicit attention (fp32 logits,
  softmax, K9 at the probabilities), the first design's path (route
  "simple" with ``flash_di``, through an autograd function of the same
  form; by route also the forward, the backward and di, each on the host
  clock with the card kept busy, on the card alone and as issued) and
  ``F.scaled_dot_product_attention`` with the boolean segment mask (a
  yardstick the port never calls; also its backward alone, dq, dk and dv
  from one call, on the fastest of the cuDNN and memory-efficient
  backends, named); then at head dims 32 and 26 ((68, 12, 384, hd), the
  MiniLM-L12-H384 and TinyBERT-4L-zh widths' doc passes), 80, 96 and 128
  ((68, 8, 384, hd); 26, 80 and 96 on the 32 and 128 templates, 26 read
  by the kernels' own copies), bf16 and fp16 on route "wgmma" (route
  "simple" stays at 64): the wrapper's forward and backward and the
  autograd function against the plain path, under the same limits, twice
  (bit-equal), di and 1 / l as above, every launch at that head dim and
  on its template; K11, K12, K13 and the rows kernel timed cold (bf16)
  beside their bounds, the plain versions and SDPA (forward; backward
  alone);
  (b) after phase 4: ``train`` with flash at phase 4's configuration, 5
  steps, evaluations at steps 2 and 4, then ``--resume`` from step 4: the
  resumed loss bit-equal, K11 12 launches a step and 12 a layer per eval
  batch, K12 and K13 12 a step, K9 as phase 4, K3 on "tf32"; ms/step and
  peak memory beside phase 4's.  Here and in (c)-(e) every K11, K12 and
  K13 launch on route "wgmma" and the rows kernel once a K12 launch;
  (c) after phase 7: ``encode`` with flash over phase 2's corpus (K11 once
  a layer an encode batch), one ``serve`` request of 144 questions at
  top-100 over that table, checked as phase 2's answers; docs/s beside
  phase 2's, the largest difference of the two tables (information);
  (d) ``train-ce`` with flash at macbert-large width, 3 steps on phase 7's
  mined file: finite losses, K11-K13 24 launches a step, K9 146; ms/step
  and peak memory beside phase 7's;
  (e) 3 train steps (the library's ``train_step``, phase 8b's data and
  config) with remat "full", "dots" and "attn" on the explicit path and
  "full" with flash: losses bit-equal to the same steps without remat (the
  flash ones also to phase 8b's first three); the peak memory of each.

* phase 9, ANN over a ragged corpus (multiview off: each doc its own
  count of rows, 32 query rows) at the sq cell's operating point, the
  host-RAM rerank table and the packed dedup:
  (c) at the end of phase 6c: the first 10,000 passages of phase 2's
  corpus encoded with ``multiview.enabled=false``, ``build-index`` (sq),
  ``serve`` (bf16 stride buckets) over the socket, two requests of 144
  questions, one request each through an int8 (int8 buckets), a
  ``serve.rerank_table=host`` and a ``serve.dedup_impl=packed`` service,
  ``evaluate --remote``.  Every answer must hold 100 valid, descending
  triples whose scores equal the exact MaxSim of the returned pids over
  the served table within 1e-4 (the host table: its int8 blocks against
  ``bf16(Qm * inv_scale)``); K4 (bf16) or K5 (int8) must launch once a
  bucket a batch and K5 once a host-table batch, every launch on route
  "wgmma_rows", K6 and K7 once a batch on route "mma";
  (b) after phase 6: a synthetic ragged corpus, 10,000 docs of 40-124
  rows drawn around ``topic_embeddings``' topics (~0.82 M rows),
  ``build-index`` with sq (K = 4,096, sq_dim 64) and pq4; one batch of 144
  two-topic queries of 32 rows from query reps with each of: bf16, int8
  and fp32 rerank tables (stride buckets; the fp32 table ragged, gathered
  with a doclen mask), the host table with funnels of 256 and 4,096, the
  packed dedup, and the pq4 index: recall@100 against the fp32 exact
  oracle over the stored rows (at least 0.98 for bf16, int8, fp32, packed
  and the 4,096 funnel; the 256 funnel and pq4 reported), the batch's time,
  its launches (as in 9c; the host table: K5 once a query chunk of at most
  4 GB of blocks), and the bf16 batch's time per stage with the packed
  against the exact dedup (information);
  (a) on that batch's candidates (144 x 4,096): K4 over the bf16 and K5
  over the int8 stride buckets on route "wgmma_rows", each bucket's launch
  and the bucketed entry against their plain versions (within 1e-4, -inf
  exactly at the -1 candidates), the first design (route "staged",
  forced) on the same inputs too, the two timed in turns (wgmma_rows,
  staged, staged, wgmma_rows; CUDA events; the pair blocks pass the L2 many
  times over: cold) beside the byte bound of the distinct doc blocks, that
  of the pair blocks, the operation bound (bf16; three terms for K5) and
  the bytes route "wgmma_rows" is reckoned to stream from L2 (the pair
  blocks and a query operand an item), failing where "wgmma_rows" is not
  the faster; and K5 over host-gathered blocks, a uniform host table (16
  rows, 16 views: route "wgmma") and the ragged corpus's at its default
  funnel (124 rows: route "wgmma_rows"), each and route "staged" against
  the plain version, timed in turns, with the host gather and the copy;
  (d) between (b) and (a): 144 two-topic queries of 48 rows, more than one
  K4/K5 launch takes, through the bf16 and int8 stride buckets and the
  host table (funnel 256) of (b), a launch a bucket (or a host chunk) and
  a 32-row chunk on route "wgmma_rows", and through phase 5b's uniform index
  as a q_view-48 batch, a launch a 16-row chunk on route "wgmma": every
  score the exact MaxSim of its pid over the served table within 1e-4,
  recall@100 against the fp32 exact oracle (at least 0.98 but the 256
  funnel's, reported), the launches counted, the batch's time.

* phase 10, several devices (``parallel/``, ``ranking/sharded.py``), on
  the cards present (four shards on one card when it is alone):
  (a) after phase 2, on its encoded corpus: ``ShardedColbertSearcher`` in
  flat mode, 4 shards, phase 2's requests of 144 questions at top-100:
  every answer checked as phase 2's against the plain version over the
  single searcher's table (within 1e-4, tie-insensitive), K2 once a shard
  a batch; the time a batch beside the single searcher's (information);
  (b) after phase 5b, on its index (the bench generator's corpus: phase
  5c's random model scores near ties, so recall there means nothing): the
  sharded sq searcher, 4 shards, one batch of 144 topic queries from their
  reps: recall@100 against the fp32 oracle (at least 0.98) and the single
  searcher's pids (at least 0.95), scores the exact MaxSim of their pids
  and at least the single searcher's (within 1e-4), K6, K7 and K4 once a
  shard on routes "mma" and "wgmma";
  (c) after phase 4: the CLI's ``train`` under a launch
  (``--coordinator 127.0.0.1:<port> --num-processes N --process-id r``,
  NCCL, N = the cards present) for 3 steps at phase 4's configuration
  against the same without the flags: N = 1, losses, parameters and AdamW's
  moments bit-equal and K9 as phase 4's; N >= 2, one process a card
  against one device at the global batch, the CPU test's limits.

* phase 11, flash attention at fp32, the two model options, DPR and real
  text (~90 s):
  (a) after phase 8a: route "tf32" of K11, K12 and K13 (three TF32
  products on wgmma) and the rows kernel's fp32 route, on fp32 inputs at
  the retriever's (68, 12, 384, 64), the CE's (20, 16) and encode's (384,
  12) attention shapes against the fp32 plain versions (TF32 off): o, dq,
  dk and dv within 1e-5 of each head vector's largest magnitude, floored
  at 1/8 of the tensor's largest (``ops/flash_attention.py::fp32_head_rel``:
  the summation order, exp's last bits and the TF32 split's ~2^-21, and
  the fp32 noise of a ds that cancels), l and m within 1e-5 relative (m's
  floored at 1), di within fp32 rounding of ``flash_di`` and bit-equal to
  its order in torch, 1 / l bit-equal, two runs bit-equal, the autograd
  function equal to the launches, every launch on the route asked for; at
  the CE's shape a NaN planted in q and one in do leave o, l, m, dq, dk
  and dv NaN where the plain version's are and nowhere else; each kernel
  timed cold and hot beside its bounds (fp32 operations over 67 TFLOP/s,
  or fp32 bytes; three TF32 products over 495 TFLOP/s, and the share of
  that bound), rows + K12 + K13, the plain versions and
  ``F.scaled_dot_product_attention`` at fp32 with the boolean mask
  (forward, forward + backward, its backward alone), in the same run; the
  same at phase 8a's head dims 32, 26, 80, 96 and 128;
  (b) after phase 4, at its configuration: 3 train steps at
  ``model.dtype=float32`` with flash against the explicit fp32 path, both
  dropping the attention output (the site flash takes): each loss within
  1e-4 of the explicit one's, relative; K11, K12, K13 and the rows kernel
  12 launches a step, K11, K12 and K13 on route "tf32", the rows kernel on
  its fp32 route; ms a step and peak memory;
  (c) the same configuration in bf16, 3 steps each: ``model.fused_qkv``
  (losses within 2e-2 relative of phase 4's, every step-1 gradient within
  5e-2 in norm but the attention key biases', whose exact value is zero;
  24 fewer GEMMs in a 12-layer doc forward) and
  ``model.embedding_impl="onehot"`` (the embeddings' forward bit-equal to
  the lookup's, so step 1's loss and every gradient but the word table's
  bit-equal, the word table's within 2^-7 in norm), ms a step and peak
  memory beside phase 4's configuration's;
  (d) after phase 2: ``DenseRetriever`` (DPR) with phase 2's model (flash
  attention: K11 once a layer a doc batch) over its 20,000 passages and
  3 x 144 questions at top-100: ids equal to an fp64 oracle's over the
  same pooled vectors but at ties within 1e-6 beyond the fp32 scores' own
  error (twice their largest error), scores within 1e-5, a passage's own
  vector 1.0 within 1e-3, ``save_index`` / ``load_index`` the same
  answers; docs/s and questions/s;
  (e) real text: ``evaluation/pydocs.py`` over this machine's standard
  library (180 modules, at most 1,500 docstrings), a ``train_wordpiece``
  vocab, a BERT-small retriever (hidden 256, 4 layers, dim 128, bf16,
  multiview off) trained 10 epochs (~320 steps) through the CLI, and dev
  MRR@10 and recall@100 of ColBERT (flat ``evaluate``) and DPR: finite,
  MRR above chance.

* phase 12, a retriever at microsoft/Multilingual-MiniLM-L12-H384's widths
  (hidden 384, 12 layers, 12 heads of head dim 32, intermediate 1536, vocab
  250,037; bf16, ``attention_impl="flash"``, seeded weights), after phase
  8: ``train`` at batch 34 on phase 4's data (9 steps at learning rate
  1e-4, evaluations and checkpoints, ``--resume`` bit-equal), the loss
  finite and falling; ``encode`` of a 20,000-passage corpus as phase 2's;
  flat ``serve`` of 3 requests of 144 questions, each answer checked as
  phase 2's against the plain version over the same table; every K11,
  K12 and K13 launch on route "wgmma" at head dim 32 (counted by head dim);
  ms/step, docs/s and peak memory.  ``--phase12`` runs it, with phase 8a's
  and 11a's head-dim cases, alone.

* phase 13, tensor parallelism (``mesh.model = 2``, ``models/sharding.py``;
  on two cards where the machine has them, else ``cuda:0`` listed twice
  holds both positions), after phase 11: (a) K9 on a position's slices
  (route "packed", strided counters): the retriever's probabilities (68,
  6, 384, 384) of (68, 12, 384, 384) and the flash output's columns (68,
  384, 384) of (68, 384, 768), bf16, at positions 0 and 1, from row 0 and
  from a data-parallel rank's row 34, forward and backward bit-equal to the
  plain version, each timed cold on the card alone in turns with the
  contiguous launch of the same bytes, beside its byte bound, the plain
  version and ``F.dropout``; (b) 3 train steps at phase 4's configuration
  (BERT-base, batch 34, bf16, flash, dropout on) at model 2 against model 1
  from the same init and generators: every dropout mask bit-equal (drawn
  by the kernel; a position's slices put together), the losses within 2e-2
  and the parameters within 7 x 3 x lr (bf16 partial products summed after
  the product, so activations round otherwise; Adam moves an element about
  lr a step whatever its gradient), three runs at model 2 bit-equal, K11-K13
  once a layer a position a step and K9's launches (strided ones at the
  attention sites) as counted; (c) ``encode`` of 4,000 passages through the
  CLI at ``--set mesh.model=2`` and flat serving of 144 questions at
  model 2: reps within 2^-4 of model 1's, the same top-10 pids but at
  ties within twice the largest score change the reps make; (d) one CE
  step at model 2 against model 1 (loss within 2e-2).  ``--phase13`` runs
  it alone.

* phase 15, phase 12's path at huawei-noah/TinyBERT_4L_zh's widths
  (hidden 312, 4 layers, 12 heads of head dim 26, intermediate 1200,
  vocab 21,128, ColBERT dim 312 = hidden, as the repo's operating point;
  bf16, flash, seeded weights), after phase 12: ``train`` (9 steps at batch
  34, learning rate 1e-4, resumed; K3's eval at h 312 on route "tf32"), the
  loss finite and falling, ``encode`` of phase 2's 20,000 passages, flat
  ``serve`` of phase 2's requests checked as phase 2's (K1 on route
  "wgmma" at h 312), one request of them in process over an int8 flat
  table (K1, the table copied by the producers) and through the unfused
  route (K2), each checked the same way; then ``build-index`` with the sq
  codec (sq_dim 64, phase 5's operating point) and ``serve`` with
  ``serve.mode=ann`` and the bf16 rerank table over the socket, the same
  requests: every answer's scores the exact MaxSim of its pids within 1e-4,
  K6 and K7 once a request on route "mma", K4 once a request on route
  "wgmma" at dim 312 (the producers' copies); K4 alone on request 0's
  144 x 4,096 candidates against its plain version, timed beside its
  bound.  Every K11, K12 and K13 launch on route "wgmma" at head dim 26
  and on the 32 template.  ``--phase12`` runs it too; ``--phase15`` runs
  phases 1b and 15 alone.

* phase 14, the host runtime (``csrc/native.cpp``, built with g++; host
  clock, medians of 5 unless said): (a) after phase 2, on its flat service
  in process: the batches of a 144-question request and of a 1,024-question
  request (phase 2's questions cycled) at top-100 through
  ``serialize_batch`` + ``wrap`` against ``serialize_batch_ref`` + ``wrap``,
  bytes equal; one 144-question request split into tokenize, encode, K1
  scan + top-k, the copy to the host and the serializer, and whole; (b)
  after phase 5b: ``balanced_assign`` (8 nearest-centroid candidates, cap
  1.2x the mean list) and ``ivf_pack`` against their plain versions (medians
  of 3) on phase 5b's rows and lists, the pack also equal to the stored
  index; then at 3.2 M rows (200,000 docs x 16) over 16,384 lists, skewed
  topics, int8 codes of width 64 (the plain assignment timed once);
  outputs equal; (c) ``build_flat_table`` once at phase 1's 200,000 docs x
  16 rows x 768, bf16 and int8, from fp16 on the host.  Phases 2, 5c, 6c
  and 9c require ``pickle_triples`` once a batch served over the socket.
  ``--phase14`` runs it alone with the set-up it needs.

Prints the card's name and power limit, the measurements, one JSON line of
the host runtime's times, one JSON line of kernels, and last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

SEED = 1234
B, M, H = 144, 16, 768
TOPK = 100
SCORE_ATOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---- launch counters and bounds ----

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense tensor-core rate
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense tensor-core rate, TF32
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3


def counters():
    from colbert_tpu_torch.ops import dropout as dr, flash_attention as fa, flat_scan as fs, maxsim as ms
    from colbert_tpu_torch.ops import pq4, rerank as rr, sq_probe, sq_probe_batched as sp
    from colbert_tpu_torch import native

    return {"pickle_triples": native.pickle_triples.calls, "ivf_pack": native.ivf_pack.calls,
            "balanced_assign": native.balanced_assign.calls,
            "K1": fs.flat_scan_fused.launches, "K2": fs.flat_maxsim_scan.launches,
            "K3": ms.maxsim.launches, "K9": dr.hw_dropout.launches,
            "K4": rr.maxsim_rerank_uniform.launches, "K5": rr.maxsim_rerank_uniform_int8.launches,
            "K6": sp.sq_batch_list_scan.launches, "K7": sp.sq_hot_list_scan.launches,
            "K8": pq4.pq4_list_scan.launches, "K10": sq_probe.sq_list_scan.launches,
            "K11": fa.fwd_launches, "K12": fa.dkv_launches, "K13": fa.dq_launches,
            "K1/K2 wgmma route": fs.route_launches["wgmma"], "K1/K2 staged route": fs.route_launches["staged"],
            "K4/K5 wgmma route": rr.route_launches["wgmma"], "K4/K5 staged route": rr.route_launches["staged"],
            "K4/K5 wgmma_rows route": rr.route_launches["wgmma_rows"],
            "K6 mma route": sp.route_launches["mma"], "K6 staged route": sp.route_launches["staged"],
            "K7 mma route": sp.hot_route_launches["mma"], "K7 staged route": sp.hot_route_launches["staged"],
            "K8 onehot route": pq4.route_launches["onehot"], "K8 lookup route": pq4.route_launches["lookup"],
            "K3 tf32 route": ms.route_launches["tf32"], "K3 staged route": ms.route_launches["staged"],
            "K10 fused route": sq_probe.route_launches["fused"],
            "K10 staged route": sq_probe.route_launches["staged"],
            "K9 packed route": dr.route_launches["packed"], "K9 simple route": dr.route_launches["simple"],
            "K9 slice": dr.slice_launches,
            "K11 wgmma route": fa.fwd_route_launches["wgmma"], "K11 simple route": fa.fwd_route_launches["simple"],
            "K12 wgmma route": fa.dkv_route_launches["wgmma"], "K12 simple route": fa.dkv_route_launches["simple"],
            "K13 wgmma route": fa.dq_route_launches["wgmma"], "K13 simple route": fa.dq_route_launches["simple"],
            "K11 tf32 route": fa.fwd_route_launches["tf32"],
            "K12 tf32 route": fa.dkv_route_launches["tf32"], "K13 tf32 route": fa.dq_route_launches["tf32"],
            "flash rows": fa.rows_launches, "flash rows fp32": fa.rows_fp32_launches,
            **{f"{kname} hd{hd}": c[hd] for kname, c in (("K11", fa.fwd_head_dim_launches),
                                                          ("K12", fa.dkv_head_dim_launches),
                                                          ("K13", fa.dq_head_dim_launches)) for hd in FLASH_HEAD_DIMS},
            **{f"{kname} template{t}": c[t] for kname, c in (("K11", fa.fwd_template_launches),
                                                              ("K12", fa.dkv_template_launches),
                                                              ("K13", fa.dq_template_launches)) for t in fa.HEAD_DIMS}}


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


def read_counts() -> dict:
    return {k: c.value for k, c in counters().items()}


def serialized_on_cpp(tag, launches, socket_batches) -> None:
    """Every batch served over the socket in a counted run went through the
    C++ serializer (``native.pickle_triples``), once a batch."""
    log(f"[{tag}] pickle_triples calls in the serving-path run: {launches['pickle_triples']} "
        f"(expected {socket_batches}: one a batch served over the socket)")
    if launches["pickle_triples"] != socket_batches:
        raise AssertionError(f"{tag}: pickle_triples ran {launches['pickle_triples']} times for "
                             f"{socket_batches} batches served over the socket")


def bound(flops: float, nbytes: float, peak_flops: float):
    """Least time on the card in ms, and what sets it: the larger of the
    operations over the peak rate for their type and the bytes (each input
    read once, each output written once) over the HBM rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---- seeded inputs ----

def _topics(rng, dim, n_topics):
    import numpy as np

    spectrum = (1.0 / np.sqrt(1.0 + np.arange(dim))).astype(np.float32)
    topics = rng.normal(size=(n_topics, dim)).astype(np.float32) * spectrum
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)
    return topics, spectrum


def _around(rng, topics, spectrum, t):
    """One unit vector around each topic of ``t``."""
    import numpy as np

    e = topics[t] + 0.3 * (rng.normal(size=(len(t), topics.shape[1])).astype(np.float32) * spectrum)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    return e


def topic_embeddings(num_docs, d_view, num_queries, q_view, dim, seed=0, n_topics=256):
    """Clustered, anisotropic unit vectors (``bench.py``'s synthetic corpus),
    plus queries drawn around the same topics, one topic per doc and per
    query.  Returns fp16 doc rows (num_docs * d_view, dim) and fp32 queries
    (num_queries, q_view, dim)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    topics, spectrum = _topics(rng, dim, n_topics)

    def draw(n, views):
        return _around(rng, topics, spectrum, np.repeat(rng.integers(0, n_topics, size=n), views))

    docs = draw(num_docs, d_view).astype(np.float16)
    queries = draw(num_queries, q_view).reshape(num_queries, q_view, dim)
    return docs, queries


def two_topic_queries(num_queries, q_view, dim, seed=0, n_topics=256):
    """Queries over :func:`topic_embeddings`' topics (same ``seed``), each
    about two topics: half its tokens around one, half around the other."""
    import numpy as np

    topics, spectrum = _topics(np.random.default_rng(seed), dim, n_topics)
    rng = np.random.default_rng([seed, 6])
    t = np.repeat(rng.integers(0, n_topics, size=(num_queries, 2)), q_view // 2, axis=1).reshape(-1)
    return _around(rng, topics, spectrum, t).reshape(num_queries, q_view, dim)


def synthetic_chinese(num_docs, num_questions, seed=0, n_topics=64):
    """Topic-structured Chinese passages and questions (a question is drawn
    from its positive passage's topic words)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chars = np.array([chr(c) for c in range(0x4E00, 0x4E00 + 3000)])
    topic_words = [rng.choice(chars, size=40, replace=False) for _ in range(n_topics)]
    puncts = list("，。！？；、")
    doc_topic = rng.integers(0, n_topics, size=num_docs)
    docs = []
    for t in doc_topic:
        n = int(rng.integers(40, 120))
        body = np.where(rng.random(n) < 0.6, rng.choice(topic_words[t], size=n), rng.choice(chars, size=n))
        for j in rng.integers(0, n, size=n // 15):
            body[j] = puncts[int(rng.integers(len(puncts)))]
        docs.append("".join(body) + "。")
    positives = rng.integers(0, num_docs, size=num_questions)
    questions = [
        "".join(rng.choice(topic_words[doc_topic[p]], size=int(rng.integers(6, 14)))) + "？"
        for p in positives
    ]
    return docs, questions, positives


# ---- phase 1: kernels against their plain versions ----

def bf16_limit(*xs):
    """One bf16 ulp (8 significant bits) at the larger magnitude of ``xs``,
    and never below the fp32 limit: two fp32 scores within ``SCORE_ATOL``
    round to bf16 values at most ``SCORE_ATOL + ulp`` apart."""
    import torch

    ax = torch.stack([x.float().abs() for x in xs]).amax(dim=0)
    _, e = torch.frexp(ax.clamp_min(torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(ax), e - 8).clamp_min(SCORE_ATOL)


def time_ms(fn, iters=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3) -> float:
    """``fn``'s time on the card alone: the stream waits behind a spin kernel
    while the host queues every call, so the events see no host gaps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles, longer than the host takes to queue the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=20, warmup=3, reps=5) -> float:
    """``fn``'s time on the host clock a call while the card is kept busy
    behind a spin kernel, so the host never waits for it: the host's own cost
    of issuing ``fn`` (the median of ``reps`` runs of ``iters`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles, longer than the host takes to queue the calls
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t0) * 1e3 / iters)
        torch.cuda.synchronize()
    return sorted(runs)[reps // 2]


def unit_rows_bf16(n_rows, dim, device, seed, chunk=1 << 18):
    """``n_rows`` random unit rows in bf16, drawn on ``device`` in chunks."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    out = torch.empty((n_rows, dim), dtype=torch.bfloat16, device=device)
    for lo in range(0, n_rows, chunk):
        x = torch.randn((min(chunk, n_rows - lo), dim), generator=g, device=device)
        out[lo : lo + x.shape[0]] = x / x.norm(dim=1, keepdim=True)
    return out


def phase_kernels(device, num_docs=20_000, ragged_docs=1_001, big_docs=200_000, seed=SEED):
    """Compare K1/K2 with their plain versions on every route and table
    type; time them, K1 over the int8 table and over ``big_docs`` docs, and
    the cuBLAS product + reduction yardstick.  Returns per-kernel summaries."""
    import numpy as np
    import torch

    from colbert_tpu_torch.ops import flat_scan as fs

    docs, queries = topic_embeddings(num_docs, 16, B, M, H, seed=seed)
    Qm = torch.from_numpy(queries).to(device)
    doclens = np.full(num_docs, 16)
    worst = {"K1": 0.0, "K2": 0.0}

    def check(name, got, want, atol):
        got, want = got.float(), want.float()
        fin = torch.isfinite(want)
        if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(got[~fin], want[~fin]):
            raise AssertionError(f"{name}: -inf pattern differs from the plain version")
        err = (got[fin] - want[fin]).abs()
        lim = atol if not torch.is_tensor(atol) else atol[fin]
        over = err > lim
        bad = int(over.sum())
        log(f"[phase1] {name}: max|d|={float(err.max()):.3e} over {err.numel()} values, {bad} beyond limit")
        if bad:
            pairs = torch.stack([got[fin][over], want[fin][over]], dim=1)[:5].tolist()
            raise AssertionError(f"{name}: {bad} values beyond the limit, e.g. (got, want) {pairs}")
        return float(err.max())

    def routed(label, q, dv):
        """Log the route the plan picks and check that it, and only it, served."""
        route = fs.flat_scan_plan(dv, q.shape[1])
        before = {k: c.value for k, c in fs.route_launches.items()}
        log(f"[phase1] {label}: route {route}")
        return route, before

    def served_by(label, route, before, n):
        got = {k: c.value - before[k] for k, c in fs.route_launches.items()}
        if got != {k: n * (k == route) for k in got}:
            raise AssertionError(f"{label}: route launches {got}, expected {n} on {route}")

    def check_bf16(label, table, q, dv, n_docs):
        s, g = fs.flat_scan_fused(q, table, dv=dv, num_docs=n_docs, score_dtype="bfloat16")
        rs, rg = fs.flat_scan_fused_ref(q, table, dv=dv, num_docs=n_docs, score_dtype="bfloat16")
        e = check(f"{label} K1 stored bf16 (1 ulp, >= 1e-4)", s, rs, bf16_limit(s, rs))
        return max(e, check(f"{label} K1 group max bf16 (1 ulp, >= 1e-4)", g, rg, bf16_limit(g, rg)))

    def run_case(label, table, q, dv, n_docs):
        route, before = routed(label, q, dv)
        k2 = fs.flat_maxsim_scan(q, table, dv=dv)
        k2_ref = fs.flat_maxsim_scan_ref(q, table, dv=dv)
        worst["K2"] = max(worst["K2"], check(f"{label} K2 scores fp32", k2, k2_ref, SCORE_ATOL))
        s, g = fs.flat_scan_fused(q, table, dv=dv, num_docs=n_docs, score_dtype="float32")
        rs, rg = fs.flat_scan_fused_ref(q, table, dv=dv, num_docs=n_docs, score_dtype="float32")
        e1 = check(f"{label} K1 stored fp32", s, rs, SCORE_ATOL)
        e1 = max(e1, check(f"{label} K1 group max", g, rg, SCORE_ATOL))
        ts, tp = fs.select_topk(s, g, group=fs.group_docs(dv), num_docs=n_docs, topk=TOPK)
        want_s, _ = torch.topk(k2_ref[:n_docs].T, min(TOPK, n_docs), dim=1)
        e1 = max(e1, check(f"{label} K1 top-{TOPK} scores", ts, want_s, SCORE_ATOL))
        if not ((tp >= 0) & (tp < n_docs)).all():
            raise AssertionError(f"{label}: top-k returned a pad doc")
        check_bf16(label, table, q, dv, n_docs)
        served_by(label, route, before, 3)
        worst["K1"] = max(worst["K1"], e1)
        return route

    def timed(fn, ref, ref_iters=5):
        return time_ms(fn), time_ms(ref, iters=ref_iters)

    table, _, dv = fs.build_flat_table(docs, doclens, dtype="bfloat16")
    table = table.to(device)
    label = f"{num_docs} docs bf16"
    routes = {"K1": run_case(label, table, Qm, dv, num_docs)}
    routes["K2"] = routes["K1"]
    times = {
        "K1": timed(lambda: fs.flat_scan_fused(Qm, table, dv=dv, num_docs=num_docs, score_dtype="float32"),
                    lambda: fs.flat_scan_fused_ref(Qm, table, dv=dv, num_docs=num_docs, score_dtype="float32")),
        "K2": timed(lambda: fs.flat_maxsim_scan(Qm, table, dv=dv),
                    lambda: fs.flat_maxsim_scan_ref(Qm, table, dv=dv)),
    }
    # yardstick, never called by the port: cuBLAS's bf16 product, then the view reduction
    qb = Qm.reshape(B * M, H).to(torch.bfloat16)

    def cublas_maxsim():
        return (table @ qb.T).view(-1, dv, B, M).amax(dim=1).float().sum(dim=-1)

    err = float((cublas_maxsim() - fs.flat_maxsim_scan_ref(Qm, table, dv=dv)).abs().max())
    times["cuBLAS"] = (time_ms(cublas_maxsim), None)
    log(f"[phase1] yardstick (not in the port): torch.matmul bf16 ({table.shape[0]} x {H}) @ ({H} x {B * M}) "
        f"-> bf16, amax over 16 rows, sum over 16 views: {times['cuBLAS'][0]:.3f} ms; max|d| vs the plain "
        f"version {err:.3e} (its product is rounded to bf16)")
    del table

    t8, inv, dv = fs.build_flat_table(docs, doclens, dtype="int8")
    t8, Q8 = t8.to(device), Qm * inv.to(device)
    routes["K1 int8"] = run_case(f"{num_docs} docs int8", t8, Q8, dv, num_docs)
    times["K1 int8"] = timed(
        lambda: fs.flat_scan_fused(Q8, t8, dv=dv, num_docs=num_docs, score_dtype="float32"),
        lambda: fs.flat_scan_fused_ref(Q8, t8, dv=dv, num_docs=num_docs, score_dtype="float32"))
    del t8, Q8

    # ROADMAP's second flat operating point: 200,000 docs x 16 rows bf16, bf16 stored scores
    docs_pad = -(-big_docs * 16 // fs.pick_rows_block(16, 2)) * fs.pick_rows_block(16, 2) // 16
    tb = unit_rows_bf16(docs_pad * 16, H, device, seed)
    tb[big_docs * 16 :] = 0
    label = f"{big_docs} docs bf16"
    route, before = routed(label, Qm, 16)
    check_bf16(label, tb, Qm, 16, big_docs)
    served_by(label, route, before, 1)
    routes["K1 200k bf16"] = route
    times["K1 200k bf16"] = timed(
        lambda: fs.flat_scan_fused(Qm, tb, dv=16, num_docs=big_docs, score_dtype="bfloat16"),
        lambda: fs.flat_scan_fused_ref(Qm, tb, dv=16, num_docs=big_docs, score_dtype="bfloat16"),
        ref_iters=2)
    del tb

    rdocs, rq = topic_embeddings(ragged_docs, 37, B, M, H, seed=seed + 1)
    tr, _, dv = fs.build_flat_table(rdocs, np.full(ragged_docs, 37), dtype="bfloat16")
    if (tr.shape[0] // dv) % fs.group_docs(dv) == 0:
        raise AssertionError("ragged case does not end inside a group")
    run_case(f"{ragged_docs} docs dv=37", tr.to(device), torch.from_numpy(rq).to(device), dv, ragged_docs)

    flops = {k: 2.0 * B * M * n * 16 * H for k, n in
             (("K1", num_docs), ("K2", num_docs), ("K1 int8", num_docs), ("K1 200k bf16", big_docs),
              ("cuBLAS", num_docs))}
    share = {k: flops[k] / PEAK_BF16_FLOPS * 1e3 / ms for k, (ms, _) in times.items()}
    for k, (ms, plain) in times.items():
        n = big_docs if k == "K1 200k bf16" else num_docs
        plain_txt = f", plain {plain:.3f} ms" if plain is not None else ""
        log(f"[phase1] {k} at {n} docs x 16 rows, B={B}: {ms:.3f} ms = {flops[k] / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * share[k]:.1f}% of the 989 TFLOP/s bf16 peak{plain_txt}"
            f"{'' if k == 'cuBLAS' else ' [route ' + routes[k] + ']'}")
    return worst, times, share, routes


# ---- phase 1b: K1/K2 and K4 at ColBERT dims that are not multiples of 16 ----

ODD_DIMS = (312, 100)  # TinyBERT-4L-zh's hidden (dim = hidden) and a bf16 row no tensor map describes


def phase_kernel_dims(device, num_docs=20_000, seed=SEED):
    """K1 (fp32 stored scores) and K2 at phase 1's shape (144 queries x 16
    views, ``num_docs`` docs x 16 rows) at the hidden dims of ``ODD_DIMS``:
    bf16 tables at 312 (a 624-byte row: the tensor map) and 100 (200 bytes:
    the producers' copies), an int8 table at 312 (312 bytes: the copies),
    each against its plain version (phase 1's limits) on route "wgmma",
    timed as phase 1 times them (CUDA events, 20 launches after 3), beside
    the bound (bf16 operations over 989 TFLOP/s or the bytes over 3.35 TB/s;
    the int8 table's products run in bf16 too), the plain version and, for
    bf16, phase 1's cuBLAS yardstick (product + amax + sum).  Then K1/K2 and
    K4 at dim 128 on route "wgmma", against their plain versions: no other
    phase drives that width through the wgmma routes now that phase 15
    serves at 312.  Returns the timings by name."""
    import numpy as np
    import torch

    from colbert_tpu_torch.ops import flat_scan as fs, rerank as rr

    out = {}

    def check(name, got, want, atol):
        got, want = got.float(), want.float()
        if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
            raise AssertionError(f"[phase1b] {name}: -inf pattern differs from the plain version")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max())
        lim = atol if not torch.is_tensor(atol) else atol[fin]
        if bool(((got[fin] - want[fin]).abs() > lim).any()):
            raise AssertionError(f"[phase1b] {name}: max|d| {err:.3e} beyond the limit")
        return err

    def on_route(name, route, fn):
        before = {k: c.value for k, c in route_counters().items()}
        res = fn()
        torch.cuda.synchronize()
        got = {k: c.value - before[k] for k, c in route_counters().items()}
        if got != {k: int(k == route) for k in got}:
            raise AssertionError(f"[phase1b] {name}: route launches {got}, expected one on {route}")
        return res

    def route_counters():
        return {**{f"flat {k}": c for k, c in fs.route_launches.items()},
                **{f"rerank {k}": c for k, c in rr.route_launches.items()}}

    for h, dtype in ((312, "bfloat16"), (312, "int8"), (100, "bfloat16"), (128, "bfloat16")):
        docs, queries = topic_embeddings(num_docs if h != 128 else 2_000, 16, B, M, h, seed=seed + h)
        n = len(docs) // 16
        table, inv, dv = fs.build_flat_table(docs, np.full(n, 16), dtype=dtype)
        table = table.to(device)
        Qm = torch.from_numpy(queries).to(device)
        if inv is not None:
            Qm = Qm * inv.to(device)
        tag = f"h {h} {dtype}"
        k2 = on_route(f"K2 {tag}", "flat wgmma", lambda: fs.flat_maxsim_scan(Qm, table, dv=dv))
        k2_ref = fs.flat_maxsim_scan_ref(Qm, table, dv=dv)
        e2 = check(f"K2 {tag}", k2, k2_ref, SCORE_ATOL)
        s, g = on_route(f"K1 {tag}", "flat wgmma",
                        lambda: fs.flat_scan_fused(Qm, table, dv=dv, num_docs=n, score_dtype="float32"))
        rs, rg = fs.flat_scan_fused_ref(Qm, table, dv=dv, num_docs=n, score_dtype="float32")
        e1 = max(check(f"K1 {tag} stored fp32", s, rs, SCORE_ATOL), check(f"K1 {tag} group max", g, rg, SCORE_ATOL))
        s, g = fs.flat_scan_fused(Qm, table, dv=dv, num_docs=n, score_dtype="bfloat16")
        rs, rg = fs.flat_scan_fused_ref(Qm, table, dv=dv, num_docs=n, score_dtype="bfloat16")
        e1_bf16 = check(f"K1 {tag} stored bf16 (1 ulp, >= 1e-4)", s, rs, bf16_limit(s, rs))
        del k2, k2_ref, s, g, rs, rg
        copies = (h * table.element_size()) % 16 != 0
        log(f"[phase1b] K1/K2 {tag} ({n} docs x 16 rows, B={B}): max|d| K2 {e2:.3e}, K1 {e1:.3e} (limit "
            f"{SCORE_ATOL}), K1's bf16 stored scores {e1_bf16:.3e} (1 ulp) [route wgmma, table by "
            f"{'copies' if copies else 'tensor map'}]")
        if h == 128:  # K4 at dim 128 on route "wgmma" over this table, random candidates
            cand = torch.randint(-1, n, (B, 512), dtype=torch.int32, device=device,
                                 generator=torch.Generator(device).manual_seed(seed))
            got = on_route("K4 dim 128", "rerank wgmma", lambda: rr.maxsim_rerank_uniform(cand, Qm, table, dv=16))
            e4 = check("K4 dim 128", got, rr.maxsim_rerank_uniform_ref(cand, Qm, table, dv=16), SCORE_ATOL)
            log(f"[phase1b] K4 dim 128: {B} x 512 candidates over {n} docs x 16 rows: max|d| {e4:.3e} "
                f"(limit {SCORE_ATOL}) [route wgmma]")
            continue
        flops = 2.0 * B * M * n * 16 * h
        nbytes = table.numel() * table.element_size() + Qm.numel() * 4 + n * B * 4
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        r = {"h": h, "dtype": dtype, "docs": n, "table_by": "copies" if copies else "tensor map",
             "K1_max_abs_err": e1, "K1_bf16_max_abs_err": e1_bf16, "K2_max_abs_err": e2, "bound_ms": b_ms,
             "bound_by": b_by,
             "K1_ms": time_ms(lambda: fs.flat_scan_fused(Qm, table, dv=dv, num_docs=n, score_dtype="float32")),
             "K2_ms": time_ms(lambda: fs.flat_maxsim_scan(Qm, table, dv=dv)),
             "K1_plain_ms": time_ms(lambda: fs.flat_scan_fused_ref(Qm, table, dv=dv, num_docs=n,
                                                                   score_dtype="float32"), iters=5),
             "K2_plain_ms": time_ms(lambda: fs.flat_maxsim_scan_ref(Qm, table, dv=dv), iters=5),
             "cublas_ms": None}
        if dtype == "bfloat16":  # phase 1's yardstick, never called by the port
            qb = Qm.reshape(B * M, h).to(torch.bfloat16)
            r["cublas_ms"] = time_ms(lambda: (table @ qb.T).view(-1, dv, B, M).amax(dim=1).float().sum(dim=-1))
        log(f"[phase1b] {tag}: K1 {r['K1_ms']:.3f} ms, K2 {r['K2_ms']:.3f} ms = "
            f"{100 * b_ms / r['K1_ms']:.1f}% / {100 * b_ms / r['K2_ms']:.1f}% of the bound {b_ms:.4f} ms ({b_by}: "
            f"{flops:.3e} FLOP); plain K1 {r['K1_plain_ms']:.3f} ms, K2 {r['K2_plain_ms']:.3f} ms"
            + (f"; cuBLAS product + amax + sum {r['cublas_ms']:.3f} ms" if r["cublas_ms"] is not None else ""))
        out[tag] = r
        del table, Qm
    return out


# ---- phase 2: the slice through the CLI ----

def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_server(cfg, serve_err, timeout_s=600) -> None:
    """Until ``serve`` accepts connections; raises if its thread failed."""
    from multiprocessing.connection import Client

    deadline = time.time() + timeout_s
    while True:
        if serve_err:
            raise RuntimeError(f"serve failed: {serve_err[0]!r}")
        try:
            Client((cfg.serve.host, cfg.serve.port), authkey=cfg.serve.authkey.encode()).close()
            return
        except ConnectionRefusedError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def check_flat_answers(requests, answer_sets, searcher, docs):
    """Each served answer of each request (``answer_sets[i]``: the answers to
    ``requests[i]``): TOPK valid, descending triples whose texts are their
    passages and whose scores equal the plain version's top-TOPK over the
    searcher's table and query encodings.  Returns the largest score
    difference and the mean pid recall (information: near ties)."""
    import numpy as np
    import torch

    from colbert_tpu_torch.ops import flat_scan as fs

    num_docs = len(docs)
    worst, recall = 0.0, []
    table, dv = searcher.emb_table, searcher.flat_dv
    for qs, ans_sets in zip(requests, answer_sets):
        enc = searcher.tok.encode_queries(qs)
        Qm = searcher.encode_queries(enc.input_ids, enc.attention_mask, enc.active_mask)
        full = fs.flat_maxsim_scan_ref(Qm, table, dv=dv)[:num_docs].T    # (B, num_docs)
        want_s, want_p = torch.topk(full, TOPK, dim=1)
        full, want_s, want_p = full.cpu().numpy(), want_s.cpu().numpy(), want_p.cpu().numpy()
        for ans in ans_sets:
            if len(ans) != len(qs):
                raise AssertionError(f"{len(ans)} answers for {len(qs)} questions")
            for b, row in enumerate(ans):
                pids = np.array([p for p, _, _ in row])
                scores = np.array([s for _, s, _ in row], np.float32)
                if len(row) != TOPK or not ((pids >= 0) & (pids < num_docs)).all():
                    raise AssertionError(f"question {b}: {len(row)} triples or invalid pids")
                if any(t != docs[p] for p, _, t in row):
                    raise AssertionError(f"question {b}: a triple's text is not its passage")
                if (np.diff(scores) > 0).any():
                    raise AssertionError(f"question {b}: scores not descending")
                err = max(np.abs(scores - want_s[b]).max(), np.abs(scores - full[b, pids]).max())
                worst = max(worst, float(err))
                recall.append(len(set(pids.tolist()) & set(want_p[b].tolist())) / TOPK)
    return worst, float(np.mean(recall))


def encoded_corpus(device, workdir: Path, label: str, num_docs=20_000, model_kw=None, tok_kw=None,
                   n_requests=3, seed=SEED, tag="phase2", index_kw=None):
    """Phase 2's set-up: a synthetic Chinese corpus of ``num_docs`` passages,
    ``n_requests`` x B questions and 2 x B eval questions, the flat config
    (``index_kw`` over the index section's fields), a seeded model saved as
    ``pytorch.bin``, and the corpus encoded through the CLI's ``encode``."""
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig, IndexConfig, ModelConfig, ServeConfig, TokenizerConfig
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.models.convert import reference_state_dict
    from colbert_tpu_torch.tokenization.vocab import build_vocab, write_vocab
    from colbert_tpu_torch.utils.io import dump_json

    n_eval = 2 * B
    docs, questions, positives = synthetic_chinese(num_docs, n_requests * B + n_eval, seed=seed)
    corpus_path, eval_path = workdir / "corpus.json", workdir / "eval.json"
    dump_json(docs, corpus_path)
    eval_q = questions[n_requests * B :]
    dump_json([{"question": q, "positive_ctxs": [docs[p]]}
               for q, p in zip(eval_q, positives[n_requests * B :])], eval_path)
    model_cfg = ModelConfig(**(model_kw or {}))
    vocab_path = write_vocab(build_vocab(docs + questions, max_size=model_cfg.vocab_size),
                             workdir / "vocab.txt")

    cfg = ColbertConfig(
        model=model_cfg,
        tokenizer=TokenizerConfig(vocab_path=str(vocab_path), **(tok_kw or {})),
        index=IndexConfig(index_path=str(workdir / "index"), num_parts=4, **(index_kw or {})),
        serve=ServeConfig(mode="flat", topk=TOPK, query_batch_size=B, port=free_port()),
    )
    conf_path = workdir / "conf.yaml"
    cfg.to_yaml(conf_path)
    model = ColbertModel(cfg.model, cfg.multiview)
    model.init_weights(torch.Generator().manual_seed(seed))
    bin_path = workdir / "pytorch.bin"
    torch.save(reference_state_dict(model.state_dict(), cfg.model), bin_path)
    log(f"[{tag}] model hidden={cfg.model.hidden_size} layers={cfg.model.num_layers} "
        f"heads={cfg.model.num_heads} ffn={cfg.model.intermediate_size} vocab={cfg.model.vocab_size} "
        f"dim={cfg.model.dim} {cfg.model.dtype}; vocab file {len(open(vocab_path, encoding='utf-8').read().split())} tokens")
    common = ["--config", str(conf_path), "--pretrain", str(bin_path), "--device", str(device)]

    t0 = time.perf_counter()
    cli.main(["encode", "--corpus", str(corpus_path), *common])
    if device.type == "cuda":
        torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    log(f"[{tag}] encode: {num_docs} docs in {enc_s:.2f} s = {num_docs / enc_s:.1f} docs/s "
        f"(doc_maxlen {cfg.tokenizer.doc_maxlen}, host tokenization included) [{label}]")
    return {"cfg": cfg, "model": model, "docs": docs, "questions": questions, "positives": positives,
            "corpus_path": corpus_path, "eval_path": eval_path, "common": common, "n_eval": n_eval,
            "requests": [questions[i * B : (i + 1) * B] for i in range(n_requests)], "enc_s": enc_s}


def unfused_searcher(device, cfg, model):
    """The flat searcher over ``cfg``'s table on the unfused (K2) route, with a copy of ``model``."""
    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.ranking.searcher import ColbertSearcher

    cfg_k2 = ColbertConfig.from_dict(cfg.to_dict())
    cfg_k2.serve.flat_fused_topk = False
    oracle_model = ColbertModel(cfg.model, cfg.multiview)
    oracle_model.load_state_dict(model.state_dict())
    return ColbertSearcher(cfg_k2, cli._tokenizer(cfg), oracle_model, IndexStorage(cfg.index.index_path),
                           device=device)


def phase_slice(device, workdir: Path, label: str, num_docs=20_000, model_kw=None,
                tok_kw=None, n_requests=3, seed=SEED):
    from colbert_tpu_torch import cli
    from colbert_tpu_torch.ops import flat_scan as fs
    from colbert_tpu_torch.serving.server import RetrievalClient, RetrievalService

    corpus = encoded_corpus(device, workdir, label, num_docs, model_kw, tok_kw, n_requests, seed)
    cfg, docs, questions, positives = corpus["cfg"], corpus["docs"], corpus["questions"], corpus["positives"]
    corpus_path, eval_path, common, n_eval = (corpus[k] for k in ("corpus_path", "eval_path", "common", "n_eval"))
    enc_s = corpus["enc_s"]

    serve_err = []

    def serve():
        try:
            cli.main(["serve", "--corpus", str(corpus_path), *common])
        except BaseException as e:  # noqa: BLE001 -- reported by the main thread
            serve_err.append(e)

    server = threading.Thread(target=serve, daemon=True, name="serve")
    server.start()
    client = RetrievalClient(cfg.serve.host, cfg.serve.port, cfg.serve.authkey.encode())
    wait_for_server(cfg, serve_err)

    # the oracle side: the same table and model, the unfused (K2) route
    k2_searcher = unfused_searcher(device, cfg, corpus["model"])
    k2_service = RetrievalService(k2_searcher, docs, k2_searcher.cfg)
    requests = corpus["requests"]
    k2_service.retrieve(requests[0][:1], topk=TOPK)  # warm-up outside the counted run

    # ---- the counted serving-path run ----
    reset_counts()
    answers, lat = [], []
    for qs in requests:
        t0 = time.perf_counter()
        answers.append(client.retrieve(qs, topk=TOPK))
        lat.append(time.perf_counter() - t0)
    cli.main(["evaluate", "--eval-data", str(eval_path), "--remote", "--topk", str(TOPK), *common])
    k2_answers = [k2_service.retrieve(qs, topk=TOPK) for qs in requests]
    launches = read_counts()
    # ----

    client.shutdown()
    server.join(timeout=60)
    if server.is_alive() or serve_err:
        raise RuntimeError(f"server did not stop cleanly: {serve_err}")
    for i, dt in enumerate(lat):
        log(f"[phase2] request {i}: {B} questions top-{TOPK} in {dt * 1e3:.1f} ms = {B / dt:.1f} QPS "
            f"over the socket (first request includes warm-up) [{label}]")
    served_batches = n_requests + -(-n_eval // B)
    log(f"[phase2] launches in the serving-path run: {launches} (K1 expected {served_batches}, "
        f"K2 expected {n_requests})")
    if launches["K1"] != served_batches or launches["K2"] != n_requests:
        raise AssertionError(f"kernel launches {launches} do not match the served batches")
    serialized_on_cpp("phase2", launches, served_batches)
    want_route = fs.flat_scan_plan(k2_searcher.flat_dv, M)
    if launches[f"K1/K2 {want_route} route"] != served_batches + n_requests or \
            launches["K1/K2 staged route" if want_route == "wgmma" else "K1/K2 wgmma route"]:
        raise AssertionError(f"route launches {launches} do not all take the {want_route} route")

    # ---- answers against the plain version on the same table and encodings ----
    worst, recall = check_flat_answers(requests, list(zip(answers, k2_answers)), k2_searcher, docs)
    log(f"[phase2] served top-{TOPK} scores vs the plain version: max|d|={worst:.3e} "
        f"(limit {SCORE_ATOL}); pid recall@{TOPK} {recall:.4f} (information only: "
        f"random-init views are near ties)")
    if worst > SCORE_ATOL:
        raise AssertionError(f"served scores differ from the plain version by {worst}")
    sharded_flat = phase_sharded_flat(device, cfg, docs, requests, k2_searcher, label)
    ann_launches, k7_deep = phase_ann_cli(device, workdir, cfg, common, corpus_path, eval_path, docs,
                                          requests, k2_searcher, n_eval, label)
    codec_launches = phase_codecs_cli(device, workdir, cfg, common, corpus_path, eval_path, docs,
                                      requests, k2_searcher, n_eval)
    ragged_cli = phase_ragged_cli(device, workdir, cfg, common, eval_path, docs, requests, n_eval, label)
    ctx = {"ragged_cli": ragged_cli, "sharded_flat": sharded_flat, "cfg": cfg, "common": common, "corpus_path": corpus_path, "docs": docs,
           "questions": questions,
           "positives": positives, "free": list(range(n_requests * B, len(questions))),
           "encode_docs_s": num_docs / enc_s}
    return launches, worst, ann_launches, codec_launches, k7_deep, ctx


# ---- phase 3: the training kernels against their plain versions ----

EVAL_Q, EVAL_D = 34, 340          # eval step at the reference batch: 34 questions x (2 + 8) docs
K9_SHAPE = (68, 12, 384, 384)     # attention probabilities of a training step, bf16
K9_THR = 26                       # round(0.1 * 256)
CE_MODEL = dict(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096)  # configs/dureader.yaml:11-17
CE_BATCH, CE_NEG = 4, 4           # ce_train: 4 questions x (1 + 4 negatives) = 20 sequences a step
# where K9 runs in a CE step: the attention probabilities (the fp32 softmax is
# cast to the bf16 model dtype before its dropout) and the hidden states;
# phase 7 records the inputs of every dropout site and holds them to these
K9_CE_SITES = {"probabilities": ((CE_BATCH * (1 + CE_NEG), 16, 384, 384), "bfloat16"),
               "hidden states": ((CE_BATCH * (1 + CE_NEG), 384, 1024), "bfloat16")}


K9_KEYS = ("shape", "dtype", "max_abs_err", "ms", "simple_ms", "plain_ms", "bound_ms", "bound_by", "byte_bound_ms",
           "int_bound_ms", "issue_bound_ms", "library_ms", "no_graph_ms", "library_no_graph_ms", "device_ms",
           "simple_device_ms", "library_device_ms", "copy_device_ms", "cold_buffers", "hot_device_ms",
           "hot_simple_device_ms", "hot_library_device_ms", "hot_copy_device_ms")
INT32_LANES_PER_SM = 64    # Hopper's INT32 units an SM: the pipe of LOP3, IADD3, PRMT, SHF, ISETP, ...
ISSUE_LANES_PER_SM = 128   # 4 warp schedulers an SM, one warp instruction a clock each
# opcodes of the INT32 pipe (IMAD issues to the FMA pipe, the compiler's way to relieve this one)
SASS_INT_OPS = {"LOP3", "LOP", "IADD3", "IADD", "PRMT", "SHF", "SHL", "SHR", "ISETP", "ICMP", "SEL", "LEA", "MOV",
                "IABS", "IMNMX", "VIMNMX", "BMSK", "SGXT", "FLO", "POPC", "BREV", "PLOP3", "P2R", "R2P", "BFE", "BFI"}


def sass_loop_mix(so_path, name_parts, elems_per_vector):
    """Static instruction mix of a kernel's vector loop in a built library
    (``cuobjdump -sass``): of the kernel whose mangled name holds every one
    of ``name_parts``, the backward branch's range with the most 16-byte
    global loads, per element (``elems_per_vector`` elements a load).
    Returns the instructions of the INT32 pipe, the IMADs and all
    instructions per element, and the loop's opcodes."""
    from collections import Counter

    from colbert_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(so_path)], capture_output=True, text=True, timeout=300,
                         check=True).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", out)[1:] if all(p in f.split("\n", 1)[0] for p in name_parts)]
    if len(funcs) != 1:
        raise RuntimeError(f"{len(funcs)} kernels in {so_path} match {name_parts}")
    insts = [(int(a, 16), op, args) for a, op, args in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", funcs[0])]
    loops = []
    for addr, op, args in insts:
        target = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if target and int(target.group(1), 16) <= addr:
            body = [o for a, o, _ in insts if int(target.group(1), 16) <= a <= addr and o != "NOP"]
            loops.append((sum(o.startswith("LDG") and ".128" in o for o in body), -len(body), body))
    if not loops or max(loops)[0] == 0:
        raise RuntimeError(f"no loop of 16-byte loads in {funcs[0].split(chr(10), 1)[0].strip()}")
    vectors, _, body = max(loops)
    elems = vectors * elems_per_vector
    ops = Counter(o.split(".")[0] for o in body)
    n_int = sum(c for o, c in ops.items() if o in SASS_INT_OPS)
    return {"function": funcs[0].split("\n", 1)[0].strip(), "loop_instructions": len(body), "loop_elements": elems,
            "int_per_element": n_int / elems, "imad_per_element": ops["IMAD"] / elems,
            "all_per_element": len(body) / elems, "opcodes": dict(ops.most_common())}


@functools.lru_cache(maxsize=None)
def k9_mix(dtype, thr=K9_THR):
    """:func:`sass_loop_mix` of route "packed"'s kernel for ``dtype`` and
    ``thr``, its way for tensors that fit in L2 (the other way's loop differs
    only in its loads' and stores' cache hints)."""
    import torch

    from colbert_tpu_torch.ops import dropout as dr

    name = {torch.float32: "If", torch.bfloat16: "I13__nv_bfloat16", torch.float16: "I6__half"}[dtype]
    # template arguments <T, HI, STREAM = false, SLICED = false>: the contiguous kernel
    return sass_loop_mix(dr._kernel_lib()._name, ("packed_kernel", f"{name}Lb{int(thr >= 128)}ELb0ELb0E"),
                         16 // torch.empty((), dtype=dtype).element_size())


def k9_routes_equal(x, seed64, thr, what):
    """Route "packed" through ``hw_dropout`` (forward and backward, both
    launches on that route) and route "simple" through ``_launch`` against
    the plain version, bit for bit; returns the largest |difference|."""
    import torch

    from colbert_tpu_torch.ops import dropout as dr

    xg = x.detach().requires_grad_(True)
    packed = dr.route_launches["packed"].value
    y = dr.hw_dropout(xg, seed64, thr)
    g = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, xg, g)
    y = y.detach()
    want_y, want_dx = dr.hw_dropout_ref(x, seed64, thr), dr.hw_dropout_ref(g, seed64, thr)
    simple_y, simple_dx = dr._launch(x, seed64, thr, route="simple"), dr._launch(g, seed64, thr, route="simple")
    torch.cuda.synchronize()
    if dr.route_launches["packed"].value != packed + 2:
        raise AssertionError(f"K9 {what}: the forward and backward did not both launch route packed")
    for name, got, want in (("packed forward", y, want_y), ("packed backward", dx, want_dx),
                            ("simple forward", simple_y, want_y), ("simple backward", simple_dx, want_dx)):
        if not dr.same_bits(got, want):
            raise AssertionError(f"K9 {what}: route {name} differs from the plain version in "
                                 f"{int((got.view(-1) != want.view(-1)).sum())} elements")
    fin = want_y.isfinite() & y.isfinite()
    return max(float((y - want_y)[fin].abs().max()), float((dx - want_dx)[want_dx.isfinite()].abs().max()))


def k9_special_values(device, seed64):
    """Both routes on subnormals, +-0, +-inf and NaN in each dtype, bit-equal to
    the plain version (NaN by position): the packed multiply neither flushes
    subnormals nor rounds otherwise than to nearest."""
    import torch

    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        fi = torch.finfo(dtype)
        special = torch.tensor([fi.tiny / 2, -fi.tiny / 3, fi.tiny / 64, fi.tiny, -fi.tiny, 0.0, -0.0, float("inf"),
                                -float("inf"), float("nan"), fi.max, -fi.max], dtype=torch.float64)
        x = torch.randn(4099, dtype=torch.float64)
        x[::7] = special.repeat(-(-x[::7].numel() // special.numel()))[: x[::7].numel()]
        for thr in (26, 200):
            k9_routes_equal(x.to(dtype).to(device), seed64, thr, f"special values {dtype} thr {thr}")
    log("[phase3] K9 special values (subnormals, +-0, +-inf, NaN, +-max) in bf16, fp16, fp32, thr 26 and 200: "
        "both routes bit-equal to the plain version, forward and backward")


def in_turn(fn, xs):
    """A call of ``fn(x, i)`` on each ``x = xs[i]`` in turn, each output held
    until its input comes round again: with inputs and outputs well past the
    card's L2, no call finds its input or its output there."""
    outs, turn = [None] * len(xs), itertools.count()

    def call():
        i = next(turn) % len(xs)
        outs[i] = fn(xs[i], i)
    return call


def k9_check(device, shape, dtype, seed64, what, mix, clock_hz):
    """K9 on both routes, forward and backward, against the plain version's
    Philox stream (bit-equal), its keep fraction, and its times.  On the host
    clock (``time_ms``, a call): route "packed" through ``hw_dropout`` and
    ``F.dropout`` on an input that records a graph, as the models call them
    (in turns), beside each without a graph, route "simple"'s launch and the
    plain version.  On the card alone (``device_ms``): route "packed" and
    route "simple" in turns, ``F.dropout`` and the ``copy_`` of the same
    bytes (the ceiling of a read-once, write-once pass), each cold (over
    copies of the input and outputs held ``in_turn``, twice the L2 and more,
    so every byte comes from and goes to device memory) and hot (the same
    input each call, as a tensor just written may sit in L2); and the bound
    of the cold time: the larger of the bytes (each element read once,
    written once) over the HBM rate, route "packed"'s INT32-pipe
    instructions (``mix``, from its SASS) over the INT32 lanes, and all its
    instructions over the schedulers' issue rate, at ``clock_hz``."""
    import torch
    import torch.nn.functional as F

    from colbert_tpu_torch.ops import dropout as dr

    x = torch.randn(shape, device=device, dtype=dtype)
    err = k9_routes_equal(x, seed64, K9_THR, f"{shape}")
    y = dr.hw_dropout(x, seed64, K9_THR)
    nz = x != 0
    frac = float(((y != 0) & nz).sum()) / float(nz.sum())
    p = (256 - K9_THR) / 256
    sigma = (p * (1 - p) / float(nz.sum())) ** 0.5
    name = str(dtype).replace("torch.", "")
    log(f"[phase3] K9 {shape} {name} thr {K9_THR} ({what}): routes packed and simple, forward and backward, "
        f"bit-equal to the plain version; keep fraction {frac:.6f} vs {p:.6f} ({(frac - p) / sigma:+.2f} sigma)")
    if abs(frac - p) > 5 * sigma:
        raise AssertionError(f"K9 keep fraction {frac} is {abs(frac - p) / sigma:.1f} sigma from {p}")
    del y, nz
    xg = x.detach().requires_grad_(True)
    host = [(r, time_ms(fn)) for r, fn in (
        ("packed", lambda: dr.hw_dropout(xg, seed64, K9_THR)), ("library", lambda: F.dropout(xg, K9_THR / 256, True)),
        ("library", lambda: F.dropout(xg, K9_THR / 256, True)), ("packed", lambda: dr.hw_dropout(xg, seed64, K9_THR)))]
    out = {"shape": list(shape), "dtype": name, "max_abs_err": err,
           "ms": sum(t for r, t in host if r == "packed") / 2,
           "library_ms": sum(t for r, t in host if r == "library") / 2,
           "no_graph_ms": time_ms(lambda: dr.hw_dropout(x, seed64, K9_THR)),
           "library_no_graph_ms": time_ms(lambda: F.dropout(x, K9_THR / 256, True)),
           "simple_ms": time_ms(lambda: dr._launch(x, seed64, K9_THR, route="simple")),
           "plain_ms": time_ms(lambda: dr.hw_dropout_ref(x, seed64, K9_THR), iters=5)}
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    xs = [x] + [x.clone() for _ in range(-(-2 * l2 // (x.numel() * x.element_size())))]
    copies = [torch.empty_like(x) for _ in xs]
    calls = {"packed": lambda t, i: dr.hw_dropout(t, seed64, K9_THR),
             "simple": lambda t, i: dr._launch(t, seed64, K9_THR, route="simple"),
             "library": lambda t, i: F.dropout(t, K9_THR / 256, True), "copy": lambda t, i: copies[i].copy_(t)}
    turns = [(r, device_ms(in_turn(calls[r], xs))) for r in ("packed", "simple", "simple", "packed")]
    out.update({"device_ms": sum(t for r, t in turns if r == "packed") / 2,
                "simple_device_ms": sum(t for r, t in turns if r == "simple") / 2,
                "library_device_ms": device_ms(in_turn(calls["library"], xs)),
                "copy_device_ms": device_ms(in_turn(calls["copy"], xs)), "cold_buffers": len(xs)})
    out.update({f"hot_{'' if r == 'packed' else r + '_'}device_ms": device_ms(lambda f=f: f(x, 0))
                for r, f in calls.items()})
    del xs, copies
    n, nbytes = x.numel(), 2.0 * x.numel() * x.element_size()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out["byte_bound_ms"] = nbytes / PEAK_HBM_BYTES * 1e3
    out["int_bound_ms"] = n * mix["int_per_element"] / (INT32_LANES_PER_SM * sms * clock_hz) * 1e3
    out["issue_bound_ms"] = n * mix["all_per_element"] / (ISSUE_LANES_PER_SM * sms * clock_hz) * 1e3
    out["bound_ms"] = max(out["byte_bound_ms"], out["int_bound_ms"], out["issue_bound_ms"])
    out["bound_by"] = "bytes" if out["bound_ms"] == out["byte_bound_ms"] else "operations"
    log(f"[phase3] K9 at {shape} {name}, host clock a call, input recording a graph as the models call it: "
        f"route packed {out['ms']:.4f} ms, F.dropout {out['library_ms']:.4f} ms (K9 "
        f"{'at or below' if out['ms'] <= out['library_ms'] else 'above'} it); without a graph, an aside: route "
        f"packed {out['no_graph_ms']:.4f}, F.dropout {out['library_no_graph_ms']:.4f}; route simple's launch "
        f"{out['simple_ms']:.4f}, plain {out['plain_ms']:.3f} ms")
    log(f"[phase3] K9 at {shape} {name}, on the card alone, cold (every call on the next of "
        f"{out['cold_buffers']} copies, {out['cold_buffers'] * nbytes / 1e6:.0f} MB against {l2 / 1e6:.0f} MB of L2): route packed "
        f"{out['device_ms']:.4f} ms, route simple {out['simple_device_ms']:.4f} ms, F.dropout "
        f"{out['library_device_ms']:.4f} ms, copy_ of the same bytes {out['copy_device_ms']:.4f} ms; hot (the same "
        f"input each call, an aside): {out['hot_device_ms']:.4f}, {out['hot_simple_device_ms']:.4f}, "
        f"{out['hot_library_device_ms']:.4f}, {out['hot_copy_device_ms']:.4f}; bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}: {nbytes / 1e6:.1f} MB read and written at {PEAK_HBM_BYTES / 1e12:.2f} TB/s "
        f"{out['byte_bound_ms']:.4f} ms; {mix['int_per_element']:.3f} INT32-pipe instructions an element at "
        f"{INT32_LANES_PER_SM} lanes x {sms} SMs x {clock_hz / 1e9:.2f} GHz {out['int_bound_ms']:.4f} ms; "
        f"{mix['all_per_element']:.3f} instructions an element at {ISSUE_LANES_PER_SM} issue lanes an SM "
        f"{out['issue_bound_ms']:.4f} ms); route packed cold at {out['bound_ms'] / out['device_ms']:.1%} of it")
    return out


def k9_on_packed(launches, what):
    if launches["K9 packed route"] != launches["K9"] or launches["K9 simple route"]:
        raise AssertionError(f"K9 in {what}: {launches['K9']} launches, {launches['K9 packed route']} on route "
                             f"packed, {launches['K9 simple route']} on route simple; expected all on packed")


def phase_train_kernels(device, eval_q=EVAL_Q, eval_d=EVAL_D, k9_shape=K9_SHAPE, k9_ce_sites=K9_CE_SITES,
                        seed=SEED):
    """Compare K3 and K9 (at the retriever's and the cross-encoder's shapes) with
    their plain versions; returns per-kernel summaries."""
    import numpy as np
    import torch

    from colbert_tpu_torch.ops import dropout as dr, maxsim as ms

    rng = np.random.default_rng(seed)

    def unit(*shape):
        a = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(a / np.linalg.norm(a, axis=-1, keepdims=True)).to(device)

    def lengths_mask(n_rows, width, lo):
        lens = rng.integers(lo, width + 1, size=n_rows)
        return torch.from_numpy((np.arange(width)[None, :] < lens[:, None]).astype(np.int32)).to(device)

    worst = 0.0
    cases = {
        "multiview 16/16": (unit(eval_q, M, H), unit(eval_d, 16, H),
                            torch.ones(eval_q, M, dtype=torch.int32, device=device),
                            torch.ones(eval_d, 16, dtype=torch.int32, device=device)),
        "multiview off, 32 x 384 tokens": (unit(eval_q, 32, H), unit(eval_d, 384, H),
                                           lengths_mask(eval_q, 32, 8), lengths_mask(eval_d, 384, 40)),
        "ragged nd": (unit(eval_q, M, H), unit(eval_d - 7, 16, H), None, None),
    }
    worst_staged = 0.0
    for case, (Q, D, qm, dm) in cases.items():
        if qm is None:  # an all-negative doc: 0 from its masked rows wins the max
            D[0] = -D[0].abs()
            dm = lengths_mask(D.shape[0], D.shape[1], 1)
            qm = torch.ones(Q.shape[:2], dtype=torch.int32, device=device)
            cases[case] = (Q, D, qm, dm)
        route = ms.maxsim_plan(Q.shape[1], D.shape[1], Q.shape[2])
        before = ms.route_launches[route].value
        got, want = ms.maxsim(Q, D, qm, dm), ms.maxsim_ref(Q, D, qm, dm)
        if ms.route_launches[route].value != before + 1:
            raise AssertionError(f"K3 {case}: the wrapper did not launch route {route}")
        staged = ms._launch(*ms._apply_masks(Q, D, qm, dm), route="staged")
        torch.cuda.synchronize()
        err, err_staged = float((got - want).abs().max()), float((staged - want).abs().max())
        log(f"[phase3] K3 {case}: Q {tuple(Q.shape)} D {tuple(D.shape)} route {route} max|d|={err:.3e}; route "
            f"staged max|d|={err_staged:.3e} (limit {SCORE_ATOL})")
        if not (err <= SCORE_ATOL and err_staged <= SCORE_ATOL):
            raise AssertionError(f"K3 {case}: max |kernel - plain| = {err} (staged {err_staged}) > {SCORE_ATOL}")
        worst, worst_staged = max(worst, err), max(worst_staged, err_staged)
    Q, D, qm, dm = cases["multiview 16/16"]
    k3 = {"max_abs_err": worst, "staged_max_abs_err": worst_staged, "kernel_route": ms.maxsim_plan(M, 16, H),
          "ms": time_ms(lambda: ms.maxsim(Q, D, qm, dm)),
          "staged_ms": time_ms(lambda: ms._launch(*ms._apply_masks(Q, D, qm, dm), route="staged")),
          "plain_ms": time_ms(lambda: ms.maxsim_ref(Q, D, qm, dm)),
          "library_ms": None}
    # each route's launch alone on the masked inputs, in turns: the wrapper's
    # time above also holds its two mask products and its host time
    Qm, Dm = ms._apply_masks(Q, D, qm, dm)
    turns = [(route, time_ms(lambda: ms._launch(Qm, Dm, route=route))) for route in ("tf32", "staged", "staged", "tf32")]
    k3["kernel_ms"] = {route: sum(t for r, t in turns if r == route) / 2 for route in ("tf32", "staged")}
    del Qm, Dm
    nq, m, h = Q.shape
    nd, n, _ = D.shape
    flops, nbytes = 2.0 * nq * m * nd * n * h, 4.0 * (Q.numel() + D.numel() + qm.numel() + dm.numel() + nq * nd)
    # route "tf32": three TF32 products a dot on the tensor cores; fp32 on the CUDA cores beside it
    k3["bound_ms"], k3["bound_by"] = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    k3["fp32_bound_ms"], _ = bound(flops, nbytes, PEAK_FP32_FLOPS)
    log(f"[phase3] K3 at {nq} x {m} vs {nd} x {n} x {h} fp32: route {k3['kernel_route']} {k3['ms']:.4f} ms, route "
        f"staged (first design) {k3['staged_ms']:.4f} ms ({k3['staged_ms'] / k3['ms']:.2f}x), plain "
        f"{k3['plain_ms']:.3f} ms; bound {k3['bound_ms']:.4f} ms ({k3['bound_by']}: {3 * flops / 1e9:.1f} GFLOP "
        f"of TF32 products at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), fp32 CUDA-core bound {k3['fp32_bound_ms']:.4f} "
        f"ms; the launch alone on masked inputs: route tf32 {k3['kernel_ms']['tf32']:.4f} ms, route staged "
        f"{k3['kernel_ms']['staged']:.4f} ms; no single PyTorch call computes MaxSim, so no library time")
    del cases, Q, D

    seed64 = int(rng.integers(0, 2**63)) * 2 + 1
    mix, clock = k9_mix(torch.bfloat16), max_sm_clock_hz()  # the three shapes K9 is timed at are bf16
    log(f"[phase3] K9 route packed, {mix['function']}: its vector loop {mix['loop_instructions']} SASS "
        f"instructions for {mix['loop_elements']} elements (cuobjdump -sass of the built library): "
        f"{mix['int_per_element']:.3f} INT32-pipe, {mix['imad_per_element']:.3f} IMAD, {mix['all_per_element']:.3f} "
        f"in all an element; opcodes {mix['opcodes']}")
    k9 = k9_check(device, k9_shape, torch.bfloat16, seed64, "the retriever's attention probabilities", mix, clock)
    k9["sass"] = {key: mix[key] for key in ("function", "loop_instructions", "loop_elements", "int_per_element",
                                            "imad_per_element", "all_per_element")}
    k9["clock_hz"] = clock
    k9_special_values(device, seed64)
    odd = torch.randn(1_000_003, device=device)
    k9_routes_equal(odd, seed64 + 2, 51, "(1000003,) fp32 thr 51")
    log(f"[phase3] K9 (1000003,) fp32 thr 51: both routes, forward and backward, bit-equal to the plain version")
    del odd
    for dtype in (torch.float32, torch.float16):
        k9_routes_equal(torch.randn(k9_ce_sites["hidden states"][0], device=device, dtype=dtype), seed64 + 3,
                        K9_THR, f"hidden-state shape {dtype}")
        log(f"[phase3] K9 {k9_ce_sites['hidden states'][0]} {dtype} thr {K9_THR}: both routes, forward and "
            f"backward, bit-equal to the plain version")
    for i, (site, (shape, dtype)) in enumerate(k9_ce_sites.items()):
        k9["ce" if i == 0 else "ce_hidden"] = k9_check(device, shape, getattr(torch, dtype), seed64 + 4 + 2 * i,
                                                        f"the cross-encoder's {site} (phase 7)",
                                                        k9_mix(getattr(torch, dtype)), clock)
    return {"K3": k3, "K9": k9}


# ---- phase 4: training through the CLI ----

def retrieval_examples(docs, questions, positives, n_neg, rng):
    """Train/dev examples: the question, its positive passage, ``n_neg``
    hard negatives drawn from the other passages."""
    out = []
    for q, p in zip(questions, positives):
        negs = [docs[j] for j in rng.choice(len(docs), size=n_neg + 1, replace=False) if j != p][:n_neg]
        out.append({"question": q, "positive_ctxs": [docs[p]], "hard_negative_ctxs": negs})
    return out


def train_setup(workdir: Path, model_kw=None, tok_kw=None, batch=34, steps=7, n_dev=40, seed=SEED,
                attention_impl="auto", train_kw=None, index_kw=None):
    """Phase 4's data and config: ``steps`` x ``batch`` train and ``n_dev``
    dev examples over synthetic Chinese passages (10 and 8 hard negatives),
    the vocab, and the config written to ``workdir / "conf.yaml"``
    (``train_kw`` over the train section's fields, ``index_kw`` over the
    index section's)."""
    import numpy as np

    from colbert_tpu_torch.config import ColbertConfig, IndexConfig, ModelConfig, TokenizerConfig, TrainConfig
    from colbert_tpu_torch.tokenization.vocab import build_vocab, write_vocab
    from colbert_tpu_torch.utils.io import dump_json

    rng = np.random.default_rng(seed + 7)
    n_train = steps * batch
    docs, questions, positives = synthetic_chinese(4 * (n_train + n_dev), n_train + n_dev, seed=seed + 3)
    train = retrieval_examples(docs, questions[:n_train], positives[:n_train], 10, rng)
    dev = retrieval_examples(docs, questions[n_train:], positives[n_train:], 8, rng)
    train_path, dev_path = workdir / "train.json", workdir / "dev.json"
    dump_json(train, train_path)
    dump_json(dev, dev_path)
    model_cfg = ModelConfig(**{**(model_kw or {}), "attention_impl": attention_impl})
    vocab_path = write_vocab(build_vocab(docs + questions, max_size=model_cfg.vocab_size), workdir / "vocab.txt")
    cfg = ColbertConfig(
        model=model_cfg,
        tokenizer=TokenizerConfig(vocab_path=str(vocab_path), **(tok_kw or {})),
        train=TrainConfig(per_device_batch_size=batch, num_epochs=1, evals_per_epoch=2, log_every=1,
                          keep_checkpoints=2, checkpoint_dir=str(workdir / "ckpt"), seed=seed, **(train_kw or {})),
        index=IndexConfig(**(index_kw or {})),
    )
    cfg.to_yaml(workdir / "conf.yaml")
    return cfg, train_path, dev_path


def phase_train(device, workdir: Path, label: str, model_kw=None, tok_kw=None, batch=34,
                steps=7, n_dev=40, seed=SEED, attention_impl="auto", tag="phase4", train_kw=None, index_kw=None):
    """The CLI's ``train`` (phase 4; with ``attention_impl="flash"``, phase 8b:
    K11-K13 at the doc pass), its launches, then ``--resume`` from the last
    checkpoint.  Returns the counted run's launches and its measurements."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.training.checkpoint import CheckpointManager
    from colbert_tpu_torch.utils.io import load_jsonl

    cfg, train_path, dev_path = train_setup(workdir, model_kw, tok_kw, batch, steps, n_dev, seed, attention_impl,
                                            train_kw, index_kw)
    n_train = steps * batch
    conf_path = workdir / "conf.yaml"
    c = cfg.model
    log(f"[{tag}] attention {c.attention_impl}; model hidden={c.hidden_size} layers={c.num_layers} "
        f"heads={c.num_heads} ffn={c.intermediate_size} vocab={c.vocab_size} dim={c.dim} {c.dtype}, dropout "
        f"{c.hidden_dropout}/{c.attention_dropout} ({c.dropout_impl}), multiview "
        f"{cfg.multiview.q_view}/{cfg.multiview.d_view}, query_maxlen {cfg.tokenizer.query_maxlen}, "
        f"doc_maxlen {cfg.tokenizer.doc_maxlen}, batch {batch}, learning rate {cfg.train.learning_rate}; {n_train} "
        f"train and {n_dev} dev examples")
    common = ["--config", str(conf_path), "--train-data", str(train_path), "--dev-data", str(dev_path),
              "--device", str(device)]
    per_step_k9 = (1 + 3 * c.num_layers) * 2 * 2
    eval_batches = -(-n_dev // batch)
    eval_every = steps // 2  # evals_per_epoch=2
    saved = [eval_every * i for i in range(1, steps // eval_every + 1)]
    if saved[-1] == steps:
        raise ValueError("steps must leave a step after the last checkpoint, for the resume")

    # ---- the counted training-path run ----
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["train", *common])
    torch.cuda.synchronize()
    launches = read_counts()
    # ----
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    train_s = time.perf_counter() - t0
    rows = load_jsonl(workdir / "ckpt" / "train_log.jsonl")
    step_rows = [r for r in rows if r["kind"] == "step"]
    eval_rows = [r for r in rows if r["kind"] == "eval"]
    losses = [r["step_loss"] for r in step_rows]
    log(f"[{tag}] train: {len(step_rows)} steps in {train_s:.1f} s (model init, evaluation and "
        f"checkpoints included); losses {[round(x, 4) for x in losses]}; evals {eval_rows}")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"expected {steps} finite losses, got {losses}")
    want = {"K3": len(saved) * eval_batches, "K9": steps * per_step_k9}
    log(f"[{tag}] launches in the training-path run: {launches} (K9 expected {want['K9']} = {steps} "
        f"steps x {per_step_k9}, K3 expected {want['K3']} = {len(saved)} evals x {eval_batches} batches)")
    if launches["K3"] != want["K3"] or launches["K9"] != want["K9"]:
        raise AssertionError(f"kernel launches {launches} do not match the training steps {want}")
    if launches["K3 tf32 route"] != want["K3"] or launches["K3 staged route"]:
        raise AssertionError(f"K3 launches by route: tf32 {launches['K3 tf32 route']}, staged "
                             f"{launches['K3 staged route']}; expected every eval batch on route tf32")
    k9_on_packed(launches, "the training-path run")
    flash_layers = c.num_layers if attention_impl == "flash" else 0  # flash at the doc pass only (384; queries 32)
    flash_launches_ok(launches, {"K11": flash_layers * (steps + len(saved) * eval_batches),
                                 "K12": flash_layers * steps, "K13": flash_layers * steps}, "the training-path run")
    ckpt = CheckpointManager(cfg.train.checkpoint_dir)
    if ckpt.all_steps() != saved[-2:]:
        raise AssertionError(f"checkpoints {ckpt.all_steps()}, expected {saved[-2:]}")
    skip = 2 if steps > 5 else 1
    step_s = [r["step_s"] for r in step_rows[skip:]]
    ms_step = 1e3 * float(np.mean(step_s))
    log(f"[{tag}] {ms_step:.1f} ms/step = {batch / ms_step * 1e3:.1f} examples/s over steps {skip + 1}-{steps} "
        f"(min {1e3 * min(step_s):.1f}, max {1e3 * max(step_s):.1f} ms; first step "
        f"{1e3 * step_rows[0]['step_s']:.1f} ms); peak device memory {peak_gb:.2f} GB [{label}]")

    # the checkpoint read back: resume from the last one for the remaining steps
    reset_counts()
    cli.main(["train", *common, "--resume"])
    torch.cuda.synchronize()
    resumed = read_counts()
    rows = [r for r in load_jsonl(workdir / "ckpt" / "train_log.jsonl") if r["kind"] == "step"]
    log(f"[{tag}] resume from checkpoint {saved[-1]}: steps {[r['step'] for r in rows]}, loss "
        f"{[r['step_loss'] for r in rows]} vs the straight run's step {steps} {losses[-1]}; launches {resumed}")
    if [r["step"] for r in rows] != list(range(saved[-1] + 1, steps + 1)) or resumed["K9"] != per_step_k9 * (steps - saved[-1]):
        raise AssertionError(f"resume ran steps {[r['step'] for r in rows]}, K9 launches {resumed['K9']}")
    if attention_impl == "flash":
        n = c.num_layers * (steps - saved[-1])
        flash_launches_ok(resumed, {"K11": n, "K12": n, "K13": n}, "the resumed run")
    # phase 8b holds the resumed loss bit-equal; phase 4 keeps its first limit
    if not abs(rows[0]["step_loss"] - losses[-1]) <= (0.0 if attention_impl == "flash" else 1e-4):
        raise AssertionError(f"resumed loss {rows[0]['step_loss']} differs from the straight run's {losses[-1]}")
    sd = cli._retriever_state_dict(cfg, None, None)
    if not all(torch.isfinite(v).all() for v in sd.values()):
        raise AssertionError("checkpoint parameters are not finite")
    return launches, {"ms_step": ms_step, "losses": losses, "peak_gb": peak_gb, "cfg": cfg, "train_path": train_path}


def phase_repeat(device, label, train_ctx, repeats=3):
    """Phase 4's full-depth repeat check: one train step's forward and backward
    (the library's ``compute_grads``, phase 4's configuration and first batch,
    explicit attention, no remat) ``repeats`` times on the same batch and
    parameters: the loss and every gradient bit-equal to the first run's."""
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.ops.dropout import same_bits
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset
    from colbert_tpu_torch.training.dataset import RetrievalSampler

    cfg = ColbertConfig.from_dict(train_ctx["cfg"].to_dict())
    tok = cli._tokenizer(cfg)
    trainer = ColbertTrainer(cfg, tok, device=device)
    sampler = RetrievalSampler(RetrievalDataset.from_json(train_ctx["train_path"]), tok, cfg.train,
                               cfg.train.per_device_batch_size, is_eval=False)
    trainer._init_state(sampler.steps_per_epoch())
    batch = next(iter(sampler.epoch(0)))
    runs = []
    t0 = time.perf_counter()
    for _ in range(repeats):
        loss = float(trainer.compute_grads(batch, 0))
        runs.append((loss, {k: p.grad.clone() for k, p in trainer.model.named_parameters() if p.grad is not None}))
    run_s = time.perf_counter() - t0
    losses = [r[0] for r in runs]
    grads = runs[0][1]
    differ = sorted({k for _, g in runs[1:] for k in grads if not same_bits(grads[k], g[k])})
    n_params = sum(1 for _ in trainer.model.parameters())
    log(f"[phase4] full-depth repeat check: {cfg.model.num_layers} layers, attention {cfg.model.attention_impl}, "
        f"{repeats} runs of one step's forward and backward on one batch in {run_s:.2f} s: losses {losses}; "
        f"{len(grads)} of {n_params} parameters with a gradient, {len(differ)} not bit-equal to the first run's "
        f"{differ[:12]} [{label}]")
    del trainer
    torch.cuda.empty_cache()
    if len(set(losses)) != 1 or differ or len(grads) != n_params:
        raise AssertionError(f"full-depth repeat check: losses {losses}, gradients that differ {differ}, "
                             f"{len(grads)} of {n_params} with a gradient")
    return {"losses": losses, "differ": differ, "parameters": len(grads), "s": run_s}


# ---- phase 5: ANN serving with the sq codec ----

NPROBE, DEPTH, TOPR, MAX_CAND = 128, 512, 8, 4096  # the JAX package's sq cell (bench.py:367-377)
SQ_DIM, KMEANS_ITERS = 64, 10
PROBE_ATOL = 1e-5  # K6/K7 scores: int8 x bf16 (x fp32) products, summed in another order


def ann_config(cfg, index_path, port):
    """``cfg`` with the sq index and ANN serving at the operating point."""
    from colbert_tpu_torch.config import ColbertConfig

    out = ColbertConfig.from_dict(cfg.to_dict())
    out.index.index_path, out.index.codec = str(index_path), "sq"
    out.index.sq_dim, out.index.kmeans_iters, out.index.partitions = SQ_DIM, KMEANS_ITERS, 0
    s = out.serve
    s.mode, s.nprobe, s.candidate_depth, s.probe_list_topr = "ann", NPROBE, DEPTH, TOPR
    s.max_candidates, s.topk, s.query_batch_size, s.port = MAX_CAND, TOPK, B, port
    return out


def check_answers(tag, questions, answers, searcher, docs, device, exact=None):
    """Every answer holds 100 valid, descending triples; returns the largest
    difference of their scores from ``exact(pids, Qm)``, by default the
    exact MaxSim of the returned pids over ``searcher``'s bf16 flat table."""
    import torch

    from colbert_tpu_torch.ops.rerank import maxsim_rerank_uniform_ref

    if exact is None:
        exact = lambda pids, Qm: maxsim_rerank_uniform_ref(pids, Qm, searcher.emb_table, dv=searcher.flat_dv)
    enc = searcher.tok.encode_queries(questions)
    Qm = searcher.encode_queries(enc.input_ids, enc.attention_mask, enc.active_mask)
    pids = torch.tensor([[p for p, _, _ in row] for row in answers], dtype=torch.int32, device=device)
    got = torch.tensor([[s for _, s, _ in row] for row in answers], dtype=torch.float32, device=device)
    if pids.shape != (len(questions), TOPK) or not ((pids >= 0) & (pids < len(docs))).all():
        raise AssertionError(f"{tag}: an answer lacks 100 valid pids")
    if any(t != docs[p] for row in answers for p, _, t in row):
        raise AssertionError(f"{tag}: a triple's text is not its passage")
    if (got[:, 1:] > got[:, :-1]).any():
        raise AssertionError(f"{tag}: scores not descending")
    return float((got - exact(pids, Qm)).abs().max())


def phase_ann_cli(device, workdir: Path, cfg, common, corpus_path, eval_path, docs, requests,
                  flat_searcher, n_eval, label):
    """Phase 5c/5d: ``build-index`` on phase 2's encoded corpus, ``serve``
    with ``serve.mode=ann`` over the socket, ``evaluate --remote``, a local
    ``evaluate`` and one batch of the service ``evaluate`` builds, both with
    the int8 rerank table; the launch counts of K4-K7 in that run, and K7
    on both routes over the deep request's plan (its real hot lists)."""
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.ops.rerank import maxsim_rerank_uniform_int8_ref
    from colbert_tpu_torch.serving.server import RetrievalClient

    acfg = ann_config(cfg, cfg.index.index_path, free_port())
    conf = workdir / "conf_ann.yaml"
    acfg.to_yaml(conf)
    args = ["--config", str(conf), *common[2:]]
    t0 = time.perf_counter()
    cli.main(["build-index", *args])
    log(f"[phase5c] build-index over phase 2's {len(docs)} encoded docs in {time.perf_counter() - t0:.1f} s")

    serve_err = []

    def serve():
        try:
            cli.main(["serve", "--corpus", str(corpus_path), *args])
        except BaseException as e:  # noqa: BLE001 -- reported by the main thread
            serve_err.append(e)

    server = threading.Thread(target=serve, daemon=True, name="serve-ann")
    server.start()
    client = RetrievalClient(acfg.serve.host, acfg.serve.port, acfg.serve.authkey.encode())
    from multiprocessing.connection import Client

    deadline = time.time() + 600
    while True:
        if serve_err:
            raise RuntimeError(f"ann serve failed: {serve_err[0]!r}")
        try:
            Client((acfg.serve.host, acfg.serve.port), authkey=acfg.serve.authkey.encode()).close()
            break
        except ConnectionRefusedError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)
    client.retrieve(requests[0][:1], topk=TOPK, depth=DEPTH, nprobe=NPROBE)  # warm-up, not counted

    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.ops.ivf import sq_probe_plan

    ivf = {k: torch.from_numpy(v).to(device) for k, v in IndexStorage(acfg.index.index_path).read_ivf().items()}
    enc = flat_searcher.tok.encode_queries(requests[0])
    Q0 = flat_searcher.encode_queries(enc.input_ids, enc.attention_mask, enc.active_mask)

    # and a deep-probe request (the protocol carries nprobe): the smallest
    # nprobe, doubling from the serving point's, at which lists overflow
    # their slots (K7's lists), so the served path gives K7 real lists
    deep, over = NPROBE, {}
    while True:
        plan = sq_probe_plan(Q0.reshape(-1, Q0.shape[-1]), ivf["coarse_centroids"], ivf["sq_proj"],
                             ivf["sq_scales"], nprobe=deep, hot_cap=max(64, deep))
        over[deep] = int((plan.hot_ids >= 0).sum())
        if over[deep]:
            break
        deep *= 2
        if deep > ivf["coarse_centroids"].shape[0]:
            raise AssertionError("no nprobe makes a list overflow its slots")
    nprobes = [NPROBE] * len(requests) + [deep]
    requests = [*requests, requests[0]]
    # the int8 service, built as `evaluate` builds it, for one batch whose answers are checked
    cfg8 = ColbertConfig.from_dict(acfg.to_dict())
    cfg8.serve.rerank_dtype = "int8"
    ns = argparse.Namespace(pretrain=common[common.index("--pretrain") + 1], checkpoint_step=None,
                            device=str(device), corpus=str(corpus_path))

    # ---- the counted ANN serving-path run ----
    reset_counts()
    answers, lat = [], []
    for qs, nprobe in zip(requests, nprobes):
        t0 = time.perf_counter()
        answers.append(client.retrieve(qs, topk=TOPK, depth=DEPTH, nprobe=nprobe))
        lat.append(time.perf_counter() - t0)
    cli.main(["evaluate", "--eval-data", str(eval_path), "--remote", "--topk", str(TOPK), *args])
    cli.main(["evaluate", "--eval-data", str(eval_path), "--corpus", str(corpus_path), "--topk", str(TOPK),
              "--set", "serve.rerank_dtype=int8", *args])
    service8 = cli.make_service(cfg8, ns)
    answers8 = service8.retrieve(requests[0], topk=TOPK)
    torch.cuda.synchronize()
    launches = read_counts()
    # ----

    client.shutdown()
    server.join(timeout=60)
    if server.is_alive() or serve_err:
        raise RuntimeError(f"ann server did not stop cleanly: {serve_err}")
    for i, (dt, nprobe) in enumerate(zip(lat, nprobes)):
        log(f"[phase5c] ann request {i}: {B} questions top-{TOPK}, nprobe {nprobe}, in "
            f"{dt * 1e3:.1f} ms over the socket")
    log(f"[phase5c] lists over the slot capacity (scanned by K7) for request 0 by nprobe: {over}")
    eval_batches = -(-n_eval // B)
    want = {"K4": len(requests) + eval_batches, "K5": eval_batches + 1,
            "K6": len(requests) + 2 * eval_batches + 1, "K7": len(requests) + 2 * eval_batches + 1,
            "K8": 0, "K10": 0}
    log(f"[phase5d] launches in the ANN serving-path run: {launches} (expected {want}: the socket's "
        f"{len(requests)} requests (the last at nprobe {deep}) and {eval_batches} evaluate "
        f"--remote batches on the bf16 table, {eval_batches} local evaluate batches and one "
        f"service batch on the int8 table)")
    want["K4/K5 wgmma route"], want["K4/K5 staged route"] = want["K4"] + want["K5"], 0
    want["K4/K5 wgmma_rows route"] = 0
    want["K6 mma route"], want["K6 staged route"] = want["K6"], 0
    want["K7 mma route"], want["K7 staged route"] = want["K7"], 0
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"ANN kernel launches {launches} do not match the served batches {want}")
    serialized_on_cpp("phase5c", launches, len(requests) + eval_batches)
    # K7 on the deep request's plan: the one served shape with real hot lists
    k7_deep = k7_both_routes("phase5c", f"request 0 at nprobe {deep}", plan.hot_ids, plan.hot_members,
                             ivf["offsets"], ivf["codes"], plan.qs, label)

    # every answer: 100 valid descending triples whose scores are the exact
    # MaxSim of the returned pids over the served table: bf16 queries x bf16
    # table, or fp32 descaled queries x int8 table, fp32 sums
    s8 = service8.searcher
    int8_maxsim = lambda pids, Qm: maxsim_rerank_uniform_int8_ref(pids, Qm.float() * s8.emb_inv_scale,
                                                                   s8.emb_table, dv=16)
    worst = {"bf16": max(check_answers("ANN bf16", qs, ans, flat_searcher, docs, device)
                         for qs, ans in zip(requests, answers)),
             "int8": check_answers("ANN int8", requests[0], answers8, flat_searcher, docs, device, int8_maxsim)}
    log(f"[phase5c] served ANN scores vs the exact MaxSim of the returned pids: max|d| "
        + ", ".join(f"{k} table {v:.3e}" for k, v in worst.items()) + f" (limit {SCORE_ATOL})")
    if max(worst.values()) > SCORE_ATOL:
        raise AssertionError(f"served ANN scores differ from exact MaxSim: {worst}")
    return launches, k7_deep


def bench_index(device, workdir: Path, num_docs=20_000, n_batches=2, seed=0):
    """Phase 5b's corpus (``bench.py:51-65``'s generator, four fp16 parts),
    ``n_batches`` x B topic queries, and its sq index at the operating point
    built through the CLI.  Returns the config, the storage, the doc rows,
    the queries and the build's seconds."""
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig, ModelConfig, TokenizerConfig
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.tokenization.vocab import build_vocab, write_vocab

    docs, queries = topic_embeddings(num_docs, 16, n_batches * B, M, H, seed=seed)
    storage = IndexStorage(workdir / "index")
    per = num_docs // 4
    for p in range(4):
        lo, hi = p * per, (p + 1) * per if p < 3 else num_docs
        storage.write_part(p, docs[lo * 16 : hi * 16], [16] * (hi - lo))
    storage.write_meta({"dim": H, "num_docs": num_docs, "num_embeddings": num_docs * 16, "multiview": True,
                        "d_view": 16, "num_parts": 4, "embedding_dtype": "float16"})
    # the model only encodes text; these phases search from query reps
    vocab = write_vocab(build_vocab(["query"]), workdir / "vocab.txt")
    base = ColbertConfig(model=ModelConfig(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2,
                                           intermediate_size=64, dim=H),
                         tokenizer=TokenizerConfig(vocab_path=str(vocab)))
    cfg = ann_config(base, workdir / "index", 0)
    conf = workdir / "conf.yaml"
    cfg.to_yaml(conf)
    t0 = time.perf_counter()
    cli.main(["build-index", "--config", str(conf), "--device", str(device)])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return cfg, storage, docs, queries, time.perf_counter() - t0


def phase_ann(device, workdir: Path, label: str, num_docs=20_000, n_batches=2, seed=0):
    """Phase 5a/5b: ``build-index`` over the bench's synthetic corpus at the
    operating point, recall@100 of ANN search against the fp32 exact
    oracle, the batch's time per stage, and K4-K7 against their plain
    versions on that batch's inputs."""
    import numpy as np
    import torch

    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.ops import rerank as rr, sq_probe_batched as sp
    from colbert_tpu_torch.ops.ivf import sq_probe_plan
    from colbert_tpu_torch.ranking import searcher as srch
    from colbert_tpu_torch.tokenization import ColbertTokenizer

    cfg, storage, docs, queries, build_s = bench_index(device, workdir, num_docs, n_batches, seed)
    searcher = srch.ColbertSearcher(cfg, ColbertTokenizer(cfg.tokenizer, cfg.multiview),
                                    ColbertModel(cfg.model, cfg.multiview), storage, device=device)
    K = int(searcher.coarse.shape[0])
    lens = torch.diff(searcher.offsets).cpu()
    log(f"[phase5b] build-index: {num_docs} docs x 16 rows x {H} (bench.py's generator, seed {seed}) in "
        f"{build_s:.1f} s: K={K}, sq_dim {SQ_DIM}, kmeans_iters {KMEANS_ITERS}; list length max "
        f"{int(lens.max())}, mean {float(lens.float().mean()):.1f}, empty {int((lens == 0).sum())}")

    Q = torch.from_numpy(queries).to(device)
    qm = torch.ones(B, M, device=device)

    # ---- 5b: recall@100 against the fp32 exact oracle, and the stage times ----
    k6_before, k7_before = k6_routes(), k7_routes()
    recall, batch_ms, oracle = [], [], []
    for i in range(n_batches):
        Qb = Q[i * B : (i + 1) * B]
        searcher.search_reps(Qb, qm)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, tp = searcher.search_reps(Qb, qm)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        _, op = searcher.exact_topk(Qb, TOPK)
        tp, op = tp.cpu().numpy(), op.cpu().numpy()
        oracle.append(op)
        if not np.isfinite(ts.cpu().numpy()).all() or ts.shape != (B, TOPK):
            raise AssertionError("ANN search returned fewer than 100 finite results")
        recall += [len(set(tp[b]) & set(op[b])) / TOPK for b in range(B)]
    rec = float(np.mean(recall))
    log(f"[phase5b] recall@{TOPK} vs the fp32 exact oracle over {n_batches} x {B} topic queries: {rec:.4f} "
        f"(nprobe {NPROBE}, depth {DEPTH}, r {TOPR}, max_candidates {MAX_CAND}); batch "
        f"{' / '.join(f'{t:.1f}' for t in batch_ms)} ms from query reps [{label}]")
    if rec < 0.98:
        raise AssertionError(f"ANN recall@{TOPK} {rec:.4f} is below 0.98")

    Qb = Q[:B]
    s = searcher.cfg.serve
    probe = searcher.probe_fn()
    stage = {}
    pids, scores = srch.probe_pids(Qb, qm, probe, searcher.pid_by_row)
    stage["probe"] = time_ms(lambda: srch.probe_pids(Qb, qm, probe, searcher.pid_by_row), iters=5)
    cand = srch.dedup(pids, scores, q_view=M, depth=DEPTH, max_cand=MAX_CAND)
    stage["dedup"] = time_ms(lambda: srch.dedup(pids, scores, q_view=M, depth=DEPTH, max_cand=MAX_CAND), iters=5)
    sc = srch.rerank(cand, Qb, searcher.emb_table, None, dv=16)
    stage["rerank"] = time_ms(lambda: srch.rerank(cand, Qb, searcher.emb_table, None, dv=16), iters=5)
    stage["topk"] = time_ms(lambda: srch.select_topk(sc, cand, TOPK), iters=5)
    log(f"[phase5b] batch of {B} x {M} query reps, ms per stage (CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()) + f" [{label}]")
    assert_k6_on_mma("phase5b", k6_before)
    assert_k7_on_mma("phase5b", k7_before)

    # ---- 5b: one batch served with serve.rerank_dtype="float32": an fp32 table, reranked in torch ops ----
    cfg32 = ColbertConfig.from_dict(cfg.to_dict())
    cfg32.serve.rerank_dtype = "float32"
    s32 = srch.ColbertSearcher(cfg32, ColbertTokenizer(cfg32.tokenizer, cfg32.multiview),
                               ColbertModel(cfg32.model, cfg32.multiview), storage, device=device)
    if s32.emb_table.dtype != torch.float32:
        raise AssertionError(f"rerank_dtype=float32 served a {s32.emb_table.dtype} table")
    launched = rr.maxsim_rerank_uniform.launches.value + rr.maxsim_rerank_uniform_int8.launches.value
    s32.search_reps(Qb, qm)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts32, tp32 = s32.search_reps(Qb, qm)
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    if rr.maxsim_rerank_uniform.launches.value + rr.maxsim_rerank_uniform_int8.launches.value != launched:
        raise AssertionError("the float32 table's rerank launched K4 or K5")
    if ts32.shape != (B, TOPK) or not torch.isfinite(ts32).all():
        raise AssertionError("the float32 batch returned fewer than 100 finite results")
    # its scores against an independent fp32 MaxSim of the returned pids (K4's plain core over the fp32 table)
    err32 = float((ts32 - rr._rerank_ref(tp32, Qb, s32.emb_table, 16)).abs().max())
    op32 = s32.exact_topk(Qb, TOPK)[1].cpu().numpy()
    tp32 = tp32.cpu().numpy()
    rec32 = float(np.mean([len(set(tp32[b]) & set(op32[b])) / TOPK for b in range(B)]))
    log(f"[phase5b] rerank_dtype=float32 ({s32.emb_table.numel() * 4 / 1e9:.3f} GB fp32 table): batch "
        f"{ms32:.1f} ms from query reps; scores vs fp32 MaxSim of the returned pids max|d|={err32:.3e} "
        f"(limit {SCORE_ATOL}); recall@{TOPK} vs the fp32 oracle {rec32:.4f} [{label}]")
    if err32 > SCORE_ATOL or rec32 < 0.98:
        raise AssertionError(f"float32 batch: max|d| {err32}, recall {rec32}")
    del s32, ts32

    # ---- 5a: K6, K7, K4, K5 against their plain versions on this batch's inputs ----
    out = {}
    tokens = Qb.reshape(B * M, H)
    plan = sq_probe_plan(tokens, searcher.coarse, *searcher.quant, nprobe=NPROBE,
                         hot_cap=s.probe_hot_lists or max(64, NPROBE))
    codes, offsets = searcher.codes, searcher.offsets
    qidx = plan.sched.qidx
    T = tokens.shape[0]
    filled = qidx[:, 0] >= 0
    lens_d = torch.diff(offsets).long()
    # K7 at its serving shape (hot_cap lists) over this batch's most-probed
    # lists, whether or not they overflow their slots, with their probing
    # tokens as members
    probed = torch.bincount(plan.lists.reshape(-1), minlength=K)
    hot = torch.sort(probed, descending=True, stable=True)[1][: plan.hot_ids.numel()].int()
    hot_l = hot.long()
    members = probe_members(plan.lists, hot, K)
    log(f"[phase5a] probe plan: {int(filled.sum())} of {qidx.shape[0]} slots filled, "
        f"{int((plan.hot_ids >= 0).sum())} lists over the slot capacity ({8 * 128} members); "
        f"K7 held on the {hot.numel()} most-probed lists ({int(probed[hot_l].min())}-"
        f"{int(probed[hot_l].max())} probing tokens, {int(lens_d[hot_l].sum())} rows)")

    out["K6"] = k6_both_routes("phase5a", "one-topic", plan, offsets, codes, label)

    out["K7"] = k7_both_routes("phase5a", "one-topic batch, forced", hot, members, offsets, codes, plan.qs, label)
    # the served plan: no list over its slots at nprobe 128, every hot entry -1
    out["K7"]["served_no_hot"] = k7_no_hot("phase5a", plan, offsets, codes, label)

    out.update(phase_rerank(device, cand, Qb, searcher.emb_table, docs, label))
    return out, {"recall": rec, "stage_ms": stage, "batch_ms": batch_ms, "build_s": build_s,
                 "queries": Q, "oracle": oracle, "config": cfg, "fp32": {"ms": ms32, "err": err32, "recall": rec32}}


def ranked_rows(tag, name, got, want, got_at_want=None):
    """Ranked (n, r) scores and rows against the plain version's: scores
    within ``PROBE_ATOL``, rows equal outside near ties."""
    from colbert_tpu_torch.ops import sq_probe_batched as sp

    err, bad = sp.ranked_mismatch(*want, *got, PROBE_ATOL, got_at_want)
    log(f"[{tag}] {name}: max|d|={err:.3e} (limit {PROBE_ATOL}), rows mismatched outside near ties {bad}")
    if err > PROBE_ATOL or bad:
        raise AssertionError(f"{name} differs from its plain version: max|d| {err}, {bad} rows")
    return err


def exact_at_ties(ws, wr, codes, qs, tok):
    """The plain version's ranked (n, r) scores with, where two neighbours
    tie exactly, the rows' exact sums (fp64, against ``qs[tok[i]]``, entry
    i's query) in their place: ``ranked_mismatch``'s ``got_at_want``.  A
    tensor-core route sums in another order than the plain version, so two
    different rows may round to one fp32 score on one side only; such a tie
    counts as a near tie where the exact sums differ.  Returns it and the
    count of tied entries."""
    import torch

    fin = torch.isfinite(ws)
    same = (ws[:, 1:] == ws[:, :-1]) & fin[:, 1:]
    tie = torch.zeros_like(fin)
    tie[:, 1:] |= same
    tie[:, :-1] |= same
    exact = ws.double()
    i, k = torch.nonzero(tie, as_tuple=True)
    exact[i, k] = (codes[wr[i, k].long()].double() * qs[tok[i]].double()).sum(dim=1)
    return exact, len(i)


def k7_routes() -> dict:
    from colbert_tpu_torch.ops import sq_probe_batched as sp

    return {k: c.value for k, c in sp.hot_route_launches.items()}


def assert_k7_on_mma(tag, before):
    """Every K7 launch since ``before`` (``k7_routes()``) took route "mma", and there was one."""
    got = {k: v - before[k] for k, v in k7_routes().items()}
    log(f"[{tag}] K7 launches by route in the served batches: {got}")
    if got["staged"] or not got["mma"]:
        raise AssertionError(f"{tag}: K7 launches by route {got}, expected all on route mma")


def probe_members(lists, hot, K):
    """(T, H) bool: token t probes hot list ``hot[h]`` (``lists`` (T, nprobe))."""
    import torch

    H = hot.numel()
    pos = torch.full((K + 1,), H, dtype=torch.int64, device=lists.device)
    pos[torch.where(hot >= 0, hot.long(), K)] = torch.arange(H, device=lists.device)
    pos[K] = H
    m = torch.zeros((lists.shape[0], H + 1), dtype=torch.bool, device=lists.device)
    m.scatter_(1, pos[lists.long()], True)
    return m[:, :H].contiguous()


def k7_both_routes(tag, what, hot, members, offsets, codes, qs, label):
    """K7 on one hot-list set: route "mma" over the member tokens (through
    the wrapper, one launch counted on it), route "mma" over every token,
    route "staged" (the first design, every token), each against the plain
    version at the member entries of real hot lists (the entries a probe
    reads) and timed; route "mma"'s schedule and work list alone; both
    bounds (the member pairs the probe needs, and every token's pairs)."""
    import torch

    from colbert_tpu_torch.ops import sq_probe_batched as sp

    T, D = qs.shape
    H = hot.numel()
    real = hot >= 0
    read = real[:, None] & members.T                                     # (H, T)
    lens_d = torch.diff(offsets).long()
    rows_h = torch.where(real, lens_d[hot.clamp(min=0).long()], 0)
    entries = int(read.sum())
    pairs, all_pairs, rows = int((read.sum(dim=1) * rows_h).sum()), int(rows_h.sum()) * T, int(rows_h.sum())
    mma = lambda: sp.sq_hot_list_scan(hot, offsets, qs, codes, r=TOPR, members=members)
    every = lambda: sp.sq_hot_list_scan(hot, offsets, qs, codes, r=TOPR)
    staged = lambda: sp._launch(hot, offsets, qs, codes, TOPR, hot=True, route="staged")
    plain = lambda: sp.sq_hot_list_scan_ref(hot, offsets, qs, codes, r=TOPR, members=members)
    # the plain version's top-(r+1): a kernel's r-th row may be its (r+1)-th where the two tie
    flat = lambda t: t.transpose(1, 2)[read]
    ws, wr = (flat(t) for t in sp.sq_hot_list_scan_ref(hot, offsets, qs, codes, r=TOPR + 1, members=members))
    exact, n_ties = exact_at_ties(ws, wr, codes, qs, torch.arange(T, device=qs.device).expand(H, T)[read])

    def check(name, got, exact_ties=True):
        # route "staged" sums as the plain version does: its exact ties resolve alike
        if not exact_ties:
            return ranked_rows(tag, f"K7 {name} ({what})", tuple(map(flat, got)), (ws[:, :TOPR], wr[:, :TOPR]))
        gs, gr = (torch.cat([flat(t), w[:, TOPR:]], dim=1) for t, w in zip(got, (ws, wr)))
        return ranked_rows(tag, f"K7 {name} ({what}; {n_ties} entries in exact ties of the plain version)",
                           (gs, gr), (ws, wr), exact)

    before = k7_routes()
    got = mma()
    if k7_routes()["mma"] != before["mma"] + 1:
        raise AssertionError(f"{tag}: K7's wrapper did not launch route mma")
    res = {"max_abs_err": check("route mma, members", got),
           "all_tokens_max_abs_err": check("route mma, every token", every()),
           "staged_max_abs_err": check("route staged", staged(), exact_ties=False)}
    del got, ws, wr, exact
    res.update(ms=time_ms(mma), all_tokens_ms=time_ms(every), staged_ms=time_ms(staged),
               schedule_ms=time_ms(lambda: sp.hot_schedule_kernel(hot, offsets, T, members)),
               plain_ms=time_ms(plain, iters=2, warmup=1), library_ms=None, kernel_route="mma",
               hot_lists=int(real.sum()), member_entries=entries, member_pairs=pairs, all_token_pairs=all_pairs)
    # fp32 queries x int8 codes as three bf16 tensor-core terms (as K5);
    # bytes: each hot list's codes once, qs, hot_ids, the members, and the
    # outputs the function writes (member entries, or every token's)
    common = rows * D + T * D * 4 + H * 4
    res["bound_ms"], res["bound_by"] = bound(3 * 2.0 * D * pairs, common + T * H + entries * TOPR * 8,
                                             PEAK_BF16_FLOPS)
    res["all_tokens_bound_ms"], res["all_tokens_bound_by"] = bound(
        3 * 2.0 * D * all_pairs, common + int(real.sum()) * T * TOPR * 8, PEAK_BF16_FLOPS)
    log(f"[{tag}] K7 ({what}): {res['hot_lists']} hot lists of {H}, {rows} rows, {entries} member entries; "
        f"(row, token) pairs: members {pairs}, every token {all_pairs}")
    log(f"[{tag}] K7 ({what}): route mma, members {res['ms']:.4f} ms (its schedule and work list alone "
        f"{res['schedule_ms']:.4f} ms); route mma, every token {res['all_tokens_ms']:.4f} ms; route staged "
        f"(first design) {res['staged_ms']:.4f} ms ({res['staged_ms'] / res['ms']:.2f}x); plain "
        f"{res['plain_ms']:.3f} ms; bound, member pairs {res['bound_ms']:.4f} ms ({res['bound_by']}), every "
        f"token {res['all_tokens_bound_ms']:.4f} ms ({res['all_tokens_bound_by']}); no single PyTorch call "
        f"computes it [{label}]")
    return res


def k7_no_hot(tag, plan, offsets, codes, label):
    """K7 on a served plan with no hot list (every entry -1): both routes
    timed in turns (staged, mma, mma, staged: the host's time bounds both);
    neither writes anything."""
    from colbert_tpu_torch.ops import sq_probe_batched as sp

    if int((plan.hot_ids >= 0).sum()):
        raise AssertionError(f"{tag}: the served plan has hot lists; expected none at nprobe {NPROBE}")
    args = (plan.hot_ids, offsets, plan.qs, codes)
    mma = lambda: sp.sq_hot_list_scan(*args, r=TOPR, members=plan.hot_members)
    staged = lambda: sp._launch(*args, TOPR, hot=True, route="staged")
    turns = [time_ms(f, iters=50) for f in (staged, mma, mma, staged)]
    res = {"ms": (turns[1] + turns[2]) / 2, "staged_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns}
    log(f"[{tag}] K7 on the served plan ({plan.hot_ids.numel()} hot entries, all -1), in turns staged / mma / "
        f"mma / staged: {' / '.join(f'{t:.4f}' for t in turns)} ms; route mma {res['ms']:.4f} ms, route staged "
        f"{res['staged_ms']:.4f} ms (+{res['ms'] - res['staged_ms']:.4f}) [{label}]")
    return res


def k6_routes() -> dict:
    from colbert_tpu_torch.ops import sq_probe_batched as sp

    return {k: c.value for k, c in sp.route_launches.items()}


def k8_routes() -> dict:
    from colbert_tpu_torch.ops import pq4

    return {k: c.value for k, c in pq4.route_launches.items()}


def k10_routes() -> dict:
    from colbert_tpu_torch.ops import sq_probe

    return {k: c.value for k, c in sq_probe.route_launches.items()}


def assert_k10_on_fused(tag, before):
    """Every K10 launch since ``before`` (``k10_routes()``) took route "fused", and there was one."""
    got = {k: v - before[k] for k, v in k10_routes().items()}
    log(f"[{tag}] K10 launches by route in the served batches: {got}")
    if got["staged"] or not got["fused"]:
        raise AssertionError(f"{tag}: K10 launches by route {got}, expected all on route fused")


def assert_k8_on_onehot(tag, before):
    """Every K8 launch since ``before`` (``k8_routes()``) took route "onehot", and there was one."""
    got = {k: v - before[k] for k, v in k8_routes().items()}
    log(f"[{tag}] K8 launches by route in the served batches: {got}")
    if got["lookup"] or not got["onehot"]:
        raise AssertionError(f"{tag}: K8 launches by route {got}, expected all on route onehot")


def assert_k6_on_mma(tag, before):
    """Every K6 launch since ``before`` (``k6_routes()``) took route "mma", and there was one."""
    got = {k: v - before[k] for k, v in k6_routes().items()}
    log(f"[{tag}] K6 launches by route in the served batches: {got}")
    if got["staged"] or not got["mma"]:
        raise AssertionError(f"{tag}: K6 launches by route {got}, expected all on route mma")


def k6_both_routes(tag, queries, plan, offsets, codes, label):
    """K6 on one batch's slot schedule: the filled slots' histogram (list
    rows, members), route "mma" (through the wrapper) and route "staged" (the
    first design) each against the plain version and timed, the longest
    slot alone on both routes, and the bound."""
    import torch

    from colbert_tpu_torch.ops import sq_probe_batched as sp

    qidx, qs = plan.sched.qidx, plan.qs
    (S, tpl), K, T = qidx.shape, offsets.numel() - 1, qs.shape[0]
    filled = qidx[:, 0] >= 0
    slots = torch.nonzero(filled).flatten()
    lens_d = torch.diff(offsets).long()
    rows = lens_d[slots % K]
    members = (qidx[filled] >= 0).sum(dim=1)
    pct = lambda t, p: float(torch.quantile(t.double(), p))
    hist = {"filled": int(slots.numel()), "slots": S,
            "rows": {"median": pct(rows, 0.5), "p99": pct(rows, 0.99), "max": int(rows.max())},
            "members": {"median": pct(members, 0.5), "p99": pct(members, 0.99), "max": int(members.max())},
            "pairs": int((rows * members).sum())}
    log(f"[{tag}] K6 histogram ({queries} batch): {hist['filled']} of {S} slots filled; list rows of a filled "
        f"slot median {hist['rows']['median']:.0f}, p99 {hist['rows']['p99']:.0f}, max {hist['rows']['max']}; "
        f"members a slot median {hist['members']['median']:.0f}, p99 {hist['members']['p99']:.0f}, max "
        f"{hist['members']['max']}; {hist['pairs']} (row, token) pairs")

    mma = lambda: sp.sq_batch_list_scan(qidx, offsets, qs, codes, r=TOPR)
    staged = lambda: sp._launch(qidx, offsets, qs, codes, TOPR, hot=False, route="staged")
    plain = lambda: sp.sq_batch_list_scan_ref(qidx, offsets, qs, codes, r=TOPR)
    # the plain version's top-(r+1): a kernel's r-th row may be its (r+1)-th where the two tie
    # (route "mma" sums on the tensor cores: exact ties as in exact_at_ties;
    # the products are bf16 queries x int8 codes)
    flat = lambda t: t[filled].transpose(1, 2).reshape(-1, t.shape[1])
    ws, wr = (flat(t) for t in sp.sq_batch_list_scan_ref(qidx, offsets, qs, codes, r=TOPR + 1))
    exact, n_ties = exact_at_ties(ws, wr, codes, qs.to(torch.bfloat16), qidx[filled].reshape(-1).long())

    def check(name, got):
        gs, gr = (torch.cat([flat(t), w[:, TOPR:]], dim=1) for t, w in zip(got, (ws, wr)))
        return ranked_rows(tag, f"{name} ({queries}; {n_ties} entries in exact ties of the plain version)",
                           (gs, gr), (ws, wr), exact)

    before = k6_routes()
    got = mma()
    if k6_routes()["mma"] != before["mma"] + 1:
        raise AssertionError(f"{tag}: K6's wrapper did not launch route mma")
    res = {"max_abs_err": check("K6 route mma", got), "staged_max_abs_err": check("K6 route staged", staged())}
    del got, ws, wr, exact
    res.update(ms=time_ms(mma), staged_ms=time_ms(staged), plain_ms=time_ms(plain, iters=2, warmup=1),
               library_ms=None, kernel_route="mma", histogram=hist)
    # route "mma"'s work list alone: the plain version's slots, most 64-row stages first
    items, count = sp.work_list_kernel(qidx, offsets)
    want_items, want_count = sp.slot_work_list(qidx, offsets)
    got = items[: int(count)].long()
    stages = ((lens_d[got % K] + 63) // 64).clamp(max=sp.WORK_BUCKETS - 1)
    if int(count) != int(want_count) or (stages[1:] > stages[:-1]).any() or not torch.equal(
            torch.sort(got)[0], torch.sort(want_items[: int(count)].long())[0]):
        raise AssertionError(f"{tag}: K6's work list differs from its plain version")
    res["work_list_ms"] = time_ms(lambda: sp.work_list_kernel(qidx, offsets))
    # the longest slot alone: its list's slot filled in a K-slot schedule
    s_long = int(slots[int(torch.argmax(rows))])
    one = torch.full((K, tpl), -1, dtype=torch.int32, device=qidx.device)
    one[s_long % K] = qidx[s_long]
    res["longest_slot_ms"] = {
        route: time_ms(lambda: sp._launch(one, offsets, qs, codes, TOPR, hot=False, route=route))
        for route in ("mma", "staged")}
    # bf16-rounded queries x int8 codes, both exact in bf16: the tensor-core
    # rate; bytes: each distinct filled list's codes once, the filled slots'
    # qidx rows (an empty slot's first int), qs, offsets, the filled outputs
    used = torch.unique(slots % K)
    n_filled = hist["filled"]
    res["bound_ms"], res["bound_by"] = bound(
        2.0 * SQ_DIM * hist["pairs"],
        float(lens_d[used].sum()) * SQ_DIM + (n_filled * tpl + S - n_filled) * 4
        + T * SQ_DIM * 4 + offsets.numel() * 4 + n_filled * TOPR * tpl * 8, PEAK_BF16_FLOPS)
    log(f"[{tag}] K6 ({queries} batch): route mma {res['ms']:.4f} ms (its work-list kernel alone "
        f"{res['work_list_ms']:.4f} ms), route staged (first design) "
        f"{res['staged_ms']:.4f} ms ({res['staged_ms'] / res['ms']:.2f}x), plain {res['plain_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}); longest slot alone ({hist['rows']['max']} rows) "
        f"mma {res['longest_slot_ms']['mma']:.4f} ms, staged {res['longest_slot_ms']['staged']:.4f} ms; "
        f"no single PyTorch call computes it [{label}]")
    return res


LOW_REUSE_DOCS = 200_000  # the low-reuse table: the serving batch's pids spread over 10x the docs


def phase_rerank(device, cand, Qb, table, docs, label, seed=SEED):
    """Phase 5a for K4/K5: on the serving batch's candidates (144 x 4,096
    over the 20,000-doc bf16 table and its int8 quantization) and in the
    low-reuse case (the same candidates mapped onto a 200,000-doc table, p
    -> 10p + b mod 10, about two readers a doc), each kernel against its
    plain version on route "wgmma" (scores within ``SCORE_ATOL``, -inf
    exactly where cand < 0), its wrapper's time (schedule included), the
    schedule's alone, the first design's (route "staged") on the same
    inputs, its bound, and the bytes each design moves."""
    import torch

    from colbert_tpu_torch.ops import rerank as rr

    q8, scale = rr.quantize_emb_table(docs)
    t8 = torch.from_numpy(q8).to(device)
    Qs = Qb * torch.from_numpy(1.0 / scale).to(device)
    del q8
    g = torch.Generator(device).manual_seed(seed + 5)
    low = {"K4": unit_rows_bf16(LOW_REUSE_DOCS * 16, H, device, seed + 5),
           "K5": torch.randint(-127, 128, (LOW_REUSE_DOCS * 16, H), dtype=torch.int8, device=device, generator=g)}
    low_q = {"K4": Qb, "K5": Qb / 127.0}  # a descale for int8 values drawn from +-127
    b_mod = (torch.arange(B, device=device, dtype=torch.int32) % 10)[:, None]
    cand_low = torch.where(cand >= 0, cand * 10 + b_mod, cand)
    out = {}
    for name, fn, ref, tdt, tab, q, terms in (
        ("K4", rr.maxsim_rerank_uniform, rr.maxsim_rerank_uniform_ref, torch.bfloat16, table, Qb, 1),
        ("K5", rr.maxsim_rerank_uniform_int8, rr.maxsim_rerank_uniform_int8_ref, torch.int8, t8, Qs, 3),
    ):
        res = {}
        for case, c, tb, qq in (("serving", cand, tab, q), ("low-reuse", cand_low, low[name], low_q[name])):
            route = rr.rerank_plan(16, M, H)
            before = rr.route_launches[route].value
            got, want = fn(c, qq, tb, dv=16), ref(c, qq, tb, dv=16)
            torch.cuda.synchronize()
            live = c >= 0
            if route != "wgmma" or rr.route_launches[route].value != before + 1:
                raise AssertionError(f"{name} {case}: not one launch on route wgmma ({route})")
            if not torch.equal(torch.isfinite(got), live) or not torch.isneginf(got[~live]).all() \
                    or not torch.equal(torch.isfinite(want), live):
                raise AssertionError(f"{name} {case}: -inf pattern differs from the -1 candidates")
            err = float((got[live] - want[live]).abs().max())
            nv, n_unique = int(live.sum()), int(torch.unique(c[live]).numel())
            num_docs = tb.shape[0] // 16
            doc_bytes = 16 * H * tb.element_size()
            window = rr.window_docs(num_docs, c.shape[1], doc_bytes)
            _, _, wstart = rr.rerank_schedule(c, num_docs, window)
            items = int((wstart[:, 1:] > wstart[:, :-1]).sum())
            log(f"[phase5a] {name} {case}: {B} x {c.shape[1]} candidates ({nv} valid, {n_unique} distinct docs "
                f"of {num_docs}) x 16 rows x {H}: max|d|={err:.3e} (limit {SCORE_ATOL}) [route {route}]")
            if not err <= SCORE_ATOL:
                raise AssertionError(f"{name} {case} differs from its plain version by {err}")
            t = {"max_abs_err": err,
                 "ms": time_ms(lambda: fn(c, qq, tb, dv=16)),
                 "schedule_ms": time_ms(lambda: (rr.rerank_schedule(c, num_docs, window),
                                                 rr.query_operand(qq, tdt == torch.int8))),
                 "staged_ms": time_ms(lambda: rr._launch(c, qq, tb, 16, tdt, fn.launches, route="staged"), iters=5),
                 "plain_ms": time_ms(lambda: ref(c, qq, tb, dv=16), iters=2, warmup=1)}
            # each input read once: every distinct candidate doc's rows once
            t["bound_ms"], t["bound_by"] = bound(
                terms * 2.0 * nv * 16 * H * M,
                n_unique * doc_bytes + c.numel() * 4 + qq.numel() * 4 + c.numel() * 4, PEAK_BF16_FLOPS)
            # what each design moves, by construction: "wgmma" reads each distinct
            # doc from device memory once if a window's blocks stay in L2, and
            # streams every pair's block plus each item's query into the SMs;
            # "staged" reads every pair's block from device memory (its readers of
            # one doc are spread over the launch)
            q_item = (48 if tdt == torch.int8 else 16) * H * 2
            t["hbm_gb"] = {"wgmma": n_unique * doc_bytes / 1e9, "staged": nv * doc_bytes / 1e9}
            t["l2_gb"] = {"wgmma": (nv * doc_bytes + items * q_item) / 1e9, "staged": nv * doc_bytes / 1e9}
            log(f"[phase5a] {name} {case}: kernel {t['ms']:.3f} ms (schedule {t['schedule_ms']:.3f} ms of it; "
                f"{window}-doc windows, {items} non-empty (window, query) items), first design (route staged) "
                f"{t['staged_ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}); bytes moved: device memory wgmma {t['hbm_gb']['wgmma']:.3f} GB vs staged "
                f"{t['hbm_gb']['staged']:.3f} GB, L2 -> SMs wgmma {t['l2_gb']['wgmma']:.3f} GB vs staged "
                f"{t['l2_gb']['staged']:.3f} GB; no single PyTorch call computes it [{label}]")
            res[case] = t
        out[name] = {**res["serving"], "kernel_route": "wgmma", "low_reuse": res["low-reuse"],
                     "wide": wide_query_rerank(name, fn, ref, cand, q, tab, terms, label)}
        del got, want
    return out


WIDE_ROWS = (48, 64)  # query rows past one K4/K5 launch's (16 on route "wgmma", 32 on "wgmma_rows")


def wide_query_rerank(name, fn, ref, cand, q, table, terms, label):
    """Phase 5a: K4 or K5 on the serving batch's candidates at 48 and 64
    query rows (the batch's rows, then other queries' rows: ``q`` rolled
    along the batch): a launch a 16-row chunk on route "wgmma", the
    schedule once a call, against the plain version over all the rows
    (within ``SCORE_ATOL``, -inf exactly at the -1 candidates), timed beside
    its bound (each distinct doc block read once, or the operations)."""
    import torch

    from colbert_tpu_torch.ops import rerank as rr

    counter = fn.launches
    out = {}
    for qv in WIDE_ROWS:
        qq = torch.cat([q.roll(i, 0) for i in range(-(-qv // q.shape[1]))], dim=1)[:, :qv].contiguous()
        chunk = rr.row_chunk(16, qv, H)
        n, route = -(-qv // chunk), rr.rerank_plan(16, chunk, H)
        before, k_before = {k: c.value for k, c in rr.route_launches.items()}, counter.value
        got, want = fn(cand, qq, table, dv=16), ref(cand, qq, table, dv=16)
        torch.cuda.synchronize()
        launched = {k: c.value - before[k] for k, c in rr.route_launches.items()}
        if route != "wgmma" or counter.value - k_before != n or launched != {k: n * (k == route) for k in launched}:
            raise AssertionError(f"{name} at {qv} query rows: launches {launched}, expected {n} on route wgmma")
        live = cand >= 0
        if not torch.equal(torch.isfinite(got), live) or not torch.isneginf(got[~live]).all():
            raise AssertionError(f"{name} at {qv} query rows: -inf pattern differs from the -1 candidates")
        err = float((got[live] - want[live]).abs().max())
        if not err <= SCORE_ATOL:
            raise AssertionError(f"{name} at {qv} query rows differs from its plain version by {err}")
        nv, n_unique = int(live.sum()), int(torch.unique(cand[live]).numel())
        doc_bytes = 16 * H * table.element_size()
        r = {"launches": n, "max_abs_err": err, "ms": time_ms(lambda: fn(cand, qq, table, dv=16))}
        r["bound_ms"], r["bound_by"] = bound(terms * 2.0 * nv * 16 * H * qv,
                                             n_unique * doc_bytes + 2 * cand.numel() * 4 + qq.numel() * 4,
                                             PEAK_BF16_FLOPS)
        log(f"[phase5a] {name} at {qv} query rows ({n} launches of {chunk} rows, route {route}): max|d|={err:.3e} "
            f"(limit {SCORE_ATOL}); {r['ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{label}]")
        out[qv] = r
    return out


# ---- phase 6: the pq4 and pq codecs and the token-major sq probe ----

PQ4_M, PQ_M, PQ_NBITS, PQ_KMEANS_ITERS = 128, 64, 8, 10
CODEC_RECALL = 0.95  # recall@100 each phase-6 path must reach
SMEM_LOADS_PER_CLOCK = 132 * 32  # 4-byte shared-memory loads per clock on the card's 132 SMs
KSUB_PQ4 = 16  # codewords a pq4 subspace: the one-hot product's k a subspace


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def codec_config(cfg, index_path, port, codec, probe_impl="auto"):
    """``ann_config`` with another codec (pq4: m 128 x 4 bits; pq: m 64 x 8
    bits) or the token-major sq probe."""
    out = ann_config(cfg, index_path, port)
    out.index.codec, out.index.pq4_m, out.index.pq_m, out.index.pq_nbits = codec, PQ4_M, PQ_M, PQ_NBITS
    out.index.pq_kmeans_iters = PQ_KMEANS_ITERS
    out.serve.probe_impl = probe_impl
    return out


def share_parts(src: Path, dst: Path) -> None:
    """A new index directory over ``src``'s encoded parts (linked, not copied)."""
    import shutil

    (dst / "ivf").mkdir(parents=True)
    (dst / "parts").symlink_to((src / "parts").resolve(), target_is_directory=True)
    shutil.copy(src / "meta.json", dst / "meta.json")


def phase_codecs_cli(device, workdir: Path, cfg, common, corpus_path, eval_path, docs, requests,
                     flat_searcher, n_eval):
    """Phase 6c: on phase 2's encoded corpus, ``build-index`` with the pq4
    codec, ``serve`` it with ``serve.mode=ann`` over the socket (two
    requests, ``evaluate --remote``), and one request through a service of
    phase 5c's sq index with ``serve.probe_impl=token``; the launch counts
    of that run."""
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.serving.server import RetrievalClient

    index = workdir / "index_pq4"
    share_parts(workdir / "index", index)
    pcfg = codec_config(cfg, index, free_port(), "pq4")
    conf = workdir / "conf_pq4.yaml"
    pcfg.to_yaml(conf)
    args = ["--config", str(conf), *common[2:]]
    t0 = time.perf_counter()
    cli.main(["build-index", *args])
    log(f"[phase6c] build-index (pq4, m {PQ4_M}) over phase 2's {len(docs)} encoded docs in "
        f"{time.perf_counter() - t0:.1f} s")
    serve_err = []

    def serve():
        try:
            cli.main(["serve", "--corpus", str(corpus_path), *args])
        except BaseException as e:  # noqa: BLE001 -- reported by the main thread
            serve_err.append(e)

    server = threading.Thread(target=serve, daemon=True, name="serve-pq4")
    server.start()
    tcfg = codec_config(cfg, cfg.index.index_path, 0, "sq", "token")
    ns = argparse.Namespace(pretrain=common[common.index("--pretrain") + 1], checkpoint_step=None,
                            device=str(device), corpus=str(corpus_path))
    service_tok = cli.make_service(tcfg, ns)
    client = RetrievalClient(pcfg.serve.host, pcfg.serve.port, pcfg.serve.authkey.encode())
    from multiprocessing.connection import Client

    deadline = time.time() + 600
    while True:
        if serve_err:
            raise RuntimeError(f"pq4 serve failed: {serve_err[0]!r}")
        try:
            Client((pcfg.serve.host, pcfg.serve.port), authkey=pcfg.serve.authkey.encode()).close()
            break
        except ConnectionRefusedError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)
    client.retrieve(requests[0][:1], topk=TOPK, depth=DEPTH, nprobe=NPROBE)  # warm-ups, not counted
    service_tok.retrieve(requests[0][:1], topk=TOPK)

    # ---- the counted run of the pq4 and token-probe serving paths ----
    reset_counts()
    answers, lat = [], []
    for qs in requests[:2]:
        t0 = time.perf_counter()
        answers.append(client.retrieve(qs, topk=TOPK, depth=DEPTH, nprobe=NPROBE))
        lat.append(time.perf_counter() - t0)
    cli.main(["evaluate", "--eval-data", str(eval_path), "--remote", "--topk", str(TOPK), *args])
    t0 = time.perf_counter()
    answers_tok = service_tok.retrieve(requests[0], topk=TOPK)
    lat_tok = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts()
    # ----

    client.shutdown()
    server.join(timeout=60)
    if server.is_alive() or serve_err:
        raise RuntimeError(f"pq4 server did not stop cleanly: {serve_err}")
    for i, dt in enumerate(lat):
        log(f"[phase6c] pq4 request {i}: {B} questions top-{TOPK} in {dt * 1e3:.1f} ms over the socket")
    log(f"[phase6c] sq token-probe service: {B} questions top-{TOPK} in {lat_tok * 1e3:.1f} ms in process")
    eval_batches = -(-n_eval // B)
    want = {"K8": 2 + eval_batches, "K10": 1, "K10 fused route": 1, "K10 staged route": 0,
            "K4": 3 + eval_batches, "K5": 0, "K6": 0, "K7": 0,
            "K4/K5 wgmma route": 3 + eval_batches, "K4/K5 staged route": 0, "K4/K5 wgmma_rows route": 0,
            "K6 mma route": 0, "K6 staged route": 0, "K7 mma route": 0, "K7 staged route": 0,
            "K8 onehot route": 2 + eval_batches, "K8 lookup route": 0}
    log(f"[phase6c] launches in the pq4 / token-probe serving-path run: {launches} (expected {want}: "
        f"2 socket requests and {eval_batches} evaluate --remote batches on the pq4 index, one "
        f"token-probe batch on the sq index)")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"kernel launches {launches} do not match the served batches {want}")
    serialized_on_cpp("phase6c", launches, 2 + eval_batches)
    worst = {
        "pq4": max(check_answers("pq4", qs, ans, flat_searcher, docs, device)
                   for qs, ans in zip(requests, answers)),
        "sq token": check_answers("sq token", requests[0], answers_tok, flat_searcher, docs, device),
    }
    log(f"[phase6c] served scores vs the exact MaxSim of the returned pids: max|d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" (limit {SCORE_ATOL})")
    if max(worst.values()) > SCORE_ATOL:
        raise AssertionError(f"served scores differ from exact MaxSim: {worst}")
    return launches


def k8_both_routes(tag, lists, offsets, lut, codes, label):
    """K8 on one batch's probes: the histogram (members and rows of a probed
    list), route "onehot" (through the wrapper, one launch counted on it) and
    route "lookup" (the first design) each against the plain version and
    timed, route "onehot"'s work list alone against its plain version, the
    bounds, and route "lookup"'s clock64 phase split (Step 0,
    ``scripts/pq4_scan_variants.py``)."""
    import importlib.util

    import torch

    from colbert_tpu_torch.ops import pq4, sq_probe_batched as sp

    T, m = lut.shape[0], lut.shape[1]
    K = offsets.numel() - 1
    lens = torch.diff(offsets).long()
    members = torch.zeros(K, dtype=torch.long, device=lists.device).scatter_add_(
        0, lists.reshape(-1).long(), torch.ones(lists.numel(), dtype=torch.long, device=lists.device))
    probed = members > 0
    pct = lambda t, q: float(torch.quantile(t.double(), q))
    rows = float(lens[lists.long()].sum())
    hist = {"probed": int(probed.sum()), "lists": K, "pairs": int(lists.numel()), "rows_scored": rows,
            "members": {"median": pct(members[probed], 0.5), "p99": pct(members[probed], 0.99),
                        "max": int(members.max())},
            "rows": {"median": pct(lens[probed], 0.5), "p99": pct(lens[probed], 0.99), "max": int(lens[probed].max())}}
    # The query-major item, the other way to group K8's work: a query's M
    # tokens against the union of their probed lists (non-members masked).
    # A wgmma's cost does not depend on its width (scripts/pq4_scan_variants.py),
    # so the products' cost follows the count of (64-row tile, subspace)
    # wgmmas: list-major, a tile of each item (up to 64 members); query-major,
    # a tile of each list of each query's union.
    tiles = (lens + 63) // 64
    per_query = lists.reshape(T // M, M * lists.shape[1]).long()
    union = torch.zeros(T // M, K, dtype=torch.bool, device=lists.device).scatter_(1, per_query, True)
    items = (members + pq4.ONEHOT_GROUP - 1) // pq4.ONEHOT_GROUP
    hist["query_union_lists"] = {"median": pct(union.sum(dim=1), 0.5), "max": int(union.sum(dim=1).max())}
    hist["wgmmas"] = {"list_major": int((items * tiles).sum()) * m, "query_major": int((union * tiles).sum()) * m}
    log(f"[{tag}] K8 histogram: {hist['probed']} of {K} lists probed by {T} tokens x {lists.shape[1]}; members a "
        f"probed list median {hist['members']['median']:.0f}, p99 {hist['members']['p99']:.0f}, max "
        f"{hist['members']['max']}; rows a probed list median {hist['rows']['median']:.0f}, p99 "
        f"{hist['rows']['p99']:.0f}, max {hist['rows']['max']}; {rows:.0f} (token, row) pairs scored; the union "
        f"of a query's {M} tokens' lists median {hist['query_union_lists']['median']:.0f}, max "
        f"{hist['query_union_lists']['max']}; (64-row tile, subspace) wgmmas list-major "
        f"{hist['wgmmas']['list_major']}, query-major {hist['wgmmas']['query_major']}")

    onehot = lambda: pq4.pq4_list_scan(lists, offsets, lut, codes, r=TOPR)
    lookup = lambda: pq4._launch(lists, offsets, lut, codes, TOPR, route="lookup")
    plain = lambda: pq4.pq4_list_scan_ref(lists, offsets, lut, codes, r=TOPR)
    # The plain version's top-(r+1): a kernel's r-th row may be its (r+1)-th
    # where they tie.  Route "onehot" sums on the tensor cores in another
    # order, so two different rows may round to one fp32 score on one side
    # only: an exact tie of the plain version counts as a near tie where the
    # rows' exact sums (fp64 over the bf16 LUT entries) differ.
    ws, wr = (t.reshape(T * lists.shape[1], TOPR + 1) for t in
              pq4.pq4_list_scan_ref(lists, offsets, lut, codes, r=TOPR + 1))
    fin = torch.isfinite(ws)
    tie = torch.zeros_like(fin)
    same = (ws[:, 1:] == ws[:, :-1]) & fin[:, 1:]
    tie[:, 1:] |= same
    tie[:, :-1] |= same
    exact = ws.double()
    u, k = torch.nonzero(tie, as_tuple=True)
    nib = pq4.pq4_unpack(codes[wr[u, k].long()]).long()                         # (n, m)
    lutb = lut.to(torch.bfloat16).double()[u // lists.shape[1]]                  # (n, m, 16)
    exact[u, k] = lutb.gather(2, nib[..., None]).sum(dim=(1, 2))

    def check(name, got):
        gs, gr = (torch.cat([t.reshape(-1, TOPR), w[:, TOPR:]], dim=1) for t, w in zip(got, (ws, wr)))
        err, bad = sp.ranked_mismatch(ws, wr, gs, gr, PROBE_ATOL, exact)
        log(f"[{tag}] K8 {name} ({len(u)} entries in exact ties of the plain version): max|d|={err:.3e} "
            f"(limit {PROBE_ATOL}), rows mismatched outside near ties {bad}")
        if err > PROBE_ATOL or bad:
            raise AssertionError(f"K8 {name} differs from its plain version: max|d| {err}, {bad} rows")
        return err

    before = k8_routes()
    got = onehot()
    if k8_routes()["onehot"] != before["onehot"] + 1:
        raise AssertionError(f"{tag}: K8's wrapper did not launch route onehot")
    res = {"max_abs_err": check("route onehot", got), "lookup_max_abs_err": check("route lookup", lookup())}
    del got, ws, wr, exact, lutb, nib
    res.update(ms=time_ms(onehot), lookup_design_ms=time_ms(lookup), plain_ms=time_ms(plain, iters=1, warmup=1),
               library_ms=None, kernel_route="onehot", histogram=hist)
    # route "onehot"'s work list alone: the plain version's items, most work first
    got_wl, want_wl = pq4.work_list_kernel(lists, offsets), pq4.pq4_work_list(lists, offsets)
    n = int(want_wl.count)
    l_flat = lists.reshape(-1).long()

    def items(wl):
        it = wl.items[:n].long()
        li = l_flat[wl.pairs.long()[it]]
        mem = torch.clamp(wl.cnt.long()[li] + wl.lstart.long()[li] - it, max=pq4.ONEHOT_GROUP)
        return li, mem, pq4.item_buckets(offsets, li, mem)

    (gl, gm, gb), (wl_, wm, wb) = items(got_wl), items(want_wl)
    if (int(got_wl.count) != n or not torch.equal(gb, wb) or not torch.equal(
            torch.sort(gl * 1000 + gm)[0], torch.sort(wl_ * 1000 + wm)[0])):
        raise AssertionError(f"{tag}: K8's work list differs from its plain version")
    hist["items"] = n
    res["work_list_ms"] = time_ms(lambda: pq4.work_list_kernel(lists, offsets))
    # The function's bound, both routes: the one-hot product on the tensor
    # cores, 2 x 16 x m FLOP a (token, row) pair at the bf16 rate; bytes: each
    # distinct probed list's codes once, the bf16 LUT, lists, offsets, the
    # output.  Route "lookup"'s own: one shared-memory load a (token, row,
    # subspace), 32 a clock on each of the 132 SMs.
    clock = max_sm_clock_hz()
    distinct = float(lens[torch.unique(lists).long()].sum())
    res["bound_ms"], res["bound_by"] = bound(
        2.0 * KSUB_PQ4 * m * rows, distinct * m // 2 + lut.numel() * 2 + lists.numel() * 4 + offsets.numel() * 4
        + lists.numel() * TOPR * 8, PEAK_BF16_FLOPS)
    res["lookup_bound_ms"] = bound(m * rows, 0.0, SMEM_LOADS_PER_CLOCK * clock)[0]
    spec = importlib.util.spec_from_file_location(
        "pq4_scan_variants", Path(__file__).resolve().parent / "scripts" / "pq4_scan_variants.py")
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    split, cycles = variants.lookup_phase_split(lists, offsets, lut, codes, TOPR)
    res["lookup_phase_split"] = split
    log(f"[{tag}] K8: route onehot {res['ms']:.4f} ms (its work-list kernels alone {res['work_list_ms']:.4f} ms, "
        f"{n} items), route lookup (first design) {res['lookup_design_ms']:.4f} ms "
        f"({res['lookup_design_ms'] / res['ms']:.2f}x), plain {res['plain_ms']:.3f} ms; bound {res['bound_ms']:.4f} "
        f"ms ({res['bound_by']}: {2.0 * KSUB_PQ4 * m * rows / 1e9:.1f} GFLOP of one-hot products), route lookup's "
        f"own bound {res['lookup_bound_ms']:.4f} ms ({m * rows / 1e9:.2f} G shared-memory lookups at "
        f"{SMEM_LOADS_PER_CLOCK} a clock x {clock / 1e6:.0f} MHz); route lookup's clock64 split "
        + ", ".join(f"{ph} {v:.3f}" for ph, v in split.items()) + f" of {cycles:.0f} cycles a warp; "
        f"no single PyTorch call computes it [{label}]")
    return res


def k10_both_routes(tag, tokens, coarse, quant, codes, offsets, cap, label):
    """K10 on one token batch (``NPROBE`` windows a token, top-``DEPTH``):
    the rows a token scores (median, p99, max, and the tokens past the keys
    route "fused" keeps in shared memory); route "fused" (through the
    wrapper, one launch counted on it) against route "staged" +
    ``_window_topk`` bit for bit, and against the plain version's
    top-(DEPTH+1) within near ties; route "staged"'s scan against the
    plain scan; the token probe's parts timed apart on both routes (coarse
    GEMM + top-nprobe, windows, ``sq_query``, the staged scan,
    ``_window_topk``, route "fused"); both routes' bounds."""
    import torch

    from colbert_tpu_torch.ops import ivf, sq_probe, sq_probe_batched as sp
    from colbert_tpu_torch.ops.sq import sq_query

    proj, scales = quant
    T = tokens.shape[0]
    lists = ivf.coarse_lists(tokens, coarse, NPROBE)
    starts = offsets[lists]
    wlens = (offsets[lists + 1] - starts).clamp(max=cap)
    qs = sq_query(tokens, proj, scales)
    per_token = wlens.sum(dim=1)
    keys_cap = min(NPROBE * cap, sq_probe._kernel_lib().sq_window_topk_keys_room(NPROBE, DEPTH))
    pct = lambda q: float(torch.quantile(per_token.double(), q))
    hist = {"median": pct(0.5), "p99": pct(0.99), "max": int(per_token.max()), "keys_cap": keys_cap,
            "tokens_past_keys_cap": int((per_token > keys_cap).sum())}
    log(f"[{tag}] K10 rows a token: median {hist['median']:.0f}, p99 {hist['p99']:.0f}, max {hist['max']}; "
        f"{hist['tokens_past_keys_cap']} of {T} tokens past the {keys_cap} keys route fused keeps in shared memory")

    fused = lambda: sq_probe.sq_window_topk(starts, wlens, qs, codes, cap=cap, depth=DEPTH)
    staged = lambda: sq_probe.sq_window_topk(starts, wlens, qs, codes, cap=cap, depth=DEPTH, route="staged")
    before = k10_routes()
    gs, gr = fused()
    if k10_routes()["fused"] != before["fused"] + 1:
        raise AssertionError(f"{tag}: K10's wrapper did not launch route fused")
    ss, sr = staged()
    same = torch.equal(gs.view(torch.int32), ss.view(torch.int32)) and torch.equal(gr, sr)
    log(f"[{tag}] K10 route fused against route staged + _window_topk: "
        f"{'bit-equal' if same else 'DIFFERENT'} scores and rows")
    if not same:
        raise AssertionError(f"{tag}: K10 route fused differs from route staged + _window_topk")
    dense = sq_probe.sq_list_scan(starts, wlens, qs, codes, cap=cap)
    plain = sq_probe.sq_list_scan_ref(starts, wlens, qs, codes, cap=cap)
    fin = torch.isfinite(plain)
    if not torch.equal(fin, torch.isfinite(dense)):
        raise AssertionError("K10: the -inf pattern differs from the plain version")
    scan_err = float((dense[fin] - plain[fin]).abs().max())
    log(f"[{tag}] K10 staged scan: {int(fin.sum())} scored slots of {fin.numel()}: max|d|={scan_err:.3e} "
        f"(limit {PROBE_ATOL})")
    if scan_err > PROBE_ATOL:
        raise AssertionError(f"K10's scan differs from its plain version by {scan_err}")
    # Among ~10^4 scores a token, different rows often sum to one fp32 value
    # on one side and not the other: an exact tie of the plain version counts
    # as near where the kernel's scores of its rows differ, and two rows at
    # one rank do where each scores within PROBE_ATOL of the other side's
    # score there, on the other side
    ws, wi = sq_probe.topk_first(plain, DEPTH)
    wr = torch.where(torch.isfinite(ws), starts.long().gather(1, wi // cap) + wi % cap, -1).int()
    want_at_got = torch.einsum("tkd,td->tk", codes[gr.clamp(min=0).long()].float(), qs).masked_fill(
        gr < 0, float("-inf"))
    err, bad = sp.ranked_mismatch(ws, wr, gs, gr, PROBE_ATOL, dense.gather(1, wi), want_at_got)
    log(f"[{tag}] K10 route fused top-{DEPTH} vs the plain version: max|d|={err:.3e} (limit {PROBE_ATOL}), "
        f"rows mismatched outside near ties {bad}")
    if err > PROBE_ATOL or bad:
        raise AssertionError(f"K10 route fused differs from its plain version: max|d| {err}, {bad} rows")
    del plain, fin, ws, wi, wr, want_at_got, ss, sr, gs, gr

    windows = lambda: (offsets[lists], (offsets[lists + 1] - offsets[lists]).clamp(max=cap))
    parts = {"coarse_topk": time_ms(lambda: ivf.coarse_lists(tokens, coarse, NPROBE)),
             "windows": time_ms(windows), "sq_query": time_ms(lambda: sq_query(tokens, proj, scales)),
             "staged_scan": time_ms(lambda: sq_probe.sq_list_scan(starts, wlens, qs, codes, cap=cap)),
             "window_topk": time_ms(lambda: sq_probe._window_topk(dense, starts, cap, DEPTH)),
             "fused": time_ms(fused)}

    def stage(route):
        ls = ivf.coarse_lists(tokens, coarse, NPROBE)
        st, ln = offsets[ls], (offsets[ls + 1] - offsets[ls]).clamp(max=cap)
        return sq_probe.sq_window_topk(st, ln, sq_query(tokens, proj, scales), codes, cap=cap, depth=DEPTH,
                                       route=route)

    res = {"max_abs_err": err, "scan_max_abs_err": scan_err, "kernel_route": "fused", "histogram": hist,
           "ms": parts["fused"], "staged_design_ms": time_ms(staged), "staged_scan_ms": parts["staged_scan"],
           "stage_ms": {"fused": time_ms(lambda: stage("fused")), "staged": time_ms(lambda: stage("staged"))},
           "stage_parts_ms": parts, "library_ms": None,
           "yardstick_staged_torch_topk_ms": time_ms(lambda: torch.topk(dense, DEPTH, dim=1)) + parts["staged_scan"],
           "plain_ms": time_ms(lambda: sq_probe.sq_window_topk_ref(starts, wlens, qs, codes, cap=cap, depth=DEPTH),
                               iters=1, warmup=1)}
    del dense
    # Route "fused": fp32 queries x int8 codes on the CUDA cores, 2 x D FLOP a
    # real row; bytes: each distinct probed list's codes once, qs, the
    # windows, the (T, DEPTH) scores and rows.  Route "staged"'s bound (the
    # scan alone) writes the dense (T, nprobe * cap) scores instead.
    rows = float(wlens.sum())
    distinct = float(torch.diff(offsets).long()[torch.unique(lists)].sum())
    inputs = distinct * SQ_DIM + qs.numel() * 4 + starts.numel() * 8
    res["bound_ms"], res["bound_by"] = bound(2.0 * SQ_DIM * rows, inputs + T * DEPTH * 8, PEAK_FP32_FLOPS)
    res["staged_scan_bound_ms"] = bound(2.0 * SQ_DIM * rows, inputs + T * NPROBE * cap * 4, PEAK_FP32_FLOPS)[0]
    log(f"[{tag}] K10 at {T} tokens x {NPROBE} windows, cap {cap}, depth {DEPTH} ({rows:.0f} real rows, "
        f"{distinct:.0f} distinct): route fused {res['ms']:.4f} ms (bound {res['bound_ms']:.4f}, "
        f"{res['bound_by']}), route staged + _window_topk {res['staged_design_ms']:.4f} ms (its scan alone "
        f"{res['staged_scan_ms']:.4f}, bound {res['staged_scan_bound_ms']:.4f}), plain {res['plain_ms']:.3f} ms; "
        f"yardstick (not in the port) staged scan + torch.topk {res['yardstick_staged_torch_topk_ms']:.4f} ms; "
        f"no single PyTorch call computes it [{label}]")
    log(f"[{tag}] token probe stage (CUDA events): route fused {res['stage_ms']['fused']:.4f} ms, route staged "
        f"{res['stage_ms']['staged']:.4f} ms; parts " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    return res


def phase_codecs(device, workdir: Path, label: str, info: dict):
    """Phase 6a/6b: on phase 5b's corpus, ``build-index`` with the pq4 and
    the pq codec (separate index directories over the same parts), and
    phase 5b's sq index served by the token-major probe (and, for
    reference, the batched one, every K6 launch on route "mma"): recall@100
    against the fp32 oracle over 2 x 144 two-topic queries (at least
    ``CODEC_RECALL``), the fewest candidates a query kept, build seconds and
    the batch's time per stage, and, as information, recall over phase 5b's
    one-topic queries; then K6 (both routes), K8 and K10 against their plain
    versions on the first batch's inputs."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.ops import ivf, pq4, sq_probe, sq_probe_batched as sp
    from colbert_tpu_torch.ops.pq import adc_lut
    from colbert_tpu_torch.ops.sq import sq_query
    from colbert_tpu_torch.ranking import searcher as srch
    from colbert_tpu_torch.tokenization import ColbertTokenizer

    base = info["config"]
    # one topic per query (phase 5b's queries) makes an exact token-major
    # top-512 fall on fewer than 100 docs; the recall here is over queries
    # about two topics each
    Q = torch.from_numpy(two_topic_queries(2 * B, M, H)).to(device)
    qm = torch.ones(B, M, device=device)
    batches = [Q[i * B : (i + 1) * B] for i in range(Q.shape[0] // B)]
    oracle, state, summary = None, {}, {}
    k6_before, k8_before, k10_before = k6_routes(), k8_routes(), k10_routes()
    for name, codec, probe_impl in (("sq batched", "sq", "auto"), ("sq token", "sq", "token"),
                                    ("pq4", "pq4", "auto"), ("pq", "pq", "auto")):
        index = workdir / ("index" if codec == "sq" else f"index_{codec}")
        cfg = codec_config(base, index, 0, codec, probe_impl)
        build_s = None
        if codec != "sq":
            share_parts(workdir / "index", index)
            conf = workdir / f"conf_{codec}.yaml"
            cfg.to_yaml(conf)
            t0 = time.perf_counter()
            cli.main(["build-index", "--config", str(conf), "--device", str(device)])
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        s = srch.ColbertSearcher(cfg, ColbertTokenizer(cfg.tokenizer, cfg.multiview),
                                 ColbertModel(cfg.model, cfg.multiview), IndexStorage(index), device=device)
        if oracle is None:
            oracle = [s.exact_topk(Qb, TOPK)[1].cpu().numpy() for Qb in batches]
        probe = s.probe_fn()

        def recall_of(qs, want):
            """recall@100 over the batches, the fewest candidates of a query, and batch ms."""
            recall, fewest, ms = [], MAX_CAND, []
            for Qb, op in zip(qs, want):
                s.search_reps(Qb, qm)  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ts, tp = s.search_reps(Qb, qm)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                cand = srch.dedup(*srch.probe_pids(Qb, qm, probe, s.pid_by_row), q_view=M, depth=DEPTH,
                                  max_cand=MAX_CAND)
                fewest = min(fewest, int((cand >= 0).sum(dim=1).min()))
                tp = tp.cpu().numpy()
                recall += [len(set(tp[b][tp[b] >= 0]) & set(op[b])) / TOPK for b in range(B)]
            return float(np.mean(recall)), fewest, ms

        rec, fewest, batch_ms = recall_of(batches, oracle)
        one_topic = recall_of([info["queries"][i * B : (i + 1) * B] for i in range(len(info["oracle"]))],
                              info["oracle"])
        Qb = batches[0]
        n_time = 2 if codec == "pq" else 5  # the pq gather probe takes ~0.1 s a batch
        stage = {"probe": time_ms(lambda: srch.probe_pids(Qb, qm, probe, s.pid_by_row), iters=n_time, warmup=1)}
        pids, scores = srch.probe_pids(Qb, qm, probe, s.pid_by_row)
        cand = srch.dedup(pids, scores, q_view=M, depth=DEPTH, max_cand=MAX_CAND)
        stage["dedup"] = time_ms(lambda: srch.dedup(pids, scores, q_view=M, depth=DEPTH, max_cand=MAX_CAND),
                                 iters=5)
        sc = srch.rerank(cand, Qb, s.emb_table, None, dv=16)
        stage["rerank"] = time_ms(lambda: srch.rerank(cand, Qb, s.emb_table, None, dv=16), iters=5)
        stage["topk"] = time_ms(lambda: srch.select_topk(sc, cand, TOPK), iters=5)
        built = f"built in {build_s:.1f} s, " if build_s is not None else "phase 5b's index, "
        log(f"[phase6a] {name}: {built}recall@{TOPK} vs the fp32 exact oracle over {len(batches)} x {B} "
            f"two-topic queries {rec:.4f} (fewest candidates of a query {fewest}); batch "
            f"{' / '.join(f'{t:.1f}' for t in batch_ms)} ms from query reps; ms per stage (CUDA events): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()) + f" [{label}]")
        log(f"[phase6a] {name}: on phase 5b's one-topic queries (information only) recall@{TOPK} "
            f"{one_topic[0]:.4f}, fewest candidates of a query {one_topic[1]}")
        summary[name] = {"recall": rec, "build_s": build_s, "stage_ms": stage, "batch_ms": batch_ms}
        state[name] = (s.coarse, s.quant, s.codes, s.offsets, s.max_list_len)
        del s, cand, sc, pids, scores
    assert_k6_on_mma("phase6a", k6_before)
    assert_k8_on_onehot("phase6a", k8_before)
    assert_k10_on_fused("phase6a", k10_before)

    # ---- 6b: K6, K8 and K10 against their plain versions on the first batch's inputs ----
    tokens = batches[0].reshape(B * M, H)
    T = tokens.shape[0]
    coarse, quant, codes, offsets, _ = state["sq batched"]
    plan = ivf.sq_probe_plan(tokens, coarse, *quant, nprobe=NPROBE,
                             hot_cap=base.serve.probe_hot_lists or max(64, NPROBE))
    out = {"K6": k6_both_routes("phase6b", "two-topic", plan, offsets, codes, label)}
    del plan

    def ranked(name, want, got, got_at_want=None):
        err, bad = sp.ranked_mismatch(*want, *got, PROBE_ATOL, got_at_want)
        log(f"[phase6b] {name}: max|d|={err:.3e} (limit {PROBE_ATOL}), rows mismatched outside near ties {bad}")
        if err > PROBE_ATOL or bad:
            raise AssertionError(f"{name} differs from its plain version: max|d| {err}, {bad} rows")
        return err

    coarse, codebooks, codes, offsets, _ = state["pq4"]
    lists = torch.topk(tokens @ coarse.T, NPROBE, dim=1)[1].int()
    lut = adc_lut(tokens, codebooks)
    out["K8"] = k8_both_routes("phase6b", lists, offsets, lut, codes, label)

    out["K10"] = k10_both_routes("phase6b", tokens, *state["sq token"], label)
    low = {k: v["recall"] for k, v in summary.items() if v["recall"] < CODEC_RECALL}
    if low:  # checked last, so that one run reports every path and kernel
        raise AssertionError(f"recall@{TOPK} below {CODEC_RECALL}: {low}")
    return out, summary


# ---- phase 7: the second stage (mine, train-ce, evaluate --rerank-ce) ----

MINE_TOPK, KEEP_OLD, OLD_NEGS = 50, 10, 15


def ce_config(cfg, workdir: Path, model_kw=None):
    """Phase 2's config (its flat service, its tokenizer) with the cross-encoder
    at macbert-large width and ``ce_train`` at the reference's batch."""
    from colbert_tpu_torch.config import CETrainConfig, ColbertConfig, ModelConfig

    c = ColbertConfig.from_dict(cfg.to_dict())
    c.ce_model = ModelConfig(**{**CE_MODEL, **(model_kw or {}), "vocab_size": cfg.model.vocab_size})
    c.ce_train = CETrainConfig(per_device_batch_size=CE_BATCH, neg_num=CE_NEG, num_epochs=1, evals_per_epoch=2,
                               log_every=1, keep_checkpoints=2, eval_topk=TOPK,
                               checkpoint_dir=str(workdir / "ce"), seed=SEED)
    return c


def phase_second_stage(device, workdir: Path, label: str, ctx: dict, model_kw=None, n_mine=128, n_dev=16,
                       n_rerank=16, ce_steps=7, seed=SEED):
    """Phase 7 on phase 2's encoded corpus, served flat in process: ``mine``,
    ``train-ce`` (straight, resumed, distilled) and ``evaluate --rerank-ce``.
    Returns the launch counts of each counted run and the measurements."""
    import argparse
    import shutil

    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.evaluation import gen_distill_data, gen_iter_train_dev
    from colbert_tpu_torch.models.bert import Dropout
    from colbert_tpu_torch.ops import dropout as dr
    from colbert_tpu_torch.training import CETrainer
    from colbert_tpu_torch.training.checkpoint import CheckpointManager
    from colbert_tpu_torch.utils.io import dump_json, load_json, load_jsonl

    docs, questions, positives = ctx["docs"], ctx["questions"], ctx["positives"]
    rng = np.random.default_rng([seed, 7])
    cfg = ce_config(ctx["cfg"], workdir, model_kw)
    conf = workdir / "conf_ce.yaml"
    cfg.to_yaml(conf)
    # ``--pretrain`` is the retriever's (mine, evaluate); train-ce starts the CE from its seeded init
    ce_common = ["--config", str(conf), "--device", str(device)]
    common = [*ce_common, "--pretrain", ctx["common"][3]]
    corpus = ["--corpus", str(ctx["corpus_path"])]
    c = cfg.ce_model
    log(f"[phase7] cross-encoder hidden={c.hidden_size} layers={c.num_layers} heads={c.num_heads} "
        f"ffn={c.intermediate_size} vocab={c.vocab_size} {c.dtype}, dropout {c.hidden_dropout}/"
        f"{c.attention_dropout} ({c.dropout_impl}), attention softmax {c.attention_softmax_dtype}, ce_maxlen "
        f"{cfg.tokenizer.ce_maxlen}, batch {CE_BATCH} x (1 + {CE_NEG}); retriever: phase 2's, flat, "
        f"{len(docs)} docs")
    per_step_k9 = 2 * (1 + 3 * c.num_layers)  # every dropout site, forward and backward

    # ---- mine: questions with known positives and 15 old negatives each ----
    # half of them phase 2's topic-word questions, half passages asked as
    # questions: the random retriever seldom ranks a topic-word question's
    # positive in its top 8 and a passage's own text far more often (the
    # log line below counts both), and --distill-out keeps only the
    # questions whose window holds the positive
    picks = ctx["free"][: n_mine // 2 + n_rerank]
    asked = [(questions[i], positives[i]) for i in picks[: n_mine // 2]]
    own = rng.choice(len(docs), n_mine - len(asked), replace=False)
    asked = [x for pair in zip(asked, [(docs[p], p) for p in own]) for x in pair]
    mine_in = [{"question": q, "positive_ctxs": [docs[p]],
                "hard_negative_ctxs": [docs[j] for j in rng.choice(len(docs), OLD_NEGS + 1, replace=False)
                                       if j != p][:OLD_NEGS]} for q, p in asked]
    mine_path, mined_path, distill_path = workdir / "mine_in.json", workdir / "mined.json", workdir / "distill.json"
    dump_json(mine_in, mine_path)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["mine", *corpus, "--eval-data", str(mine_path), "--out", str(mined_path), "--topk", str(MINE_TOPK),
              "--keep-old", str(KEEP_OLD), "--distill-out", str(distill_path), *common])
    mine_s = time.perf_counter() - t0
    mine_launches = read_counts()
    mined, distill = load_json(mined_path), load_json(distill_path)
    # the same retrieval in process, through the service ``mine`` builds:
    # mine's files are the generators over its results
    base = cli.make_service(cfg, argparse.Namespace(checkpoint_step=None, pretrain=ctx["common"][3],
                                                    device=str(device), corpus=str(ctx["corpus_path"])))
    res = base.retrieve([t["question"] for t in mine_in], topk=MINE_TOPK)
    merged = [{**t, "res": r} for t, r in zip(mine_in, res)]
    want_mined = gen_iter_train_dev(merged, keep_old=KEEP_OLD, top=MINE_TOPK)
    want_distill = gen_distill_data(merged, group=cfg.ce_train.distill_group)
    if [m["hard_negative_ctxs"] for m in mined] != [m["hard_negative_ctxs"] for m in want_mined] or \
            [m["question"] for m in mined] != [t["question"] for t in mine_in]:
        raise AssertionError("mine's negatives differ from gen_iter_train_dev over the service's own results")
    for m, t in zip(mined, mine_in):
        old = t["hard_negative_ctxs"][:KEEP_OLD]
        if m["hard_negative_ctxs"][:KEEP_OLD] != old or len(m["hard_negative_ctxs"]) > KEEP_OLD + MINE_TOPK:
            raise AssertionError(f"--keep-old {KEEP_OLD} not honored for {t['question']!r}")
        if any(x in t["positive_ctxs"] for x in old):
            raise AssertionError(f"an old negative of {t['question']!r} is its positive")
    own_text = {docs[p] for p in own}
    pos_in_fresh = sum(any(x in t["positive_ctxs"] for x in m["hard_negative_ctxs"][KEEP_OLD:])
                       for m, t in zip(mined, mine_in))
    d_err = max([abs(s - w) for d, wd in zip(distill, want_distill)
                 for (s, _), (w, _) in zip(d["res_scored"], wd["res_scored"])] or [0.0])
    if [[x for _, x in d["res_scored"]] for d in distill] != [[x for _, x in d["res_scored"]] for d in want_distill] \
            or d_err > SCORE_ATOL:
        raise AssertionError(f"--distill-out differs from gen_distill_data over the service's results ({d_err})")
    log(f"[phase7] mine --topk {MINE_TOPK} --keep-old {KEEP_OLD} --distill-out: {n_mine} questions in "
        f"{mine_s:.2f} s (service start included); every question keeps its {KEEP_OLD} old negatives first, "
        f"then {np.mean([len(m['hard_negative_ctxs']) - KEEP_OLD for m in mined]):.1f} fresh ones on average; "
        f"negatives equal gen_iter_train_dev over the in-process service's results, distill windows equal "
        f"gen_distill_data (teacher scores within {d_err:.2e}); {len(distill)}/{n_mine} questions have their "
        f"positive in the top-{cfg.ce_train.distill_group} window ({sum(d['question'] in own_text for d in distill)} "
        f"of them passages asked as questions); {pos_in_fresh} have it among the fresh "
        f"negatives (gen_iter_train_dev does not filter positives, as the reference's gen_iter does not); "
        f"launches {mine_launches}")
    if mine_launches["K1"] != -(-n_mine // B):
        raise AssertionError(f"mine: K1 launched {mine_launches['K1']} times for {n_mine} questions")

    # ---- train-ce: ce_steps steps, an evaluation and a checkpoint every ce_steps // 2 ----
    train_path, dev_path = workdir / "ce_train.json", workdir / "ce_dev.json"
    dump_json(mined[: ce_steps * CE_BATCH], train_path)
    dump_json(mined[ce_steps * CE_BATCH :][:n_dev], dev_path)
    if len(mined) < ce_steps * CE_BATCH + n_dev:
        raise ValueError(f"{len(mined)} mined questions for {ce_steps} steps and {n_dev} dev questions")
    ce_args = ["train-ce", "--train-data", str(train_path), *ce_common]
    held_gb = torch.cuda.memory_allocated(device) / 1e9  # phase 2's table and searchers
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    cli.main([*ce_args, "--dev-data", str(dev_path)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    ckpt = CheckpointManager(cfg.ce_train.checkpoint_dir)
    steps = load_jsonl(ckpt.dir / "ce_train_steps.jsonl")
    evals = load_jsonl(ckpt.dir / "ce_train_log.jsonl")
    losses = [r["loss"] for r in steps]
    log(f"[phase7] train-ce: {len(steps)} steps in {train_s:.1f} s (model init, evaluation and checkpoints "
        f"included); losses {[round(x, 4) for x in losses]}; evaluations {evals} (dev MRR over {n_dev} questions "
        f"x (1 + {2 * CE_NEG}), information only: a random order gives H(9)/9 = 0.314)")
    if len(losses) != ce_steps or not np.isfinite(losses).all():
        raise AssertionError(f"expected {ce_steps} finite CE losses, got {losses}")
    eval_every = ce_steps // 2
    saved = [eval_every * i for i in range(1, ce_steps // eval_every + 1)]
    want_ckpts = sorted(set(saved + [ce_steps]))[-2:]
    if [r["step"] for r in evals] != saved or ckpt.all_steps() != want_ckpts:
        raise AssertionError(f"evaluations at {[r['step'] for r in evals]}, checkpoints {ckpt.all_steps()}; "
                             f"expected {saved} and {want_ckpts}")
    log(f"[phase7] launches in the train-ce run: {launches} (K9 expected {ce_steps} steps x {per_step_k9} = "
        f"{ce_steps * per_step_k9}: 1 + 3 x {c.num_layers} dropout sites, forward and backward)")
    if launches["K9"] != ce_steps * per_step_k9:
        raise AssertionError(f"K9 launched {launches['K9']} times, expected {ce_steps * per_step_k9}")
    k9_on_packed(launches, "the train-ce run")
    step_s = [r["step_s"] for r in steps[2:6]]
    ms_step = 1e3 * float(np.mean(step_s))
    log(f"[phase7] {ms_step:.1f} ms/step = {CE_BATCH / ms_step * 1e3:.2f} questions/s over steps 3-6 on the host "
        f"clock (min {1e3 * min(step_s):.1f}, max {1e3 * max(step_s):.1f} ms; first step "
        f"{1e3 * steps[0]['step_s']:.1f} ms); peak device memory {peak_gb:.2f} GB, of which {held_gb:.2f} GB "
        f"held before the run (phase 2's tables and searchers) [{label}]")

    # ---- resume from the checkpoint before the last step: bit-exact ----
    last, before_last = ckpt.all_steps()[-1], ckpt.all_steps()[-2]
    straight = torch.load(ckpt.params_path(last), map_location="cpu", weights_only=True)
    shutil.rmtree(ckpt.path(last))
    sites = set()

    def record(mod, args):
        if isinstance(mod, Dropout) and mod.training:
            sites.add((tuple(args[0].shape), str(args[0].dtype).replace("torch.", "")))

    # and the host's time inside K9's calls (forward and backward), which sets
    # their pace at the hidden states: the card takes ~0.01 ms for each
    k9_host_s = []
    apply = dr._apply

    def timed_apply(x, seed, thr, *where):
        t = time.perf_counter()
        out = apply(x, seed, thr, *where)
        k9_host_s.append(time.perf_counter() - t)
        return out

    hook = torch.nn.modules.module.register_module_forward_pre_hook(record)
    dr._apply = timed_apply
    reset_counts()
    try:
        cli.main([*ce_args, "--resume"])
    finally:
        hook.remove()
        dr._apply = apply
    torch.cuda.synchronize()
    resumed_launches = read_counts()
    k9_host_ms = 1e3 * sum(k9_host_s) / (last - before_last)
    log(f"[phase7] K9's inputs in the resumed step (shape, dtype): {sorted(sites)}; phase 3 held K9 at "
        f"{sorted(K9_CE_SITES.values())}; the host's time inside K9's {len(k9_host_s)} calls: {k9_host_ms:.3f} ms "
        f"a CE step (a call: least {1e6 * min(k9_host_s):.1f}, median {1e6 * float(np.median(k9_host_s)):.1f}, mean "
        f"{1e6 * float(np.mean(k9_host_s)):.1f} us) [{label}]")
    if sites != set(K9_CE_SITES.values()):
        raise AssertionError(f"K9 ran at {sorted(sites)} in a CE step; phase 3 holds it at {K9_CE_SITES}")
    rsteps = load_jsonl(ckpt.dir / "ce_train_steps.jsonl")
    resumed = torch.load(ckpt.params_path(last), map_location="cpu", weights_only=True)
    differ = [k for k in straight if not torch.equal(straight[k], resumed[k])]
    log(f"[phase7] resume from checkpoint {before_last}: steps {[r['step'] for r in rsteps]}, loss "
        f"{[r['loss'] for r in rsteps]} vs the straight run's {losses[before_last:]}; parameters after step "
        f"{last}: {len(straight) - len(differ)}/{len(straight)} tensors bit-equal to the straight run's; "
        f"K9 launches {resumed_launches['K9']}")
    if [r["step"] for r in rsteps] != list(range(before_last + 1, last + 1)) or \
            [r["loss"] for r in rsteps] != losses[before_last:] or differ or \
            resumed_launches["K9"] != per_step_k9 * (last - before_last):
        raise AssertionError(f"the resumed run differs from the straight one (tensors {differ[:3]})")
    del straight, resumed

    # ---- train-ce with distillation, on mine's --distill-out file ----
    dcfg = ["--set", "ce_train.distill_weight=0.5", "--set", f"ce_train.checkpoint_dir={workdir / 'ce_distill'}"]
    n_distill_steps = len(distill) // CE_BATCH
    if n_distill_steps < 1:
        raise AssertionError(f"{len(distill)} distillation questions, fewer than a batch of {CE_BATCH}")
    reset_counts()
    cli.main(["train-ce", "--train-data", str(distill_path), *ce_common, *dcfg])
    torch.cuda.synchronize()
    distill_launches = read_counts()
    dsteps = load_jsonl(workdir / "ce_distill" / "ce_train_steps.jsonl")
    log(f"[phase7] train-ce with ce_train.distill_weight=0.5 over {len(distill)} distillation questions: "
        f"{len(dsteps)} steps, losses {[r['loss'] for r in dsteps]}; K9 launches {distill_launches['K9']}")
    if len(dsteps) != n_distill_steps or not np.isfinite([r["loss"] for r in dsteps]).all() or \
            distill_launches["K9"] != per_step_k9 * n_distill_steps:
        raise AssertionError("the distillation run did not take finite steps through K9")

    # ---- evaluate --rerank-ce: retrieve top-100, rerank with the CE checkpoint ----
    eval_path, metrics_path = workdir / "rerank_eval.json", workdir / "rerank_metrics.json"
    dump_json([{"question": questions[i], "positive_ctxs": [docs[positives[i]]]} for i in picks[n_mine // 2 :]],
              eval_path)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["evaluate", "--eval-data", str(eval_path), *corpus, "--topk", str(TOPK), "--rerank-ce",
              "--out", str(metrics_path), *common])
    torch.cuda.synchronize()
    rerank_s = time.perf_counter() - t0
    rerank_launches = read_counts()
    metrics = load_json(metrics_path)
    # one question again through the same two-stage closure, against the
    # argsort of its CE scores computed anew by the model
    q = questions[picks[n_mine // 2]]
    row = base.retrieve([q], topk=TOPK)[0]
    two_stage = cli._reranked(cfg, device, lambda qs, k: base.retrieve(qs, topk=k))
    t1 = time.perf_counter()
    reranked = two_stage([q], TOPK)[0]
    torch.cuda.synchronize()
    one_q_ms = 1e3 * (time.perf_counter() - t1)
    ce = CETrainer(cfg, cli._tokenizer(cfg), device=device)
    ce.load_for_inference()
    enc = ce.tok.encode_ce_pairs([(q, t) for _, _, t in row])
    pad = 128 - len(row)
    scores = ce._score(np.pad(enc.input_ids, ((0, pad), (0, 0))), np.pad(enc.attention_mask, ((0, pad), (0, 0))))
    want = [row[i] for i in np.argsort(-scores[: len(row)])]
    log(f"[phase7] evaluate --rerank-ce over {n_rerank} questions, top-{TOPK} retrieved and reranked "
        f"(ce_train.eval_topk {cfg.ce_train.eval_topk}, CE batches of 128): {rerank_s:.2f} s = "
        f"{1e3 * rerank_s / n_rerank:.1f} ms a question (CE init and checkpoint load included); one question "
        f"through the same two stages {one_q_ms:.1f} ms; metrics {metrics} (information: random weights); "
        f"distinct CE scores among the 100: {len(set(scores[: len(row)].tolist()))}; launches {rerank_launches}")
    if [p for p, _, _ in reranked] != [p for p, _, _ in want]:
        raise AssertionError("the reranked order differs from the argsort of the question's CE scores")
    if rerank_launches["K1"] != -(-n_rerank // B) or not np.isfinite(list(metrics.values())).all():
        raise AssertionError(f"evaluate --rerank-ce: launches {rerank_launches}, metrics {metrics}")
    return {"mine": mine_launches, "train": launches, "resume": resumed_launches, "distill": distill_launches,
            "rerank": rerank_launches}, {
        "ms_step": ms_step, "peak_gb": peak_gb, "held_gb": held_gb, "per_step_k9": per_step_k9, "losses": losses,
        "k9_host_ms_per_step": k9_host_ms,
        "rerank_ms_per_question": 1e3 * rerank_s / n_rerank, "one_question_ms": one_q_ms,
        "dev_mrr": [r.get("dev_mrr") for r in evals], "metrics": metrics, "distill_questions": len(distill),
        "mined_path": mined_path, "conf": conf, "layers": c.num_layers}


# ---- phase 8: the flash-attention path (K11-K13) and remat ----

FLASH_SCALE = 0.125               # 1 / sqrt(64): the models' head dim
FLASH_HEAD_DIMS = (26, 32, 64, 80, 96, 128)  # head dims counted by name: the script's cases (templates: fa.HEAD_DIMS)
FLASH_HEAD_ULPS = 2               # bf16 ulps of an element's head vector (its row of 64)
FLASH_ELEMENT_SHARE = 1e-3        # elements allowed beyond 2 ulps of their own magnitude
L2_BYTES = 50 * 2**20             # the card's L2


def synthetic_doc_lengths(n, seed, workdir: Path):
    """The token counts of ``n`` of the synthetic Chinese passages phases 2 and
    4 encode, through the port's tokenizer at ``doc_maxlen`` 384."""
    import numpy as np

    from colbert_tpu_torch.config import MultiviewConfig, TokenizerConfig
    from colbert_tpu_torch.tokenization import ColbertTokenizer
    from colbert_tpu_torch.tokenization.vocab import build_vocab, write_vocab

    docs, _, _ = synthetic_chinese(n, 1, seed=seed)
    vocab = write_vocab(build_vocab(docs), workdir / f"vocab_lengths_{seed}.txt")
    tok = ColbertTokenizer(TokenizerConfig(vocab_path=str(vocab)), MultiviewConfig())
    return np.asarray(tok.encode_docs(docs).attention_mask).sum(1)


def flash_bounds(B, nh, L, hd=64, elem_bytes=2, peak_flops=PEAK_BF16_FLOPS):
    """(bound ms, by) of K11, K12 and K13 at (B, nh, L, hd), elements of
    ``elem_bytes`` (bf16 by default) and operations at ``peak_flops``: each
    input read once, each output written once; K11 4 L^2 hd flops a head,
    K12 8, K13 6."""
    t = B * nh * L * hd * elem_bytes  # one (B, nh, L, hd) tensor
    rows, seg = B * nh * L * 4, 2 * B * L * 4
    per_head = B * nh * L * L * hd
    return {"K11": bound(4 * per_head, 4 * t + 2 * rows + seg, peak_flops),
            "K12": bound(8 * per_head, 6 * t + 3 * rows + seg, peak_flops),
            "K13": bound(6 * per_head, 5 * t + 3 * rows + seg, peak_flops)}


def di_within_fp32(got, o, do):
    """The largest error of the card's di against :func:`flash_di` in units of
    the two fp32 sums' joint rounding bound, 2 * 64 * 2^-24 * sum |o * do| a
    row (<= 1: within fp32 rounding)."""
    import torch

    from colbert_tpu_torch.ops import flash_attention as fa

    x = o.float() * do.float()
    limit = 2 * x.shape[-1] * 2.0**-24 * x.abs().sum(-1)
    return float(((got - fa.flash_di(o, do)).abs() / limit.clamp_min(torch.finfo(torch.float32).tiny)).max())


def sdpa_backward_alone(q, k, v, mask, do, scale=FLASH_SCALE):
    """SDPA's backward alone (dq, dk and dv from one call), the yardstick of
    K12 + K13 with the rows kernel: for each of the backends that take a
    boolean mask (cuDNN, memory-efficient; the math backend where neither
    takes the shape), its forward once and its backward timed on that graph;
    the fastest as (ms, backend name), with every backend's time or why it
    did not run."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    tried = {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        if backend == SDPBackend.MATH and any(isinstance(t, float) for t in tried.values()):
            break  # the explicit product, only where neither fused backend takes the shape (hd 26)
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)
            tried[backend.name] = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                                          iters=10, warmup=2)
        except RuntimeError as e:
            tried[backend.name] = f"not run: {str(e).splitlines()[0][:120]}"
    timed = {n: t for n, t in tried.items() if isinstance(t, float)}
    if not timed:
        raise AssertionError(f"no SDPA backend ran the masked backward: {tried}")
    best = min(timed, key=timed.get)
    return timed[best], best, tried


def first_design_flash(seg):
    """The attention as the first design ran it, through an autograd function
    of the same form as ``flash_attention``: K11, K12 and K13 on route
    "simple", di by ``flash_di`` (fp32 copies); the yardstick of the autograd
    function's forward + backward.  Takes (q, k, v); ``seg`` both sides' ids."""
    import torch

    from colbert_tpu_torch.ops import flash_attention as fa

    class FirstDesign(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, l, m = fa._launch_forward(q, k, v, seg, seg, FLASH_SCALE, route="simple")
            ctx.save_for_backward(q, k, v, o, l, m)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, l, m = ctx.saved_tensors
            di = fa.flash_di(o, do)
            dk, dv = fa._launch_dkv(q, k, v, seg, seg, FLASH_SCALE, l, m, do, di, route="simple")
            return fa._launch_dq(q, k, v, seg, seg, FLASH_SCALE, l, m, do, di, route="simple"), dk, dv
    return FirstDesign.apply


def flash_route_parts(args, o, l, m, do, paths, fwd_bwd):
    """Each route's parts of the flash path timed three ways, the routes in
    turn (forward order, then reverse; the means kept): on the host clock a
    call with the card kept busy (:func:`host_ms`, the host's own cost), on
    the card alone (:func:`device_ms`, hot) and as issued (:func:`time_ms`,
    host gaps included).  Parts: the forward (``_launch_forward``), the
    backward (route "wgmma": the rows kernel, K12, K13; "simple": ``flash_di``,
    K12, K13 on "simple"), di (the rows kernel; ``flash_di``) and the forward + backward
    through ``paths``' autograd functions."""
    from colbert_tpu_torch.ops import flash_attention as fa

    def backward(route):
        def run():
            if route == "wgmma":
                di, inv_l = fa._launch_rows(o, do, l)
            else:
                di, inv_l = fa.flash_di(o, do), None
            fa._launch_dkv(*args, l, m, do, di, route=route, inv_l=inv_l)
            fa._launch_dq(*args, l, m, do, di, route=route, inv_l=inv_l)
        return run
    parts = {"forward": {r: (lambda r=r: fa._launch_forward(*args, route=r)) for r in fa.ROUTES},
             "backward": {r: backward(r) for r in fa.ROUTES},
             "di": {"wgmma": lambda: fa._launch_rows(o, do, l), "simple": lambda: fa.flash_di(o, do)},
             "fwd_bwd": {r: fwd_bwd(paths[r]) for r in fa.ROUTES}}
    out = {}
    for clock, measure in (("host", host_ms), ("card", device_ms), ("issued", time_ms)):
        got = {p: {r: [] for r in fa.ROUTES} for p in parts}
        for order in (fa.ROUTES, fa.ROUTES[::-1]):
            for p, fns in parts.items():
                for r in order:
                    got[p][r].append(measure(fns[r]))
        out[clock] = {p: {r: sum(t) / len(t) for r, t in rs.items()} for p, rs in got.items()}
    return out


def flash_case(device, name, B, nh, lengths, seed, timed, label, hd=64):
    """The path the model runs at (B, nh, 384, hd) in its layout (heads-major
    views of (B, L, nh, hd)), bf16, then fp16: the public wrapper's forward
    (K11), then its backward (the rows kernel's di and 1 / l from K11's own
    o and l, K12 and K13 on K11's own l and m), and the autograd function
    over them, against the plain forward and backward run the same way;
    twice (bit-equal); every launch on route "wgmma" at ``hd``.  Then K11,
    K12 and K13 on each route ("wgmma", the wrapper's; "simple", the first
    design, at head dim 64 alone) against the plain versions (K12 and K13 on
    the plain forward's l, m and di), each twice (bit-equal), and the card's
    di against ``flash_di`` (within fp32 rounding) and its order emulated in
    torch (bit-equal), 1 / l bit-equal to the division.  The bf16 results
    stand at the top of the returned dict, fp16's under "float16".  With
    ``timed`` (bf16), each kernel's time on each route cold and hot beside
    its bound at ``hd``; the rows kernel beside ``flash_di``; the plain
    versions, the flash forward through the autograd function and
    ``F.scaled_dot_product_attention`` (forward, and its backward alone);
    at head dim 64 also the port's explicit attention, SDPA's forward +
    backward and, by route, the forward, the backward, di and the forward +
    backward through an autograd function (route "simple":
    :func:`first_design_flash`) on the host clock, on the card alone and as
    issued (:func:`flash_route_parts`)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from colbert_tpu_torch.config import ModelConfig
    from colbert_tpu_torch.models.bert import BertSelfAttention, draw_seed
    from colbert_tpu_torch.ops import flash_attention as fa

    L, scale = 384, hd ** -0.5
    routes = fa.ROUTES if hd == fa.SIMPLE_HEAD_DIM else ("wgmma",)
    g = torch.Generator(device).manual_seed(seed)
    seg = (torch.arange(L, device=device)[None, :] < torch.as_tensor(lengths, device=device)[:, None]).to(torch.int32)
    res = {"shape": [B, nh, L, hd], "lengths": [int(np.min(lengths)), int(np.max(lengths))]}
    for dtype in (torch.bfloat16, torch.float16):
        dt = str(dtype).removeprefix("torch.")

        def heads():
            return torch.randn((B, L, nh, hd), generator=g, device=device).to(dtype).transpose(1, 2)
        q, k, v, do = heads(), heads(), heads(), heads()
        args = (q, k, v, seg, seg, scale)
        before = read_counts()
        o, l, m = fa.flash_forward(*args)
        dq, dk, dv = fa.flash_backward(*args, o, l, m, do)
        o2, l2, m2 = fa.flash_forward(*args)
        dq2, dk2, dv2 = fa.flash_backward(*args, o2, l2, m2, do)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, seg, seg, scale)
        out.backward(do)
        torch.cuda.synchronize()
        after = read_counts()
        flash_launches_ok({key: after[key] - before[key] for key in after}, {"K11": 3, "K12": 3, "K13": 3},
                          f"phase 8a at {name}, {dt}", head_dim=hd)
        ro, rl, rm = fa.flash_forward_ref(*args)
        rdi = fa.flash_di(ro, do)
        want = fa.flash_backward_ref(*args, rl, rm, do, rdi)
        torch.cuda.synchronize()
        stable = all(torch.equal(a, b) for a, b in ((o, o2), (l, l2), (m, m2), (dq, dq2), (dk, dk2), (dv, dv2)))
        autograd_same = torch.equal(out, o) and all(torch.equal(t.grad, x) for t, x in zip(leaves, (dq, dk, dv)))
        r = {"bit_stable": stable, "autograd_same": autograd_same}
        for what, got, ref in (("o", o, ro), ("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
            r[what] = dict(zip(("head_ulps", "element_share", "max_abs_err"), fa.close_in_head_ulps(got, ref)))
        r["l_max_rel_err"] = float(((l - rl).abs() / rl).max())
        r["m_max_abs_err"] = float((m - rm).abs().max())
        log(f"[phase8a] {name} ({B}, {nh}, {L}, {hd}) {dt}, lengths {res['lengths'][0]}-{res['lengths'][1]}: "
            f"bit-stable {stable}, autograd function equal {autograd_same}; wrapper path against the plain path: "
            + "; ".join(f"{w} {r[w]['head_ulps']:.2f} ulps of its head vector, "
                        f"{r[w]['element_share']:.2e} of elements past 2 own ulps, max|d| "
                        f"{r[w]['max_abs_err']:.3e}" for w in ("o", "dq", "dk", "dv"))
            + f"; l rel {r['l_max_rel_err']:.2e}, m {r['m_max_abs_err']:.2e}")
        bad = [w for w in ("o", "dq", "dk", "dv") if r[w]["head_ulps"] > FLASH_HEAD_ULPS
               or r[w]["element_share"] > FLASH_ELEMENT_SHARE]
        if not (stable and autograd_same) or bad or not (torch.isfinite(o.float()).all()
                                                         and torch.isfinite(dq.float()).all()):
            raise AssertionError(f"K11-K13 at {name} ({dt}): bit-stable {stable}, autograd function equal "
                                 f"{autograd_same}, beyond the limits: {bad} ({r})")

        # ---- each route of K11, K12 and K13 against the plain versions, twice ----
        bargs = (*args, rl, rm, do, rdi)
        r["routes"] = {}
        for route in routes:
            ro1, ro2 = fa._launch_forward(*args, route=route), fa._launch_forward(*args, route=route)
            rk1, rk2 = fa._launch_dkv(*bargs, route=route), fa._launch_dkv(*bargs, route=route)
            rq1, rq2 = fa._launch_dq(*bargs, route=route), fa._launch_dq(*bargs, route=route)
            torch.cuda.synchronize()
            rr = {"bit_stable": all(torch.equal(a, b) for a, b in zip((*ro1, *rk1, rq1), (*ro2, *rk2, rq2)))}
            for what, got, ref in (("o", ro1[0], ro), ("dk", rk1[0], want[1]), ("dv", rk1[1], want[2]),
                                   ("dq", rq1, want[0])):
                rr[what] = dict(zip(("head_ulps", "element_share", "max_abs_err"), fa.close_in_head_ulps(got, ref)))
            rr["l_max_rel_err"] = float(((ro1[1] - rl).abs() / rl).max())
            rr["m_max_abs_err"] = float((ro1[2] - rm).abs().max())
            r["routes"][route] = rr
            log(f"[phase8a] {name} {dt} route {route}: K11, K12, K13 bit-stable {rr['bit_stable']}; against the "
                "plain versions " + "; ".join(f"{w} {rr[w]['head_ulps']:.2f} ulps of its head vector, "
                                              f"{rr[w]['element_share']:.2e} past 2 own ulps, max|d| "
                                              f"{rr[w]['max_abs_err']:.3e}" for w in ("o", "dk", "dv", "dq"))
                + f"; l rel {rr['l_max_rel_err']:.2e}, m {rr['m_max_abs_err']:.2e}")
            off = [w for w in ("o", "dk", "dv", "dq") if rr[w]["head_ulps"] > FLASH_HEAD_ULPS
                   or rr[w]["element_share"] > FLASH_ELEMENT_SHARE]
            if off or not rr["bit_stable"] or rr["l_max_rel_err"] > 1e-5 or rr["m_max_abs_err"] > 1e-5:
                raise AssertionError(f"K11-K13 route {route} at {name} ({dt}): beyond the limits {off} ({rr})")

        # ---- the card's di and 1 / l ----
        di_card, inv_l = fa._launch_rows(o, do, l)
        torch.cuda.synchronize()
        r["di"] = {"fp32_bound_share": di_within_fp32(di_card, o, do),
                   "card_order_equal": bool(torch.equal(di_card, fa.flash_di_card_order(o, do))),
                   "inv_l_equal": bool(torch.equal(inv_l, torch.ones_like(l) / l)),
                   "max_abs_err": float((di_card - fa.flash_di(o, do)).abs().max())}
        log(f"[phase8a] {name} {dt} the card's di: {r['di']['fp32_bound_share']:.3f} of the fp32 rounding bound "
            f"from flash_di (max|d| {r['di']['max_abs_err']:.3e}), bit-equal to its order in torch "
            f"{r['di']['card_order_equal']}; 1 / l bit-equal {r['di']['inv_l_equal']}")
        if not (r["di"]["fp32_bound_share"] <= 1.0 and r["di"]["card_order_equal"] and r["di"]["inv_l_equal"]):
            raise AssertionError(f"the rows kernel at {name} ({dt}): {r['di']}")
        if dtype == torch.bfloat16:
            res.update(r)
            kept = (q, k, v, do, args, leaves, o, l, m, ro, rl, rm, di_card, inv_l)
        else:
            res[dt] = r
    if not timed:
        return res

    # ---- times (bf16): CUDA events, hot (the same inputs) and cold (copies in turn past twice the L2) ----
    q, k, v, do, args, leaves, o, l, m, ro, rl, rm, di_card, inv_l = kept
    bargs = (*args, l, m, do, di_card)
    set_bytes = 4 * q.numel() * 2
    n_copies = max(1, -(-4 * L2_BYTES // set_bytes))
    copies = [tuple(t.clone() for t in (q, k, v, do)) for _ in range(n_copies)]
    outs = [tuple(t.clone() for t in (o, do)) for _ in range(n_copies)]
    runs = {"hot": {}, "cold": {}}  # each time taken three times, the routes in turn; the medians kept

    def timed(key, hot_fn, cold_fn, xs):
        runs["hot"].setdefault(key, []).append(time_ms(hot_fn))
        # every input set's outputs allocated before the clock starts
        runs["cold"].setdefault(key, []).append(time_ms(in_turn(cold_fn, xs), warmup=len(xs) + 2))
    for _ in range(3):
        for route in routes:
            tag = "" if route == "wgmma" else " simple"
            timed("K11" + tag, lambda: fa._launch_forward(*args, route=route),
                  lambda x, i: fa._launch_forward(x[0], x[1], x[2], seg, seg, scale, route=route), copies)
            timed("K12" + tag, lambda: fa._launch_dkv(*bargs, route=route, inv_l=inv_l),
                  lambda x, i: fa._launch_dkv(x[0], x[1], x[2], seg, seg, scale, l, m, x[3], di_card,
                                              route=route, inv_l=inv_l), copies)
            timed("K13" + tag, lambda: fa._launch_dq(*bargs, route=route, inv_l=inv_l),
                  lambda x, i: fa._launch_dq(x[0], x[1], x[2], seg, seg, scale, l, m, x[3], di_card,
                                             route=route, inv_l=inv_l), copies)
        timed("rows", lambda: fa._launch_rows(o, do, l), lambda x, i: fa._launch_rows(x[0], x[1], l), outs)
        timed("flash_di", lambda: fa.flash_di(o, do), lambda x, i: fa.flash_di(x[0], x[1]), outs)
    hot, cold = ({k: float(np.median(v)) for k, v in runs[kind].items()} for kind in ("hot", "cold"))

    flash = lambda a, b, c: fa.flash_attention(a, b, c, seg, seg, scale)
    mask = (seg[:, :, None] == seg[:, None, :])[:, None]          # (B, 1, L, L) segment equality
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=mask, scale=scale)
    with torch.no_grad():
        t_plain = time_ms(lambda: fa.flash_forward_ref(*args), iters=5, warmup=1)
        t_plain_bwd = time_ms(lambda: fa.flash_backward_ref(*args, rl, rm, do, fa.flash_di(ro, do)), iters=3,
                              warmup=1)
        t_flash = time_ms(lambda: flash(q, k, v))
        t_sdpa = time_ms(lambda: sdpa(q, k, v))
    t_sdpa_bwd, sdpa_backend, sdpa_tried = sdpa_backward_alone(q, k, v, mask, do, scale=scale)
    bounds = flash_bounds(B, nh, L, hd)
    bounds["rows"] = bound(0, 2 * B * nh * L * hd * 2 + 3 * B * nh * L * 4, PEAK_BF16_FLOPS)
    res.update({"ms": cold, "hot_ms": hot, "bound": bounds, "plain_ms": t_plain, "plain_backward_ms": t_plain_bwd,
                "flash_ms": t_flash, "sdpa_ms": t_sdpa, "sdpa_backward_ms": t_sdpa_bwd,
                "sdpa_backward_backend": sdpa_backend, "sdpa_backward_tried": sdpa_tried, "cold_copies": n_copies,
                "cold_runs_ms": runs["cold"], "rows_k12_k13_ms": cold["rows"] + cold["K12"] + cold["K13"]})
    for kname in ("K11", "K12", "K13", "rows"):
        simple = (f"; route simple {cold[kname + ' simple']:.4f} cold, {hot[kname + ' simple']:.4f} hot"
                  if kname + " simple" in cold else "")
        log(f"[phase8a] {name} {kname} at head dim {hd}: {cold[kname]:.4f} ms cold ({n_copies} input sets in turn), "
            f"{hot[kname]:.4f} hot{simple}; bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]}) [{label}]")
    log(f"[phase8a] {name} di and 1 / l: rows kernel {cold['rows']:.4f} ms cold, {hot['rows']:.4f} hot; flash_di "
        f"(fp32 copies) {cold['flash_di']:.4f} cold, {hot['flash_di']:.4f} hot [{label}]")
    log(f"[phase8a] {name} head dim {hd}: K11 {cold['K11']:.4f} ms against SDPA's forward {t_sdpa:.4f}; rows + K12 "
        f"+ K13 {res['rows_k12_k13_ms']:.4f} against SDPA's backward alone {t_sdpa_bwd:.4f} ({sdpa_backend}; tried "
        f"{sdpa_tried}); flash forward (K11 through the autograd function) {t_flash:.4f}; plain forward "
        f"{t_plain:.3f}, plain backward {t_plain_bwd:.3f} [{label}]")
    if hd != fa.SIMPLE_HEAD_DIM:
        return res

    def fwd_bwd(fn):
        def run():
            for t in leaves:
                t.grad = None
            fn(*leaves).backward(do)
        return run
    att = BertSelfAttention(ModelConfig(hidden_size=hd * nh, num_heads=nh, attention_dropout=0.1)).to(device).train()
    bias = ((1.0 - seg[:, None, None, :].float()) * -1e9)
    seed64 = draw_seed(torch.Generator().manual_seed(seed))
    explicit = lambda a, b, c: att._explicit(a, b, c, bias, seed64)   # fp32 logits, softmax, K9, P.V
    with torch.no_grad():
        t_explicit = time_ms(lambda: explicit(q, k, v), iters=5, warmup=1)
    first = first_design_flash(seg)
    parts = flash_route_parts(args, o, l, m, do, {"wgmma": flash, "simple": first}, fwd_bwd)
    t_flash_fb, t_flash_fb_simple = (parts["issued"]["fwd_bwd"][r] for r in ("wgmma", "simple"))
    t_sdpa_fb = time_ms(fwd_bwd(sdpa), iters=10, warmup=2)
    t_explicit_fb = time_ms(fwd_bwd(explicit), iters=5, warmup=1)
    res.update({"flash_fwd_bwd_ms": t_flash_fb, "flash_fwd_bwd_simple_ms": t_flash_fb_simple,
                "route_parts_ms": parts, "sdpa_fwd_bwd_ms": t_sdpa_fb, "explicit_ms": t_explicit,
                "explicit_fwd_bwd_ms": t_explicit_fb})
    for clock, what in (("host", "on the host clock a call, the card kept busy"), ("card", "on the card alone, hot"),
                        ("issued", "as issued, host gaps included")):
        log(f"[phase8a] {name} by route, {what}: " + "; ".join(
            f"{p} wgmma {parts[clock][p]['wgmma']:.4f} ms, simple {parts[clock][p]['simple']:.4f}"
            for p in ("forward", "backward", "di", "fwd_bwd")) + f" [{label}]")
    log(f"[phase8a] {name} forward: the port's explicit attention (fp32 logits, softmax, K9 at the probabilities, "
        f"P.V) {t_explicit:.3f} ms, SDPA with the segment mask {t_sdpa:.4f} (a yardstick the port never calls); "
        f"forward + backward: flash {t_flash_fb:.4f} (the first design's path, route simple and flash_di: "
        f"{t_flash_fb_simple:.4f}), explicit {t_explicit_fb:.3f}, SDPA {t_sdpa_fb:.4f} [{label}]")
    return res


def phase_flash_kernels(device, workdir: Path, label, seed=SEED, shapes=None):
    """Phase 8a: K11-K13 at the retriever's doc pass, the CE's pairs, the encode
    batch (timed), a batch with no padding and one padded just past 128."""
    import numpy as np

    rng = np.random.default_rng([seed, 8])
    shapes = shapes or {"retriever": (68, 12), "ce": (20, 16), "encode": (384, 12), "unpadded": (16, 12),
                        "past_128": (16, 12)}
    lengths = {
        "retriever": synthetic_doc_lengths(shapes["retriever"][0], seed + 3, workdir),
        "ce": rng.integers(64, 385, size=shapes["ce"][0]),
        "encode": synthetic_doc_lengths(shapes["encode"][0], seed, workdir),
        "unpadded": np.full(shapes["unpadded"][0], 384),
        "past_128": np.where(np.arange(shapes["past_128"][0]) % 2, 129, 257),
    }
    t0 = time.perf_counter()
    out = {name: flash_case(device, name, *shapes[name], lengths[name], seed + i, name in ("retriever", "ce", "encode"),
                            label)
           for i, name in enumerate(shapes)}
    log(f"[phase8a] K11-K13 checked at {len(shapes)} shapes and timed at 3 in {time.perf_counter() - t0:.1f} s")
    return out


# phase 8a's and 11a's head dims but 64, each with its heads: 32 and 26 at the
# MiniLM-L12-H384- and TinyBERT-4L-zh-width retrievers' doc passes (12
# heads), 80, 96 and 128 at 8 heads (on the 128 template; 80 and 96 read by
# the tensor maps, 26 by the kernels' own copies)
FLASH_CASES = ((32, 12), (26, 12), (80, 8), (96, 8), (128, 8))


def phase_flash_head_dims(device, workdir: Path, label, seed=SEED, cases=FLASH_CASES):
    """Phase 8a at the head dims but 64 (``cases``: (head dim, heads)) at
    (68, nh, 384, hd), the retriever's segment lengths."""
    lengths = synthetic_doc_lengths(68, seed + 3, workdir)
    t0 = time.perf_counter()
    out = {hd: flash_case(device, f"hd{hd}", 68, nh, lengths, seed + 29 + hd, True, label, hd=hd)
           for hd, nh in cases}
    log(f"[phase8a] K11-K13 at head dims {[hd for hd, _ in cases]} checked and timed in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def flash_launches_ok(launches, want, what, route="wgmma", head_dim=None):
    """K11-K13's launches as ``want`` says, each all on ``route`` ("wgmma" for
    bf16 and fp16, "tf32" for fp32) and, with ``head_dim``, all at that head
    dim (none at the other head dims counted by name) and on its template
    (none on the others: so none at an uncounted head dim either), and the
    backward's rows kernel (di, 1 / l) once a K12 launch, on its fp32 route
    for fp32."""
    from colbert_tpu_torch.ops import flash_attention as fa

    want = dict(want)
    for kname in ("K11", "K12", "K13"):
        if kname in want:
            for r in ("wgmma", "simple", "tf32"):
                want[f"{kname} {r} route"] = want[kname] if r == route else 0
            if head_dim is not None:
                for hd in FLASH_HEAD_DIMS:
                    want[f"{kname} hd{hd}"] = want[kname] if hd == head_dim else 0
                for t in fa.HEAD_DIMS:
                    want[f"{kname} template{t}"] = want[kname] if t == fa.template_head_dim(head_dim) else 0
    if "K12" in want:
        want["flash rows"] = want["K12"]
        want["flash rows fp32"] = want["K12"] if route == "tf32" else 0
    got = {kname: launches[kname] for kname in want}
    if got != want:
        raise AssertionError(f"{what}: flash launches {got}, expected {want}")


def phase_flash_encode(device, workdir: Path, label, ctx):
    """Phase 8c: ``encode`` with flash over phase 2's corpus, then one ``serve``
    request over that table, its answers against the plain top-100."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.ranking.searcher import ColbertSearcher
    from colbert_tpu_torch.serving.server import RetrievalClient

    cfg = ColbertConfig.from_dict(ctx["cfg"].to_dict())
    cfg.model.attention_impl = "flash"
    cfg.index.index_path = str(workdir / "index_flash")
    cfg.serve.port = free_port()
    conf = workdir / "conf_flash.yaml"
    cfg.to_yaml(conf)
    common = ["--config", str(conf), *ctx["common"][2:]]
    docs, n = ctx["docs"], len(ctx["docs"])
    batches = sum(-(-((p + 1) * n // cfg.index.num_parts - p * n // cfg.index.num_parts) // cfg.index.encode_batch_size)
                  for p in range(cfg.index.num_parts))
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["encode", "--corpus", str(ctx["corpus_path"]), *common])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    launches = read_counts()
    log(f"[phase8c] encode with flash: {n} docs in {enc_s:.2f} s = {n / enc_s:.1f} docs/s (phase 2, explicit "
        f"attention: {ctx['encode_docs_s']:.1f}); launches {launches} [{label}]")
    flash_launches_ok(launches, {"K11": cfg.model.num_layers * batches, "K12": 0, "K13": 0}, "encode")
    flash_parts, base_parts = IndexStorage(cfg.index.index_path), IndexStorage(ctx["cfg"].index.index_path)
    diff = max(float(np.abs(flash_parts.read_part(p).astype(np.float32) - base_parts.read_part(p).astype(np.float32)).max())
               for p in range(cfg.index.num_parts))
    log(f"[phase8c] the flash table against phase 2's, row by row: max|d| {diff:.3e} (information: bf16 "
        f"encoders that round p differently)")

    serve_err = []

    def serve():
        try:
            cli.main(["serve", "--corpus", str(ctx["corpus_path"]), *common])
        except BaseException as e:  # noqa: BLE001 -- reported by the main thread
            serve_err.append(e)
    server = threading.Thread(target=serve, daemon=True, name="serve-flash")
    server.start()
    wait_for_server(cfg, serve_err)
    client = RetrievalClient(cfg.serve.host, cfg.serve.port, cfg.serve.authkey.encode())
    qs = [ctx["questions"][i] for i in ctx["free"][-B:]]
    reset_counts()
    t0 = time.perf_counter()
    answers = client.retrieve(qs, topk=TOPK)
    req_ms = 1e3 * (time.perf_counter() - t0)
    served = read_counts()
    client.shutdown()
    server.join(timeout=60)
    if server.is_alive() or serve_err:
        raise RuntimeError(f"server did not stop cleanly: {serve_err}")
    model = cli._model(cfg, argparse.Namespace(checkpoint_step=None, pretrain=ctx["common"][3]))
    searcher = ColbertSearcher(cfg, cli._tokenizer(cfg), model, IndexStorage(cfg.index.index_path), device=device)
    worst, recall = check_flat_answers([qs], [[answers]], searcher, docs)
    log(f"[phase8c] one serve request over the flash table: {B} questions top-{TOPK} in {req_ms:.1f} ms; scores "
        f"vs the plain version's top-{TOPK} over the same table max|d| {worst:.3e} (limit {SCORE_ATOL}); pid "
        f"recall {recall:.4f} (information); launches {served} [{label}]")
    if worst > SCORE_ATOL or served["K1"] != 1:
        raise AssertionError(f"flash serve: scores off by {worst}, K1 launches {served['K1']}")
    return {"docs_s": n / enc_s, "launches": launches, "table_max_diff": diff, "request_ms": req_ms}


def phase_flash_ce(device, workdir: Path, label, ce_ctx, steps=3):
    """Phase 8d: ``train-ce`` with flash at macbert-large width, on phase 7's mined file."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.utils.io import dump_json, load_json, load_jsonl

    mined = load_json(ce_ctx["mined_path"])
    train_path = workdir / "ce_flash_train.json"
    dump_json(mined[: steps * CE_BATCH], train_path)
    ckpt_dir = workdir / "ce_flash"
    args = ["train-ce", "--train-data", str(train_path), "--config", str(ce_ctx["conf"]), "--device", str(device),
            "--set", "ce_model.attention_impl=flash", "--set", f"ce_train.checkpoint_dir={ckpt_dir}",
            "--set", "ce_train.evals_per_epoch=1"]
    layers = ce_ctx["layers"]
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    cli.main(args)
    torch.cuda.synchronize()
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    rows = load_jsonl(ckpt_dir / "ce_train_steps.jsonl")
    losses = [r["loss"] for r in rows]
    ms_step = 1e3 * float(np.mean([r["step_s"] for r in rows[1:]]))
    log(f"[phase8d] train-ce with flash: {len(rows)} steps, losses {[round(x, 4) for x in losses]}; "
        f"{ms_step:.1f} ms/step over steps 2-{steps} (phase 7, explicit attention: {ce_ctx['ms_step']:.1f} over "
        f"steps 3-6); peak device memory {peak_gb:.2f} GB (phase 7: {ce_ctx['peak_gb']:.2f}); launches {launches} "
        f"[{label}]")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"expected {steps} finite CE losses with flash, got {losses}")
    flash_launches_ok(launches, {"K11": steps * layers, "K12": steps * layers, "K13": steps * layers,
                                 "K9": steps * ce_ctx["per_step_k9"]}, "train-ce")
    k9_on_packed(launches, "the flash train-ce run")
    return {"ms_step": ms_step, "peak_gb": peak_gb, "launches": launches, "losses": losses}


def phase_remat(device, label, train_ctx, steps=3):
    """Phase 8e: 3 train steps with ``model.remat`` "full", "dots" and "attn"
    (explicit attention) and "full" with flash, each against the same 3
    steps without remat: losses bit-equal; the peak memory of each."""
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset
    from colbert_tpu_torch.training.dataset import RetrievalSampler

    base = train_ctx["cfg"]
    train_ds = RetrievalDataset.from_json(train_ctx["train_path"])

    def run(impl, remat):
        cfg = ColbertConfig.from_dict(base.to_dict())
        cfg.model.attention_impl, cfg.model.remat = impl, remat
        tok = cli._tokenizer(cfg)
        trainer = ColbertTrainer(cfg, tok, device=device)
        sampler = RetrievalSampler(train_ds, tok, cfg.train, cfg.train.per_device_batch_size, is_eval=False)
        trainer._init_state(sampler.steps_per_epoch())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        losses, t0 = [], time.perf_counter()
        for gstep, batch in zip(range(steps), sampler.epoch(0)):
            losses.append(float(trainer.train_step(batch, gstep)))
        run_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        del trainer
        torch.cuda.empty_cache()
        if impl == "flash":  # the doc pass: K11 once a layer and step, twice under "full" (the recompute)
            n = base.model.num_layers * steps
            flash_launches_ok(launches, {"K11": n * (2 if remat == "full" else 1), "K12": n, "K13": n},
                              f"phase 8e's flash run with remat {remat}")
        return losses, peak, run_s

    out = {}
    for impl, remat in (("auto", "none"), ("auto", "full"), ("auto", "dots"), ("auto", "attn"), ("flash", "none"),
                        ("flash", "full")):
        losses, peak, run_s = run(impl, remat)
        ref = out.get((impl, "none"), {}).get("losses", losses)
        out[impl, remat] = {"losses": losses, "peak_gb": peak, "s": run_s, "bit_equal": losses == ref}
        log(f"[phase8e] attention {impl}, remat {remat}: losses {losses}, bit-equal to no remat "
            f"{losses == ref}; peak device memory {peak:.2f} GB; {steps} steps in {run_s:.2f} s [{label}]")
    if out["flash", "none"]["losses"] != train_ctx["losses"][:steps]:
        raise AssertionError(f"phase 8e's flash steps {out['flash', 'none']['losses']} differ from phase 8b's "
                             f"first {steps} {train_ctx['losses'][:steps]}")
    bad = [k for k, r in out.items() if not r["bit_equal"]]
    if bad:
        raise AssertionError(f"remat losses differ from no remat's for {bad}: {out}")
    return {f"{impl}/{remat}": r for (impl, remat), r in out.items()}


# ---- phase 9: ANN over a ragged corpus, the host-RAM table, the packed dedup ----

RAGGED_DOCS, RAGGED_ROWS = 10_000, (40, 125)  # docs and their row counts (rng.integers' bounds)
RAGGED_QV = 32                                # query rows with multiview off: query_maxlen
RAGGED_K = 4096                               # IVF lists of phase 9b's indexes
RAGGED_RECALL = 0.98                          # recall@100 each required phase-9b path must reach
HOST_FUNNELS = (256, 4096)                    # serve.host_rerank_candidates: the default and the whole budget
HOST_UNIFORM_DOCS = 20_000                    # phase 9a's uniform host table (16 rows a doc)


def ragged_topic_embeddings(num_docs, rows, dim, seed=0, n_topics=256):
    """Ragged docs around :func:`topic_embeddings`' topics (same ``seed``):
    doc i holds ``rng.integers(*rows)`` unit rows around its topic.  Returns
    fp16 rows (sum of doclens, dim) and the doclens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    topics, spectrum = _topics(rng, dim, n_topics)
    doclens = rng.integers(*rows, size=num_docs)
    t = np.repeat(rng.integers(0, n_topics, size=num_docs), doclens)
    out = np.empty((len(t), dim), np.float16)
    for lo in range(0, len(t), 1 << 16):
        tc = t[lo : lo + (1 << 16)]
        e = topics[tc] + 0.3 * (rng.standard_normal((len(tc), dim), dtype=np.float32) * spectrum)
        out[lo : lo + len(tc)] = e / np.linalg.norm(e, axis=1, keepdims=True)
    return out, doclens


def ragged_config(cfg, index_path, port, codec="sq"):
    """``codec_config`` with multiview off (32 query rows, ragged docs)."""
    out = codec_config(cfg, index_path, port, codec)
    out.multiview.enabled = False
    return out


def host_chunks(searcher, topk=TOPK, batch=None):
    """K5 launches of one host-table batch: its query chunks."""
    from colbert_tpu_torch.ranking import searcher as srch

    h = searcher.host_table
    per_query = searcher.host_funnel(topk) * h.cap * searcher.dim
    nq = max(1, min(batch or B, srch._HOST_BLOCK_BYTES // per_query))
    return -(-(batch or B) // nq)


def host_exact(searcher):
    """The exact MaxSim of pids over ``searcher``'s host table, as its rerank
    computes it: each doc's int8 block, rows past its doclen zeroed, against
    ``bf16(Qm * inv_scale)``, in K5's plain version."""
    import torch

    from colbert_tpu_torch.ops import rerank as rr

    h, dev = searcher.host_table, searcher.device

    def exact(pids, Qm):
        n, k = pids.shape
        c = pids.long().cpu()
        blocks = h.gather(c, torch.empty((n * k * h.cap, searcher.dim), dtype=torch.int8)).to(dev)
        if h.doc_offsets is not None:
            past = torch.arange(h.cap, device=dev) >= h.doclens[c.clamp(min=0)].to(dev)[..., None]
            blocks.view(n, k, h.cap, -1).masked_fill_(past[..., None], 0)
        local = torch.arange(n * k, dtype=torch.int32, device=dev).view(n, k)
        q = (Qm.float() * searcher.emb_inv_scale).to(torch.bfloat16).float()
        return rr.maxsim_rerank_uniform_int8_ref(torch.where(pids >= 0, local, -1), q, blocks, dv=h.cap)

    return exact


def bucket_exact(searcher):
    """The exact MaxSim of pids over ``searcher``'s stride buckets (bf16 or
    int8), in the bucketed rerank's plain version."""
    from colbert_tpu_torch.ops import rerank as rr

    return lambda pids, Qm: rr.maxsim_rerank_buckets_ref(pids, Qm, *searcher.emb_table,
                                                        inv_scale=searcher.emb_inv_scale)


def rerank_launches() -> dict:
    return {k: v for k, v in read_counts().items() if k.startswith(("K4", "K5", "K6", "K7"))}


def phase_ragged_cli(device, workdir: Path, cfg, common, eval_path, docs, requests, n_eval, label,
                     num_docs=RAGGED_DOCS):
    """Phase 9c: the first ``num_docs`` passages of phase 2's corpus encoded
    with multiview off, ``build-index`` (sq), ``serve`` (ann, bf16 stride
    buckets) over the socket, two requests; one request each through an
    int8, a host-table and a packed-dedup service; ``evaluate --remote``.
    The launch counts of that run: K4/K5 once a bucket a batch (the host
    table: K5 once a batch), all on route "wgmma_rows", K6 and K7 once a
    batch on "mma"; every answer's scores the exact MaxSim of its pids over
    the served table."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.ops.rerank import stride_buckets
    from colbert_tpu_torch.serving.server import RetrievalClient
    from colbert_tpu_torch.utils.io import dump_json

    rdocs = docs[:num_docs]
    corpus = workdir / "corpus_ragged.json"
    dump_json(rdocs, corpus)
    rcfg = ragged_config(cfg, workdir / "index_ragged", free_port())
    rcfg.index.partitions = 0  # auto, as phase 5c's
    conf = workdir / "conf_ragged.yaml"
    rcfg.to_yaml(conf)
    args = ["--config", str(conf), *common[2:]]
    t0 = time.perf_counter()
    cli.main(["encode", "--corpus", str(corpus), *args])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli.main(["build-index", *args])
    build_s = time.perf_counter() - t0
    doclens = np.asarray(IndexStorage(rcfg.index.index_path).read_doclens())
    strides = stride_buckets(doclens, row_multiple=16)  # int8 at dim 768 takes 16 rows too (JAX's rule)
    log(f"[phase9c] encode (multiview off) of phase 2's first {num_docs} passages in {enc_s:.1f} s, build-index "
        f"(sq) in {build_s:.1f} s: {int(doclens.sum())} rows, doclens {int(doclens.min())}-{int(doclens.max())}, "
        f"strides {strides}")
    serve_err = []

    def serve():
        try:
            cli.main(["serve", "--corpus", str(corpus), *args])
        except BaseException as e:  # noqa: BLE001 -- reported by the main thread
            serve_err.append(e)

    server = threading.Thread(target=serve, daemon=True, name="serve-ragged")
    server.start()
    ns = argparse.Namespace(pretrain=common[common.index("--pretrain") + 1], checkpoint_step=None,
                            device=str(device), corpus=str(corpus))
    services = {}
    for name, key, value in (("int8", "rerank_dtype", "int8"), ("host", "rerank_table", "host"),
                             ("packed", "dedup_impl", "packed")):
        c = ColbertConfig.from_dict(rcfg.to_dict())
        setattr(c.serve, key, value)
        services[name] = cli.make_service(c, ns)
        services[name].retrieve(requests[0][:1], topk=TOPK)  # warm-up, not counted
    client = RetrievalClient(rcfg.serve.host, rcfg.serve.port, rcfg.serve.authkey.encode())
    wait_for_server(rcfg, serve_err)
    client.retrieve(requests[0][:1], topk=TOPK, depth=DEPTH, nprobe=NPROBE)  # warm-up, not counted

    # ---- the counted ragged ANN serving-path run ----
    reset_counts()
    answers, lat = {"bf16": []}, {}
    for i, qs in enumerate(requests[:2]):
        t0 = time.perf_counter()
        answers["bf16"].append(client.retrieve(qs, topk=TOPK, depth=DEPTH, nprobe=NPROBE))
        lat[f"socket {i}"] = time.perf_counter() - t0
    for name, service in services.items():
        t0 = time.perf_counter()
        answers[name] = [service.retrieve(requests[0], topk=TOPK)]
        lat[name] = time.perf_counter() - t0
    cli.main(["evaluate", "--eval-data", str(eval_path), "--remote", "--topk", str(TOPK), *args])
    torch.cuda.synchronize()
    launches = read_counts()
    # ----

    client.shutdown()
    server.join(timeout=60)
    if server.is_alive() or serve_err:
        raise RuntimeError(f"ragged ann server did not stop cleanly: {serve_err}")
    log(f"[phase9c] {B} questions top-{TOPK} in ms: "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in lat.items()) + f" (socket, or in process) [{label}]")
    nb, eval_batches = len(strides), -(-n_eval // B)
    host_k5 = host_chunks(services["host"].searcher)
    bf16_batches = 2 + eval_batches + 1  # the socket's, evaluate --remote's, the packed service's
    batches = bf16_batches + 2
    want = {"K4": nb * bf16_batches, "K5": nb + host_k5, "K6": batches, "K7": batches,
            "K4/K5 wgmma_rows route": nb * (bf16_batches + 1) + host_k5, "K4/K5 wgmma route": 0,
            "K4/K5 staged route": 0,
            "K6 mma route": batches, "K6 staged route": 0, "K7 mma route": batches, "K7 staged route": 0}
    log(f"[phase9c] launches in the ragged serving-path run: {rerank_launches()} (expected {want}: {nb} buckets; "
        f"{bf16_batches} bf16-bucket batches (2 socket requests, {eval_batches} evaluate --remote, 1 packed), one "
        f"int8-bucket batch, one host-table batch of {host_k5} K5 launch(es))")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"ragged ANN launches {launches} do not match the served batches {want}")
    serialized_on_cpp("phase9c", launches, 2 + eval_batches)
    ref = services["packed"].searcher  # bf16 buckets of the served index, the server's tables
    worst = {"bf16": max(check_answers("ragged bf16", qs, ans, ref, rdocs, device, bucket_exact(ref))
                         for qs, ans in zip(requests, answers["bf16"]))}
    for name, exact in (("int8", bucket_exact), ("host", host_exact), ("packed", bucket_exact)):
        s = services[name].searcher
        worst[name] = check_answers(f"ragged {name}", requests[0], answers[name][0], s, rdocs, device, exact(s))
    log(f"[phase9c] served scores vs the exact MaxSim of the returned pids over the served table: max|d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" (limit {SCORE_ATOL})")
    if max(worst.values()) > SCORE_ATOL:
        raise AssertionError(f"ragged ANN scores differ from exact MaxSim: {worst}")
    for service in services.values():
        service.searcher.close()
    return {"launches": launches, "strides": strides, "latency_ms": {k: v * 1e3 for k, v in lat.items()},
            "max_abs_err": worst, "encode_s": enc_s, "build_s": build_s}


def rows_l2_gb(cand, q_rows, table, dv, int8):
    """The bytes route "wgmma_rows" streams from L2 into the SMs for one
    call, reckoned from its work list: every pair's block (its 16-row tiles,
    rows past dv zero-filled by TMA and not read) and one query operand an
    item (32 rows, or K5's three terms of them)."""
    import torch

    from colbert_tpu_torch.ops import rerank as rr

    dim, num_docs = table.shape[1], table.shape[0] // dv
    window = rr.window_docs(num_docs, cand.shape[1], dv * dim * table.element_size())
    items = rr.rerank_items(rr.rerank_schedule(cand, num_docs, window)[2], cand.shape[1], rr._ROWS_PART[int8])
    n_items = int((items[:, 0] >= 0).sum())
    chunks = -(-q_rows // rr.MAX_VIEWS)
    q_bytes = dim * rr.MAX_VIEWS * (3 if int8 else 1) * 2
    pair = int((cand >= 0).sum()) * dv * dim * table.element_size()
    return chunks * (pair + n_items * q_bytes) / 1e9, n_items


def timed_in_turns(new, old, iters=3):
    """``new`` and ``old`` timed in turns (new, old, old, new; CUDA events);
    the mean of each one's two turns, and the four turns."""
    turns = [time_ms(f, iters=iters, warmup=1) for f in (new, old, old, new)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def ragged_bucket_kernels(cand, Qb, searchers, label):
    """Phase 9a: K4 (bf16 buckets) and K5 (int8 buckets) on route
    "wgmma_rows" at the ragged shape, each bucket's launch and the bucketed
    entry against their plain versions (within ``SCORE_ATOL``, -inf exactly
    at the -1 candidates), and the first design (route "staged", forced) on
    the same inputs against them too; the two routes timed in turns
    (wgmma_rows, staged, staged, wgmma_rows; CUDA events; the pair blocks
    pass the L2 many times over, so every launch reads cold), beside both
    byte bounds (distinct doc blocks; the pair blocks "staged" reads), the
    operation bound and the L2 bytes route "wgmma_rows" is reckoned to
    stream (:func:`rows_l2_gb`)."""
    import torch

    from colbert_tpu_torch.ops import rerank as rr

    def check(what, got, want, live):
        if not torch.equal(torch.isfinite(got), live) or not torch.isneginf(got[~live]).all():
            raise AssertionError(f"{what}: -inf pattern differs from the -1 candidates")
        err = float((got[live] - want[live]).abs().max()) if live.any() else 0.0
        if not err <= SCORE_ATOL:
            raise AssertionError(f"{what} differs from its plain version by {err}")
        return err

    out = {}
    for name, s, fn, ref, terms in (("K4", searchers["bfloat16"], rr.maxsim_rerank_uniform,
                                     rr.maxsim_rerank_uniform_ref, 1),
                                    ("K5", searchers["int8"], rr.maxsim_rerank_uniform_int8,
                                     rr.maxsim_rerank_uniform_int8_ref, 3)):
        t = s.emb_table
        q, int8 = rr._bucket_query(Qb, t.tables, s.emb_inv_scale)
        dtype = t.tables[0].dtype
        staged = lambda c, qq, table, dv: rr._launch(c, qq, table, dv, dtype, fn.launches, route="staged")
        safe = cand.clamp(min=0).long()
        b_of = torch.where(cand >= 0, t.bucket_of_pid[safe], -1)
        s_of = t.slot_of_pid[safe]
        qv, dim, elt = Qb.shape[1], Qb.shape[2], t.tables[0].element_size()
        buckets, tot = [], {"distinct_gb": 0.0, "pair_gb": 0.0, "flops": 0.0, "l2_gb": 0.0}
        for b, (table, stride) in enumerate(zip(t.tables, t.strides)):
            cb = torch.where(b_of == b, s_of, -1)
            before = {k: c.value for k, c in rr.route_launches.items()}
            got, want = fn(cb, q, table, dv=stride), ref(cb, q, table, dv=stride)
            torch.cuda.synchronize()
            launched = {k: c.value - before[k] for k, c in rr.route_launches.items()}
            if launched != {k: int(k == "wgmma_rows") for k in launched}:
                raise AssertionError(f"{name} bucket {stride}: launches {launched}, not one on route wgmma_rows")
            live = cb >= 0
            err = check(f"{name} bucket {stride}", got, want, live)
            err_staged = check(f"{name} bucket {stride}, route staged", staged(cb, q, table, stride), want, live)
            nv, n_unique = int(live.sum()), int(torch.unique(cb[live]).numel())
            block = stride * dim * elt
            l2_gb, n_items = rows_l2_gb(cb, qv, table, stride, int8)
            ms, staged_ms, turns = timed_in_turns(lambda: fn(cb, q, table, dv=stride),
                                                  lambda: staged(cb, q, table, stride))
            r = {"stride": stride, "valid": nv, "distinct_docs": n_unique, "max_abs_err": err,
                 "staged_max_abs_err": err_staged, "ms": ms, "staged_ms": staged_ms, "turns_ms": turns,
                 "distinct_gb": n_unique * block / 1e9, "pair_gb": nv * block / 1e9, "l2_gb": l2_gb,
                 "items": n_items, "flops": terms * 2.0 * nv * stride * dim * qv}
            io = cb.numel() * 8 + q.numel() * 4
            r["bound_ms"], r["bound_by"] = bound(r["flops"], n_unique * block + io, PEAK_BF16_FLOPS)
            r["pair_bound_ms"] = (nv * block + io) / PEAK_HBM_BYTES * 1e3
            for k in tot:
                tot[k] += r[k]
            log(f"[phase9a] {name} bucket stride {stride}: {nv} pairs ({n_unique} distinct docs) x {qv} query rows x "
                f"{dim}: max|d|={err:.3e} (staged {err_staged:.3e}); route wgmma_rows {ms:.3f} ms, route staged "
                f"{staged_ms:.3f} ms ({staged_ms / ms:.2f}x; turns {' / '.join(f'{x:.3f}' for x in turns)}); bounds: "
                f"distinct docs {r['distinct_gb']:.3f} GB {r['bound_ms']:.3f} ms ({r['bound_by']}), pair blocks "
                f"{r['pair_gb']:.2f} GB {r['pair_bound_ms']:.3f} ms, operations "
                f"{r['flops'] / PEAK_BF16_FLOPS * 1e3:.3f} ms; wgmma_rows streams {l2_gb:.2f} GB from L2 "
                f"({n_items} items; {l2_gb / ms:.2f} TB/s) [{label}]")
            buckets.append(r)
        before = {k: c.value for k, c in rr.route_launches.items()}
        got = rr.maxsim_rerank_buckets(cand, Qb, *t, inv_scale=s.emb_inv_scale)
        torch.cuda.synchronize()
        launched = {k: c.value - before[k] for k, c in rr.route_launches.items()}
        if launched != {k: len(t.tables) * (k == "wgmma_rows") for k in launched}:
            raise AssertionError(f"{name} bucketed entry: launches {launched}, not one on wgmma_rows a bucket")
        t0 = time.perf_counter()
        want = rr.maxsim_rerank_buckets_ref(cand, Qb, *t, inv_scale=s.emb_inv_scale)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        live = cand >= 0
        bucketed_staged = lambda: rr._buckets(cand, q, t.tables, t.strides, t.bucket_of_pid, t.slot_of_pid, staged)
        err = check(f"{name} bucketed entry", got, want, live)
        err_staged = check(f"{name} bucketed entry, route staged", bucketed_staged(), want, live)
        ms, staged_ms, turns = timed_in_turns(
            lambda: rr.maxsim_rerank_buckets(cand, Qb, *t, inv_scale=s.emb_inv_scale), bucketed_staged)
        io = cand.numel() * 8 + Qb.numel() * 4
        res = {"max_abs_err": err, "staged_max_abs_err": err_staged, "plain_ms": plain_ms, "buckets": buckets,
               "strides": list(t.strides), "ms": ms, "staged_ms": staged_ms, "turns_ms": turns,
               "bucket_ms_sum": sum(r["ms"] for r in buckets), "distinct_gb": tot["distinct_gb"],
               "pair_gb": tot["pair_gb"], "l2_gb": tot["l2_gb"], "items": sum(r["items"] for r in buckets),
               "pair_bound_ms": (tot["pair_gb"] * 1e9 + io) / PEAK_HBM_BYTES * 1e3,
               "ops_ms": tot["flops"] / PEAK_BF16_FLOPS * 1e3}
        res["bound_ms"], res["bound_by"] = bound(tot["flops"], tot["distinct_gb"] * 1e9 + io, PEAK_BF16_FLOPS)
        log(f"[phase9a] {name} bucketed entry: {B} x {cand.shape[1]} candidates over {len(buckets)} buckets "
            f"{list(t.strides)}: max|d|={err:.3e} (staged {err_staged:.3e}; limit {SCORE_ATOL}); route wgmma_rows "
            f"{ms:.3f} ms (buckets alone {res['bucket_ms_sum']:.3f}), route staged {staged_ms:.3f} ms "
            f"({staged_ms / ms:.2f}x; turns {' / '.join(f'{x:.3f}' for x in turns)}), plain {plain_ms:.1f} ms; "
            f"bounds: distinct docs {res['distinct_gb']:.3f} GB {res['bound_ms']:.3f} ms ({res['bound_by']}), pair "
            f"blocks {res['pair_gb']:.2f} GB {res['pair_bound_ms']:.3f} ms, operations {res['ops_ms']:.3f} ms; "
            f"wgmma_rows streams {res['l2_gb']:.2f} GB from L2 ({res['items']} items); no single PyTorch call "
            f"computes it [{label}]")
        if not ms < staged_ms or any(not r["ms"] < r["staged_ms"] for r in buckets):
            raise AssertionError(f"{name}: route wgmma_rows is not faster than route staged on every bucket and "
                                 f"the bucketed entry")
        out[name] = res
    return out


def host_block_kernels(device, host_searcher, Qb, qm, label, num_docs=HOST_UNIFORM_DOCS, seed=SEED):
    """Phase 9a: K5 over host-gathered block sets: a uniform host table (16
    rows a doc, 16 query views: route "wgmma") and the ragged corpus's host
    table at its default funnel (its cap, 124 rows, at 32 views: route
    "wgmma_rows"); each launch, and the first design (route "staged",
    forced) on the same blocks, against the plain version; the two timed in
    turns beside the bound, and the host gather's and the copy's time."""
    import torch

    from colbert_tpu_torch.ops import rerank as rr
    from colbert_tpu_torch.ranking.searcher import HostTable

    g = torch.Generator().manual_seed(seed)
    uniform = HostTable(torch.randint(-127, 128, (num_docs, 16 * H), dtype=torch.int8, generator=g).pin_memory(),
                        None, torch.full((num_docs,), 16), 16)
    hc = host_searcher.host_funnel(TOPK)
    cases = {
        "uniform": (uniform, torch.stack([torch.randperm(num_docs, generator=g)[:hc] for _ in range(B)]),
                    Qb[:, :M] / 127.0),
        "ragged": (host_searcher.host_table,
                   host_searcher.candidates(Qb, qm)[:, :hc].cpu().long(), Qb.float() * host_searcher.emb_inv_scale),
    }
    out = {}
    for kind, (host, cand, q) in cases.items():
        cand = torch.sort(cand, dim=1).values
        n, cap = cand.numel(), host.cap
        buf = torch.empty((n * cap, H), dtype=torch.int8, pin_memory=True)
        t0 = time.perf_counter()
        host.gather(cand, buf)
        gather_ms = (time.perf_counter() - t0) * 1e3
        copy_ms = time_ms(lambda: buf.to(device, non_blocking=True), iters=3, warmup=1)
        blocks = buf.to(device)
        if host.doc_offsets is not None:
            past = torch.arange(cap, device=device) >= host.doclens[cand.clamp(min=0)].to(device)[..., None]
            blocks.view(B, hc, cap, H).masked_fill_(past[..., None], 0)
        local = torch.arange(n, dtype=torch.int32, device=device).view(B, hc)
        local = torch.where(cand.to(device) >= 0, local, -1)
        qb = q.to(torch.bfloat16).float()
        route = rr.rerank_plan(cap, qb.shape[1], H)
        before = rr.route_launches[route].value
        got = rr.maxsim_rerank_uniform_int8(local, qb, blocks, dv=cap)
        torch.cuda.synchronize()
        if rr.route_launches[route].value != before + 1:
            raise AssertionError(f"K5 over {kind} host blocks: not one launch on route {route}")
        staged = lambda: rr._launch(local, qb, blocks, cap, torch.int8, rr.maxsim_rerank_uniform_int8.launches,
                                    route="staged")
        want = rr.maxsim_rerank_uniform_int8_ref(local, qb, blocks, dv=cap)
        err, err_staged = float((got - want).abs().max()), float((staged() - want).abs().max())
        if not (err <= SCORE_ATOL and err_staged <= SCORE_ATOL):
            raise AssertionError(f"K5 over {kind} host blocks differs from its plain version by {err} "
                                 f"(staged {err_staged})")
        ms, staged_ms, turns = timed_in_turns(lambda: rr.maxsim_rerank_uniform_int8(local, qb, blocks, dv=cap), staged)
        bnd = bound(3 * 2.0 * n * cap * H * qb.shape[1], blocks.numel() + local.numel() * 8 + qb.numel() * 4,
                    PEAK_BF16_FLOPS)
        out[kind] = {"route": route, "max_abs_err": err, "staged_max_abs_err": err_staged, "ms": ms,
                     "staged_ms": staged_ms, "turns_ms": turns, "bound_ms": bnd[0], "bound_by": bnd[1],
                     "gather_ms": gather_ms, "copy_ms": copy_ms, "gb": blocks.numel() / 1e9}
        log(f"[phase9a] K5 over {kind} host-gathered blocks ({B} x {hc} docs x {cap} rows, {blocks.numel() / 1e9:.2f} "
            f"GB): max|d|={err:.3e} (staged {err_staged:.3e}); route {route} {ms:.3f} ms, route staged "
            f"{staged_ms:.3f} ms ({staged_ms / ms:.2f}x; turns {' / '.join(f'{x:.3f}' for x in turns)}), bound "
            f"{bnd[0]:.3f} ms ({bnd[1]}); host gather {gather_ms:.1f} ms (host clock), copy to the card "
            f"{copy_ms:.1f} ms [{label}]")
        if kind == "ragged" and not ms < staged_ms:
            raise AssertionError(f"K5 over ragged host blocks: route {route} is not faster than route staged")
        del blocks, buf
    return out


def wide_query_search(device, kept, uniform_cfg, label, seed=0, qv=48):
    """Phase 9d: one batch of 144 two-topic queries of ``qv`` (48) rows from
    query reps, more than one K4/K5 launch takes, through the ragged
    index's bf16 and int8 stride buckets and its host table (funnel 256), a
    launch a bucket (or a host chunk) and a 32-row chunk on route "wgmma_rows",
    and through phase 5b's uniform index (multiview, 16 rows a doc, bf16
    table) as a q_view-48 batch, a launch a 16-row chunk on route "wgmma":
    the launches counted, every score the exact MaxSim of its pid over the
    served table (within ``SCORE_ATOL``), recall@100 against the fp32 exact
    oracle (at least ``RAGGED_RECALL`` but for the 256 funnel, reported as
    at 32 rows), the batch's time."""
    import numpy as np
    import torch

    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.ops import rerank as rr
    from colbert_tpu_torch.ranking import searcher as srch
    from colbert_tpu_torch.tokenization import ColbertTokenizer

    Q = torch.from_numpy(two_topic_queries(B, qv, H, seed=seed)).to(device)
    qm = torch.ones(B, qv, device=device)
    uniform = srch.ColbertSearcher(uniform_cfg, ColbertTokenizer(uniform_cfg.tokenizer, uniform_cfg.multiview),
                                   ColbertModel(uniform_cfg.model, uniform_cfg.multiview),
                                   IndexStorage(uniform_cfg.index.index_path), device=device)
    rows = -(-qv // rr.MAX_VIEWS)  # 32-row chunks
    cases = {"ragged bf16": (kept["bfloat16"], "K4", rows * len(kept["bfloat16"].ragged_strides), "wgmma_rows",
                             bucket_exact(kept["bfloat16"])),
             "ragged int8": (kept["int8"], "K5", rows * len(kept["int8"].ragged_strides), "wgmma_rows",
                             bucket_exact(kept["int8"])),
             "ragged host": (kept["host"], "K5", rows * host_chunks(kept["host"]), "wgmma_rows",
                             host_exact(kept["host"])),
             "uniform bf16, q_view 48": (uniform, "K4", -(-qv // 16), "wgmma",
                                         lambda pids, q: rr.maxsim_rerank_uniform_ref(pids, q, uniform.emb_table, dv=16))}
    out, low = {}, {}
    for name, (s, kern, n, route, exact) in cases.items():
        s.search_reps(Q, qm)  # warm-up
        torch.cuda.synchronize()
        before = rerank_launches()
        t0 = time.perf_counter()
        ts, tp = s.search_reps(Q, qm)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v - before[k] for k, v in rerank_launches().items()}
        want = {"K4": n * (kern == "K4"), "K5": n * (kern == "K5"), "K4/K5 staged route": 0,
                "K4/K5 wgmma_rows route": n * (route == "wgmma_rows"), "K4/K5 wgmma route": n * (route == "wgmma"),
                "K6": 1, "K7": 1, "K6 mma route": 1, "K7 mma route": 1}
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"phase9d {name}: launches {got}, expected {want}")
        if ts.shape != (B, TOPK) or not torch.isfinite(ts).all():
            raise AssertionError(f"phase9d {name}: fewer than {TOPK} finite results")
        err = float((ts - exact(tp, Q)).abs().max())
        oracle = s.exact_topk(Q, TOPK)[1].cpu().numpy()
        tp = tp.cpu().numpy()
        rec = float(np.mean([len(set(tp[b]) & set(oracle[b])) / TOPK for b in range(B)]))
        out[name] = {"recall": rec, "batch_ms": ms, "max_abs_err": err, "launches": got}
        log(f"[phase9d] {name}: {B} x {qv} query rows, recall@{TOPK} vs the fp32 exact oracle {rec:.4f}; scores vs "
            f"the exact MaxSim of the returned pids max|d|={err:.3e} (limit {SCORE_ATOL}); batch {ms:.1f} ms from "
            f"query reps; launches {got} ({n} {kern} on route {route}) [{label}]")
        if name in ("ragged bf16", "ragged int8"):  # the bucketed rerank alone on this batch's candidates
            cand, t = s.candidates(Q, qm), s.emb_table
            rerank = lambda: rr.maxsim_rerank_buckets(cand, Q, *t, inv_scale=s.emb_inv_scale)
            b_of = torch.where(cand >= 0, t.bucket_of_pid[cand.clamp(min=0).long()], -1)
            flops = nbytes = 0.0
            for b, (table, stride) in enumerate(zip(t.tables, t.strides)):
                live = b_of == b
                flops += (3 if kern == "K5" else 1) * 2.0 * int(live.sum()) * stride * H * qv
                nbytes += int(torch.unique(cand[live]).numel()) * stride * H * table.element_size()
            k = {"ms": time_ms(rerank, iters=3, warmup=1)}
            k["bound_ms"], k["bound_by"] = bound(flops, nbytes + cand.numel() * 8 + Q.numel() * 4, PEAK_BF16_FLOPS)
            out[name]["kernel"] = k
            log(f"[phase9d] {name}: the bucketed rerank ({kern}, {n} launches) {k['ms']:.3f} ms on this batch's "
                f"candidates, bound {k['bound_ms']:.3f} ms ({k['bound_by']}: each distinct doc block read once) "
                f"[{label}]")
        if not err <= SCORE_ATOL:
            raise AssertionError(f"phase9d {name}: scores differ from the exact MaxSim of their pids by {err}")
        if rec < RAGGED_RECALL and name != "ragged host":
            low[name] = rec
    del uniform
    torch.cuda.empty_cache()
    if low:
        raise AssertionError(f"phase9d recall@{TOPK} below {RAGGED_RECALL}: {low}")
    return out


def phase_ragged(device, workdir: Path, label: str, num_docs=RAGGED_DOCS, rows=RAGGED_ROWS, partitions=RAGGED_K,
                 funnels=HOST_FUNNELS, seed=0, uniform_cfg=None):
    """Phase 9b then 9a: ``build-index`` (sq, K = ``partitions``, sq_dim 64;
    and pq4) over a ragged synthetic corpus, ANN search of 144 two-topic
    queries of 32 rows from query reps with each rerank table (bf16, int8
    and fp32; the host table with each funnel of ``funnels``) and the packed
    dedup: recall@100 against the fp32 exact oracle, the batch's time and
    its launches (K4/K5 once a bucket, or a host chunk, all on route
    "wgmma_rows"; K6 and K7 once on "mma"), the stages' times; then phase 9d
    (48 query rows over the ragged tables and ``uniform_cfg``'s index) and
    phase 9a on the served batch's candidates."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig, ModelConfig, TokenizerConfig
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.ranking import searcher as srch
    from colbert_tpu_torch.tokenization import ColbertTokenizer
    from colbert_tpu_torch.tokenization.vocab import build_vocab, write_vocab

    t_all = time.perf_counter()
    emb, doclens = ragged_topic_embeddings(num_docs, rows, H, seed=seed)
    storage = IndexStorage(workdir / "ragged")
    bounds = np.linspace(0, num_docs, 5).astype(int)
    offs = np.concatenate([[0], np.cumsum(doclens)])
    for p in range(4):
        lo, hi = bounds[p], bounds[p + 1]
        storage.write_part(p, emb[offs[lo] : offs[hi]], doclens[lo:hi].tolist())
    storage.write_meta({"dim": H, "num_docs": num_docs, "num_embeddings": int(offs[-1]), "multiview": False,
                        "num_parts": 4, "embedding_dtype": "float16"})
    del emb
    vocab = write_vocab(build_vocab(["query"]), workdir / "vocab_ragged.txt")
    base = ColbertConfig(model=ModelConfig(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2,
                                           intermediate_size=64, dim=H),
                         tokenizer=TokenizerConfig(vocab_path=str(vocab)))
    build = {}
    cfgs = {}
    for codec in ("sq", "pq4"):
        index = workdir / ("ragged" if codec == "sq" else "ragged_pq4")
        if codec != "sq":
            share_parts(workdir / "ragged", index)
        cfgs[codec] = ragged_config(base, index, 0, codec)
        cfgs[codec].index.partitions = partitions
        conf = workdir / f"conf_ragged_{codec}.yaml"
        cfgs[codec].to_yaml(conf)
        t0 = time.perf_counter()
        cli.main(["build-index", "--config", str(conf), "--device", str(device)])
        torch.cuda.synchronize()
        build[codec] = time.perf_counter() - t0
    log(f"[phase9b] ragged corpus: {num_docs} docs of {rows[0]}-{rows[1] - 1} rows ({int(offs[-1])} rows x {H}, "
        f"fp16; topic_embeddings' topics, seed {seed}); build-index sq (K={partitions}, sq_dim {SQ_DIM}) "
        f"{build['sq']:.1f} s, pq4 (m {PQ4_M}) {build['pq4']:.1f} s")

    Qb = torch.from_numpy(two_topic_queries(B, RAGGED_QV, H, seed=seed)).to(device)
    qm = torch.ones(B, RAGGED_QV, device=device)
    variants = [("bf16", "sq", {}), ("int8", "sq", {"rerank_dtype": "int8"}),
                ("fp32", "sq", {"rerank_dtype": "float32"}), ("packed", "sq", {"dedup_impl": "packed"}),
                *[(f"host {f}", "sq", {"rerank_table": "host", "host_rerank_candidates": f}) for f in funnels],
                ("pq4", "pq4", {})]
    required = {"bf16", "int8", "fp32", "packed", f"host {funnels[-1]}"}
    oracle, summary, kept, stage = None, {}, {}, {}
    for name, codec, serve_kw in variants:
        cfg = ColbertConfig.from_dict(cfgs[codec].to_dict())
        for k, v in serve_kw.items():
            setattr(cfg.serve, k, v)
        t0 = time.perf_counter()
        s = srch.ColbertSearcher(cfg, ColbertTokenizer(cfg.tokenizer, cfg.multiview),
                                 ColbertModel(cfg.model, cfg.multiview), IndexStorage(cfg.index.index_path),
                                 device=device)
        init_s = time.perf_counter() - t0
        if oracle is None:
            t0 = time.perf_counter()
            oracle = s.exact_topk(Qb, TOPK)[1].cpu().numpy()
            log(f"[phase9b] the fp32 exact oracle (stored rows, {s.rerank_cap}-row windows, rows past a doc's end "
                f"zeroed) over {num_docs} docs in {time.perf_counter() - t0:.1f} s")
        host = s.host_table is not None
        if not (host and s.host_funnel(TOPK) >= 1024):
            s.search_reps(Qb, qm)  # warm-up (the widest funnel's batch runs once)
        torch.cuda.synchronize()
        before = rerank_launches()
        t0 = time.perf_counter()
        ts, tp = s.search_reps(Qb, qm)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v - before[k] for k, v in rerank_launches().items()}
        n_k45 = host_chunks(s) if host else (0 if name == "fp32" else len(s.ragged_strides or ()))
        want = {"K4": n_k45 if name in ("bf16", "packed", "pq4") else 0,
                "K5": n_k45 if (name == "int8" or host) else 0, "K4/K5 wgmma_rows route": n_k45,
                "K4/K5 staged route": 0, "K4/K5 wgmma route": 0, "K6": int(codec == "sq"), "K7": int(codec == "sq"),
                "K6 mma route": int(codec == "sq"), "K7 mma route": int(codec == "sq")}
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"phase9b {name}: launches {got}, expected {want}")
        tp = tp.cpu().numpy()
        if ts.shape != (B, TOPK) or not torch.isfinite(ts).all():
            raise AssertionError(f"phase9b {name}: fewer than {TOPK} finite results")
        rec = float(np.mean([len(set(tp[b]) & set(oracle[b])) / TOPK for b in range(B)]))
        table = ("host int8 %.3f GB" % (s.host_table.rows.numel() / 1e9) if host else
                 "buckets %s" % (list(s.ragged_strides),) if s.ragged_strides else "ragged fp32")
        summary[name] = {"recall": rec, "batch_ms": ms, "init_s": init_s, "launches": got}
        log(f"[phase9b] {name} ({codec}, {table}): recall@{TOPK} vs the fp32 exact oracle {rec:.4f}; batch {ms:.1f} "
            f"ms from query reps; searcher built in {init_s:.1f} s; launches {got} [{label}]")
        if name in ("bf16", "int8"):
            kept[{"bf16": "bfloat16", "int8": "int8"}[name]] = s
        elif host and s.host_funnel(TOPK) == funnels[0]:
            kept["host"] = s
        if name in ("bf16", "packed"):
            probe = s.probe_fn()
            pids, scores = srch.probe_pids(Qb, qm, probe, s.pid_by_row)
            dd = lambda: srch.dedup(pids, scores, q_view=RAGGED_QV, depth=DEPTH, max_cand=MAX_CAND,
                                    dedup_impl=s.cfg.serve.dedup_impl, num_docs=num_docs)
            stage[f"dedup {name}"] = time_ms(dd, iters=5)
            if name == "bf16":
                stage["probe"] = time_ms(lambda: srch.probe_pids(Qb, qm, probe, s.pid_by_row), iters=5)
                cand = dd()
                sc = srch.rerank(cand, Qb, s.emb_table, None, dv=s.rerank_cap)
                stage["rerank"] = time_ms(lambda: srch.rerank(cand, Qb, s.emb_table, None, dv=s.rerank_cap),
                                          iters=3, warmup=1)
                stage["topk"] = time_ms(lambda: srch.select_topk(sc, cand, TOPK), iters=5)
                del sc
        if s not in kept.values():
            s.close()
            del s
        torch.cuda.empty_cache()
    log(f"[phase9b] bf16 batch of {B} x {RAGGED_QV} query reps, ms per stage (CUDA events): "
        + ", ".join(f"{k} {stage[k]:.3f}" for k in ("probe", "dedup bf16", "rerank", "topk"))
        + f"; the packed dedup {stage['dedup packed']:.3f} against the exact {stage['dedup bf16']:.3f} "
        f"(information) [{label}]")

    out = {"summary": summary, "stage_ms": stage, "build_s": build}
    out["wide"] = wide_query_search(device, kept, uniform_cfg, label, seed)
    out["buckets"] = ragged_bucket_kernels(cand, Qb, kept, label)
    out["host_blocks"] = host_block_kernels(device, kept["host"], Qb, qm, label)
    for s in kept.values():
        s.close()
    low = {k: v["recall"] for k, v in summary.items() if k in required and v["recall"] < RAGGED_RECALL}
    log(f"[phase9] phases 9a and 9b took {time.perf_counter() - t_all:.1f} s")
    if low:  # checked last, so that one run reports every path and kernel
        raise AssertionError(f"phase9b recall@{TOPK} below {RAGGED_RECALL}: {low}")
    return out


# ---- phase 10: several devices ----

SHARDS = 4  # corpus shards of phase 10a/10b, on the cards present


def shard_devices(device, shards=SHARDS):
    """``shards`` positions over the cards present (several a card when
    fewer), or ``device`` for each on the CPU."""
    import torch

    if device.type != "cuda":
        return [device] * shards
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(shards)]


def phase_sharded_flat(device, cfg, docs, requests, single, label, shards=SHARDS):
    """Phase 10a: ``ShardedColbertSearcher`` in flat mode over phase 2's
    encoded corpus, ``shards`` shards on the cards present, every request
    of 144 questions at top-100: each answer checked as phase 2's against
    the plain version's top-100 over the single searcher's table and query
    encodings (within 1e-4, tie-insensitive), K2 once a shard a batch and
    no K1; the time a batch beside the single searcher's (K2, unfused), in
    turns (information)."""
    import numpy as np
    import torch

    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.parallel.mesh import make_mesh
    from colbert_tpu_torch.ranking.sharded import ShardedColbertSearcher

    start = t0 = time.perf_counter()
    sharded = ShardedColbertSearcher(single.cfg, single.tok, single.model, IndexStorage(cfg.index.index_path),
                                     mesh=make_mesh(devices=shard_devices(device, shards)))
    build_s = time.perf_counter() - t0
    encs = [single.tok.encode_queries(qs) for qs in requests]
    run = lambda s, e: s.search_tokens(e.input_ids, e.attention_mask, e.active_mask, topk=TOPK)
    run(sharded, encs[0])  # warm-up, not counted

    # ---- the counted sharded flat run ----
    reset_counts()
    got = [run(sharded, e) for e in encs]
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_counts()
    # ----

    want = {"K2": shards * len(requests), "K1": 0}
    log(f"[phase10a] launches in the sharded flat run: {launches} (expected {want}: K2 once a shard a batch)")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"sharded flat launches {launches}, expected {want}")
    answers = [[[(int(p), float(s), docs[int(p)]) for p, s in zip(r.pids[b], r.scores[b])] for b in range(len(qs))]
               for r, qs in zip(got, requests)]
    worst, recall = check_flat_answers(requests, [[a] for a in answers], single, docs)
    ms = {"sharded": [], "single": []}
    for who in ("sharded", "single", "single", "sharded"):
        s = sharded if who == "sharded" else single
        for e in encs:
            t0 = time.perf_counter()
            run(s, e)
            ms[who].append((time.perf_counter() - t0) * 1e3)
    out = {"launches": launches, "max_abs_err": worst, "shards": shards, "build_s": build_s,
           "ms": float(np.median(ms["sharded"])), "single_ms": float(np.median(ms["single"])),
           "s": time.perf_counter() - start}
    log(f"[phase10a] sharded flat: {shards} shards on {[str(d) for d in sharded.mesh.devices]}, built in "
        f"{build_s:.1f} s; {len(requests)} requests of {B} questions top-{TOPK}: scores vs the plain version "
        f"max|d|={worst:.3e} (limit {SCORE_ATOL}), pid recall {recall:.4f} (near ties); a batch "
        f"{out['ms']:.1f} ms sharded, {out['single_ms']:.1f} ms single (host clock, synchronised, medians in "
        f"turns, information) [{label}]")
    if worst > SCORE_ATOL:
        raise AssertionError(f"sharded flat scores differ from the plain version by {worst}")
    return out


def phase_sharded_ann(device, label, ann_info, shards=SHARDS):
    """Phase 10b: ``ShardedColbertSearcher`` over phase 5b's sq index (the
    bench generator's corpus, where recall means something: phase 2's random
    model scores near ties), ``shards`` shards, one batch of 144 topic
    queries from their reps: recall@100 against the fp32 exact oracle (at
    least 0.98, phase 5b's limit) and against the single searcher's pids (at
    least 0.95: a shard probes its own lists, a superset of the single
    searcher's candidates), every rank's score at least the single
    searcher's (within 1e-4) and the exact MaxSim of its pid over the bf16
    table (within 1e-4); K6, K7 and K4 once a shard, K6/K7 on route "mma",
    K4 on "wgmma"; the batch's time beside the single searcher's
    (information).  ``ann_info``: phase 5b's config and query reps."""
    import numpy as np
    import torch

    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.ops.rerank import maxsim_rerank_uniform_ref
    from colbert_tpu_torch.parallel.mesh import make_mesh
    from colbert_tpu_torch.ranking.searcher import ColbertSearcher
    from colbert_tpu_torch.ranking.sharded import ShardedColbertSearcher
    from colbert_tpu_torch.tokenization import ColbertTokenizer

    start = time.perf_counter()
    cfg = ann_info["config"]
    storage = IndexStorage(cfg.index.index_path)
    tok, model = ColbertTokenizer(cfg.tokenizer, cfg.multiview), ColbertModel(cfg.model, cfg.multiview)
    single = ColbertSearcher(cfg, tok, model, storage, device=device)
    t0 = time.perf_counter()
    sharded = ShardedColbertSearcher(cfg, tok, model, storage, mesh=make_mesh(devices=shard_devices(device, shards)))
    build_s = time.perf_counter() - t0
    Qb = ann_info["queries"][:B]
    qm = torch.ones(B, M, device=device)
    sharded.search_reps(Qb, qm, TOPK)  # warm-up, not counted

    # ---- the counted sharded ANN run ----
    reset_counts()
    ts, tp = sharded.search_reps(Qb, qm, TOPK)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_counts()
    # ----

    want = {"K6": shards, "K7": shards, "K4": shards, "K5": 0, "K6 mma route": shards, "K7 mma route": shards,
            "K4/K5 wgmma route": shards, "K4/K5 wgmma_rows route": 0, "K4/K5 staged route": 0}
    log(f"[phase10b] launches in the sharded ANN batch: {launches} (expected {want}: once a shard)")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"sharded ANN launches {launches}, expected {want}")
    ws, wp = single.search_reps(Qb, qm, TOPK)
    exact = maxsim_rerank_uniform_ref(tp, Qb, single.emb_table, dv=16)
    err = float((ts - exact).abs().max())
    below = float((ws - ts).max())
    op = single.exact_topk(Qb, TOPK)[1].cpu().numpy()
    tp_np, wp_np = tp.cpu().numpy(), wp.cpu().numpy()
    rec_exact = float(np.mean([len(set(tp_np[b]) & set(op[b])) / TOPK for b in range(B)]))
    rec_single = float(np.mean([len(set(tp_np[b]) & set(wp_np[b])) / TOPK for b in range(B)]))
    single_rec = float(np.mean([len(set(wp_np[b]) & set(op[b])) / TOPK for b in range(B)]))
    ms = {"sharded": [], "single": []}
    for who in ("sharded", "single", "single", "sharded"):
        s = sharded if who == "sharded" else single
        t0 = time.perf_counter()
        s.search_reps(Qb, qm, TOPK)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms[who].append((time.perf_counter() - t0) * 1e3)
    out = {"launches": launches, "max_abs_err": err, "recall_exact": rec_exact, "recall_single": rec_single,
           "single_recall_exact": single_rec, "shards": shards, "build_s": build_s,
           "ms": float(np.mean(ms["sharded"])), "single_ms": float(np.mean(ms["single"])),
           "s": time.perf_counter() - start}
    log(f"[phase10b] sharded sq ANN: {shards} shards, shard_index and tables in {build_s:.1f} s; a batch of {B} "
        f"x {M} query reps: recall@{TOPK} vs the fp32 exact oracle {rec_exact:.4f} (single {single_rec:.4f}), vs "
        f"the single searcher's pids {rec_single:.4f}; scores vs exact MaxSim of the pids max|d|={err:.3e}, the "
        f"single searcher's rank scores above the sharded by at most {below:.3e}; a batch {out['ms']:.1f} ms "
        f"sharded, {out['single_ms']:.1f} ms single (host clock, means in turns, information) [{label}]")
    if rec_exact < 0.98 or rec_single < 0.95 or err > SCORE_ATOL or below > SCORE_ATOL:
        raise AssertionError(f"sharded ANN: recall {rec_exact} / {rec_single}, max|d| {err}, below single {below}")
    return out


def phase9_alone(device, label):
    """Phases 9b, 9d and 9a with only the set-up they need (``chip_smoke.py
    --phase9``): phase 5b's corpus and uniform index (9d's q_view-48 batch)
    and the synthetic ragged corpus; 9c, which serves phase 2's encoded
    corpus, runs only in the whole script."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase9_") as tmp:
        tmp = Path(tmp)
        (tmp / "ann").mkdir()
        cfg, *_ = bench_index(device, tmp / "ann", n_batches=1)
        return phase_ragged(device, tmp, label, uniform_cfg=cfg)


def phase10_alone(device, label):
    """Phase 10 with only the set-up it needs (``chip_smoke.py --phase10``,
    for a machine with several cards): phase 2's encoded corpus, phase 5b's
    corpus and index, phase 4's data and config."""
    import torch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase10_") as tmp:
        tmp = Path(tmp)
        for d in ("flat", "ann", "train"):
            (tmp / d).mkdir()
        corpus = encoded_corpus(device, tmp / "flat", label)
        flat = phase_sharded_flat(device, corpus["cfg"], corpus["docs"], corpus["requests"],
                                  unfused_searcher(device, corpus["cfg"], corpus["model"]), label)
        cfg, _, _, queries, _ = bench_index(device, tmp / "ann", n_batches=1)
        ann = phase_sharded_ann(device, label, {"config": cfg, "queries": torch.from_numpy(queries).to(device)})
        tcfg, train_path, _ = train_setup(tmp / "train")
        launch = phase_launch_train(device, tmp / "train", label, {"cfg": tcfg, "train_path": train_path})
    return {"sharded_flat": flat, "sharded_ann": ann, "launch_train": launch}


def phase_launch_train(device, workdir: Path, label: str, train_ctx, steps=3, processes=None, model=1):
    """Phase 10c: the CLI's ``train`` under a launch (``--coordinator
    127.0.0.1:<port> --num-processes N --process-id r``, NCCL, N =
    ``processes``, by default the cards present) for ``steps`` steps at
    phase 4's configuration, against the same steps without the launch
    flags.  N = 1 (in this process): every step's loss, the parameters and
    AdamW's moments after the last step bit-equal (the moments of step 1
    are the gradients scaled), K9 and no K3 as phase 4's steps.  N >= 2
    (one process a card, each rank's output in ``workdir``): the CPU test's
    conditions (the model in fp32, Adam's eps 1e-6), 34 // N examples a
    rank, the one device at the global batch; the ranks' losses within 1e-6
    of their size and the parameters within 1e-6 of the one device's.  With
    ``model`` > 1 each rank holds ``model`` cards (``mesh.model``, tensor
    parallelism; N by default the cards present over ``model``: phase 13 on
    four cards runs data 2 x model 2), and the limit is ``TP_LAUNCH_TOL``
    (the forward's sums run in another order)."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.training.checkpoint import CheckpointManager
    from colbert_tpu_torch.utils.io import dump_json, load_json, load_jsonl

    start = time.perf_counter()
    n = processes or (torch.cuda.device_count() // model if device.type == "cuda" else 1)
    base = train_ctx["cfg"]
    b = base.train.per_device_batch_size // n
    data = workdir / "launch_train.json"
    dump_json(load_json(train_ctx["train_path"])[: steps * n * b], data)

    def conf(name, batch, mesh_model=1):
        c = ColbertConfig.from_dict(base.to_dict())
        c.train.per_device_batch_size, c.train.evals_per_epoch = batch, 1
        c.mesh.model = mesh_model
        c.train.checkpoint_dir = str(workdir / name)
        if n > 1:
            # the CPU test's conditions: fp32, and Adam's eps at 1e-6, since the
            # default 1e-8 scales the rounding noise of exactly-zero gradients
            # (the key biases') up to ~lr a step
            c.model.dtype, c.train.adam_eps = "float32", 1e-6
        c.to_yaml(workdir / f"{name}.yaml")
        return ["train", "--config", str(workdir / f"{name}.yaml"), "--train-data", str(data)]

    t0 = time.perf_counter()
    cli.main([*conf("one", n * b), "--device", str(device)])
    one_s = time.perf_counter() - t0
    port = free_port()
    launch = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n)]
    t0 = time.perf_counter()
    if n == 1:
        # ---- the counted launched run ----
        reset_counts()
        cli.main([*conf("ranks", b), "--device", str(device), *launch, "--process-id", "0"])
        torch.cuda.synchronize()
        launches = read_counts()
        # ----
    else:
        args = conf("ranks", b, model)
        outs = [open(workdir / f"rank{r}.log", "w") for r in range(n)]
        procs = [subprocess.Popen([sys.executable, "-m", "colbert_tpu_torch.cli", *args, "--device", device.type,
                                   *launch, "--process-id", str(r)], cwd=Path(__file__).resolve().parent,
                                  stdout=out, stderr=subprocess.STDOUT) for r, out in enumerate(outs)]
        try:
            for r, proc in enumerate(procs):
                if proc.wait(timeout=900):
                    tail = (workdir / f"rank{r}.log").read_text()[-3000:]
                    raise RuntimeError(f"rank {r} of the launch exited {proc.returncode}:\n{tail}")
        finally:
            for proc, out in zip(procs, outs):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
        launches = None
    ranks_s = time.perf_counter() - t0
    losses = {k: [r["step_loss"] for r in load_jsonl(workdir / k / "train_log.jsonl") if r["kind"] == "step"]
              for k in ("one", "ranks")}
    ckpt = {k: CheckpointManager(str(workdir / k)) for k in ("one", "ranks")}
    params = {k: torch.load(c.params_path(steps), map_location="cpu", weights_only=True) for k, c in ckpt.items()}
    moments = {k: c.load_train_state(steps)["optimizer"]["adamw"]["state"] for k, c in ckpt.items()}
    if any(len(v) != steps or not np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"launched train losses {losses}")
    diffs = sorted(((float((params["one"][k].float() - v.float()).abs().max()), k) for k, v in params["ranks"].items()),
                   reverse=True)
    p_diff = diffs[0][0]
    m_diff = max(float((moments["one"][i][m] - s[m]).abs().max()) for i, s in moments["ranks"].items()
                 for m in ("exp_avg", "exp_avg_sq"))
    out = {"processes": n, "model": model, "backend": "nccl" if device.type == "cuda" else "gloo", "losses": losses,
           "max_param_diff": p_diff, "max_moment_diff": m_diff, "one_s": one_s, "ranks_s": ranks_s,
           "launches": launches, "s": time.perf_counter() - start}
    log(f"[phase10c] train under a launch of {n} process(es) ({out['backend']}, mesh.model={model} a rank), "
        f"{steps} steps at phase 4's "
        f"configuration{' in fp32, adam_eps 1e-6' if n > 1 else ''}, per-device batch {b}: losses {losses['ranks']} vs "
        f"the one device's {losses['one']}; parameters max|d| {p_diff:.3e} (largest: "
        f"{', '.join(f'{k} {d:.2e}' for d, k in diffs[:3])}), AdamW moments max|d| {m_diff:.3e}; {ranks_s:.1f} s launched, "
        f"{one_s:.1f} s without (model init and checkpoints included); launches {launches} [{label}]")
    if n == 1:
        per_step_k9 = (1 + 3 * base.model.num_layers) * 2 * 2
        if losses["ranks"] != losses["one"] or p_diff or m_diff:
            raise AssertionError("a launch of one process is not bit-equal to no launch")
        if launches["K9"] != steps * per_step_k9 or launches["K3"]:
            raise AssertionError(f"launched train launches {launches}, expected K9 {steps * per_step_k9}, no K3")
        k9_on_packed(launches, "the launched train run")
    else:
        tol = 1e-6 if model == 1 else TP_LAUNCH_TOL
        if not (np.allclose(losses["ranks"], losses["one"], rtol=tol, atol=0) and p_diff <= tol):
            raise AssertionError(f"{n} ranks of model {model} against one device: losses {losses}, parameters "
                                 f"max|d| {p_diff}")
    return out



# ---- phase 11: flash at fp32, the two model options, DPR, real text ----

FP32_LOSS_REL = 1e-4   # 11b: a flash fp32 step's loss against the explicit fp32 path's, relative to its size
OPTION_LOSS_REL = 2e-2  # 11c: a fused_qkv bf16 step's loss against phase 4's configuration's
OPTION_GRAD_REL = 5e-2  # 11c: a fused_qkv bf16 gradient against phase 4's, |d| / |g| over each tensor
WORD_GRAD_REL = 2**-7   # 11c: the onehot word gradient against the lookup's, |d| / |g| over the table
DPR_TIE = 1e-6          # 11d: an id may differ from the fp64 oracle's only at ties this close (beyond fp32's error)
REAL_TEXT_MODEL = dict(vocab_size=8192, hidden_size=256, num_layers=4, num_heads=4, intermediate_size=1024,
                       max_position_embeddings=256, dim=128)  # scripts/real_data_e2e.py's BERT-small width


def flash_fp32_bounds(B, nh, L, hd=64):
    """The bounds at (B, nh, L, hd) fp32: (ms, by) of K11, K12 and K13 as fp32
    FMAs (fp32 operations over 67 TFLOP/s or fp32 bytes over 3.35 TB/s) and
    of the rows kernel (2 L hd flops a head; o and do read, l read, di and 1
    / l written); "tf32x3": the products as three TF32 products on the
    tensor cores (495 TFLOP/s, route "tf32", each kernel's bound), (ms, by)."""
    out = flash_bounds(B, nh, L, hd, elem_bytes=4, peak_flops=PEAK_FP32_FLOPS)
    out["rows"] = bound(2 * B * nh * L * hd, 2 * B * nh * L * hd * 4 + 3 * B * nh * L * 4, PEAK_FP32_FLOPS)
    per_head = B * nh * L * L * hd
    t, rows, seg = B * nh * L * hd * 4, B * nh * L * 4, 2 * B * L * 4  # flash_bounds' bytes at fp32
    nbytes = {"K11": 4 * t + 2 * rows + seg, "K12": 6 * t + 3 * rows + seg, "K13": 5 * t + 3 * rows + seg}
    out["tf32x3"] = {k: bound(3 * n * per_head, nbytes[k], PEAK_TF32_FLOPS) for k, n in (("K11", 4), ("K12", 8),
                                                                                        ("K13", 6))}
    return out


def flash_fp32_case(device, name, B, nh, lengths, seed, label, hd=64):
    """Phase 11a at (B, nh, 384, hd) fp32 in the models' layout: route
    "tf32" of K11 and the rows kernel's fp32 route (di and 1 / l from K11's
    own o and l), route "tf32" of K12 and K13 (on the plain forward's l, m
    and di) against the fp32 plain versions (TF32 off): o, dq, dk and dv
    within ``FP32_HEAD_REL`` (``fp32_head_rel``), l and m within it,
    relative (m's floored at 1); di bit-equal to its order in torch and
    within fp32 rounding of ``flash_di``, 1 / l bit-equal; two runs
    bit-equal; the autograd function equal to the launches on its own o, l
    and m; every launch on the route asked for.  Times: each kernel cold
    and hot (medians of three in turn), the plain forward and backward, the
    autograd forward + backward, and ``F.scaled_dot_product_attention`` at
    fp32 with the boolean segment mask (forward, forward + backward, its
    backward alone), beside the bounds (fp32 FMAs; three TF32 products, and
    each kernel's share of the latter)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from colbert_tpu_torch.ops import flash_attention as fa

    L, scale = 384, hd ** -0.5
    g = torch.Generator(device).manual_seed(seed)

    def heads():
        return torch.randn((B, L, nh, hd), generator=g, device=device, dtype=torch.float32).transpose(1, 2)
    q, k, v, do = heads(), heads(), heads(), heads()
    seg = (torch.arange(L, device=device)[None, :] < torch.as_tensor(lengths, device=device)[:, None]).to(torch.int32)
    args = (q, k, v, seg, seg, scale)
    before = read_counts()
    o, l, m = fa._launch_forward(*args)
    di, inv_l = fa._launch_rows(o, do, l)
    ro, rl, rm = fa.flash_forward_ref(*args)
    rdi = fa.flash_di(ro, do)
    bargs = (*args, rl, rm, do, rdi)
    dk, dv = fa._launch_dkv(*bargs)
    dq = fa._launch_dq(*bargs)
    want = fa.flash_backward_ref(*bargs)
    again = (*fa._launch_forward(*args), *fa._launch_dkv(*bargs), fa._launch_dq(*bargs))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, seg, seg, scale)
    out.backward(do)
    own = (*args, l, m, do, di)
    own_dk, own_dv = fa._launch_dkv(*own, inv_l=inv_l)
    own_dq = fa._launch_dq(*own, inv_l=inv_l)
    torch.cuda.synchronize()
    after = read_counts()
    launched = {key: after[key] - before[key] for key in after
                if key.startswith(("K11 ", "K12 ", "K13 ", "flash rows"))}
    tpl = fa.template_head_dim(hd)
    want_launched = {key: 0 for key in launched} | {"K11 tf32 route": 3, "K12 tf32 route": 4, "K13 tf32 route": 4,
                                                     "flash rows": 2, "flash rows fp32": 2, f"K11 hd{hd}": 3,
                                                     f"K12 hd{hd}": 4, f"K13 hd{hd}": 4, f"K11 template{tpl}": 3,
                                                     f"K12 template{tpl}": 4, f"K13 template{tpl}": 4}
    stable = all(torch.equal(a, b) for a, b in zip((o, l, m, dk, dv, dq), again))
    autograd_same = torch.equal(out, o) and all(torch.equal(t.grad, w)
                                                for t, w in zip(leaves, (own_dq, own_dk, own_dv)))
    res = {"shape": [B, nh, L, hd], "dtype": "float32", "lengths": [int(np.min(lengths)), int(np.max(lengths))],
           "bit_stable": stable, "autograd_same": autograd_same, "launched": launched}
    checked = (("o", o, ro), ("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2]))
    for what, got, ref in checked:
        res[what] = {"head_rel": fa.fp32_head_rel(got, ref), "max_abs_err": float((got - ref).abs().max())}
    res["l_max_rel_err"] = float(((l - rl).abs() / rl).max())
    res["m_max_rel_err"] = float(((m - rm).abs() / rm.abs().clamp_min(1.0)).max())
    res["di"] = {"fp32_bound_share": di_within_fp32(di, o, do),
                 "card_order_equal": bool(torch.equal(di, fa.flash_di_card_order(o, do))),
                 "inv_l_equal": bool(torch.equal(inv_l, torch.ones_like(l) / l))}
    log(f"[phase11a] {name} ({B}, {nh}, {L}, {hd}) fp32, lengths {res['lengths'][0]}-{res['lengths'][1]}, K11, K12 "
        f"and K13 route tf32: bit-stable {stable}, autograd function equal "
        f"{autograd_same}; against the fp32 plain versions "
        + "; ".join(f"{w} {res[w]['head_rel']:.2e} of its head vector (max|d| {res[w]['max_abs_err']:.3e})"
                    for w, _, _ in checked)
        + f"; l rel {res['l_max_rel_err']:.2e}, m rel {res['m_max_rel_err']:.2e}; di {res['di']['fp32_bound_share']:.3f} "
        f"of the fp32 rounding bound, bit-equal to its order {res['di']['card_order_equal']}, 1 / l bit-equal "
        f"{res['di']['inv_l_equal']}; launches {launched}")
    off = [w for w, _, _ in checked if not res[w]["head_rel"] <= fa.FP32_HEAD_REL]
    if off or not (stable and autograd_same) or launched != want_launched \
            or not res["l_max_rel_err"] <= fa.FP32_HEAD_REL or not res["m_max_rel_err"] <= fa.FP32_HEAD_REL \
            or not (res["di"]["fp32_bound_share"] <= 1.0
                                                       and res["di"]["card_order_equal"] and res["di"]["inv_l_equal"]):
        raise AssertionError(f"flash at fp32 at {name}: beyond the limits {off}, launches {launched} (expected "
                             f"{want_launched}): {res}")

    # ---- times: CUDA events, hot (the same inputs) and cold (copies in turn past twice the L2) ----
    n_copies = max(1, -(-4 * L2_BYTES // (4 * q.numel() * 4)))
    copies = [tuple(t.clone() for t in (q, k, v, do)) for _ in range(n_copies)]
    outs = [tuple(t.clone() for t in (o, do)) for _ in range(n_copies)]
    runs = {"hot": {}, "cold": {}}

    def timed(key, hot_fn, cold_fn, xs):
        runs["hot"].setdefault(key, []).append(time_ms(hot_fn))
        runs["cold"].setdefault(key, []).append(time_ms(in_turn(cold_fn, xs), warmup=len(xs) + 2))
    for _ in range(3):
        timed("K11", lambda: fa._launch_forward(*args),
              lambda x, i: fa._launch_forward(x[0], x[1], x[2], seg, seg, scale), copies)
        timed("K12", lambda: fa._launch_dkv(*own, inv_l=inv_l),
              lambda x, i: fa._launch_dkv(x[0], x[1], x[2], seg, seg, scale, l, m, x[3], di, inv_l=inv_l), copies)
        timed("K13", lambda: fa._launch_dq(*own, inv_l=inv_l),
              lambda x, i: fa._launch_dq(x[0], x[1], x[2], seg, seg, scale, l, m, x[3], di, inv_l=inv_l), copies)
        timed("rows", lambda: fa._launch_rows(o, do, l), lambda x, i: fa._launch_rows(x[0], x[1], l), outs)
    hot, cold = ({key: float(np.median(t)) for key, t in runs[kind].items()} for kind in ("hot", "cold"))

    def fwd_bwd(fn):
        def run():
            for t in leaves:
                t.grad = None
            fn(*leaves).backward(do)
        return run
    mask = (seg[:, :, None] == seg[:, None, :])[:, None]  # (B, 1, L, L) segment equality
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=mask, scale=scale)
    with torch.no_grad():
        t_plain = time_ms(lambda: fa.flash_forward_ref(*args), iters=3, warmup=1)
        t_plain_bwd = time_ms(lambda: fa.flash_backward_ref(*bargs), iters=3, warmup=1)
        t_sdpa = time_ms(lambda: sdpa(q, k, v), iters=10, warmup=2)
    t_flash_fb = time_ms(fwd_bwd(lambda a, b, c: fa.flash_attention(a, b, c, seg, seg, scale)), iters=10,
                         warmup=2)
    t_sdpa_fb = time_ms(fwd_bwd(sdpa), iters=10, warmup=2)
    t_sdpa_bwd, sdpa_backend, sdpa_tried = sdpa_backward_alone(q, k, v, mask, do, scale=scale)
    bounds = flash_fp32_bounds(B, nh, L, hd)
    backward = cold["rows"] + cold["K12"] + cold["K13"]
    res.update({"ms": cold, "hot_ms": hot, "bound": bounds, "plain_ms": t_plain, "plain_backward_ms": t_plain_bwd,
                "flash_fwd_bwd_ms": t_flash_fb, "sdpa_ms": t_sdpa, "sdpa_fwd_bwd_ms": t_sdpa_fb,
                "sdpa_backward_ms": t_sdpa_bwd, "sdpa_backward_backend": sdpa_backend,
                "sdpa_backward_tried": sdpa_tried, "cold_copies": n_copies, "rows_k12_k13_ms": backward,
                "tf32x3_bound_share": {kn: bounds["tf32x3"][kn][0] / cold[kn] for kn in ("K11", "K12", "K13")}})
    for kname in ("K11", "K12", "K13", "rows"):
        route = "fp32" if kname == "rows" else "tf32"
        tf32 = "" if kname == "rows" else (f"; as three TF32 products {bounds['tf32x3'][kname][0]:.4f} "
                                           f"({100 * bounds['tf32x3'][kname][0] / cold[kname]:.1f}% of it)")
        log(f"[phase11a] {name} {kname} route {route}: {cold[kname]:.4f} ms cold ({n_copies} input sets in turn), "
            f"{hot[kname]:.4f} hot; bound as fp32 FMAs {bounds[kname][0]:.4f} ms ({bounds[kname][1]}){tf32} "
            f"[{label}]")
    log(f"[phase11a] {name} fp32: K11 (route tf32) {cold['K11']:.4f} ms cold against SDPA's forward {t_sdpa:.4f} "
        f"({t_sdpa / cold['K11']:.2f}x); rows + K12 + K13 (route tf32) {backward:.4f} ms against SDPA's backward alone {t_sdpa_bwd:.4f} ({sdpa_backend}; tried "
        f"{sdpa_tried}); plain forward {t_plain:.3f} ms, plain backward {t_plain_bwd:.3f}; the autograd forward + "
        f"backward (K11, rows, K12, K13) {t_flash_fb:.4f}; F.scaled_dot_product_attention with the segment mask (a "
        f"yardstick the port never calls): forward {t_sdpa:.4f}, forward + backward {t_sdpa_fb:.4f} [{label}]")
    return res


def flash_tf32_nan_check(device, name, B, nh, lengths, seed):
    """K11, K12 and K13 on route "tf32" at (B, nh, 384, 64) fp32 with a NaN
    planted in q (0xFFFFFFFF; batch 1, head 0) and one in do (0x7FFFFFFF;
    the last batch, the last head): o, l and m NaN exactly where
    ``flash_forward_ref``'s are, dq, dk and dv where ``flash_backward_ref``'s
    are on the same inputs (its l, m and di), some but not all of each, and
    the rest within ``FP32_HEAD_REL`` (l and m relative, m's floored at 1)."""
    import torch

    from colbert_tpu_torch.ops import flash_attention as fa

    L = 384
    g = torch.Generator(device).manual_seed(seed)
    q, k, v, do = (torch.randn((B, L, nh, 64), generator=g, device=device).transpose(1, 2) for _ in range(4))
    q.view(torch.int32)[1, 0, 5, 17] = -1  # NaN 0xFFFFFFFF and the canonical 0x7FFFFFFF: as integers
    do.view(torch.int32)[B - 1, nh - 1, int(lengths[B - 1]) - 1, 40] = 0x7FFFFFFF  # they round to +0.0, -0.0
    seg = (torch.arange(L, device=device)[None, :] < torch.as_tensor(lengths, device=device)[:, None]).to(torch.int32)
    args = (q, k, v, seg, seg, FLASH_SCALE)
    ro, rl, rm = fa.flash_forward_ref(*args)
    bargs = (*args, rl, rm, do, fa.flash_di(ro, do))
    want = fa.flash_backward_ref(*bargs)
    o, l, m = fa._launch_forward(*args)
    dk, dv = fa._launch_dkv(*bargs)
    got = (o, l, m, fa._launch_dq(*bargs), dk, dv)
    torch.cuda.synchronize()
    res = {}
    for what, a, b in zip(("o", "l", "m", "dq", "dk", "dv"), got, (ro, rl, rm, *want)):
        nan = torch.isnan(b)
        a0, b0 = a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)
        rel = fa.fp32_head_rel(a0, b0) if a.dim() == 4 else float(((a0 - b0).abs() / b0.abs().clamp_min(1.0)).max())
        res[what] = {"ref_nan": int(nan.sum()), "nan": int(torch.isnan(a).sum()),
                     "same_nan": bool(torch.equal(torch.isnan(a), nan)), "head_rel": rel, "size": b.numel()}
    log(f"[phase11a] {name} ({B}, {nh}, {L}, 64) fp32, a NaN in q and one in do, K11/K12/K13 route tf32: " + "; ".join(
        f"{w} {r['nan']} NaN (plain {r['ref_nan']}), same places {r['same_nan']}, the rest {r['head_rel']:.2e} of "
        f"its head vector (l, m: relative)" for w, r in res.items()))
    bad = [w for w, r in res.items() if not (r["same_nan"] and 0 < r["ref_nan"] < r["size"]
                                             and r["head_rel"] <= fa.FP32_HEAD_REL)]
    if bad:
        raise AssertionError(f"route tf32 with NaN inputs at {name}: {bad} disagree with the plain versions: {res}")
    return res


def phase_flash_fp32(device, workdir: Path, label, seed=SEED, shapes=None):
    """Phase 11a: flash at fp32 (K11, K12 and K13 on route "tf32", the rows
    kernel on its fp32 route) at the retriever's doc pass, the CE's pairs
    and the encode batch, with phase 8a's segment lengths; the NaN check at
    the CE's shape."""
    import numpy as np

    rng = np.random.default_rng([seed, 8])
    shapes = shapes or {"retriever": (68, 12), "ce": (20, 16), "encode": (384, 12)}
    lengths = {"retriever": synthetic_doc_lengths(shapes["retriever"][0], seed + 3, workdir),
               "ce": rng.integers(64, 385, size=shapes["ce"][0]),
               "encode": synthetic_doc_lengths(shapes["encode"][0], seed, workdir)}
    t0 = time.perf_counter()
    out = {name: flash_fp32_case(device, name, *shapes[name], lengths[name], seed + 11 + i, label)
           for i, name in enumerate(shapes)}
    if "ce" in shapes:
        out["ce"]["nan_check"] = flash_tf32_nan_check(device, "ce", *shapes["ce"], lengths["ce"], seed + 19)
    log(f"[phase11a] flash at fp32 checked and timed at {len(shapes)} shapes in {time.perf_counter() - t0:.1f} s")
    return out


def phase_flash_fp32_head_dims(device, workdir: Path, label, seed=SEED, cases=FLASH_CASES):
    """Phase 11a at the head dims but 64 (``cases``, as phase 8a's): route
    "tf32" at (68, nh, 384, hd), the retriever's segment lengths."""
    lengths = synthetic_doc_lengths(68, seed + 3, workdir)
    t0 = time.perf_counter()
    out = {hd: flash_fp32_case(device, f"hd{hd}", 68, nh, lengths, seed + 31 + hd, label, hd=hd)
           for hd, nh in cases}
    log(f"[phase11a] flash at fp32 at head dims {[hd for hd, _ in cases]} checked and timed in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def library_steps(device, train_ctx, steps=3, keep_grads=False, probe=None, **model_kw):
    """``steps`` steps of the library's trainer (``compute_grads``, then the
    optimizer) on phase 4's data and configuration with ``model_kw`` set on
    ``model``, counted and timed: losses, ms a step (the host clock, each step
    synchronised; the first left out of the mean), peak device memory,
    launches, with ``keep_grads`` step 1's gradients, and ``probe(model,
    batch)``'s value on the initial model and step 1's batch."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset
    from colbert_tpu_torch.training.dataset import RetrievalSampler

    cfg = ColbertConfig.from_dict(train_ctx["cfg"].to_dict())
    for key, val in model_kw.items():
        setattr(cfg.model, key, val)
    tok = cli._tokenizer(cfg)
    trainer = ColbertTrainer(cfg, tok, device=device)
    sampler = RetrievalSampler(RetrievalDataset.from_json(train_ctx["train_path"]), tok, cfg.train,
                               cfg.train.per_device_batch_size, is_eval=False)
    trainer._init_state(sampler.steps_per_epoch())
    batches = [b for _, b in zip(range(steps), sampler.epoch(0))]
    probed = None if probe is None else probe(trainer.model, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    losses, step_ms, grads = [], [], None
    for gstep, batch in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(float(trainer.compute_grads(batch, gstep)))
        if keep_grads and gstep == 0:
            grads = {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters() if p.grad is not None}
        trainer.optimizer.step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    del trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "ms_step": float(np.mean(step_ms[1:])), "peak_gb": peak_gb,
            "launches": launches, "grads": grads, "probed": probed}


def phase_flash_fp32_train(device, label, train_ctx, steps=3):
    """Phase 11b: ``steps`` train steps at phase 4's configuration (BERT-base,
    batch 34, 12 layers) with ``model.dtype="float32"`` and flash (K11, K12
    and K13 on route "tf32", the rows kernel on its fp32 route) against the
    explicit fp32 path, both dropping the attention output (the site flash
    takes), so the two draw the same masks: each loss within
    ``FP32_LOSS_REL`` of the explicit path's; K11, K12, K13 and the rows
    kernel 12 launches a step, all on those routes; ms a step and peak
    memory of each."""
    kw = dict(dtype="float32", attention_dropout_site="output")
    explicit = library_steps(device, train_ctx, steps, attention_impl="auto", **kw)
    flash = library_steps(device, train_ctx, steps, attention_impl="flash", **kw)
    layers = train_ctx["cfg"].model.num_layers
    rel = [abs(a - b) / abs(b) for a, b in zip(flash["losses"], explicit["losses"])]
    log(f"[phase11b] train at fp32, {steps} steps: flash losses {flash['losses']}, explicit {explicit['losses']} "
        f"(relative {max(rel):.2e}, limit {FP32_LOSS_REL}); flash {flash['ms_step']:.1f} ms/step, peak "
        f"{flash['peak_gb']:.2f} GB; explicit {explicit['ms_step']:.1f} ms/step, peak {explicit['peak_gb']:.2f} GB; "
        f"flash launches {{" + ", ".join(f"{k}: {v}" for k, v in flash["launches"].items()
                                         if k.startswith(("K11", "K12", "K13", "flash"))) + f"}} [{label}]")
    flash_launches_ok(flash["launches"], {"K11": layers * steps, "K12": layers * steps, "K13": layers * steps},
                      "phase 11b's fp32 flash steps", route="tf32")
    flash_launches_ok(explicit["launches"], {"K11": 0, "K12": 0, "K13": 0}, "phase 11b's explicit fp32 steps")
    import math
    if not all(math.isfinite(x) for x in flash["losses"] + explicit["losses"]) or max(rel) > FP32_LOSS_REL:
        raise AssertionError(f"fp32 flash losses {flash['losses']} against the explicit path's {explicit['losses']}")
    return {"flash": {k: flash[k] for k in ("losses", "ms_step", "step_ms", "peak_gb", "launches")},
            "explicit": {k: explicit[k] for k in ("losses", "ms_step", "step_ms", "peak_gb")}, "loss_rel": max(rel)}


def doc_forward_probe(model, batch):
    """One eval-mode doc forward of ``batch``'s docs: the aten ``mm``/``addmm``
    calls in it (one cuBLAS GEMM each) and the embeddings' output."""
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    dev = next(model.parameters()).device
    ids = torch.from_numpy(np.ascontiguousarray(batch.d_ids)).long().to(dev)
    attn = torch.from_numpy(np.ascontiguousarray(batch.d_attn)).to(dev)
    model.eval()
    with torch.no_grad():
        emb = model.bert.embeddings(ids, torch.zeros_like(ids), torch.bfloat16)
        with Count() as count:
            model.doc(ids, attn)
    return {"gemms": count.n, "embeddings": emb}


def phase_model_options(device, label, train_ctx, steps=3):
    """Phase 11c: ``model.fused_qkv`` and ``model.embedding_impl="onehot"`` at
    phase 4's configuration (bf16, 12 layers, batch 34), ``steps`` steps each
    beside the same steps without them (losses bit-equal to phase 4's).
    fused_qkv: each loss within ``OPTION_LOSS_REL`` of phase 4's, every step-1
    gradient within ``OPTION_GRAD_REL`` of it (|d| / |g| a tensor; the
    attention key biases aside: their exact gradient is zero, a softmax
    ignores a constant added to a row, so both are rounding noise), and 24
    fewer GEMMs in a doc forward of step 1's docs (2 a layer).  onehot: the
    embeddings' forward on those docs bit-equal to the lookup's, so step 1's
    loss and every gradient but the word table's bit-equal, the word table's
    within
    ``WORD_GRAD_REL`` in norm (on the card both are fp32 sums of the same
    bf16 terms, in two orders, each rounded once to bf16: 2^-9 of an entry
    a rounding; an entry whose sum cancels can be many of its own ulps off,
    so the largest, in ulps, is information).  ms a step and peak memory of
    each (information)."""
    import torch

    base_cfg = train_ctx["cfg"]
    run = functools.partial(library_steps, device, train_ctx, steps, keep_grads=True, probe=doc_forward_probe)
    base = run()
    if base["losses"] != train_ctx["losses"][:steps]:
        raise AssertionError(f"phase 11c's steps {base['losses']} differ from phase 4's {train_ctx['losses'][:steps]}")
    fused = run(fused_qkv=True)
    onehot = run(embedding_impl="onehot")
    gemms = {"unfused": base["probed"]["gemms"], "fused": fused["probed"]["gemms"]}
    emb_equal = bool(torch.equal(base["probed"]["embeddings"], onehot["probed"]["embeddings"]))
    for r in (base, fused, onehot):
        del r["probed"]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(torch.finfo(torch.float32).tiny))
    g0 = base["grads"]
    fused_rel = {k: rel(fused["grads"][k], g) for k, g in g0.items() if not k.endswith("attention.key.bias")}
    fused_loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fused["losses"], base["losses"]))
    word = "bert.embeddings.word_embeddings.weight"
    differ = sorted(k for k, g in g0.items() if k != word and not torch.equal(onehot["grads"][k], g))
    a, b = onehot["grads"][word], g0[word]
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(torch.float32).tiny))
    word_ulps = float(((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max())
    word_rel = rel(a, b)

    worst = max(fused_rel, key=fused_rel.get)
    log(f"[phase11c] fused_qkv, {steps} steps: losses {fused['losses']} against phase 4's {base['losses']} (relative "
        f"{fused_loss_rel:.2e}, limit {OPTION_LOSS_REL}); step 1's gradients |d| / |g| at most "
        f"{fused_rel[worst]:.2e} ({worst}; limit {OPTION_GRAD_REL}); GEMMs (aten mm/addmm) in a doc forward at "
        f"{base_cfg.model.num_layers} layers: {gemms['unfused']} unfused, {gemms['fused']} fused; "
        f"{fused['ms_step']:.1f} ms/step (without: {base['ms_step']:.1f}), peak {fused['peak_gb']:.2f} GB "
        f"(without: {base['peak_gb']:.2f}) [{label}]")
    log(f"[phase11c] embedding_impl onehot, {steps} steps: embeddings' forward bit-equal to the lookup's {emb_equal}; "
        f"losses {onehot['losses']} (step 1 bit-equal {onehot['losses'][0] == base['losses'][0]}); gradients other "
        f"than the word table's not bit-equal: {differ[:8]}; the word table's |d| / |g| {word_rel:.2e} (limit "
        f"{WORD_GRAD_REL:.2e}), at most {word_ulps:.2f} bf16 ulps of an entry; {onehot['ms_step']:.1f} ms/step "
        f"(without: {base['ms_step']:.1f}), peak {onehot['peak_gb']:.2f} GB (without: {base['peak_gb']:.2f}; "
        f"phase 4's run: {train_ctx['peak_gb']:.2f}) [{label}]")
    if fused_loss_rel > OPTION_LOSS_REL or fused_rel[worst] > OPTION_GRAD_REL or \
            gemms["unfused"] - gemms["fused"] != 2 * base_cfg.model.num_layers:
        raise AssertionError(f"fused_qkv: losses {fused['losses']} against {base['losses']}, gradients {fused_rel}, "
                             f"GEMMs {gemms}")
    if not emb_equal or onehot["losses"][0] != base["losses"][0] or differ or word_rel > WORD_GRAD_REL:
        raise AssertionError(f"onehot: embeddings equal {emb_equal}, losses {onehot['losses']} against "
                             f"{base['losses']}, gradients not bit-equal {differ}, word table {word_rel}")
    keep = ("losses", "ms_step", "step_ms", "peak_gb")
    return {"base": {k: base[k] for k in keep}, "fused_qkv": {k: fused[k] for k in keep} | {
                "loss_rel": fused_loss_rel, "grad_rel_max": fused_rel[worst], "grad_rel_worst": worst, "gemms": gemms},
            "onehot": {k: onehot[k] for k in keep} | {"embeddings_equal": emb_equal, "word_grad_rel": word_rel,
                                                       "word_grad_ulps": word_ulps}}


def phase_dense(device, workdir: Path, label, ctx, batch=256):
    """Phase 11d: ``DenseRetriever`` with phase 2's model and
    ``attention_impl="flash"`` (K11 once a layer a doc batch of 384 tokens;
    queries at 32 keep the explicit attention) over its 20,000 passages:
    ``build_index``, then phase 2's 3 x 144 questions at top-100.
    Each answer's ids equal those of an fp64 numpy oracle over the same
    pooled vectors, but at ties: the fp64 scores at a position within
    ``DPR_TIE`` plus twice the largest error of the returned fp32 scores
    against fp64's (an fp32 score orders two passages only as far as its
    own error; that error at most 1e-5); a
    passage's own pooled vector scores 1.0 within 1e-3, as the top score of
    its own search; ``save_index`` / ``load_index`` give the same answers.
    Docs/s to build, questions/s to search."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.ranking.dense import DenseRetriever

    from colbert_tpu_torch.config import ColbertConfig

    cfg = ColbertConfig.from_dict(ctx["cfg"].to_dict())
    cfg.model.attention_impl = "flash"
    model = cli._model(cfg, argparse.Namespace(checkpoint_step=None, pretrain=ctx["common"][3]))
    r = DenseRetriever(cfg, cli._tokenizer(cfg), model, device=device)
    docs, questions = ctx["docs"], ctx["questions"][: 3 * B]
    reset_counts()
    t0 = time.perf_counter()
    r.build_index(docs, batch=batch)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    flash_launches_ok(read_counts(), {"K11": cfg.model.num_layers * -(-len(docs) // batch), "K12": 0, "K13": 0},
                      "DPR's build_index")
    t0 = time.perf_counter()
    scores, ids = r.search(questions, topk=TOPK)
    search_s = time.perf_counter() - t0
    D = r.index.vectors.double().cpu().numpy()
    Qv = r._encode(questions, is_query=True).astype(np.float64)
    S = Qv @ D.T
    order = np.argsort(-S, axis=1, kind="stable")[:, :TOPK]
    want_s, got_s = np.take_along_axis(S, order, 1), np.take_along_axis(S, ids, 1)
    pos_err = float(np.abs(got_s - want_s).max())
    score_err = float(np.abs(scores - got_s).max())
    tie = DPR_TIE + 2 * score_err
    unique = all(len(set(row.tolist())) == TOPK for row in ids)
    id_diff = int((ids != order).sum())
    own_s, own_i = r.index.search(r.index.vectors[:100], 1)
    self_err = float(np.abs((D[:100] * D[:100]).sum(1) - 1.0).max())
    r.save_index(str(workdir / "dense_index"))
    r2 = DenseRetriever(cfg, cli._tokenizer(cfg), model, device=device)
    r2.load_index(str(workdir / "dense_index"))
    s2, i2 = r2.search(questions[:B], topk=TOPK)
    round_trip = bool(np.array_equal(i2, ids[:B]) and np.array_equal(s2, scores[:B]))
    log(f"[phase11d] DenseRetriever over {len(docs)} passages (phase 2's model, {cfg.model.dtype}, attention "
        f"{cfg.model.attention_impl}, K11 {cfg.model.num_layers * -(-len(docs) // batch)} launches): build "
        f"{build_s:.2f} s = {len(docs) / build_s:.1f} docs/s; {len(questions)} questions top-{TOPK} in "
        f"{search_s:.3f} s = {len(questions) / search_s:.1f} questions/s; against the fp64 "
        f"oracle: scores by position max|d| {pos_err:.2e} (ties within {tie:.2e}), {id_diff} ids at another position "
        f"(ties), returned scores vs fp64 max|d| {score_err:.2e}, ids unique {unique}; own vectors |1 - |d|^2| "
        f"{self_err:.2e}, their top score {float(own_s.min()):.6f}-{float(own_s.max()):.6f}; save/load same answers "
        f"{round_trip} [{label}]")
    if pos_err > tie or score_err > 1e-5 or not unique or self_err > 1e-3 or \
            float(np.abs(own_s - 1.0).max()) > 1e-3 or not round_trip:
        raise AssertionError(f"DPR: position scores {pos_err}, scores {score_err}, unique {unique}, self {self_err}, "
                             f"own top {own_s.ravel()[:8]}, round trip {round_trip}")
    return {"docs_s": len(docs) / build_s, "questions_s": len(questions) / search_s, "build_s": build_s,
            "search_s": search_s, "oracle_pos_err": pos_err, "score_err": score_err, "ids_at_ties": id_diff}


def phase_real_text(device, workdir: Path, label, max_modules=180, max_entries=1500, epochs=10, seed=SEED):
    """Phase 11e, real text: the docstring corpus of this machine's Python
    (``evaluation/pydocs.py``: the first ``max_modules`` importable standard
    library modules, at most ``max_entries`` entries; summaries as questions,
    bodies as passages, same-module hard negatives), a learned WordPiece
    vocab (``train_wordpiece``), a BERT-small retriever
    (``scripts/real_data_e2e.py``'s width: hidden 256, 4 layers, dim 128,
    doc_maxlen 224; bf16; multiview off, a vector a token) trained
    ``epochs`` epochs through the CLI, the corpus encoded, and dev MRR@10
    and recall@100 of ColBERT (flat mode over the ragged table,
    ``evaluate``) and of DPR (``DenseRetriever`` on the same weights).  The
    numbers name the machine (its Python's docstrings) and vary from process
    to process (``build_retrieval_dataset`` mines hard negatives in the
    order of sets of strings, which Python's hash seed sets); the check:
    finite, and MRR above chance."""
    import math

    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import (ColbertConfig, IndexConfig, ModelConfig, MultiviewConfig, ServeConfig,
                                          TokenizerConfig, TrainConfig)
    from colbert_tpu_torch.evaluation import eval_retrieval
    from colbert_tpu_torch.evaluation.pydocs import build_retrieval_dataset, collect_docstrings, train_dev_split
    from colbert_tpu_torch.ranking.dense import DenseRetriever
    from colbert_tpu_torch.tokenization.vocab import train_wordpiece, write_vocab
    from colbert_tpu_torch.training.checkpoint import CheckpointManager
    from colbert_tpu_torch.utils.io import dump_json, load_json, load_jsonl

    t0 = time.perf_counter()
    entries = collect_docstrings(max_modules=max_modules, max_entries=max_entries)
    collect_s = time.perf_counter() - t0
    texts, examples = build_retrieval_dataset(entries, num_negatives=8, seed=seed)
    train, dev = train_dev_split(examples, dev_frac=0.08, seed=seed)
    t0 = time.perf_counter()
    vocab = train_wordpiece(texts + [x["question"] for x in examples], vocab_size=8000, max_merges=3000)
    vocab_s = time.perf_counter() - t0
    paths = {name: workdir / f"{name}.json" for name in ("corpus", "train", "dev")}
    for name, data in (("corpus", texts), ("train", train), ("dev", dev)):
        dump_json(data, paths[name])
    cfg = ColbertConfig(
        model=ModelConfig(**REAL_TEXT_MODEL, dtype="bfloat16"),
        # a vector a token: it matches words from the first step, where the 8/8 views of
        # scripts/real_data_e2e.py (marker positions) need thousands of steps to carry any
        multiview=MultiviewConfig(enabled=False),
        tokenizer=TokenizerConfig(vocab_path=write_vocab(vocab, workdir / "vocab.txt"), query_maxlen=32,
                                  doc_maxlen=224),
        train=TrainConfig(learning_rate=5e-4, per_device_batch_size=32, num_epochs=epochs, evals_per_epoch=1,
                          score_temperature=0.05, warmup_ratio=0.05, checkpoint_dir=str(workdir / "ckpt"),
                          keep_checkpoints=1, log_every=50, seed=seed),
        index=IndexConfig(index_path=str(workdir / "index"), num_parts=1),
        serve=ServeConfig(mode="flat", topk=TOPK, query_batch_size=128),
    )
    conf = workdir / "conf.yaml"
    cfg.to_yaml(conf)
    common = ["--config", str(conf), "--device", str(device)]
    log(f"[phase11e] pydocs: {len(entries)} docstrings from {max_modules} modules in {collect_s:.2f} s; "
        f"{len(train)} train / {len(dev)} dev questions, {len(texts)} passages; WordPiece vocab {len(vocab)} "
        f"in {vocab_s:.2f} s")
    t0 = time.perf_counter()
    cli.main(["train", "--train-data", str(paths["train"]), *common])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = [row for row in load_jsonl(workdir / "ckpt" / "train_log.jsonl") if row["kind"] == "step"]
    cli.main(["encode", "--corpus", str(paths["corpus"]), *common])
    cli.main(["evaluate", "--eval-data", str(paths["dev"]), "--corpus", str(paths["corpus"]), "--topk", str(TOPK),
              "--out", str(workdir / "metrics.json"), *common])
    colbert = load_json(workdir / "metrics.json")
    dense = DenseRetriever(cfg, cli._tokenizer(cfg), cli._model(cfg, argparse.Namespace(checkpoint_step=None,
                                                                                       pretrain=None)),
                           device=device)
    dense.build_index(texts)
    s, i = dense.search([x["question"] for x in dev], topk=TOPK)
    dpr = eval_retrieval([{"res": [(int(p), float(v), texts[p]) for p, v in zip(i[j], s[j])],
                           "positive_ctxs": x["positive_ctxs"]} for j, x in enumerate(dev)], topk=10,
                         recall_topk=(50, TOPK))
    chance = sum(1.0 / (r * len(texts)) for r in range(1, 11))
    losses = [row["loss"] for row in steps]
    n_steps = CheckpointManager(cfg.train.checkpoint_dir).latest_step()
    log(f"[phase11e] BERT-small bf16 trained {n_steps} steps in {train_s:.1f} s (loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}); dev ({len(dev)} questions, {len(texts)} passages): ColBERT flat MRR@10 "
        f"{colbert['mrr@10']:.4f}, recall@100 {colbert['recall@100']:.4f}; DPR MRR@10 {dpr['mrr@10']:.4f}, "
        f"recall@100 {dpr['recall@100']:.4f}; chance MRR@10 {chance:.4f} (this machine's Python docstrings, "
        f"{sys.version.split()[0]}) [{label}]")
    vals = [colbert["mrr@10"], colbert["recall@100"], dpr["mrr@10"], dpr["recall@100"]]
    if not all(math.isfinite(x) for x in vals + losses) or min(colbert["mrr@10"], dpr["mrr@10"]) <= chance:
        raise AssertionError(f"real text: ColBERT {colbert}, DPR {dpr}, chance {chance}, losses {losses[-3:]}")
    return {"entries": len(entries), "train": len(train), "dev": len(dev), "vocab": len(vocab),
            "steps": n_steps, "train_s": train_s, "colbert": colbert, "dpr": dpr, "chance_mrr": chance,
            "python": sys.version.split()[0]}


# ---- phase 12: a MiniLM-L12-H384-width retriever on flash at head dim 32 ----

# microsoft/Multilingual-MiniLM-L12-H384's published config.json (the widths of
# sentence-transformers/paraphrase-multilingual-MiniLM-L12-v2, a multilingual
# retriever for Chinese among others): BertModel, post-LayerNorm, GELU;
# hidden 384, 12 layers, 12 heads (head dim 32), intermediate 1536, 512
# positions, type vocab 2, vocab 250,037, LayerNorm eps 1e-12.  The weights
# are a seeded init; the tokenizer is the repo's WordPiece, whose ids use the
# first rows of the vocab; the ColBERT projection keeps the hidden width.
MINILM_MODEL = dict(vocab_size=250037, hidden_size=384, num_layers=12, num_heads=12, intermediate_size=1536,
                    max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12, dim=384)


MINILM_LR = 1e-4  # phase 12's learning rate: at the default 3e-5, 5 steps moved its loss by less than the batches' spread


# ---- phase 15: a TinyBERT-4L-zh-width retriever on flash at head dim 26 ----

# huawei-noah/TinyBERT_4L_zh's published config.json: BertModel, hidden 312,
# 4 layers, 12 heads (head dim 26: not a multiple of 8, a head's bf16 row 52
# bytes, so the flash kernels copy its rows themselves), intermediate 1200,
# 512 positions, type vocab 2, vocab 21,128 (configs/dureader.yaml's
# chinese-bert-wwm-ext vocab).  Weights a seeded init, as phase 12's; the
# ColBERT projection keeps the hidden width, as the repo's operating point
# does (configs/dureader.yaml: dim = hidden_size): dim 312, not a multiple of
# 16 (a bf16 row of 624 bytes, an int8 row of 312).
TINYBERT_MODEL = dict(vocab_size=21128, hidden_size=312, num_layers=4, num_heads=12, intermediate_size=1200,
                      max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12, dim=312)
TINYBERT_LR = 1e-4  # phase 15's learning rate, phase 12's
# phase 15's index section: the default codec, pq, needs its 64 sub-quantizers
# to divide the dim, which 312 does not (both packages refuse it); phase 15's
# ANN service runs the sq codec
TINYBERT_INDEX = dict(codec="sq")


def phase_minilm(device, workdir: Path, label, steps=9):
    """Phase 12: :func:`phase_retriever` at the MiniLM-L12-H384 widths (head dim 32)."""
    return phase_retriever(device, workdir, label, MINILM_MODEL, MINILM_LR, "phase12", "MiniLM-L12-H384",
                           steps=steps)


def phase_tinybert(device, workdir: Path, label, steps=9):
    """Phase 15: :func:`phase_retriever` at the TinyBERT-4L-zh widths (head
    dim 26, ColBERT dim 312), with its int8 flat pass, unfused flat pass and
    sq ANN service."""
    return phase_retriever(device, workdir, label, TINYBERT_MODEL, TINYBERT_LR, "phase15", "TinyBERT-4L-zh",
                           steps=steps, more=True, index_kw=TINYBERT_INDEX)


def retriever_flat_variants(device, corpus, tag):
    """Phase 15's flat passes beside its served ones, each over the served
    corpus and model in process: one request (144 questions) over an int8
    table (K1 on route "wgmma", the table copied by the producers: a
    312-byte row) and one through the unfused route (K2 on route "wgmma"),
    each answer checked as phase 2's against the plain version over the same
    table.  Returns the launches and the largest differences."""
    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.ranking.searcher import ColbertSearcher
    from colbert_tpu_torch.serving.server import RetrievalService

    cfg, docs, qs = corpus["cfg"], corpus["docs"], corpus["requests"][0]
    cfg8 = ColbertConfig.from_dict(cfg.to_dict())
    cfg8.serve.rerank_dtype = "int8"
    s8 = ColbertSearcher(cfg8, cli._tokenizer(cfg8), corpus["model"], IndexStorage(cfg.index.index_path),
                         device=device)
    k2_searcher = unfused_searcher(device, cfg, corpus["model"])
    out = {}
    for name, searcher, kernel in (("int8", s8, "K1"), ("unfused", k2_searcher, "K2")):
        service = RetrievalService(searcher, docs, searcher.cfg)
        reset_counts()
        ans = service.retrieve(qs, topk=TOPK)
        launched = read_counts()
        want = {"K1": int(kernel == "K1"), "K2": int(kernel == "K2"), "K1/K2 wgmma route": 1, "K1/K2 staged route": 0}
        if any(launched[k] != v for k, v in want.items()):
            raise AssertionError(f"{tag}'s {name} flat pass: launches {launched}, expected {want}")
        worst, _ = check_flat_answers([qs], [[ans]], searcher, docs)
        if worst > SCORE_ATOL:
            raise AssertionError(f"{tag}'s {name} flat pass: scores off by {worst}")
        out[name] = {"launches": launched[kernel], "max_abs_err": worst, "table": str(searcher.emb_table.dtype)}
    return out


def retriever_ann(device, workdir: Path, corpus, flat_searcher, tag, label):
    """Phase 15's ANN service over its own corpus: ``build-index`` with the
    sq codec at phase 5's operating point (sq_dim 64), ``serve`` with
    ``serve.mode=ann`` and the bf16 rerank table over the socket, the
    corpus's requests (144 questions each, top-100): every answer 100 valid,
    descending triples whose scores equal the exact MaxSim of the returned
    pids over the served table within 1e-4; K6 and K7 once a request on
    route "mma", K4 once a request on route "wgmma" (at the corpus's dim, by
    the producers' copies where it is not whole 64-dim chunks).  Then K4
    alone on request 0's candidates (the serving batch, 144 x 4,096) against
    its plain version, timed as phase 5a times it, beside its bound."""
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.ops import rerank as rr
    from colbert_tpu_torch.ranking.searcher import ColbertSearcher
    from colbert_tpu_torch.serving.server import RetrievalClient

    cfg, docs, requests = corpus["cfg"], corpus["docs"], corpus["requests"]
    acfg = ann_config(cfg, cfg.index.index_path, free_port())
    conf = workdir / "conf_ann.yaml"
    acfg.to_yaml(conf)
    args = ["--config", str(conf), *corpus["common"][2:]]
    t0 = time.perf_counter()
    cli.main(["build-index", *args])
    build_s = time.perf_counter() - t0
    serve_err = []

    def serve():
        try:
            cli.main(["serve", "--corpus", str(corpus["corpus_path"]), *args])
        except BaseException as e:  # noqa: BLE001 -- reported by the main thread
            serve_err.append(e)
    server = threading.Thread(target=serve, daemon=True, name=f"serve-ann-{tag}")
    server.start()
    wait_for_server(acfg, serve_err)
    client = RetrievalClient(acfg.serve.host, acfg.serve.port, acfg.serve.authkey.encode())
    client.retrieve(requests[0][:1], topk=TOPK)  # warm-up, not counted
    reset_counts()
    answers, lat = [], []
    for qs in requests:
        t0 = time.perf_counter()
        answers.append(client.retrieve(qs, topk=TOPK))
        lat.append(time.perf_counter() - t0)
    launches = read_counts()
    client.shutdown()
    server.join(timeout=60)
    if server.is_alive() or serve_err:
        raise RuntimeError(f"{tag}'s ann server did not stop cleanly: {serve_err}")
    n = len(requests)
    want = {"K4": n, "K5": 0, "K6": n, "K7": n, "K1": 0, "K4/K5 wgmma route": n, "K4/K5 staged route": 0,
            "K4/K5 wgmma_rows route": 0, "K6 mma route": n, "K6 staged route": 0, "K7 mma route": n,
            "K7 staged route": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{tag}'s ANN launches {launches} do not match the served batches {want}")
    serialized_on_cpp(tag, launches, n)
    worst = max(check_answers(f"{tag} ANN bf16", qs, ans, flat_searcher, docs, device)
                for qs, ans in zip(requests, answers))
    if worst > SCORE_ATOL:
        raise AssertionError(f"{tag}'s served ANN scores differ from exact MaxSim by {worst}")

    # K4 alone on request 0's candidates: the serving batch at this dim
    searcher = ColbertSearcher(acfg, cli._tokenizer(acfg), corpus["model"], IndexStorage(acfg.index.index_path),
                               device=device)
    enc = searcher.tok.encode_queries(requests[0])
    Qm = searcher.encode_queries(enc.input_ids, enc.attention_mask, enc.active_mask)
    qm = torch.as_tensor(enc.active_mask).to(device, torch.float32)
    cand = searcher.candidates(Qm, qm)
    table, dim = searcher.emb_table, searcher.dim
    route = rr.rerank_plan(16, Qm.shape[1], dim)
    before = rr.route_launches[route].value
    got, ref = rr.maxsim_rerank_uniform(cand, Qm, table, dv=16), rr.maxsim_rerank_uniform_ref(cand, Qm, table, dv=16)
    torch.cuda.synchronize()
    live = cand >= 0
    if route != "wgmma" or rr.route_launches[route].value != before + 1:
        raise AssertionError(f"{tag}: K4 at dim {dim} not one launch on route wgmma ({route})")
    if not torch.equal(torch.isfinite(got), live) or not torch.isneginf(got[~live]).all():
        raise AssertionError(f"{tag}: K4 at dim {dim}: -inf pattern differs from the -1 candidates")
    err = float((got[live] - ref[live]).abs().max())
    if not err <= SCORE_ATOL:
        raise AssertionError(f"{tag}: K4 at dim {dim} differs from its plain version by {err}")
    nv, n_unique = int(live.sum()), int(torch.unique(cand[live]).numel())
    doc_bytes = 16 * dim * 2
    k4 = {"dim": dim, "candidates": list(cand.shape), "valid": nv, "distinct_docs": n_unique, "max_abs_err": err,
          "ms": time_ms(lambda: rr.maxsim_rerank_uniform(cand, Qm, table, dv=16)),
          "plain_ms": time_ms(lambda: rr.maxsim_rerank_uniform_ref(cand, Qm, table, dv=16), iters=2, warmup=1),
          "table_by": "copies" if dim % 64 else "tensor map"}
    k4["bound_ms"], k4["bound_by"] = bound(2.0 * nv * 16 * dim * Qm.shape[1],
                                           n_unique * doc_bytes + 2 * cand.numel() * 4 + Qm.numel() * 4,
                                           PEAK_BF16_FLOPS)
    out = {"build_s": build_s, "request_ms": [1e3 * x for x in lat], "max_abs_err": worst,
           "launches": {k: launches[k] for k in ("K4", "K6", "K7", "K4/K5 wgmma route")}, "k4": k4}
    log(f"[{tag}] ANN (sq, sq_dim {SQ_DIM}, bf16 rerank table at dim {dim}): build-index {build_s:.1f} s; {n} "
        f"requests of {B} questions top-{TOPK} in {[round(1e3 * x, 1) for x in lat]} ms over the socket, scores vs "
        f"the exact MaxSim of the returned pids max|d| {worst:.3e} (limit {SCORE_ATOL}); launches K4 {launches['K4']} "
        f"(route wgmma), K6 {launches['K6']}, K7 {launches['K7']}; K4 alone on request 0's {B} x {cand.shape[1]} "
        f"candidates ({nv} valid, {n_unique} distinct docs): max|d| {err:.3e}, {k4['ms']:.3f} ms, plain "
        f"{k4['plain_ms']:.3f} ms, bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}), the table by "
        f"{k4['table_by']} [{label}]")
    return out


def phase_retriever(device, workdir: Path, label, model, lr, tag, what, steps=9, num_docs=20_000, more=False,
                    index_kw=None):
    """A retriever at a published model's widths (``model``, bf16,
    ``attention_impl="flash"``) through the entry points: the CLI's
    ``train`` at batch 34 (phase 4's data, learning rate ``lr``;
    ``steps`` steps, evaluations, checkpoints and the resume, as phase 8b),
    the loss finite and falling (the last three steps' mean under the first
    three's, and the last step's under the first's);
    ``encode`` of phase 2's corpus (``num_docs`` passages); ``serve`` (flat) answering
    phase 2's requests, checked as phase 2 checks them, every K1 launch on
    route "wgmma".  Every K11, K12 and K13 launch is on route "wgmma" at the
    model's head dim (and its template).  ``more``: also
    :func:`retriever_flat_variants` and :func:`retriever_ann`.  Logs
    ms/step, docs/s and peak device memory under ``tag``."""
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.ranking.searcher import ColbertSearcher
    from colbert_tpu_torch.serving.server import RetrievalClient

    t_all = time.perf_counter()
    flash = {**model, "attention_impl": "flash"}
    hd = flash["hidden_size"] // flash["num_heads"]
    (workdir / "train").mkdir(parents=True)
    (workdir / "serve").mkdir()
    launches, train = phase_train(device, workdir / "train", label, model_kw=model, steps=steps,
                                  attention_impl="flash", tag=tag, train_kw={"learning_rate": lr}, index_kw=index_kw)
    layers, n_dev, batch = flash["num_layers"], 40, 34
    evals = len([s for s in range(1, steps + 1) if s % (steps // 2) == 0])
    flash_launches_ok(launches, {"K11": layers * (steps + evals * -(-n_dev // batch)), "K12": layers * steps,
                                 "K13": layers * steps}, f"{tag}'s train", head_dim=hd)
    losses = train["losses"]
    if not (sum(losses[-3:]) < sum(losses[:3]) and losses[-1] < losses[0]):
        raise AssertionError(f"{tag}'s train loss did not fall: {losses}")

    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    corpus = encoded_corpus(device, workdir / "serve", label, num_docs=num_docs, model_kw=flash, tag=tag,
                            index_kw=index_kw)
    torch.cuda.synchronize()
    encoded = read_counts()
    enc_peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    cfg, docs, n = corpus["cfg"], corpus["docs"], len(corpus["docs"])
    parts, per = cfg.index.num_parts, cfg.index.encode_batch_size
    batches = sum(-(-((p + 1) * n // parts - p * n // parts) // per) for p in range(parts))
    flash_launches_ok(encoded, {"K11": layers * batches, "K12": 0, "K13": 0}, f"{tag}'s encode", head_dim=hd)
    docs_s = n / corpus["enc_s"]

    serve_err = []

    def serve():
        try:
            cli.main(["serve", "--corpus", str(corpus["corpus_path"]), *corpus["common"]])
        except BaseException as e:  # noqa: BLE001 -- reported by the main thread
            serve_err.append(e)
    server = threading.Thread(target=serve, daemon=True, name=f"serve-{tag}")
    server.start()
    wait_for_server(cfg, serve_err)
    client = RetrievalClient(cfg.serve.host, cfg.serve.port, cfg.serve.authkey.encode())
    reset_counts()
    answers, lat = [], []
    for qs in corpus["requests"]:
        t0 = time.perf_counter()
        answers.append(client.retrieve(qs, topk=TOPK))
        lat.append(time.perf_counter() - t0)
    served = read_counts()
    client.shutdown()
    server.join(timeout=60)
    if server.is_alive() or serve_err:
        raise RuntimeError(f"server did not stop cleanly: {serve_err}")
    searcher = ColbertSearcher(cfg, cli._tokenizer(cfg), corpus["model"], IndexStorage(cfg.index.index_path),
                               device=device)
    worst, recall = check_flat_answers(corpus["requests"], [[a] for a in answers], searcher, docs)
    if worst > SCORE_ATOL or served["K1"] != len(corpus["requests"]) or \
            served["K1/K2 wgmma route"] != served["K1"] or served["K1/K2 staged route"]:
        raise AssertionError(f"{tag}'s serve: scores off by {worst}, launches {served}")
    out = {"model": dict(model), "head_dim": hd, "train": {
               "ms_step": train["ms_step"], "losses": losses, "peak_gb": train["peak_gb"],
               "launches": {k: n for k, n in launches.items()
                            if k in ("K11", "K12", "K13", "K9", "K3", "flash rows") or " hd" in k
                            or " template" in k}},
           "encode": {"docs_s": docs_s, "docs": n, "peak_gb": enc_peak_gb,
                      "launches": {k: encoded[k] for k in ("K11", "K12", "K13")}},
           "serve": {"request_ms": [1e3 * x for x in lat], "max_abs_err": worst, "recall": recall,
                     "launches": served["K1"], "dim": model["dim"]}}
    if more:
        out["flat_variants"] = retriever_flat_variants(device, corpus, tag)
        out["ann"] = retriever_ann(device, workdir / "serve", corpus, searcher, tag, label)
    out["s"] = time.perf_counter() - t_all
    log(f"[{tag}] {what} width (hidden {model['hidden_size']}, {layers} layers, {model['num_heads']} heads of "
        f"{hd}), bf16, flash: train "
        f"{train['ms_step']:.1f} ms/step at batch 34, losses {[round(x, 4) for x in losses]}, peak "
        f"{train['peak_gb']:.2f} GB; encode {n} docs at {docs_s:.1f} docs/s, peak {enc_peak_gb:.2f} GB; serve "
        f"{len(lat)} requests of {B} questions top-{TOPK} in {[round(1e3 * x, 1) for x in lat]} ms, scores vs the "
        f"plain version max|d| {worst:.3e} (limit {SCORE_ATOL}), pid recall {recall:.4f} (information); launches "
        f"train {out['train']['launches']}, encode {out['encode']['launches']}, serve K1 {served['K1']} (route "
        f"wgmma, ColBERT dim {model['dim']})"
        + (f"; flat int8 / unfused passes {out['flat_variants']}" if more else "") + f"; {out['s']:.1f} s [{label}]")
    return out


# ---- phase 13: tensor parallelism (mesh.model = 2) ----

TP_MODEL = 2          # positions of phase 13's model group
TP_DOCS = 4_000       # 13c's corpus
TP_TOPK = 10          # 13c's answers compared
TP_LOSS_REL = OPTION_LOSS_REL  # 13b/13d: a bf16 loss at model 2 against model 1, relative to its size
TP_FP32_TOL = 1e-5    # 13b in fp32, model 2 against model 1 (the CPU test's TOL_TP): losses relative to their size,
                      # each step-1 gradient element within this of the largest, parameters absolute
TP_REP_ERR = 2**-4    # 13c: a unit rep (query or doc view) at model 2 within this of model 1's, in norm: a head
                      # or a mask out of place moves one by O(1); bf16 sums taken in another order moved them by
                      # up to 1.41e-2 at BERT-base depth (NVIDIA H100 80GB HBM3, 700.00 W)
TP_LAUNCH_TOL = TP_FP32_TOL  # phase 13's launch at data x model (four cards), fp32: losses relative, parameters absolute


def tp_group(device, model=TP_MODEL):
    """Phase 13's model group: the first ``model`` cards, or ``device``
    listed ``model`` times where there are fewer (one card holds both
    positions)."""
    import torch

    if device.type == "cuda" and torch.cuda.device_count() >= model:
        return [torch.device("cuda", i) for i in range(model)]
    return [device] * model


def counts_ok(launches, want, what):
    """The counters named in ``want`` at those values."""
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def phase_tp_k9(device, label, m=TP_MODEL, seed=SEED, row0=34, shape=K9_SHAPE, hidden=768):
    """Phase 13a: K9 on a tensor-parallel position's slice (route "packed",
    strided counters): the retriever's probabilities at position p of m, (68,
    12 / m, 384, 384) of (68, 12, 384, 384), and the flash output's columns,
    (68, 384, 768 / m) of (68, 384, 768), bf16, for p = 0 .. m - 1, also from
    a data-parallel rank's ``row0``: forward and backward bit-equal to the
    plain version (``hw_dropout_ref`` with the same slice).  Each slice is
    timed on the card alone, cold (``in_turn`` over copies past twice the
    L2), in turns with the contiguous launch of the same bytes; beside the
    bound (the bytes read and written at the HBM rate), the plain version and
    ``F.dropout`` of the same tensor."""
    import math

    import torch
    import torch.nn.functional as F

    from colbert_tpu_torch.ops import dropout as dr

    B, nh, L = shape[:3]
    h = hidden
    gen = torch.Generator(device=device).manual_seed(seed)
    seed64 = int(torch.randint(0, 1 << 62, (1,), generator=torch.Generator().manual_seed(seed + 13)))
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    out = {}
    for kind, full, dim in (("probabilities", (B, nh, L, L), 1), ("columns", (B, L, h), 2)):
        part = list(full)
        part[dim] //= m
        inner, per_row = math.prod(part[dim:]), math.prod(full[1:])
        slices = []
        before = dr.slice_launches.value
        for p in range(m):
            for r0 in (0, row0):
                args = ((r0 * per_row + p * inner) // 16, inner // 16, m * inner // 16)
                x = torch.randn(part, device=device, dtype=torch.bfloat16, generator=gen)
                xg = x.detach().requires_grad_(True)
                y = dr.hw_dropout(xg, seed64, K9_THR, *args)
                g = torch.randn(part, device=device, dtype=torch.bfloat16, generator=gen)
                (dx,) = torch.autograd.grad(y, xg, g)
                for what, got, want in (("forward", y, dr.hw_dropout_ref(x, seed64, K9_THR, *args)),
                                        ("backward", dx, dr.hw_dropout_ref(g, seed64, K9_THR, *args))):
                    if not dr.same_bits(got, want):
                        raise AssertionError(f"K9 on a {kind} slice {part} (position {p}, row0 {r0}), {what}: "
                                             f"{int((got.view(-1) != want.view(-1)).sum())} elements differ from "
                                             "the plain version")
                slices.append({"p": p, "row0": r0, "base": args[0]})
        counts_ok({"K9 slice": dr.slice_launches.value - before}, {"K9 slice": 4 * m}, f"K9 on {kind} slices")
        args = (p * inner // 16, inner // 16, m * inner // 16)  # the last position's slice, from row 0
        xs = [x] + [x.clone() for _ in range(-(-2 * l2 // (x.numel() * x.element_size())))]
        calls = {"strided": lambda t, i: dr.hw_dropout(t, seed64, K9_THR, *args),
                 "contiguous": lambda t, i: dr.hw_dropout(t, seed64, K9_THR, args[0])}
        turns = [(r, device_ms(in_turn(calls[r], xs))) for r in ("strided", "contiguous", "contiguous", "strided")]
        nbytes = 2.0 * x.numel() * x.element_size()
        res = {"full_shape": list(full), "shape": part, "slices": slices, "max_abs_err": 0.0,
               "ms": sum(t for r, t in turns if r == "strided") / 2,
               "contiguous_ms": sum(t for r, t in turns if r == "contiguous") / 2,
               "library_ms": device_ms(in_turn(lambda t, i: F.dropout(t, K9_THR / 256, True), xs)),
               "plain_ms": time_ms(lambda: dr.hw_dropout_ref(x, seed64, K9_THR, *args), iters=3, warmup=1),
               "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes", "cold_buffers": len(xs)}
        out[kind] = res
        log(f"[phase13a] K9 on a position's {kind} slice {tuple(part)} of {full} bf16 (route packed, strided "
            f"counters, {m} positions x row0 0 and {row0}): forward and backward bit-equal to the plain version; "
            f"on the card alone, cold over {len(xs)} copies: strided {res['ms']:.4f} ms, the contiguous launch of "
            f"the same bytes {res['contiguous_ms']:.4f} ms, F.dropout {res['library_ms']:.4f} ms; bound "
            f"{res['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB at {PEAK_HBM_BYTES / 1e12:.2f} TB/s); plain "
            f"{res['plain_ms']:.2f} ms [{label}]")
        del xs, x, xg, y, g, dx
    torch.cuda.empty_cache()
    return out


def _tp_mask_log(masks, m):
    """A stand-in for ``models.bert.hw_dropout`` that records each forward
    call's keep mask, drawn by the kernel itself (the same call on ones),
    and calls the kernel."""
    import torch

    from colbert_tpu_torch.ops import dropout as dr

    def logged(x, seed, thr, base=0, inner=0, stride=0):
        with torch.no_grad():
            masks.append((dr.hw_dropout(torch.ones_like(x), seed, thr, base, inner, stride) != 0, inner))
        return dr.hw_dropout(x, seed, thr, base, inner, stride)
    return logged


def _tp_whole_masks(masks, m):
    """The recorded masks with each site's m position slices put together
    along the split dim (1 of the probabilities, 2 of the attention output)."""
    import torch

    out, i = [], 0
    while i < len(masks):
        keep, inner = masks[i]
        if not inner:
            out.append(keep)
            i += 1
            continue
        out.append(torch.cat([k.to(keep.device) for k, _ in masks[i : i + m]], dim=1 if keep.dim() == 4 else 2))
        i += m
    return out


def _tp_compare(full, sharded, model_cfg):
    """``{full name: (max |d|, |d| / |full|)}`` between a model-1 tensor dict
    and a model-m one (shards named ``name.p``) on the shards' devices."""
    import torch

    from colbert_tpu_torch.models.convert import flax_paths
    from colbert_tpu_torch.models.sharding import full_name, split_dim

    paths = flax_paths(model_cfg)
    acc = {}
    for name, t in sharded.items():
        f = full_name(name, paths)
        want = full[f]
        if f != name:
            dim, p = split_dim(paths[f], want.dim()), int(name[len(f) + 1 :])
            want = want.narrow(dim, p * t.shape[dim], t.shape[dim])
        d = (t.float() - want.to(t.device).float())
        mx, sq, ref = acc.get(f, (0.0, 0.0, 0.0))
        acc[f] = (max(mx, float(d.abs().max())), sq + float(d.square().sum()), ref + float(want.float().square().sum()))
    rel = lambda sq, ref: (sq / ref) ** 0.5 if ref else (0.0 if not sq else float("inf"))
    return {f: (mx, rel(sq, ref)) for f, (mx, sq, ref) in acc.items()}


def tp_steps(device, cfg, train_path, group, steps, record=False):
    """``steps`` steps of the library's trainer at phase 4's data on the
    model group ``group`` (``mesh.model = len(group)``), counted and timed:
    losses, ms a step, launches, step 1's gradients and the parameters after
    the last step (by parameter, on their devices), and with ``record`` every
    forward dropout call's keep mask (``_tp_whole_masks``)."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.models import bert
    from colbert_tpu_torch.parallel.mesh import Mesh
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset
    from colbert_tpu_torch.training.dataset import RetrievalSampler

    m = len(group)
    c = ColbertConfig.from_dict(cfg.to_dict())
    c.mesh.model = m
    tok = cli._tokenizer(c)
    trainer = ColbertTrainer(c, tok, device=group[0], mesh=Mesh.of(group, m))
    sampler = RetrievalSampler(RetrievalDataset.from_json(train_path), tok, c.train, c.train.per_device_batch_size,
                               is_eval=False)
    trainer._init_state(sampler.steps_per_epoch())
    batches = [b for _, b in zip(range(steps), sampler.epoch(0))]
    masks, original = [], bert.hw_dropout
    if record:
        bert.hw_dropout = _tp_mask_log(masks, m)
    try:
        torch.cuda.synchronize()
        reset_counts()
        losses, step_ms, grads = [], [], None
        for gstep, batch in enumerate(batches):
            t0 = time.perf_counter()
            losses.append(float(trainer.compute_grads(batch, gstep)))
            if gstep == 0:
                grads = {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}
            trainer.optimizer.step()
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        launches = read_counts()
    finally:
        bert.hw_dropout = original
    params = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    del trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "ms_step": float(np.mean(step_ms[1:])), "launches": launches,
            "grads": grads, "params": params, "masks": _tp_whole_masks(masks, m) if record else None}


def tp_fp32_compare(device, cfg, train_path, group, steps):
    """13b's check of the model-axis backward (the broadcasts' and reduces'
    backward, the gradients on each position's device, the clip over
    devices): ``steps`` steps at ``mesh.model = 1`` and at ``len(group)``
    from the same init, in fp32 with Adam's eps at 1e-6 (phase 10c's
    conditions for several ranks: at the default 1e-8 Adam scales the
    rounding noise of the key biases' gradient, which is zero but for
    rounding, up to ~lr an element a step).  The sums differ only in order,
    so the limits are the CPU test's: each loss within ``TP_FP32_TOL`` of
    its size, each step-1 gradient element within ``TP_FP32_TOL`` of the
    largest, each parameter after the last step within ``TP_FP32_TOL``.
    Returns the readings and ``ok``; beside them each tensor's |d| / |g|
    (the key biases apart), as information."""
    import math

    from colbert_tpu_torch.config import ColbertConfig

    c = ColbertConfig.from_dict(cfg.to_dict())
    c.model.dtype, c.train.adam_eps = "float32", 1e-6
    one = tp_steps(device, c, train_path, [device], steps)
    two = tp_steps(device, c, train_path, group, steps)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(two["losses"], one["losses"]))
    grads = _tp_compare(one["grads"], two["grads"], c.model)
    largest = max(float(g.abs().max()) for g in one["grads"].values())
    grad_diff = max(grads.items(), key=lambda kv: kv[1][0])
    grad_rel = max(((rel, f) for f, (_, rel) in grads.items() if not f.endswith("attention.key.bias")))
    params = _tp_compare(one["params"], two["params"], c.model)
    param_diff = max(params.items(), key=lambda kv: kv[1][0])
    out = {"losses": two["losses"], "model1_losses": one["losses"], "loss_rel": loss_rel,
           "grad_max_diff": grad_diff[1][0], "grad_max_at": grad_diff[0], "grad_largest": largest,
           "grad_ratio": grad_diff[1][0] / largest, "grad_rel": grad_rel[0], "grad_rel_at": grad_rel[1],
           "param_max_diff": param_diff[1][0], "param_max_at": param_diff[0],
           "ms_step": two["ms_step"], "model1_ms_step": one["ms_step"]}
    out["ok"] = (all(math.isfinite(x) for x in two["losses"] + one["losses"]) and loss_rel <= TP_FP32_TOL
                 and out["grad_ratio"] <= TP_FP32_TOL and out["param_max_diff"] <= TP_FP32_TOL)
    return out


def phase_tp_train(device, workdir: Path, label, model_kw=None, batch=34, steps=3, repeats=3):
    """Phase 13b: ``steps`` train steps at phase 4's configuration (BERT-base,
    batch 34, bf16, ``attention_impl="flash"``, dropout "byte" on) at
    ``mesh.model = 2`` (``tp_group``) against ``mesh.model = 1`` from the same
    init and generators: every dropout site's mask bit-equal (drawn by the
    kernel; a position's slices put together), each loss within
    ``TP_LOSS_REL`` of model 1's; model 2's ``repeats`` runs bit-equal
    (losses, step-1 gradients, parameters); K11, K12 and K13 once a layer a
    position a step (the doc pass at 12 / 2 heads), all on route "wgmma";
    K9's strided launches counted.  ms a step at each model from runs that
    do not record masks (model 1 in a run of its own).  The backward is held
    in fp32 (``tp_fp32_compare``), where the sums differ in order only: in
    bf16 the two models' activations round apart from the first layer on,
    so their gradients and Adam's steps are shown, not held."""
    import math

    cfg, train_path, _ = train_setup(workdir, model_kw=model_kw, batch=batch, steps=steps, n_dev=4,
                                     attention_impl="flash")
    group = tp_group(device)
    m, layers = len(group), cfg.model.num_layers
    one = tp_steps(device, cfg, train_path, [device], steps, record=True)
    one_ms = tp_steps(device, cfg, train_path, [device], steps)["ms_step"]
    runs = [tp_steps(device, cfg, train_path, group, steps, record=r == 0) for r in range(repeats)]
    two = runs[0]
    if len(one["masks"]) != len(two["masks"]) or not all(
            a.shape == b.shape and bool((a == b.to(a.device)).all()) for a, b in zip(one["masks"], two["masks"])):
        bad = [i for i, (a, b) in enumerate(zip(one["masks"], two["masks"]))
               if a.shape != b.shape or not bool((a == b.to(a.device)).all())]
        raise AssertionError(f"model {m} dropout masks differ from model 1's: {len(two['masks'])} vs "
                             f"{len(one['masks'])} sites, differing {bad[:10]}")
    n_masks = len(one["masks"])
    del one["masks"], two["masks"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(two["losses"], one["losses"]))
    bf16_grad_rel = max(rel for f, (_, rel) in _tp_compare(one["grads"], two["grads"], cfg.model).items()
                        if not f.endswith("attention.key.bias"))
    bf16_param_diff = max(mx for mx, _ in _tp_compare(one["params"], two["params"], cfg.model).values())
    repeat_equal = all(r["losses"] == two["losses"] and all(
        torch_equal(r[k][n], two[k][n]) for k in ("grads", "params") for n in two[k]) for r in runs[1:])
    counted = runs[1]["launches"] if repeats > 1 else two["launches"]
    one_losses = one["losses"]
    ms_step = sum(r["ms_step"] for r in runs[1:]) / (repeats - 1) if repeats > 1 else two["ms_step"]
    del one, runs
    fp32 = tp_fp32_compare(device, cfg, train_path, group, steps)
    # what a reduce moves: each other position's (rows, L, H) bf16 partial product, to the first position;
    # two a layer (attention out, MLP output) a pass, and the broadcasts' backward as many the other way
    group_n = cfg.train.train_num_positives + cfg.train.train_num_negatives
    elem = 2 if cfg.model.dtype != "float32" else 4
    reduce_mb = {"doc": batch * group_n * cfg.tokenizer.doc_maxlen * cfg.model.hidden_size * elem * (m - 1) / 1e6,
                 "query": batch * cfg.tokenizer.query_maxlen * cfg.model.hidden_size * elem * (m - 1) / 1e6}
    reduce_mb["step_forward"] = 2 * layers * (reduce_mb["doc"] + reduce_mb["query"])
    lr = cfg.train.learning_rate
    log(f"[phase13b] train at mesh.model={m} on {[str(d) for d in group]}, {steps} steps at phase 4's configuration "
        f"with flash, dropout on: {n_masks} dropout masks bit-equal to model 1's; losses {two['losses']} vs model "
        f"1's {one_losses} (relative {loss_rel:.2e}, "
        f"limit {TP_LOSS_REL}); bf16, shown: step-1 gradients |d|/|g| at most {bf16_grad_rel:.2e}, parameters "
        f"max|d| {bf16_param_diff:.3e} = {bf16_param_diff / lr:.2f} lr; {repeats} runs at model {m} bit-equal: "
        f"{repeat_equal}; {ms_step:.1f} ms/step at model {m}, {one_ms:.1f} at model 1 (runs without the mask "
        f"record); launches at model {m}: K9 {counted['K9']} ({counted['K9 slice']} on strided counters), K11 "
        f"{counted['K11']}, K12 {counted['K12']}, K13 {counted['K13']}; a reduce moves {reduce_mb['doc']:.1f} MB at "
        f"the doc pass, {reduce_mb['query']:.2f} MB at the query pass, {reduce_mb['step_forward']:.0f} MB a step's "
        f"forward ({'across cards' if group[0] != group[-1] else 'on one card: read in place'}) [{label}]")
    log(f"[phase13b] fp32 (adam_eps 1e-6), model {m} against model 1: losses {fp32['losses']} vs "
        f"{fp32['model1_losses']} (relative {fp32['loss_rel']:.2e}); step-1 gradients max|d| "
        f"{fp32['grad_max_diff']:.3e} ({fp32['grad_max_at']}) = {fp32['grad_ratio']:.2e} of the largest element "
        f"{fp32['grad_largest']:.3e}, |d|/|g| at most {fp32['grad_rel']:.2e} ({fp32['grad_rel_at']}); parameters "
        f"max|d| {fp32['param_max_diff']:.3e} ({fp32['param_max_at']}); limits {TP_FP32_TOL} each; "
        f"{fp32['ms_step']:.1f} ms/step at model {m}, {fp32['model1_ms_step']:.1f} at model 1 [{label}]")
    if not all(math.isfinite(x) for x in two["losses"]) or loss_rel > TP_LOSS_REL:
        raise AssertionError(f"model {m} losses {two['losses']} against model 1's (relative {loss_rel})")
    if not fp32["ok"]:
        raise AssertionError(f"model {m} in fp32 against model 1 off the limit {TP_FP32_TOL}: {fp32}")
    if not repeat_equal:
        raise AssertionError(f"{repeats} runs at model {m} are not bit-equal")
    flash_launches_ok(counted, {"K11": steps * layers * m, "K12": steps * layers * m, "K13": steps * layers * m},
                      f"phase 13b's steps at model {m}", head_dim=cfg.model.hidden_size // cfg.model.num_heads)
    # a step: a position's attention site in each layer of both passes, forward and backward
    counts_ok(counted, {"K9": steps * 2 * 2 * (1 + (2 + m) * layers), "K9 slice": steps * 2 * 2 * m * layers,
                        "K9 packed route": steps * 2 * 2 * (1 + (2 + m) * layers), "K9 simple route": 0},
              f"phase 13b's steps at model {m}")
    return {"group": [str(d) for d in group], "losses": two["losses"], "model1_losses": one_losses,
            "loss_rel": loss_rel, "bf16_grad_rel": bf16_grad_rel, "bf16_param_max_diff": bf16_param_diff, "fp32": fp32,
            "masks": n_masks, "repeat_equal": repeat_equal, "ms_step": ms_step, "model1_ms_step": one_ms,
            "launches": counted, "reduce_mb": reduce_mb, "cfg": cfg, "train_path": train_path}


def torch_equal(a, b) -> bool:
    from colbert_tpu_torch.ops.dropout import same_bits

    return a.shape == b.shape and same_bits(a, b)


def phase_tp_serve(device, workdir: Path, label, num_docs=TP_DOCS, model_kw=None):
    """Phase 13c: ``encode`` of a ``num_docs``-passage corpus (phase 2's
    generator) and flat serving of 144 questions at ``mesh.model = 2``
    through the CLI's ``encode`` (``--set mesh.model=2``: a named card holds
    both positions) and the library's ``ColbertSearcher``, against the same
    at ``mesh.model = 1``: every unit rep (the parts' doc views, the query
    views) within ``TP_REP_ERR`` in norm of model 1's; ``e``, the largest
    change of a (question, pid) score between the two (over every pair both
    top-1,000s hold), within 16 views x (the largest query view error + the
    largest doc view error), what those errors allow a MaxSim sum; the same
    top-10 pids at every rank but where model 1 scores the two pids within
    ``2 e`` of each other (a tie the change can reorder); each top-10 score
    within ``e`` of model 1's of the same rank.  K11 once a layer a position
    a batch in the encode, K1 once a request."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.ranking.searcher import ColbertSearcher

    group = tp_group(device)
    m = len(group)
    ctx = encoded_corpus(device, workdir, label, num_docs=num_docs, model_kw={"attention_impl": "flash",
                                                                              **(model_kw or {})},
                         n_requests=1, tag="phase13c")
    cfg, common = ctx["cfg"], ctx["common"]
    tp_index = workdir / "index_tp"
    dev_arg = "cuda" if group[0] != group[-1] else str(device)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["encode", "--corpus", str(ctx["corpus_path"]), "--config", common[1], "--pretrain", common[3],
              "--device", dev_arg, "--set", f"mesh.model={m}", "--set", "mesh.data=1",
              "--set", f"index.index_path={tp_index}"])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc_launches = read_counts()
    one_parts, tp_parts = IndexStorage(cfg.index.index_path), IndexStorage(str(tp_index))
    d1 = torch.from_numpy(one_parts.load_all_embeddings().astype(np.float32))
    d2 = torch.from_numpy(tp_parts.load_all_embeddings().astype(np.float32))
    if d1.shape != d2.shape or one_parts.read_doclens() != tp_parts.read_doclens():
        raise AssertionError(f"model {m} parts {tuple(d2.shape)} against model 1's {tuple(d1.shape)}")
    d_err = float((d1 - d2).norm(dim=-1).max())

    def searcher(dev, mm, path):
        cc = ColbertConfig.from_dict(cfg.to_dict())
        cc.mesh.model, cc.index.index_path, cc.serve.topk = mm, str(path), TP_TOPK
        model = ColbertModel(cc.model, cc.multiview)
        model.load_state_dict(ctx["model"].state_dict())
        return ColbertSearcher(cc, cli._tokenizer(cc), model, IndexStorage(str(path)), device=dev)

    one = searcher(device, 1, cfg.index.index_path)
    two = searcher(dev_arg, m, tp_index)
    if tuple(two.model.model_group) != tuple(group):
        raise AssertionError(f"the model-{m} searcher's model group {two.model.model_group}, expected {group}")
    questions = ctx["requests"][0]
    enc = two.tok.encode_queries(questions)
    q1 = one.encode_queries(enc.input_ids, enc.attention_mask, enc.active_mask)
    q2 = two.encode_queries(enc.input_ids, enc.attention_mask, enc.active_mask)
    q_err = float((q1 - q2).norm(dim=-1).max())
    reset_counts()
    got = two.search(questions, topk=TP_TOPK)
    torch.cuda.synchronize()
    serve_launches = read_counts()
    want = one.search(questions, topk=TP_TOPK)
    bound = 16 * (q_err + d_err)
    # every pair both deep lists hold: the largest score change e, and model 1's scores of model 2's pids
    deep = min(num_docs, 1000)
    s1, s2 = (r.search(questions, topk=deep) for r in (one, two))
    at1 = [dict(zip(s1.pids[i].tolist(), s1.scores[i].tolist())) for i in range(len(questions))]
    at2 = [dict(zip(s2.pids[i].tolist(), s2.scores[i].tolist())) for i in range(len(questions))]
    e = max(abs(a[p] - b[p]) for a, b in zip(at1, at2) for p in a.keys() & b.keys())
    s_diff = float(np.abs(got.scores - want.scores).max())
    swapped = [(i, r) for i in range(len(questions)) for r in range(TP_TOPK) if got.pids[i, r] != want.pids[i, r]]
    untied = [(i, r) for i, r in swapped
              if abs(at1[i].get(int(got.pids[i, r]), -np.inf) - float(want.scores[i, r])) > 2 * e]
    log(f"[phase13c] encode of {num_docs} docs at mesh.model={m} ({dev_arg}) in {enc_s:.2f} s "
        f"(model 1: {ctx['enc_s']:.2f} s); doc views within {d_err:.2e} of model 1's, query views within {q_err:.2e} "
        f"(limit {TP_REP_ERR:.2e}); a score changes by at most e = {e:.2e} (the reps allow {bound:.2e}); top-"
        f"{TP_TOPK} of {len(questions)} questions: scores within {s_diff:.2e} of model 1's, {len(swapped)} of "
        f"{got.pids.size} pids differ, all at ties within 2e: {not untied}; "
        f"launches: encode K11 {enc_launches['K11']} (hd64 {enc_launches['K11 hd64']}), K9 {enc_launches['K9']}, "
        f"serve K1 {serve_launches['K1']} [{label}]")
    if d_err > TP_REP_ERR or q_err > TP_REP_ERR or e > bound or s_diff > e or untied:
        raise AssertionError(f"model {m} serving off model 1's: rep errors {d_err}, {q_err}; score change {e} "
                             f"(bound {bound}); rank score diff {s_diff}; untied pid swaps {untied[:5]}")
    n, parts = num_docs, cfg.index.num_parts
    batches = sum(-(-((p + 1) * n // parts - p * n // parts) // cfg.index.encode_batch_size) for p in range(parts))
    flash_launches_ok(enc_launches, {"K11": batches * cfg.model.num_layers * m, "K12": 0, "K13": 0},
                      "phase 13c's encode", head_dim=cfg.model.hidden_size // cfg.model.num_heads)
    counts_ok(enc_launches, {"K9": 0}, "phase 13c's encode")
    counts_ok(serve_launches, {"K1": 1}, "phase 13c's request")
    return {"docs": num_docs, "encode_s": enc_s, "model1_encode_s": ctx["enc_s"], "doc_rep_err": d_err,
            "query_rep_err": q_err, "score_max_diff": s_diff, "score_change": e, "score_bound": bound,
            "pids_differ": len(swapped),
            "encode_launches": enc_launches, "serve_launches": serve_launches}


def phase_tp_ce(device, workdir: Path, label, train_ctx, n_questions=4):
    """Phase 13d: one CE step (BERT-base CE at phase 4's width, pairs of 1 +
    ``neg_num`` passages at ``ce_maxlen`` 384, flash, dropout on) at
    ``mesh.model = 2`` against ``mesh.model = 1`` from the same init: the
    loss finite and within ``TP_LOSS_REL`` of model 1's; K11, K12 and K13
    once a layer a position, K9 on strided counters."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import CETrainConfig, ColbertConfig
    from colbert_tpu_torch.parallel.mesh import Mesh
    from colbert_tpu_torch.training import CETrainer
    from colbert_tpu_torch.utils.io import load_json

    group = tp_group(device)
    m = len(group)
    c = ColbertConfig.from_dict(train_ctx["cfg"].to_dict())
    c.ce_model = ColbertConfig.from_dict(c.to_dict()).model
    c.ce_train = CETrainConfig(per_device_batch_size=n_questions, neg_num=4, seed=SEED,
                               checkpoint_dir=str(workdir / "ce_tp"))
    examples = load_json(train_ctx["train_path"])[:n_questions]
    out = {}
    for mm, g in ((1, [device]), (m, group)):
        cc = ColbertConfig.from_dict(c.to_dict())
        cc.mesh.model = mm
        t = CETrainer(cc, cli._tokenizer(cc), device=g[0], mesh=Mesh.of(g, mm))
        t._init_state(1)
        t.np_rng = np.random.default_rng((SEED, 0))
        ids, attn, group_n, teacher = t._build_pairs(examples, "train")
        reset_counts()
        loss = float(t.train_step(ids, attn, group_n, teacher, 0))
        torch.cuda.synchronize()
        out[mm] = {"loss": loss, "launches": read_counts(), "pairs": list(ids.shape)}
        del t
        torch.cuda.empty_cache()
    rel = abs(out[m]["loss"] - out[1]["loss"]) / abs(out[1]["loss"])
    launches, layers = out[m]["launches"], c.ce_model.num_layers
    log(f"[phase13d] one CE step at mesh.model={m}, pairs {out[m]['pairs']}: loss {out[m]['loss']:.6f} vs model 1's "
        f"{out[1]['loss']:.6f} (relative {rel:.2e}, limit {TP_LOSS_REL}); launches K11 {launches['K11']}, K12 "
        f"{launches['K12']}, K13 {launches['K13']}, K9 {launches['K9']} ({launches['K9 slice']} strided) [{label}]")
    import math
    if not math.isfinite(out[m]["loss"]) or rel > TP_LOSS_REL:
        raise AssertionError(f"CE loss at model {m} {out[m]['loss']} against model 1's {out[1]['loss']}")
    flash_launches_ok(launches, {"K11": layers * m, "K12": layers * m, "K13": layers * m}, "phase 13d's CE step")
    counts_ok(launches, {"K9": 2 * (1 + (2 + m) * layers), "K9 slice": 2 * m * layers}, "phase 13d's CE step")
    return {"loss": out[m]["loss"], "model1_loss": out[1]["loss"], "loss_rel": rel, "launches": launches,
            "pairs": out[m]["pairs"]}


def phase_tp(device, label):
    """Phase 13: tensor parallelism (``mesh.model = 2``) on the cards present
    (one card holds both positions): 13a K9 on a position's slices, 13b train,
    13c encode and flat serve, 13d a CE step; with four cards or more, 13e:
    the CLI's ``train`` under a launch of data (cards / 2) x model 2
    (``phase_launch_train``)."""
    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        tmp = Path(tmp)
        for d in ("train", "serve", "launch"):
            (tmp / d).mkdir()
        k9 = phase_tp_k9(device, label)
        train = phase_tp_train(device, tmp / "train", label)
        serve = phase_tp_serve(device, tmp / "serve", label)
        ce = phase_tp_ce(device, tmp / "train", label, train)
        launch = None
        if device.type == "cuda" and torch.cuda.device_count() >= 2 * TP_MODEL:
            launch = phase_launch_train(device, tmp / "launch", label, train, model=TP_MODEL)
    train = {k: v for k, v in train.items() if k not in ("cfg", "train_path")}
    s = time.perf_counter() - t0
    log(f"[phase13] tensor parallelism took {s:.1f} s [{label}]")
    return {"k9": k9, "train": train, "serve": serve, "ce": ce, "launch": launch, "s": s}


# ---- phase 14: the host runtime (csrc/native.cpp) against its plain versions ----

ASSIGN_CANDIDATES, ASSIGN_FACTOR = 8, 1.2  # balanced_assign's candidates a row and cap over the mean list
BIG_DOCS = 200_000                         # phase 1's second flat operating point: 3.2 M rows at 16 a doc


def host_median(fn, reps=5):
    """Median host-clock ms of ``reps`` calls of ``fn`` (which returns its
    result, kept from the last call)."""
    runs, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return sorted(runs)[reps // 2], out


def host_cpu() -> dict:
    import os

    import torch

    return {"cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads()}


def phase_host_serialize(device, label, ctx):
    """Phase 14a: the serializer on phase 2's served results (a 144- and a
    1,024-question request through the flat service in process), the C++
    against the plain version, bytes equal; and one request's split."""
    import numpy as np
    import torch

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.ops.flat_scan import flat_scan_topk
    from colbert_tpu_torch.serving.serializer import TripleSerializer

    cfg, docs, questions = ctx["cfg"], ctx["docs"], ctx["questions"]
    common = ctx["common"]
    ns = argparse.Namespace(pretrain=common[common.index("--pretrain") + 1], checkpoint_step=None,
                            device=str(device), corpus=str(ctx["corpus_path"]))
    service = cli.make_service(cfg, ns)
    searcher = service.searcher
    t0 = time.perf_counter()
    ser = TripleSerializer(docs)
    build_ms = (time.perf_counter() - t0) * 1e3
    out = {"serializer_build_ms": build_ms, "fragments_mb": ser.blob.nbytes / 1e6}
    service.retrieve(questions[:1], topk=TOPK)  # warm-up
    for name, n in (("request_144", B), ("request_1024", 1024)):
        qs = [questions[i % len(questions)] for i in range(n)]
        batches = []
        service._retrieve_batches(qs, TOPK, None, None,
                                  lambda pids, scores, n_real: batches.append((pids[:n_real].copy(),
                                                                               scores[:n_real].copy())))
        cpp_ms, got = host_median(lambda: ser.wrap([ser.serialize_batch(p, s) for p, s in batches]))
        ref_ms, want = host_median(lambda: ser.wrap([ser.serialize_batch_ref(p, s) for p, s in batches]))
        if bytes(got) != bytes(want):
            raise AssertionError(f"phase14a {name}: the C++ payload differs from the plain version's")
        dtypes = sorted({str(s.dtype) for _, s in batches})
        out[name] = {"questions": n, "batches": len(batches), "payload_mb": got.nbytes / 1e6,
                     "score_dtypes": dtypes, "cpp_ms": cpp_ms, "plain_ms": ref_ms}
        log(f"[phase14a] serialize + wrap, {n} questions x top-{TOPK} ({len(batches)} batches, "
            f"{got.nbytes / 1e6:.2f} MB, scores {dtypes}): C++ {cpp_ms:.3f} ms, plain {ref_ms:.3f} ms "
            f"({ref_ms / cpp_ms:.1f}x), bytes equal [{label}; host {host_cpu()}]")

    # one 144-question request of phase 2, split as PERF.md section 5 splits it
    qs = questions[:B]
    tok = searcher.tok

    def encode():
        with torch.inference_mode():
            Qm = searcher.encode_queries(enc.input_ids, enc.attention_mask, enc.active_mask)
        torch.cuda.synchronize()
        return Qm

    def scan():
        with torch.inference_mode():
            r = flat_scan_topk(Qm, searcher.emb_table, dv=searcher.flat_dv, num_docs=searcher.num_docs,
                               topk=TOPK, score_dtype=searcher.score_dtype)
        torch.cuda.synchronize()
        return r

    split = {}
    split["tokenize_ms"], enc = host_median(lambda: tok.encode_queries(qs))
    split["encode_ms"], Qm = host_median(encode)
    split["scan_topk_ms"], (ts, tp) = host_median(scan)
    split["to_host_ms"], (s_h, p_h) = host_median(lambda: (ts.cpu().numpy(), tp.cpu().numpy()))
    split["serialize_ms"], _ = host_median(lambda: ser.wrap([ser.serialize_batch(p_h, s_h)]))
    split["serialize_plain_ms"], _ = host_median(lambda: ser.wrap([ser.serialize_batch_ref(p_h, s_h)]))
    split["request_ms"], _ = host_median(lambda: service.retrieve_pickled(qs, topk=TOPK))
    out["split_144"] = split
    log(f"[phase14a] one {B}-question flat request in process, ms: "
        + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in split.items()) + f" [{label}]")
    searcher.close()
    return out


def _assign_and_pack(tag, cand, codes, K, label, plain_reps):
    """balanced_assign and ivf_pack against their plain versions on one input."""
    import numpy as np

    from colbert_tpu_torch.ops import ivf

    n = cand.shape[0]
    cap = max(1, int(np.ceil(n / K * ASSIGN_FACTOR)))
    cpp_ms, got = host_median(lambda: ivf.balanced_assign(cand, K, cap))
    ref_ms, want = host_median(lambda: ivf.balanced_assign_ref(cand, K, cap), reps=plain_reps)
    if not np.array_equal(got, want):
        raise AssertionError(f"{tag}: balanced_assign differs from its plain version")
    pack_ms, packed = host_median(lambda: ivf.ivf_pack(got, codes, K))
    pack_ref_ms, packed_ref = host_median(lambda: ivf.ivf_pack_ref(got, codes, K), reps=3)
    if not all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(packed, packed_ref)):
        raise AssertionError(f"{tag}: ivf_pack differs from its plain version")
    first = np.bincount(cand[:, 0], minlength=K)
    lens = np.diff(packed[1])
    out = {"rows": n, "lists": K, "candidates": cand.shape[1], "cap": cap, "code_width": codes.shape[1],
           "code_dtype": str(codes.dtype), "spilled_from_first": int((got != cand[:, 0]).sum()),
           "first_choice_max_list": int(first.max()), "max_list": int(lens.max()),
           "balanced_assign_ms": cpp_ms, "balanced_assign_plain_ms": ref_ms,
           "balanced_assign_plain_reps": plain_reps, "ivf_pack_ms": pack_ms, "ivf_pack_plain_ms": pack_ref_ms}
    log(f"[{tag}] {n} rows, {K} lists, cap {cap}: balanced_assign C++ {cpp_ms:.3f} ms, plain {ref_ms:.1f} ms "
        f"(median of {plain_reps}); ivf_pack ({codes.shape[1]} x {codes.dtype}) C++ {pack_ms:.3f} ms, plain "
        f"{pack_ref_ms:.3f} ms; outputs equal; {out['spilled_from_first']} rows off their first candidate, "
        f"list max {int(first.max())} -> {int(lens.max())} [{label}]")
    return out


def skewed_candidates(device, n, K, dim, kc, seed, chunk=1 << 18):
    """(n, kc) nearest-centroid candidates of rows drawn around K random unit
    centroids, topic ``floor(K u^1.3)`` for uniform u: the first list holds
    ~K^0.23 times the mean (9.4x at 16,384 lists), so the first lists
    overflow a cap near the mean and their rows spill down their candidates."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    cent = torch.randn((K, dim), generator=g, device=device)
    cent = (cent / cent.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    out = torch.empty((n, kc), dtype=torch.int32, device=device)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        topic = (torch.rand(m, generator=g, device=device) ** 1.3 * K).long().clamp_max(K - 1)
        x = cent[topic].float() + torch.randn((m, dim), generator=g, device=device) / dim ** 0.5
        out[lo : lo + m] = torch.topk(x.to(torch.bfloat16) @ cent.T, kc, dim=1).indices.int()
    return out.cpu().numpy()


def phase_host_build(device, label, cfg, seed=SEED):
    """Phase 14b: balanced_assign and ivf_pack on phase 5b's rows and lists
    (the pack also equal to the index phase 5b's build wrote) and at 3.2 M
    rows, each against its plain version."""
    import numpy as np
    import torch

    from colbert_tpu_torch.indexing.builder import auto_partitions
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.ops import ivf
    from colbert_tpu_torch.ops.kmeans import nearest_centroids

    storage = IndexStorage(cfg.index.index_path)
    stored = storage.read_ivf()
    K = stored["coarse_centroids"].shape[0]
    perm = stored["row_emb"].astype(np.int64)
    n = perm.shape[0]
    # the build's inputs, in row order: each row's list and code
    assign = np.empty(n, np.int32)
    assign[perm] = np.repeat(np.arange(K, dtype=np.int32), np.diff(stored["offsets"]))
    codes = np.empty_like(stored["codes"])
    codes[perm] = stored["codes"]
    cent = torch.from_numpy(stored["coarse_centroids"]).to(device)
    cand = np.concatenate([
        nearest_centroids(torch.from_numpy(np.asarray(storage.read_part(p))).to(device), cent,
                          ASSIGN_CANDIDATES).cpu().numpy() for p in storage.part_ids()])
    out = {}
    out["phase5b"] = _assign_and_pack("phase14b", cand, codes, K, label, plain_reps=3)
    repacked = ivf.ivf_pack(assign, codes, K)
    for got, name in zip(repacked, ("row_emb", "offsets", "codes")):
        if not np.array_equal(got, stored[name]) or got.dtype != stored[name].dtype:
            raise AssertionError(f"phase14b: ivf_pack of phase 5b's lists differs from its stored {name}")
    log(f"[phase14b] ivf_pack of phase 5b's rows by their stored lists is bit-equal to the stored index")

    n_big = BIG_DOCS * 16
    K_big = auto_partitions(n_big)
    t0 = time.perf_counter()
    cand_big = skewed_candidates(device, n_big, K_big, H, ASSIGN_CANDIDATES, seed)
    g = torch.Generator(device).manual_seed(seed + 1)
    codes_big = torch.randint(-127, 128, (n_big, SQ_DIM), generator=g, device=device,
                              dtype=torch.int8).cpu().numpy()
    log(f"[phase14b] {n_big} rows' candidates and codes drawn on the card in {time.perf_counter() - t0:.1f} s")
    out["rows_3_2m"] = _assign_and_pack("phase14b", cand_big, codes_big, K_big, label, plain_reps=1)
    return out


def phase_host_flat_table(device, label, seed=SEED):
    """Phase 14c: ``build_flat_table`` once at 200,000 docs x 16 rows x 768
    from fp16 on the host, bf16 and int8 (torch's CPU conversions: the port
    has no counterpart of the JAX package's fp16 helpers)."""
    import numpy as np
    import torch

    from colbert_tpu_torch.ops import flat_scan as fs

    rows = BIG_DOCS * 16
    emb = unit_rows_bf16(rows, H, device, seed).to(torch.float16).cpu().numpy()
    doclens = np.full(BIG_DOCS, 16)
    out = {"docs": BIG_DOCS, "rows": rows, "dim": H, "fp16_gb": emb.nbytes / 1e9, **host_cpu()}
    for dtype in ("bfloat16", "int8"):
        t0 = time.perf_counter()
        table, inv, _ = fs.build_flat_table(emb, doclens, dtype=dtype)
        out[f"{dtype}_s"] = time.perf_counter() - t0
        if table.shape[0] < rows or (dtype == "int8") != (inv is not None):
            raise AssertionError(f"phase14c: a {dtype} table of shape {tuple(table.shape)}")
        del table
    log(f"[phase14c] build_flat_table at {BIG_DOCS} docs x 16 x {H} from fp16 ({out['fp16_gb']:.2f} GB): "
        f"bf16 {out['bfloat16_s']:.2f} s, int8 {out['int8_s']:.2f} s (torch CPU, {out['torch_threads']} "
        f"threads of {out['cpu_count']} cores) [{label}]")
    return out


def phase14_alone(device, label):
    """Phase 14 with the set-up it needs: phase 2's encoded corpus and flat
    index, phase 5b's sq index."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as tmp:
        ctx = encoded_corpus(device, Path(tmp), label)
        out = {"serialize": phase_host_serialize(device, label, ctx)}
        (Path(tmp) / "bench").mkdir()
        cfg = bench_index(device, Path(tmp) / "bench", n_batches=1)[0]
        out["build"] = phase_host_build(device, label, cfg)
    out["flat_table"] = phase_host_flat_table(device, label)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description="Smoke run of colbert_tpu_torch on the cards present.")
    ap.add_argument("--phase10", action="store_true",
                    help="phase 10 alone (several devices), with the set-up it needs")
    ap.add_argument("--phase9", action="store_true",
                    help="phases 9b, 9d and 9a alone (ragged corpora, the host table), with the set-up they need")
    ap.add_argument("--phase12", action="store_true",
                    help="phases 12 and 15 and phases 8a and 11a at the head dims but 64 alone")
    ap.add_argument("--phase13", action="store_true",
                    help="phase 13 (tensor parallelism, mesh.model = 2: on two cards where there are, else one "
                         "card holds both positions) alone")
    ap.add_argument("--phase14", action="store_true",
                    help="phase 14 (the host runtime against its plain versions) alone, with the set-up it needs")
    ap.add_argument("--phase15", action="store_true",
                    help="phases 1b and 15 (K1/K2 and K4 at ColBERT dims that are not multiples of 16, the "
                         "TinyBERT-4L-zh-width retriever at dim 312) alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from colbert_tpu_torch.ops import _build, dropout as dr, flash_attention as fa, flat_scan as fs, maxsim as ms
    from colbert_tpu_torch.ops import pq4, rerank as rr, sq_probe, sq_probe_batched as sp

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    label = card_label()
    log(label)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    sources = ("flat_scan", "maxsim", "dropout", "sq_probe", "rerank", "pq4_scan", "sq_token_scan", "flash_attention")
    _build.load_libraries(*sources)
    for mod in (fs, ms, dr, sp, rr, pq4, sq_probe, fa):
        mod._kernel_lib()
    log(f"[build] {', '.join(n + '.cu' for n in sources)} built in parallel and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in sources:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    if args.phase10 or args.phase9 or args.phase12 or args.phase13 or args.phase14 or args.phase15:
        if args.phase15:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_tinybert_") as tmp:
                out = {"phase1b": phase_kernel_dims(device), "phase15": phase_tinybert(device, Path(tmp), label)}
        elif args.phase14:
            out = {"host_runtime": phase14_alone(device, label)}
        elif args.phase13:
            out = {"phase13": phase_tp(device, label)}
        elif args.phase12:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_minilm_") as tmp:
                out = {"phase8a_head_dims": phase_flash_head_dims(device, Path(tmp), label),
                       "phase11a_head_dims": phase_flash_fp32_head_dims(device, Path(tmp), label),
                       "phase12": phase_minilm(device, Path(tmp) / "minilm", label),
                       "phase15": phase_tinybert(device, Path(tmp) / "tinybert", label)}
        else:
            out = {"phase10": phase10_alone(device, label)} if args.phase10 else {"phase9": phase9_alone(device, label)}
        log(label)
        log(json.dumps(out, default=str))
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0
    worst, times, share, routes = phase_kernels(device)
    dims = phase_kernel_dims(device)
    train_kernels = phase_train_kernels(device)
    t8 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flash_") as tmp:
        flash_kernels = phase_flash_kernels(device, Path(tmp), label)
        flash_hd = phase_flash_head_dims(device, Path(tmp), label)
        t8 = time.perf_counter() - t8
        t11 = time.perf_counter()
        flash_fp32 = phase_flash_fp32(device, Path(tmp), label)
        flash_fp32_hd = phase_flash_fp32_head_dims(device, Path(tmp), label)
        t11 = time.perf_counter() - t11
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serve_launches, _, ann_launches, codec_launches, k7_deep, ctx = phase_slice(device, Path(tmp), label)
        ragged_cli, sharded_flat = ctx["ragged_cli"], ctx["sharded_flat"]
        t14 = time.perf_counter()
        host_runtime = {"serialize": phase_host_serialize(device, label, ctx)}
        t14 = time.perf_counter() - t14
        t0 = time.perf_counter()
        dense = phase_dense(device, Path(tmp), label, ctx)
        t11 += time.perf_counter() - t0
        ce_launches, ce_info = phase_second_stage(device, Path(tmp), label, ctx)
        t0 = time.perf_counter()
        flash_encode = phase_flash_encode(device, Path(tmp), label, ctx)
        flash_ce = phase_flash_ce(device, Path(tmp), label, ce_info)
        t8 += time.perf_counter() - t0
        del ctx
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_launches, train_info = phase_train(device, Path(tmp), label)
        repeat = phase_repeat(device, label, train_info)
        launch_train = phase_launch_train(device, Path(tmp), label, train_info)
        t0 = time.perf_counter()
        fp32_train = phase_flash_fp32_train(device, label, train_info)
        options = phase_model_options(device, label, train_info)
        t11 += time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flash_train_") as tmp:
        t0 = time.perf_counter()
        flash_launches, flash_train = phase_train(device, Path(tmp), label, steps=5, attention_impl="flash",
                                                  tag="phase8b")
        log(f"[phase8b] flash train {flash_train['ms_step']:.1f} ms/step, peak {flash_train['peak_gb']:.2f} GB; "
            f"phase 4 (explicit attention) {train_info['ms_step']:.1f} ms/step, peak {train_info['peak_gb']:.2f} GB "
            f"[{label}]")
        remat = phase_remat(device, label, flash_train)
        t8 += time.perf_counter() - t0
    log(f"[phase8] the flash path and remat took {t8:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_minilm_") as tmp:
        minilm = phase_minilm(device, Path(tmp), label)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tinybert_") as tmp:
        tinybert = phase_tinybert(device, Path(tmp), label)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ann_") as tmp:
        ann_kernels, ann_info = phase_ann(device, Path(tmp), label)
        t0 = time.perf_counter()
        host_runtime["build"] = phase_host_build(device, label, ann_info["config"])
        t14 += time.perf_counter() - t0
        sharded_ann = phase_sharded_ann(device, label, ann_info)
        codec_kernels, _ = phase_codecs(device, Path(tmp), label, ann_info)
        ragged = phase_ragged(device, Path(tmp), label, uniform_cfg=ann_info["config"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_text_") as tmp:
        t0 = time.perf_counter()
        real_text = phase_real_text(device, Path(tmp), label)
        t11 += time.perf_counter() - t0
    log(f"[phase11] flash at fp32 (11a) {sum(1 for _ in flash_fp32)} shapes, fp32 train (11b), the model options "
        f"(11c), DPR (11d) and real text (11e) took {t11:.1f} s")
    tp = phase_tp(device, label)
    t0 = time.perf_counter()
    host_runtime["flat_table"] = phase_host_flat_table(device, label)
    host_runtime["s"] = t14 + time.perf_counter() - t0
    log(f"[phase14] the host runtime's comparisons took {host_runtime['s']:.1f} s")

    log(f"[phase10] sharded flat {sharded_flat['s']:.1f} s, sharded ANN {sharded_ann['s']:.1f} s, train under a "
        f"launch {launch_train['s']:.1f} s: {sharded_flat['s'] + sharded_ann['s'] + launch_train['s']:.1f} s")
    num_docs, dv = 20_000, 16
    k12_bound = bound(2.0 * B * M * num_docs * dv * H,
                      num_docs * dv * H * 2 + B * M * H * 4 + num_docs * B * 4, PEAK_BF16_FLOPS)
    kernels = []
    for name, fn, line in (("K1 flat_scan_fused", "K1", 157), ("K2 flat_maxsim_scan", "K2", 59)):
        kernels.append({
            "name": name, "route": "cuda", "source": "colbert_tpu_torch/csrc/flat_scan.cu",
            "replaces": f"colbert_tpu/ops/flat_scan.py:{line}", "launches": serve_launches[fn],
            "max_abs_err": worst[fn], "ms": times[fn][0], "plain_ms": times[fn][1],
            "bound_ms": k12_bound[0], "bound_by": k12_bound[1], "library_ms": None,
            "kernel_route": routes[fn], "peak_share": share[fn], "yardstick_cublas_ms": times["cuBLAS"][0],
        })
    kernels[1]["sharded"] = {key: sharded_flat[key] for key in ("shards", "max_abs_err", "ms", "single_ms")} | {
        "launches": sharded_flat["launches"]["K2"]}  # phase 10a: K2 once a shard a batch
    kernels[0]["second_stage_launches"] = {"mine": ce_launches["mine"]["K1"],
                                           "evaluate_rerank_ce": ce_launches["rerank"]["K1"]}
    kernels[0].update({"int8_ms": times["K1 int8"][0], "int8_peak_share": share["K1 int8"],
                       "docs_200k_bf16_ms": times["K1 200k bf16"][0],
                       "docs_200k_peak_share": share["K1 200k bf16"]})
    for name, fn, src, replaces in (
        ("K3 maxsim", "K3", "colbert_tpu_torch/csrc/maxsim.cu", "colbert_tpu/ops/maxsim.py:61"),
        ("K9 hw_dropout", "K9", "colbert_tpu_torch/csrc/dropout.cu", "colbert_tpu/ops/dropout_pallas.py:36"),
    ):
        k = train_kernels[fn]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": train_launches[fn], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
        if launch_train["launches"] is not None:  # phase 10c: train under a launch of one process
            kernels[-1]["launch_train_launches"] = launch_train["launches"][fn]
        if fn == "K9":
            ce, ce_hidden = k["ce"], k["ce_hidden"]
            kernels[-1].update({
                "kernel_route": "packed", "route_launches": {
                    r: train_launches[f"K9 {r} route"] for r in ("packed", "simple")},
                "ce_launches": ce_launches["train"]["K9"], "ce_launches_per_step": ce_info["per_step_k9"],
                "ce_resume_launches": ce_launches["resume"]["K9"], "ce_distill_launches": ce_launches["distill"]["K9"],
                "ce_host_ms_per_step": ce_info["k9_host_ms_per_step"], "sass": k["sass"], "clock_hz": k["clock_hz"],
                **{key: k[key] for key in K9_KEYS if key not in ("shape", "dtype", "max_abs_err", "ms", "plain_ms",
                                                                  "bound_ms", "bound_by", "library_ms")},
                **{f"ce_{key}": ce[key] for key in K9_KEYS},
                **{f"ce_hidden_{key}": ce_hidden[key] for key in K9_KEYS}})
        if fn == "K3":
            kernels[-1].update({
                "kernel_route": k["kernel_route"], "route_launches": {
                    r: train_launches[f"K3 {r} route"] for r in ("tf32", "staged")},
                **{key: k[key] for key in ("staged_ms", "staged_max_abs_err", "fp32_bound_ms", "kernel_ms")}})
    for name, fn, src, replaces in (
        ("K4 maxsim_rerank_uniform", "K4", "colbert_tpu_torch/csrc/rerank.cu", "colbert_tpu/ops/rerank_pallas.py:26"),
        ("K5 maxsim_rerank_uniform_int8", "K5", "colbert_tpu_torch/csrc/rerank.cu", "colbert_tpu/ops/rerank_pallas.py:65"),
        ("K6 sq_batch_list_scan", "K6", "colbert_tpu_torch/csrc/sq_probe.cu", "colbert_tpu/ops/sq_probe_batched.py:221"),
        ("K7 sq_hot_list_scan", "K7", "colbert_tpu_torch/csrc/sq_probe.cu", "colbert_tpu/ops/sq_probe_batched.py:345"),
    ):
        k = ann_kernels[fn]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": ann_launches[fn], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,
            "sharded_launches": sharded_ann["launches"][fn],  # phase 10b: once a shard
        })
        if fn == "K6":
            two = codec_kernels["K6"]
            kernels[-1].update({
                "kernel_route": k["kernel_route"], "route_launches": {
                    r: ann_launches[f"K6 {r} route"] for r in ("mma", "staged")},
                "staged_design_ms": k["staged_ms"], "staged_max_abs_err": k["staged_max_abs_err"],
                "longest_slot_ms": k["longest_slot_ms"], "histogram": k["histogram"],
                "work_list_ms": k["work_list_ms"],
                "two_topic": {key: two[key] for key in ("ms", "staged_ms", "max_abs_err", "staged_max_abs_err",
                                                         "plain_ms", "bound_ms", "histogram")}})
        if fn == "K7":
            kernels[-1].update({
                "kernel_route": k["kernel_route"], "route_launches": {
                    r: ann_launches[f"K7 {r} route"] for r in ("mma", "staged")},
                "launches_note": "one per ANN batch; only batches whose lists overflow their slots "
                                 "(the nprobe-1,024 request here) have hot lists",
                **{key: k[key] for key in ("staged_ms", "staged_max_abs_err", "all_tokens_ms",
                                           "all_tokens_max_abs_err", "schedule_ms", "all_tokens_bound_ms",
                                           "hot_lists", "member_entries", "member_pairs", "all_token_pairs",
                                           "served_no_hot")},
                "deep_plan": {key: k7_deep[key] for key in (
                    "ms", "staged_ms", "all_tokens_ms", "schedule_ms", "plain_ms", "max_abs_err",
                    "staged_max_abs_err", "bound_ms", "all_tokens_bound_ms", "hot_lists", "member_pairs",
                    "all_token_pairs")}})
        if fn in ("K4", "K5"):
            lr = k["low_reuse"]
            kernels[-1].update({
                "kernel_route": k["kernel_route"], "route_launches": {
                    r: ann_launches[f"K4/K5 {r} route"] for r in ("wgmma", "staged")},
                "schedule_ms": k["schedule_ms"], "staged_design_ms": k["staged_ms"],
                "low_reuse_ms": lr["ms"], "low_reuse_bound_ms": lr["bound_ms"],
                "low_reuse_staged_design_ms": lr["staged_ms"], "low_reuse_max_abs_err": lr["max_abs_err"],
                "wide_query_rows": k["wide"],  # phase 5a: 48 and 64 query rows, a launch a 16-row chunk
                "wide_query_search": {n: r for n, r in ragged["wide"].items() if r["launches"][fn]}})  # phase 9d
    for name, fn, line in (("K4 maxsim_rerank_buckets (ragged stride buckets)", "K4", 26),
                           ("K5 maxsim_rerank_buckets (ragged int8 stride buckets, host blocks)", "K5", 65)):
        rk = ragged["buckets"][fn]  # phase 9a; launches: phase 9c's served ragged run, all on "wgmma_rows"
        kernels.append({
            "name": name, "route": "cuda", "source": "colbert_tpu_torch/csrc/rerank.cu",
            "replaces": f"colbert_tpu/ops/rerank_pallas.py:{line}", "launches": ragged_cli["launches"][fn],
            "max_abs_err": rk["max_abs_err"], "ms": rk["ms"], "plain_ms": rk["plain_ms"], "bound_ms": rk["bound_ms"],
            "bound_by": rk["bound_by"], "library_ms": None, "kernel_route": "wgmma_rows",
            "route_launches": {r: ragged_cli["launches"][f"K4/K5 {r} route"] for r in ("wgmma_rows", "staged")},
            "staged_design_ms": rk["staged_ms"], "staged_max_abs_err": rk["staged_max_abs_err"],
            "turns_ms": rk["turns_ms"], "strides": rk["strides"],
            **{key: rk[key] for key in ("pair_bound_ms", "ops_ms", "bucket_ms_sum", "distinct_gb", "pair_gb",
                                        "l2_gb", "items")},
            "bucket_ms": [b["ms"] for b in rk["buckets"]], "bucket_staged_ms": [b["staged_ms"] for b in rk["buckets"]],
            "bucket_l2_gb": [b["l2_gb"] for b in rk["buckets"]]})
        if fn == "K5":
            kernels[-1]["host_blocks"] = ragged["host_blocks"]
    for name, fn, src, replaces in (
        ("K8 pq4_list_scan", "K8", "colbert_tpu_torch/csrc/pq4_scan.cu", "colbert_tpu/ops/pq4.py:125"),
        ("K10 sq_window_topk", "K10", "colbert_tpu_torch/csrc/sq_token_scan.cu",
         "colbert_tpu/ops/sq_probe_pallas.py:40"),
    ):
        k = codec_kernels[fn]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": codec_launches[fn], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
        if fn == "K8":
            kernels[-1].update({
                "kernel_route": k["kernel_route"], "route_launches": {
                    r: codec_launches[f"K8 {r} route"] for r in ("onehot", "lookup")},
                "lookup_design_ms": k["lookup_design_ms"], "lookup_max_abs_err": k["lookup_max_abs_err"],
                "lookup_bound_ms": k["lookup_bound_ms"], "lookup_phase_split": k["lookup_phase_split"],
                "work_list_ms": k["work_list_ms"], "histogram": k["histogram"]})
        if fn == "K10":
            kernels[-1].update({
                "kernel_route": k["kernel_route"], "route_launches": {
                    r: codec_launches[f"K10 {r} route"] for r in ("fused", "staged")},
                **{key: k[key] for key in ("staged_design_ms", "staged_scan_ms", "staged_scan_bound_ms",
                                           "scan_max_abs_err", "stage_ms", "stage_parts_ms",
                                           "yardstick_staged_torch_topk_ms", "histogram")}})
    fk = flash_kernels["retriever"]
    for name, kname, line, what in (("K11 flash_attention forward", "K11", 758, "o"),
                                    ("K12 flash_attention dK/dV", "K12", 1121, "dk"),
                                    ("K13 flash_attention dQ", "K13", 1456, "dq")):
        errs = {s: max(r[w]["max_abs_err"] for w in ((what, "dv") if kname == "K12" else (what,)))
                for s, r in flash_kernels.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": "colbert_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line} (jax 0.9.0; reached from "
                        "colbert_tpu/models/bert.py:185-193)",
            "launches": flash_launches[kname], "max_abs_err": errs["retriever"], "ms": fk["ms"][kname],
            "plain_ms": fk["plain_ms"] if kname == "K11" else fk["plain_backward_ms"],
            "bound_ms": fk["bound"][kname][0], "bound_by": fk["bound"][kname][1],
            "library_ms": fk["sdpa_ms"] if kname == "K11" else fk["sdpa_backward_ms"],
            "shape": fk["shape"], "hot_ms": fk["hot_ms"][kname], "max_abs_err_by_shape": errs,
            "head_ulps_by_shape": {s: r[what]["head_ulps"] for s, r in flash_kernels.items()},
            "ce": {key: flash_kernels["ce"][key][kname] for key in ("ms", "hot_ms")} | {
                "bound_ms": flash_kernels["ce"]["bound"][kname][0]},
            "encode": {key: flash_kernels["encode"][key][kname] for key in ("ms", "hot_ms")} | {
                "bound_ms": flash_kernels["encode"]["bound"][kname][0]},
            "ce_launches": flash_ce["launches"][kname], "encode_launches": flash_encode["launches"][kname],
        })
        timed_shapes, simple = ("retriever", "ce", "encode"), f"{kname} simple"
        kernels[-1].update({
            "kernel_route": "wgmma", "route_launches": {
                r: flash_launches[f"{kname} {r} route"] for r in ("wgmma", "simple")},
            "simple_design_ms": fk["ms"][simple], "simple_design_hot_ms": fk["hot_ms"][simple],
            "route_head_ulps_by_shape": {s: {r: v[what]["head_ulps"] for r, v in flash_kernels[s]["routes"].items()}
                                         for s in flash_kernels},
            "simple_design_by_shape": {s: flash_kernels[s]["ms"][simple] for s in timed_shapes}})
        kernels[-1]["ce"]["simple_design_ms"] = flash_kernels["ce"]["ms"][simple]
        kernels[-1]["encode"]["simple_design_ms"] = flash_kernels["encode"]["ms"][simple]
        if kname == "K11":
            kernels[-1].update({f"{key}_by_shape": {s: flash_kernels[s][key] for s in timed_shapes}
                                for key in ("flash_fwd_bwd_ms", "flash_fwd_bwd_simple_ms", "route_parts_ms",
                                            "sdpa_fwd_bwd_ms",
                                            "sdpa_backward_ms", "explicit_ms", "explicit_fwd_bwd_ms", "plain_ms",
                                            "plain_backward_ms")})
        else:  # SDPA's backward alone computes dq, dk and dv together: the pair's yardstick
            kernels[-1].update({"library_call": f"SDPA backward alone ({fk['sdpa_backward_backend']})",
                                "library_ms_by_shape": {s: flash_kernels[s]["sdpa_backward_ms"] for s in timed_shapes},
                                "yardstick_sdpa_fwd_bwd_ms": fk["sdpa_fwd_bwd_ms"]})
        if kname == "K12":
            kernels[-1]["di"] = {
                "launches": flash_launches["flash rows"], "ms": fk["ms"]["rows"], "hot_ms": fk["hot_ms"]["rows"],
                "flash_di_ms": fk["ms"]["flash_di"], "flash_di_hot_ms": fk["hot_ms"]["flash_di"],
                "bound_ms": fk["bound"]["rows"][0],
                "fp32_bound_share_by_shape": {s: r["di"]["fp32_bound_share"] for s, r in flash_kernels.items()},
                "by_shape": {s: {"ms": flash_kernels[s]["ms"]["rows"], "flash_di_ms": flash_kernels[s]["ms"]["flash_di"]}
                             for s in timed_shapes}}
    f32 = flash_fp32["retriever"]
    for name, kname, line, what in (("K11 flash_attention forward at fp32, route tf32", "K11", 758, ("o",)),
                                    ("K12 flash_attention dK/dV at fp32, route tf32", "K12", 1121, ("dk", "dv")),
                                    ("K13 flash_attention dQ at fp32, route tf32", "K13", 1456, ("dq",))):
        plain, library = ("plain_ms", "sdpa_ms") if kname == "K11" else ("plain_backward_ms", "sdpa_backward_ms")
        route = "tf32"
        kb = lambda r: r["bound"]["tf32x3"][kname]  # route "tf32"'s bound: its three TF32 products'

        kernels.append({
            "name": name, "route": "cuda", "source": "colbert_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line} (jax 0.9.0, on fp32 inputs; "
                        "reached from colbert_tpu/models/bert.py:185-193)",
            "launches": fp32_train["flash"]["launches"][f"{kname} {route} route"],
            "max_abs_err": max(f32[w]["max_abs_err"] for w in what), "ms": f32["ms"][kname],
            "plain_ms": f32[plain], "bound_ms": kb(f32)[0], "bound_by": kb(f32)[1],
            "library_ms": f32[library], "kernel_route": route, "dtype": "float32", "shape": f32["shape"],
            "hot_ms": f32["hot_ms"][kname], "fma_bound_ms": f32["bound"][kname][0],
            "tf32x3_bound_ms": f32["bound"]["tf32x3"][kname][0],
            "head_rel_by_shape": {s: max(r[w]["head_rel"] for w in what) for s, r in flash_fp32.items()},
            "by_shape": {s: {"ms": r["ms"][kname], "hot_ms": r["hot_ms"][kname], "bound_ms": kb(r)[0],
                             "plain_ms": r[plain], "library_ms": r[library]} for s, r in flash_fp32.items()},
        })
        kernels[-1]["tf32x3_bound_share"] = f32["tf32x3_bound_share"][kname]
        if kname == "K11":
            kernels[-1].update({"flash_fwd_bwd_ms": f32["flash_fwd_bwd_ms"], "sdpa_fwd_bwd_ms": f32["sdpa_fwd_bwd_ms"],
                                "library_call": "SDPA forward, fp32, boolean mask"})
        else:
            kernels[-1].update({
                "library_call": f"SDPA backward alone ({f32['sdpa_backward_backend']}), fp32",
                "rows_k12_k13_ms_by_shape": {s: r["rows_k12_k13_ms"] for s, r in flash_fp32.items()}})
        if kname == "K12":
            kernels[-1]["di"] = {
                "launches": fp32_train["flash"]["launches"]["flash rows fp32"], "ms": f32["ms"]["rows"],
                "hot_ms": f32["hot_ms"]["rows"], "bound_ms": f32["bound"]["rows"][0],
                "bound_by": f32["bound"]["rows"][1],
                "by_shape": {s: {"ms": r["ms"]["rows"], "bound_ms": r["bound"]["rows"][0]}
                             for s, r in flash_fp32.items()}}
        kernels[-1]["by_head_dim"] = {str(hd): {
            "shape": r["shape"], "ms": r["ms"][kname], "hot_ms": r["hot_ms"][kname], "bound_ms": kb(r)[0],
            "bound_by": kb(r)[1], "plain_ms": r[plain], "library_ms": r[library],
            "head_rel": max(r[w]["head_rel"] for w in what), "max_abs_err": max(r[w]["max_abs_err"] for w in what),
            "launches": fp32_train["flash"]["launches"][f"{kname} hd{hd}"]}
            | ({"rows_ms": r["ms"]["rows"], "rows_bound_ms": r["bound"]["rows"][0]} if kname == "K12" else {})
            for hd, r in flash_fp32_hd.items()}
    kernels[-3]["fp32_train"] = fp32_train
    kernels[-6]["flash_train"] = {key: flash_train[key] for key in ("ms_step", "peak_gb", "losses")}
    kernels[-6]["flash_encode_docs_s"] = flash_encode["docs_s"]
    kernels[-6]["flash_ce"] = {key: flash_ce[key] for key in ("ms_step", "peak_gb")}
    kernels[-6]["remat_peak_gb"] = {k: r["peak_gb"] for k, r in remat.items()}
    kernels[-6]["explicit_repeat"] = {key: repeat[key] for key in ("losses", "parameters", "s")}
    # K11-K13 by head dim, route "wgmma": 32 on phase 12's path and 26 on phase 15's (each its train run's
    # launches; its encode's beside), 80, 96 and 128 in phase 8a only (no configuration the port ships has
    # them: phase 12's train run counts 0 there)
    paths = {32: ("MiniLM-L12-H384", minilm), 26: ("TinyBERT-4L-zh", tinybert)}
    bf16_flash = kernels[-6:-3]
    for i, (kname, line, what) in enumerate((("K11", 758, ("o",)), ("K12", 1121, ("dk", "dv")),
                                             ("K13", 1456, ("dq",)))):
        plain, library = ("plain_ms", "sdpa_ms") if kname == "K11" else ("plain_backward_ms", "sdpa_backward_ms")
        by_hd = {str(hd): {
            "shape": r["shape"], "ms": r["ms"][kname], "bound_ms": r["bound"][kname][0],
            "bound_by": r["bound"][kname][1], "plain_ms": r[plain], "library_ms": r[library],
            "max_abs_err": max(x[w]["max_abs_err"] for w in what for x in (r, r["float16"])),
            "head_ulps": {dt: max(x[w]["head_ulps"] for w in what) for dt, x in (("bfloat16", r),
                                                                                  ("float16", r["float16"]))},
            "launches": paths.get(hd, paths[32])[1]["train"]["launches"][f"{kname} hd{hd}"],
            "template": fa.template_head_dim(hd)}
            | ({"rows_ms": r["ms"]["rows"], "rows_bound_ms": r["bound"]["rows"][0]} if kname == "K12" else {})
            for hd, r in flash_hd.items()}
        bf16_flash[i]["by_head_dim"] = by_hd
        for hd, (model_name, path) in paths.items():
            r = flash_hd[hd]
            kernels.append({
                "name": f"{bf16_flash[i]['name']}, head dim {hd}", "route": "cuda",
                "source": "colbert_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line} (jax 0.9.0, head dim {hd}; "
                            "reached from colbert_tpu/models/bert.py:185-193)",
                "launches": by_hd[str(hd)]["launches"], "max_abs_err": by_hd[str(hd)]["max_abs_err"],
                "ms": r["ms"][kname], "plain_ms": r[plain], "bound_ms": r["bound"][kname][0],
                "bound_by": r["bound"][kname][1], "library_ms": r[library], "kernel_route": "wgmma",
                "head_dim": hd, "template": fa.template_head_dim(hd), "shape": r["shape"],
                "head_ulps": by_hd[str(hd)]["head_ulps"], "model": model_name,
                "encode_launches": path["encode"]["launches"][kname],
                "library_call": "SDPA forward, boolean mask" if kname == "K11" else
                                f"SDPA backward alone ({r['sdpa_backward_backend']})"})
            if kname == "K12":
                kernels[-1]["di"] = {"launches": path["train"]["launches"]["flash rows"], "ms": r["ms"]["rows"],
                                     "bound_ms": r["bound"]["rows"][0], "bound_by": r["bound"]["rows"][1]}
            if kname == "K11":
                kernels[-1]["retriever"] = path
    # phase 13 (mesh.model = 2): K9 on a position's slices; the train steps', the encode's and the request's
    # launches at 12 / 2 heads a position
    by_name = {k["name"]: k for k in kernels}
    by_name["K9 hw_dropout"]["tensor_parallel"] = {
        "slices": tp["k9"], "train_launches": tp["train"]["launches"]["K9"],
        "train_slice_launches": tp["train"]["launches"]["K9 slice"], "ce_launches": tp["ce"]["launches"]["K9"],
        "ce_slice_launches": tp["ce"]["launches"]["K9 slice"]}
    for kname, name in (("K11", "K11 flash_attention forward"), ("K12", "K12 flash_attention dK/dV"),
                        ("K13", "K13 flash_attention dQ")):
        by_name[name]["tensor_parallel_launches"] = {"train": tp["train"]["launches"][kname],
                                                     "ce": tp["ce"]["launches"][kname]} | (
            {"encode": tp["serve"]["encode_launches"][kname]} if kname == "K11" else {})
    by_name["K1 flat_scan_fused"]["tensor_parallel_launches"] = tp["serve"]["serve_launches"]["K1"]
    # phase 1b's timings at ColBERT dims that are not multiples of 16; launches: phase 15's served and flat
    # passes at dim 312 (h 100 is no configuration's: 0)
    fv = tinybert["flat_variants"]
    paths_312 = {("K1", "bfloat16"): tinybert["serve"]["launches"], ("K2", "bfloat16"): fv["unfused"]["launches"],
                 ("K1", "int8"): fv["int8"]["launches"]}
    for r in dims.values():
        for kname, name, line in (("K1", "K1 flat_scan_fused", 157), ("K2", "K2 flat_maxsim_scan", 59)):
            kernels.append({
                "name": f"{name}, h {r['h']} {r['dtype']}", "route": "cuda",
                "source": "colbert_tpu_torch/csrc/flat_scan.cu", "replaces": f"colbert_tpu/ops/flat_scan.py:{line}",
                "launches": paths_312.get((kname, r["dtype"]), 0) if r["h"] == 312 else 0,
                "max_abs_err": r[f"{kname}_max_abs_err"], "ms": r[f"{kname}_ms"], "plain_ms": r[f"{kname}_plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None, "kernel_route": "wgmma",
                "table_by": r["table_by"], "yardstick_cublas_ms": r["cublas_ms"], "docs": r["docs"]})
    k4 = tinybert["ann"]["k4"]
    kernels.append({
        "name": f"K4 maxsim_rerank_uniform, dim {k4['dim']}", "route": "cuda",
        "source": "colbert_tpu_torch/csrc/rerank.cu", "replaces": "colbert_tpu/ops/rerank_pallas.py:26",
        "launches": tinybert["ann"]["launches"]["K4"], "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"], "library_ms": None,
        "kernel_route": "wgmma", "table_by": k4["table_by"],
        **{key: k4[key] for key in ("candidates", "valid", "distinct_docs")}})
    log(json.dumps({"phase11": {"model_options": options, "dense": dense, "real_text": real_text, "s": t11}}))
    log(json.dumps({"phase13": {k: v for k, v in tp.items() if k != "k9"}}, default=str))
    log(json.dumps({"host_runtime": host_runtime}))
    log(label)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
