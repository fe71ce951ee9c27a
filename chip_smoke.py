#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and hold its kernels to
their plain versions.

    python3 chip_smoke.py

1. Prints the card's name and power limit as nvidia-smi reports them.
2. Builds the kernels of the serving and training paths from
   src/repro_torch/csrc for sm_90a (one nvcc per source, started together,
   while the full-width datasets are generated) and prints ptxas's
   register/spill report; fails if the quant-pack, dequant-matmul,
   dequant-unpack or segment-sum kernels spill.
3. For each kernel, at the shapes its path gives it, compares the kernel
   with its plain PyTorch version on the same inputs on the card:
     quant_pack  codes, scale and zero bit-identical to the plain version
                 and across two calls (70,679x256 and 24,915x256, bits 8
                 and 4, nearest and SR; KGAT's 184,166x64 INT2 SR site;
                 odd widths and padded packs; ``x[1:]`` of a table at an
                 odd width, its base 4 bytes off 16; a row wider than a
                 stage, 12,288, and one wider than the ring, 40,000; a
                 small table, 2,708x16), each with the plan its launch
                 follows (route, rows a tile, shared memory, grid); the
                 SASS instructions an element of every kernel's codes and
                 min/max loops (cuobjdump -sass), and for every timed
                 quant-pack case the instructions the SMs issue an element
                 in the bound's time beside them; timed at the serving
                 store's 70,679x256 INT8 and the KGAT site with the device
                 time (held stream); every timed quant-pack case here and
                 in 12-14 rotates its calls over three copies of its input
                 where the input fits the 50 MB L2, and reports its device
                 time;
     spmm        <= 1e-5 relative (max |diff| / max |plain|) on the
                 full-width KGAT graph at the main path's three shapes (d 64,
                 d 64 in the transpose direction, d 1: the edge softmax's
                 ones column), and bit-identical across two runs;
     topk_score  indices and values bit-identical on integer-valued inputs
                 full of ties; on random inputs values <= 1e-5 relative and
                 indices equal except between scores within that tolerance;
                 at B 1, 8 and 128 (k 20), and both again at k 200 (the
                 merge-rounds route);
     sddmm       <= 1e-5 relative on the full-width graph at d 64 (the
                 FP32 layers' gradient) and d 1 (the edge softmax's ones
                 column) and bit-identical across two runs; timed at both;
     segment_sum the attention's gather backward (port-only, no TPU
                 kernel; csrc/segment_sum.cu): <= 1e-5 relative and
                 bit-identical across two runs on the full-width graph's
                 groupings by destination and by source (d 64), by
                 relation (d 64 and d 4, chunked levels) and by
                 destination at d 1; the library call is index_add_; for
                 each grouping the longest run, the chunk C, the CUDA
                 kernels each level's launch starts, and the device time
                 (held stream) of the kernel, of index_add_ and of the
                 SPMM route (the SPMM kernel with gat := perm, which the
                 port took before csrc/segment_sum.cu) beside the bound; the relation
                 grouping as one level, timed beside its chunk levels;
     dequant_sddmm  the same at bits 8/4/2/1 (d 64) and on a padded pack
                 (d 37, bits 2); timed at INT2 and INT8, d 64;
     dequant_matmul <= 1e-5 relative at R 184,166, 64 x 64, bits 8/4/2/1,
                 a padded pack (d 37), and rows offset far from 0 (INT8,
                 INT2), bit-identical across two runs; timed at INT2 with
                 its device time (held stream) and the device time of each
                 of its two CUDA kernels (torch.profiler);
     coarse_topm values and indices bit-identical at I 24,915, d 256, INT8
                 and INT4, on ties and random inputs, at B 1, 8 and 128
                 with m 80 and at B 8 with m = n_items, and on a tier-2
                 shard's table (12,458 items, B 8, m 80);
     dequant_unpack bit-identical on the item table (INT8, INT4, and an
                 unaligned base), bits 2/1 and padded packs, every row and
                 through the fused row gather (the re-rank's 640 candidate
                 ids, int32 and int64); timed on the item table and on the
                 re-rank's 640 rows, fused and on the select-then-unpack
                 route, with device times (held stream);
   and times kernel, plain version and (where one PyTorch call computes the
   same function) that call, as medians of CUDA-event timings (which read
   the host's pace where a call's launches outlast its device work), beside
   the bound: max(bytes / 3.35 TB/s, ops / peak), the H100 SXM's published
   peaks (``launch.roofline``'s "h100" profile), with the bytes and
   operations of the kernel module's cost function (``spmm_cost``,
   ``quant_pack_cost``, ...: each input read once, each output written
   once; the dry run's roofline counts with the same functions). The peak
   is the fp32 rate outside the tensor cores (67 TFLOP/s), except for
   coarse_topm (its dot multiplies int8 query codes by unsigned codes and
   is exact at the int8 tensor-core rate, 1,979 TOP/s) and dequant_matmul
   (three exact bf16 products at the bf16 tensor-core rate, 989 TFLOP/s).
   For topk_score, coarse_topm and
   dequant_matmul it also prints the device time of the kernel and of the
   library call (20 calls queued while a spinning kernel holds the stream,
   then run back to back between two CUDA events: no host gaps); for
   topk_score and coarse_topm also the CUDA kernels one wrapper call
   launches, counted by the C entry point at each launch and held to the
   kernel's own plan (at most 2 at k <= 128), and as torch.profiler reads
   them in 8 calls with 25 ms of idle time on each side of the call
   (each read must see the plan's count) and in 8 bare calls (the
   reads that lost an event are printed). The main path runs the top-K
   and coarse kernels at the planner's query tiles (an empty autotune
   cache of its own, no sweeps). For
   top-K at B 1, 2 and 4 it also prints the device time at each query tile
   (8, 16, 32), the results bit-identical.
4. Cross-checks the reduced KGAT rollout on the card against the CPU.
5. Drives the main path at full width through ``serve_kgnn``: the paper's
   KGAT config (70,679 users, 113,487 entities, 80 relations, d 64, 3
   layers, concat readout) on the synthetic Amazon-Book-sized CKG, random
   seeded weights, FP32 rollout, INT8 store, engine warmup and a burst of
   requests, streaming eval over all users, dense reference on the first
   8,192 (streaming and dense within 1e-6), the eval's time printed.
   Launch counts are reset just
   before and read just after; every kernel must have launched.
6. Holds what the main path served against plain versions at full width:
   a second rollout with the kernels against one with the plain SPMM
   (<= 1e-5 relative), the served store against the plain quantizer on
   that rollout (bit-identical), and the engine's responses for a sample of
   users against the plain top-K on the served store (as in 3).
7. Drives the tier-2 serving path at full width through ``serve_kgnn``
   (counts reset just before, read just after; every kernel of the path
   must have launched): two-stage C 4, 2 item shards, a 4,096-entry cache,
   400 zipfian requests (a 1.1, seed 0), 2 FP32 BPR steps, a re-roll and a
   delta refresh, a second burst. Prints QPS and p50/p99 beside a
   single-stage engine's on the same requests, the stage times, the
   candidate share and the cache hit rate. Checks the live store against
   the new rollout (bit-identical) and every cache hit: its stamp is the
   live version and it agrees with a fresh score (as in 3). Holds the
   coarse kernel to its plain version on the served store's two shard
   tables (12,457 and 12,458 items) with the burst's users and exclusions
   at batch 1/2/4/8 and m 80 (bit-identical), and the first burst's
   responses for 256 users to two-stage retrieval run on the plain
   versions per shard and merged on the host (as in 3). Then prints
   two-stage recall@20 against single stage on all users (both phases'
   times printed) and holds the
   m = n_items anchor on 256 users to the single-stage kernel (indices
   equal except between scores within 1e-5 relative). [rerank]: the
   two-stage responses for 256 of the burst's users on both shard tables
   with the re-rank's fused row gather against the select-then-unpack
   route, bit-identical, beside the recall ratio and the refresh check.
8. Drives the training path at full width through ``train_model``: the same
   config and graph, BPR batch 1024, Adam, seed-0 parameters, a few steps
   each under FP32, INT8, INT4 and INT2 (stochastic rounding). Launch
   counts are reset just before and read just after each schedule's run;
   every kernel of its path must have launched. Prints per schedule the
   losses (finite), the median step time, peak allocated memory, the ACT
   bytes of the recorded residuals and their ratio to FP32, and launches
   per step by kernel.
9. Profiles one INT2 training step (torch.profiler, CUDA activity): device
   time by kernel, the step's device busy time and idle share; fails if
   the step launches an index_add_ scatter kernel (indexFunc*).
   [train-kg]: three reduced INT2 steps of KGCN, KGIN and R-GCN on the card
   against the CPU's plain versions (losses within 1e-4), then each at full
   width on the same graph (KGCN and KGIN: the paper's configs, d 64, 3
   layers, readout sum; R-GCN: KGAT's config with 4 bases, readout sum),
   3 steps under FP32 and INT2, batch 1024, Adam, counts reset just before
   and read just after each run: losses finite, every kernel of the path
   launched, the ACT bytes exactly those of ``model_sites`` (one (nodes, d)
   residual per site and layer); prints median step time, peak allocated
   memory, ACT bytes against FP32 and launches per step; then profiles one
   INT2 step of each (as above).
   [determinism]: two full-width steps from one state (parameters and Adam
   moments after a first step) on one batch, for KGAT under FP32 and INT2
   and for KGCN, KGIN and R-GCN under INT2, without
   torch.use_deterministic_algorithms: loss, parameters and moments
   bit-identical.
10. One full-width step's gradients with the kernels against the same step
   with every kernel's plain version, from the same seeds, parameters and
   batch (the plain steps under torch.use_deterministic_algorithms: they
   still add with index_add_). FP32: both against the same step run in
   float64; per parameter the kernels' error (rms of the difference over
   the rms of the float64 gradient) must be within four times the plain
   versions' error, or within 1e-5 (readings 1.1-1.9 on correct kernels).
   Summation orders differ between the two and the backward cancels
   terms, so each is off float64 by up to about 1e-3 of max |grad|
   (printed beside the rms), and which of the two lands nearer float64 for
   one parameter is chance: the margin stands between that spread and a
   wrong kernel. INT2: max |kernels - plain| within 1e-2 of that
   parameter's SR quantization noise, max |INT2 grad - FP32 grad|
   (readings up to 8.4e-4 on correct kernels; an SR code can flip
   between the two runs where the SPMM's summation order moves a
   quantization input across a rounding threshold; one flip moves a
   gradient by one rounding step of one residual element, the noise sums
   such steps over every element).
11. [replay]: full-width KGAT under FP32 and INT2: a trainer takes 3
   steps and checkpoints at step 2; step 3 from that checkpoint, restored
   from disk into a fresh trainer, on step 3's batch, must give the same
   loss, parameters and Adam moments bit for bit; a failure injected before
   step 3 must roll back to step 2 and end at step 3. Prints the time of a
   synchronous save and a restore of the full-width state.
   [launch]: the launcher (``repro_torch.launch.train.main``) at its default
   size on the card: kgcn 4 steps with --ckpt, --metrics-out and --trace,
   then 8 steps on the same directory, which must resume at step 4 (step
   lines 5-8); steps.jsonl, summary.json (the port's validator) and the
   trace's train spans must exist; --arch kgin on that directory must be
   refused.
12. Sampled minibatch training on the zipf-skewed graph of the same size
    (``gen_zipf_kg_dataset(**AMAZON_BOOK_ZIPF)``, generated beside the build
    and printed as [data-zipf]: nodes, edges, largest in-degree).
    [sampled-kernels] (run with the kernel checks of 3): on the first batch's
    outermost block (batch 256, fanouts 15,10,5: 135,168 <- 811,008 rows,
    675,840 slots, trailing all-pad blocks, masked slots), the SPMM (d 64,
    d 64 transposed, d 1), the fp32 SDDMM (d 64), the packed SDDMM (INT2),
    the dequant-matmul (INT2, the block's 135,168 destination rows) and the
    segment sum (by relation and by source at d 64, by destination at d 1)
    within 1e-5 relative of their plain versions and bit-identical across
    two runs, each timed beside its library call and bound
    (``sampled_shape`` in the kernels line); the segment sums also with
    the device times and run lengths of the full-graph lines, and the run
    fails if the sum by source at d 64 is slower than index_add_ in
    device time.
    [sampled]: ``training.tiering.run_sampled_training`` at the paper's
    width (fanouts 15,10,5, batch 256, hot_frac 0.1, Adam 3e-3, root seed
    1): KGAT FP32 and INT2 8 steps, KGCN, KGIN and R-GCN INT2 4 steps, KGAT
    INT2 with no hot tier 4 steps; counts reset just before and read just
    after each run, every kernel of the model's path launched, the same
    launches every step, losses finite, peak memory below the full-graph
    KGAT step's. Prints the median step, the four spans' medians
    (dispatch, gather, scatter, patch), peak memory, hit rate, rows per
    step, hot-tier and table MiB, ACT bytes, launches per step, and the
    rows-per-step ratio of hot_frac 0.1 to hot_frac 0.
    [sampled-determinism]: two KGAT INT2 runs of 4 steps from one seed and
    one on the sequential schedule (no prefetch, no patch): losses, dense
    parameters and the flushed entity table bit-identical; the first run
    under torch.profiler: no index_add_ kernel, device busy time a step and
    idle share printed.
    [sampled-reduced]: three reduced sampled INT2 steps of each KG model on
    the card against the CPU's plain versions, losses within 1e-4.
13. Several ranks sharing the card (``--mesh``; gloo, since NCCL refuses
    two ranks on one card). [shard-kernels] (run with the kernel checks of
    3): every training kernel of 12 and the quant-pack on the smaller
    shard of the full-width graph split over ``data=2`` (92,083 rows <-
    184,160 halo rows, 3,548,208 slots of which 441,602 masked pads) as in
    12 (``shard_shape`` in the kernels line). [dp]: single-device
    references first (the FP32 rollout, the FP32 step's loss and
    gradients, seed 0, batch 1024, root seed 1; ``dp_references``), then
    one spawn a mesh, ``data=2`` and ``data=2,model=2``, each rank running
    ``dp_rank_phase``: the sharded FP32 rollout (within 1e-6 relative; bit
    for bit is printed), the exact all-reduce step's loss (1e-5 relative)
    and gradients (1e-3 of each leaf's max |grad|) against the
    references, then through the launcher's ``train_rank`` 3 steps each of
    FP32 and INT2 with the int8 all-reduce and FP32 with the fp32
    all-reduce (Adam 3e-3; counts reset just before and read just after
    each run on each rank; every kernel of the path launched on every
    rank; the ranks' losses equal and their parameter copies bitwise
    equal after every step; the exact run's losses within 1e-4 of the
    [train] run's, the int8 runs' first loss within 1e-5 and their last
    below their first), then on ``data=2`` one reduced INT2 step of KGCN,
    KGIN and R-GCN and [dp-retry]: a reduced KGAT INT2 run of 4 steps
    (checkpoints at step 2) in which rank 1 fails step 3; both ranks must
    log that one failure and roll back to step 2, and the run's losses
    must equal, bit for bit, those of a run with no failure on the
    batches the failed run kept. Every ``train_rank`` run checkpoints, each
    to its own temporary directory. Prints the backend and route, each shard's edges and halo
    rows, each rank's peak memory, the median step (N ranks sharing one
    H100) and the all-reduce bytes a step, int8 and fp32; profiles one
    INT2 step on every rank (rank 0's wall, device busy time, idle share,
    kernels and the host time in the collectives printed; fails on an
    index_add_ scatter kernel).
14. The GCN (gcn-cora, ``build_step("gcn-cora", shape=...)`` through
    ``launch.train.train_model``; Adam 1e-2, seed-0 parameters, root seed
    1). The ogbn-products-sized graph and its layout and the Reddit-sized
    graph and its CSR are made on the host beside the build
    ([data-gcn]); each ``cora_like`` with the ``avg_deg`` nearest the
    shape's edge count (no edge cut). [gcn]: ``full_graph_sm`` (2,708
    nodes, d 1,433 -> 16 -> 7) and [gcn-products]: ``ogb_products``
    (2,449,029 nodes, d 100 -> 16 -> 47): each kernel at the step's
    shapes against its plain version (quant_pack codes bit-identical, the
    SPMM both directions and the dequant-matmul within 1e-5 relative, all
    bit-identical twice, timed), FP32 and INT2 runs of 8 and 3 steps
    (counts reset just before and read just after each; losses finite and
    falling; exactly ``path_kernels("gcn", ...)`` launched, the same every
    step; median step, the run's wall time a step, peak memory, ACT bytes
    against FP32), two steps from one state bit-identical, and one
    step's gradients against the plain versions' step (FP32 within 1e-5
    of max |grad|, INT2 within 1e-2 of the SR noise, as in 10).
    [gcn-sampled]: ``minibatch_lg`` (232,965 nodes, the reference's
    sharded cell's d 602 and 41 classes, batch 1,024, fanouts 15,10):
    the first batch's host time and blocks, the SPMM (d 602), quant-pack
    and dequant-matmul on its outermost block and the SPMM both ways on
    the inner one against their plain versions, FP32 and INT2 4 steps (as
    above, the loss not required to fall; the sampler's host time a batch
    printed), two steps on one batch bit-identical. [gcn-molecule]: 128
    graphs of 30 nodes and 64 edges plus self loops (d 32, 2 classes):
    the readout's segment sum against its plain version, one INT2 forward
    and backward timed, then profiled with the counts reset just before
    and read just after: the path's kernels and the segment sum launched,
    no index_add_ kernel.
15. The recsys family (FM, Wide&Deep, DLRM, xDeepFM; seed-0 parameters
    drawn on the card, Adam 1e-3, root seed 1, ``criteo_batches(seed=3)``).
    [recsys-kernels]: the quant-pack (INT2 SR) at 40,960 x 7,800 and x
    1,521 (xDeepFM's CIN residuals at batch 4,096), 4,096 x 13 and 4,096 x
    1,280; the dequant-matmul (INT2) at (40,960, 7,800, 200), (40,960,
    1,521, 200), (4,096, 13, 512) and (4,096, 256, 1); the top-K at d 11,
    33 and 129 over 1,000,000 INT8 candidates (B 8, k 32); the segment
    sum on the lookup plan of each model's first batch at 4,096 (the
    table gradient by distinct row: 106,496-163,840 positions, hub rows
    of more than a chunk, at the embedding width and at width 1), and the
    whole lookup forward and backward (``gather_rows`` with ``rows=``)
    against its plain version and ``index_add_``: each against its plain
    version, twice bit-identical, timed beside its library call and bound
    (``recsys_shape`` in the kernels line). [recsys]: three reduced INT2
    steps of each model on the card against the CPU (losses within 1e-4;
    ``reduced_recsys_losses`` of tests/test_torch_cuda.py); each model at full
    width (xDeepFM and FM 33,764,241 table rows, Wide&Deep 12,693,600, DLRM at
    MLPerf widths with each table capped at 2,097,152 rows: 13,693,358), batch
    4,096, 6 steps under FP32 and INT2 through ``train_model`` (counts reset
    just before and read just after; exactly ``path_kernels`` launched, the
    same every step; median step, peak memory, ACT bytes against FP32, losses,
    AUC on a held-out batch; one INT2 step of each profiled: device busy time,
    idle share, the longest kernels, no index_add_); xDeepFM at batch
    16,384, 3 steps under FP32 and INT2 (the peak memory ACT sells at the
    CIN; INT2's peak must be lower); [determinism]: two xDeepFM INT2 steps
    from one state bit-identical. [recsys-serve]: ``serve_recsys``
    p50/p99 of each model at ``serve_p99`` (512) and ``serve_bulk``
    (262,144; xDeepFM 16,384: at 262,144 two of its (B, k, 7,800) CIN
    inputs, 81.8 GB each, are held at once). [recsys-retrieval]: the
    two-stage path, xDeepFM's towers over 1,000,000 candidates of field 2,
    INT8 store, top-32 through the engine for 200 requests (the quant-pack
    and top-K launched), the first 16 responses against the plain top-K on
    the served store, the recall against a dense fp32 top-32 of the same
    towers and the re-rank's p50/p99. The phase prints its seconds.
16. The LM families (dense GQA and MoE transformers; seed-0 weights drawn
    on the card in bf16, Adam 1e-3, root seed 1, ``lm_batches(seed=0)``;
    the card configs: published widths at 2 layers, batch 2 x 4,096).
    [lm-kernels]: the quant-pack (INT2 SR) at each block's saved input,
    8,192 x 5,120 (stablelm-12b) and 8,192 x 2,048 (moonshot-v1-16b-a3b),
    from bf16 (as the step hands it over), from bf16 through an fp32 copy
    and from fp32, bit-identical to the plain version; the segment sum on
    each config's embedding gradient (8,192 positions by distinct token
    id) against its plain version and beside ``index_add_`` (``lm_shape``
    in the kernels line). [lm]: three reduced INT2 steps of each of the
    five archs on the card against the CPU (losses within 1e-5; exactly
    ``path_kernels`` every step; ``reduced_lm_losses`` of
    tests/test_torch_cuda.py). [lm-train]: stablelm-12b and
    moonshot-v1-16b-a3b at the card configs, 4 steps under FP32 and INT2
    through ``train_model`` (finite losses, the first near ln V + 0.5,
    exactly the path's kernels, median step, peak memory, ACT bytes as the
    reference prices them and as the block stack's graph holds them,
    measured; one INT2 step profiled, no index_add_; [determinism]: two
    INT2 steps from one state bit-identical; the bf16 forward against the
    same weights in fp32 within ``LM_BF16_TOL``, for the MoE at the tokens
    routed the same in both, with the share routed otherwise at most
    ``LM_ROUTER_FLIP_MAX``). [lm-serve]: ``serve_lm``: stablelm-12b's
    prefill of 1 x 32,768 tokens, its decode at batch 8 (a 32,704-token
    prompt, 64 steps) with the bf16 cache and the int8 cache (ms a token,
    cache bytes, int8 at most 0.53x bf16), then both caches teacher-forced
    with the bf16 run's tokens (the largest logit difference and top-1
    agreement),
    moonshot-v1-16b-a3b at batch 8, a 4,096-token prompt, 32 steps. The
    phase prints its seconds.
17. [tooling]: the autotuner swept over the query tiles (8, 16, 32) at B
    1, 8 and 128 over KGAT's 24,915-item INT8 table (top-K k 20, coarse m
    80) and at B 8, k 32 over 1,000,000 INT8 rows of width 33: every
    tile's values and indices the default's bit for bit, each candidate's
    device time, a second ``Autotuner`` on the cache returning the winners
    with no sweep; ``launch.dryrun`` on KGAT INT2 over this script's CKG,
    xDeepFM INT2 and stablelm-12b INT2 (2 layers): each record ok, its
    peak and one copy of the parameters (the training phase's caller holds
    the untrained ones beside the copy it trains) within 5% of the
    training phase's peak, stablelm's traced FLOPs within
    5% of ``lm_train_flops``, then ``launch.report`` renders the records;
    ``embedding_bag`` over 4,096 weighted bags of 1-64 lookups from a
    2,097,152 x 128 table (sum and mean) against its plain versions, two
    segment sums and no index_add_; the ``train_kgnn`` example for 20
    steps at scale 1.0 (600k entities x d 160), loss finite and falling.
    The phase prints its seconds.
18. Prints the kernels JSON line (launches per path: serve, serve_tier2,
    train_<schedule>, train_<model>_<schedule>, train_sampled_<model>_
    <schedule>, train_dp_<mesh>_<schedule>_<all-reduce>, train_gcn_
    <schedule>, train_gcn_products_<schedule>, train_gcn_sampled_
    <schedule>, train_gcn_molecule, train_recsys_<arch>_<schedule>,
    train_recsys_xdeepfm_b16384_<schedule>, serve_recsys_retrieval,
    train_lm_<arch>_<schedule>; ``gcn_shape``, ``recsys_shape`` and
    ``lm_shape``: each kernel's checks and times at the GCN, recsys and LM
    shapes), the card's line, then last the ok line.

    python3 chip_smoke.py --quant-pack-against DIR

builds DIR's src/repro_torch/csrc/quant_pack.cu (another tree, e.g. the
parent commit unpacked with ``git archive``) beside this tree's and, at every
shape this script times the quant-pack at, holds the two to the same bits
and prints their device times in turns (other, this, this, other); nothing
else runs.

    python3 chip_smoke.py --serve-host-against DIR

times the host's share of a served top-K and coarse call (``ops.topk`` and
``ops.coarse_topm`` at B 1 and 8 over the served item table, queued behind a
held stream) for DIR's tree and this one, each in a process of its own, in
ten pairs whose first process alternates, with the medians, the pairs this
tree wins and the other tree's spread; nothing else runs.

Exits non-zero, printing no result, without CUDA, outside a checkout of the
repository, or when any check fails.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HW = "h100"                    # launch.roofline's profile of the bounds
TOL = 1e-5
L2_BYTES = 50e6                # H100 L2: an input this small is rotated
ROTATION = 3                   # distinct inputs the timed calls cycle over
INSTR_RATE = 4 * 132 * 1.98e9 * 32   # H100 thread-instructions a second
LIB_SUM_TOL = 1e-4             # index_add_'s atomic fp32 sums vs float64
DEV = "cuda"
# the paper's Amazon-Book-sized CKG (KGAT config: configs/kgnn_paper.py)
DATASET = dict(n_users=70679, n_items=24915, n_attrs=88572, n_relations=39,
               n_triples=2557746, inter_per_user=12, seed=0)
QUANT_ROWS = (70679, 24915)    # the store's user and item tables
SERVING = ("quant_pack", "spmm", "topk_score")
TIER2_KERNELS = SERVING + ("coarse_topm", "dequant_unpack", "sddmm",
                           "segment_sum")
TRAIN_BATCH = 1024
TRAIN_STEPS = 4              # per schedule
SCHEDULES = ("fp32", "int8", "int4", "int2")
KG_MODELS = ("kgcn", "kgin", "rgcn")   # the KG layers beside KGAT
KG_SCHEDULES = ("fp32", "int2")
KG_STEPS = 3                 # per model and schedule
# sampled minibatch training (--sample) on the zipf graph of that size
SAMPLED_FANOUTS = (15, 10, 5)
SAMPLED_BATCH = 256
SAMPLED_RUNS = (("kgat", "fp32", 8, 0.1), ("kgat", "int2", 8, 0.1),
                ("kgcn", "int2", 4, 0.1), ("kgin", "int2", 4, 0.1),
                ("rgcn", "int2", 4, 0.1), ("kgat", "int2", 4, 0.0))
GRAD_FP64_RATIO = 4.0
# the GCN (gcn-cora) on its four shapes: (tag, shape, steps per schedule)
GCN_FULL = (("gcn", "full_graph_sm", 8), ("gcn-products", "ogb_products", 3))
GCN_SAMPLED_STEPS = 4
# several ranks sharing the one card (training.data_parallel, gloo)
RECSYS_ARCHS = ("fm", "wide-deep", "dlrm-mlperf", "xdeepfm")
RECSYS_BATCH = 4096          # xDeepFM's published batch (arXiv:1803.05170)
RECSYS_STEPS = 6             # per model and schedule
RECSYS_ROW_CAP = {"dlrm-mlperf": 2097152}   # 96.1 GB of table cut to 7.0
RECSYS_PEAK_BATCH = 16384    # xDeepFM's peak-memory runs
RECSYS_PEAK_STEPS = 3
RECSYS_HELDOUT_SEED = 4      # the held-out AUC batch (training uses 3)
RECSYS_P99_REQUESTS = 50
RECSYS_BULK_REQUESTS = 10
RECSYS_XDEEPFM_BULK = 16384  # serve_bulk for xDeepFM (its CIN input)
RECSYS_RETRIEVAL = dict(n_cand=1_000_000, k=32, requests=200,
                        item_field=2, bits=8)
# the LM families: the card configs (published widths in bf16, 2 layers,
# batch 2 x 4,096; models.registry.lm_config)
LM_ARCHS = ("mistral-large-123b", "codeqwen1.5-7b", "stablelm-12b",
            "moonshot-v1-16b-a3b", "grok-1-314b")
LM_TRAIN = ("stablelm-12b", "moonshot-v1-16b-a3b")
LM_FULL_LAYERS = {"stablelm-12b": 40, "moonshot-v1-16b-a3b": 48}
LM_STEPS = 4                 # per model and schedule
LM_FIRST_LOSS_TOL = 0.25     # the first loss vs ln V + 0.5
LM_BF16_TOL = 5e-2           # bf16 logits vs fp32, of max |logit|
LM_BF16_LOSS_TOL = 1e-2      # bf16 loss vs fp32, relative
LM_ROUTER_FLIP_MAX = 0.30    # MoE tokens routed otherwise in bf16, share
LM_PREFILL = (1, 32768)      # prefill_32k: batch 32 cut to 1
LM_DECODE = (8, 32768, 64)   # decode_32k: batch 128 cut to 8; steps
LM_MOE_SERVE = (8, 4096, 32)
DP_MESHES = ("data=2", "data=2,model=2")
DP_RUNS = (("fp32", "int8"), ("int2", "int8"), ("fp32", "fp32"))
DP_STEPS = 3                 # per run: (schedule, all-reduce)
DP_RETRY_STEPS, DP_RETRY_EVERY = 4, 2   # [dp-retry]: checkpoints at step 2
DP_RETRY_FAIL = (1, 3)       # rank 1 fails step 3: every rank rolls back to 2
DP_LOSS_TOL = 1e-6           # exact all-reduce losses vs one device's
DP_GRAD_TOL = 1e-5           # exact all-reduce gradients vs one device's
DP_INT8_SLACK = 1e-3         # int8 mean within (1 + this) codes of exact
DP_INT8_Z = 6.0              # |bias| of the int8 mean, in standard errors
DP_INT8_LOSS_TOL = 3e-3      # int8 runs' losses vs the plain int8 run's
GRAD_NOISE_SHARE = 1e-2
ENGINE_BATCH = 8               # the engine's largest bucket
EVAL_BATCH = 128               # the streaming eval's user chunk
TOPK_BATCH = (1, ENGINE_BATCH, EVAL_BATCH)
LARGE_K = 200                  # past the threshold route's 128: merge rounds
COARSE_BATCH = TOPK_BATCH
COARSE_M = 4 * 20              # two-stage C 4 at k 20
SHARD_ITEMS = 12458            # the larger of the tier-2 path's two shards
QUERY_TILES = (8, 16, 32)      # csrc/topk_select.cuh kQTiles
TIER2 = dict(two_stage=4, item_shards=2, cache=4096, refresh_steps=2)
ZIPF_A = 1.1
ANCHOR_USERS = 256
PROFILED_BATCHES = 20
REQUESTS = 400
DENSE_USERS = 8192
SERVED_USERS = 256           # engine responses held against plain top-K


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median per-call device time from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound_ms(c) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of one call of cost
    ``c`` (a kernel module's ``*_cost``, ``backend.KernelCost``) on the
    H100, the larger of its bytes over the memory rate and its operations
    over their type's peak (``launch.roofline``'s "h100" profile)."""
    from repro_torch.launch.roofline import get_hw, kernel_bound_ms

    return kernel_bound_ms(c, get_hw(HW))


def _cost_str(c) -> str:
    from repro_torch.launch.roofline import get_hw

    return (f"{c.bytes / 1e6:.3f} MB, {c.flops / 1e9:.3f} G ops at "
            f"{get_hw(HW)[f'peak_{c.peak}'] / 1e12:g} T/s")


# -- kernels against their plain versions -------------------------------------


def check_quant_pack(torch, qp, gen):
    """Codes, scale and zero bit-identical to the plain version at the
    store's tables (INT8, INT4, nearest and SR, an odd width), KGAT's INT2
    site (184,166x64), padded packs, a misaligned base (``x[1:]`` of a
    table at an odd width), a row wider than a stage and one wider than
    the ring, a small table (both on the warp-a-row route), two calls
    bit-identical. Timed at the
    serving store's 70,679x256 INT8 (the kernels line's shape) and KGAT's
    184,166x64 INT2 SR site: events and device time (held stream), inputs
    rotated where they fit the L2, the plan, and the SASS instructions an
    element of the route beside the bound's budget."""
    log("[quant_pack] kernel vs plain (codes, scale, zero bit-identical)")
    n_kg = DATASET["n_users"] + DATASET["n_items"] + DATASET["n_attrs"]
    cases = [(r, 256, b, s) for r in QUANT_ROWS for b in (8, 4)
             for s in (False, True)]
    cases += [(QUANT_ROWS[1], 255, 4, True), (4096, 37, 2, False),
              (4096, 37, 1, True), (n_kg, 64, 2, True), (n_kg, 64, 8, False),
              ("slice", 601, 2, True), (64, 12288, 2, True),
              (5, 40000, 4, False), (2708, 16, 2, True)]
    xs = {}
    for rows, d, bits, sr in cases:
        if rows == "slice":       # a row slice at an odd width: 4-byte base
            x = (torch.randn((16385, d), generator=gen, device=DEV)
                 * 0.3)[1:]
        else:
            x = xs.get((rows, d))
            if x is None:
                x = xs[(rows, d)] = torch.randn(
                    (rows, d), generator=gen, device=DEV) * 0.3
        seed = 0x5EED + bits
        got = qp.quant_pack_cuda(x, seed, bits=bits, stochastic=sr)
        again = qp.quant_pack_cuda(x, seed, bits=bits, stochastic=sr)
        ref = qp.quant_pack_plain(x, seed, bits=bits, stochastic=sr)
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        twice = all(torch.equal(g, a) for g, a in zip(got, again))
        plan = qp.quant_pack_plan(x.shape[0], d, bits=bits, stochastic=sr)
        log(f"  {x.shape[0]}x{d} bits={bits} {'sr' if sr else 'nearest'}"
            f"{' (x[1:], base 4 bytes off 16)' if rows == 'slice' else ''}:"
            f" {'bit-identical' if same else 'MISMATCH'}, two calls "
            f"{'bit-identical' if twice else 'DIFFER'}; {_plan_str(plan)}")
        check(same and twice, f"quant_pack {x.shape[0]}x{d} bits={bits} "
              f"sr={sr}: plain {same}, twice {twice}")
        del got, again, ref
    sass = quant_pack_sass()
    for key, v in sass.items():
        log(f"  SASS {key}: {_sass_str(v)}")
    entries = []
    for rows, d, bits, sr in ((QUANT_ROWS[0], 256, 8, False),
                              (n_kg, 64, 2, True)):
        label, _, kernel, plain, _, cost = quant_case(
            qp, xs[(rows, d)], 1, bits=bits, stochastic=sr)
        got, ref = kernel(), plain()
        err = max(float((g.float() - r.float()).abs().max())
                  for g, r in zip(got, ref))
        check(err == 0.0, f"quant_pack timed case {label} differs by {err}")
        del got, ref
        ms = time_ms(kernel, 50)
        plain_ms = time_ms(plain, 10)
        dev = device_ms(torch, kernel)
        bnd, by = bound_ms(cost)
        log(f"  time {label}: kernel {ms:.4f} ms (events), device "
            f"{dev:.4f} ms (held stream), plain {plain_ms:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}; {bnd / dev:.0%} of it)")
        entries.append(dict(
            name="quant_pack", route="cuda",
            source="src/repro_torch/csrc/quant_pack.cu",
            replaces="src/repro/kernels/quant_pack.py:39",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
            bound_by=by, library_ms=None, device_ms=dev,
            shape=f"{rows}x{d} bits {bits} {'sr' if sr else 'nearest'}"))
    entries[0]["sass_per_element"] = sass
    return _with_other_shape(*entries)


def _plan_str(plan):
    if plan["route"] == "rows":
        return f"route rows (a warp a row), grid {plan['grid']}"
    return (f"route tiles, {plan['rows_a_tile']} rows a tile, "
            f"{plan['stages']} stage buffers of {plan['stage_floats']} "
            f"elements, {plan['smem']} B shared, {plan['tiles']} tiles, grid "
            f"{plan['grid']}, {plan['lanes_a_row']} lanes a row")


def _sass_str(v):
    if not v:
        return "not counted"
    return "; ".join(
        f"{name} " + ", ".join(f"{n} instructions for {e} elements "
                               f"({n / e:.1f} an element)" for n, e in loops)
        for name, loops in v.items() if loops)


def _budget_str(v, bnd_ms, elements):
    """The SASS count an element of a route (its codes and min/max loops,
    the fewest and the most over their variants) beside the instructions
    an element the SMs can issue in the bound's time."""
    budget = INSTR_RATE * bnd_ms * 1e-3 / elements
    if not v or not all(v.values()):
        return f"SASS not counted, budget {budget:.1f} an element"
    lo = sum(min(n / e for n, e in loops) for loops in v.values())
    hi = sum(max(n / e for n, e in loops) for loops in v.values())
    return (f"SASS {lo:.1f}-{hi:.1f} instructions an element (codes and "
            f"min/max loops) against the {budget:.1f} the SMs issue in the "
            f"bound's time")


def _sass_loops(text):
    """Per function of a ``cuobjdump -sass`` listing, its instructions
    (address, text) and its loops (first, last address of each backward
    branch's range)."""
    funcs, cur, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs[m.group(1)] = {"ins": [], "labels": {}}
            labels, pending = cur["labels"], []
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            cur["ins"].append((addr, m.group(2)))
    out = {}
    for name, f in funcs.items():
        loops = []
        for addr, ins in f["ins"]:
            if "BRA" not in ins:
                continue
            m = re.search(r"\(?(\.L_x_\d+)\)?", ins)
            tgt = (f["labels"].get(m.group(1)) if m else None)
            if tgt is None:
                m = re.search(r"BRA\S*\s+(?:\S+\s+)?(0x[0-9a-f]+)", ins)
                tgt = int(m.group(1), 16) if m else None
            if tgt is not None and tgt <= addr:
                loops.append((tgt, addr))
        out[name] = (f["ins"], loops)
    return out


def _inner_loops(ins, loops, count):
    """(instructions, elements) of each loop with elements (``count`` of
    its body) that holds no smaller loop with elements."""
    found = []
    for lo, hi in sorted(set(loops)):
        body = [t for a, t in ins if lo <= a <= hi]
        n = count(body)
        if n:
            found.append((lo, hi, len(body), n))
    return [(size, n) for lo, hi, size, n in found
            if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                       for a, b, _, _ in found)]


def _codes(body):          # one F2I a code
    return sum(1 for t in body if re.match(r"(@\S+\s+)?F2I", t))


def _minmax_reads(body):   # elements read by a loop with FMNMX and no F2I
    if _codes(body) or not any("FMNMX" in t for t in body):
        return 0
    return sum(4 if ".128" in t else 2 if ".64" in t else 1
               for t in body if re.match(r"(@\S+\s+)?LD[SG]", t))


@functools.lru_cache(maxsize=None)
def quant_pack_sass():
    """Static SASS instructions an element of each quant-pack kernel (the
    tile route and the warp-a-row route, per bit-width and rounding), from
    ``cuobjdump -sass`` of the built library: its codes loops (the
    innermost loops with F2I, one a code: a variant each for rows of whole
    words, for pads and for packs under 4 bytes) and its min/max loops (the
    innermost with FMNMX and no F2I, elements counted by their loads),
    instructions over elements. Cached: the library does not change within
    a run."""
    from repro_torch.kernels import backend

    tool = Path(backend._nvcc()).with_name("cuobjdump")
    try:
        text = subprocess.run(
            [str(tool), "-sass", str(backend.lib_path("quant_pack"))],
            capture_output=True, text=True, check=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as err:
        log(f"  SASS: cuobjdump failed ({err})")
        return {}
    out = {}
    for name, (ins, loops) in _sass_loops(text).items():
        m = re.search(r"quant_(tile|rows)_kernelILi(\d)ELb([01])E([ft])",
                      name)
        if not m:
            continue
        key = (f"{m.group(1).replace('tile', 'tiles')} INT{m.group(2)} "
               f"{'sr' if m.group(3) == '1' else 'nearest'}"
               + (" bf16" if m.group(4) == "t" else ""))
        out[key] = {"codes": _inner_loops(ins, loops, _codes),
                    "min/max": _inner_loops(ins, loops, _minmax_reads)}
    return out


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _spmm_library(torch, layout, ew, transpose):
    """cuSPARSE's operand: the layout's edges as a coalesced CSR (A, or Aᵀ
    for the transpose direction) with the edge weights (ones where ``ew``
    is None) as values."""
    m = layout.meta
    perm = layout.perm_blk.reshape(-1)
    real = perm < m.n_edges
    src = layout.src_blk.reshape(-1)[real].long()
    dst = layout.dstg_blk.reshape(-1)[real].long()
    val = (torch.ones(src.shape[0], device=src.device) if ew is None
           else ew[perm[real].long()])
    idx, shape = ((torch.stack([src, dst]), (m.n_src, m.n_dst)) if transpose
                  else (torch.stack([dst, src]), (m.n_dst, m.n_src)))
    with warnings.catch_warnings():      # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, val, shape).coalesce() \
            .to_sparse_csr()


def check_spmm(torch, sp, g, x, gen):
    """The main path's three SPMM shapes on the full-width graph: a layer's
    aggregation (d 64), its input gradient (d 64, transpose direction) and
    the edge softmax's denominators (a ones column, d 1)."""
    log("[spmm] kernel vs plain on the full-width KGAT graph")
    m = g.layout.meta
    ew = torch.rand(m.n_edges, generator=gen, device=DEV)
    rel1 = _rel(sp.spmm_cuda(x, None, g.layout),
                sp.spmm_plain(x, None, g.layout))
    log(f"  d={x.shape[1]} unweighted: rel {rel1:.3e}")
    check(rel1 <= TOL, f"spmm unweighted rel error {rel1} > {TOL}")
    gt = torch.randn((m.n_dst, x.shape[1]), generator=gen,
                     device=DEV) * 0.1
    ones = torch.ones((m.n_src, 1), device=DEV)
    entries = []
    for xin, tr in ((x, False), (gt, True), (ones, False)):
        d = xin.shape[1]
        label = f"d={d}{' transpose' if tr else ''}"
        out1 = sp.spmm_cuda(xin, ew, g.layout, transpose=tr)
        same = torch.equal(out1, sp.spmm_cuda(xin, ew, g.layout,
                                              transpose=tr))
        ref = sp.spmm_plain(xin, ew, g.layout, transpose=tr)
        rel, err = _rel(out1, ref), float((out1 - ref).abs().max())
        log(f"  {label} weighted: rel {rel:.3e} (max abs {err:.3e}), two "
            f"runs {'bit-identical' if same else 'DIFFER'}")
        check(rel <= TOL, f"spmm {label} rel error {rel} > {TOL}")
        check(same, f"spmm {label} is not deterministic across runs")
        a = _spmm_library(torch, g.layout, ew, tr)
        lib_err = _rel(torch.sparse.mm(a, xin), ref)
        check(lib_err <= TOL, f"library sparse.mm disagrees ({lib_err})")
        ms = time_ms(lambda: sp.spmm_cuda(xin, ew, g.layout, transpose=tr),
                     20)
        plain = time_ms(lambda: sp.spmm_plain(xin, ew, g.layout,
                                              transpose=tr), 5)
        lib = time_ms(lambda: torch.sparse.mm(a, xin), 20)
        n_out = out1.shape[0]
        log(f"  {label}: an uncached per-edge row gather would move "
            f"{m.n_edges * d * 4 / 1e9:.3f} GB")
        entries.append(_entry(
            "spmm", "spmm", "src/repro/kernels/spmm.py:91", err, ms, plain,
            lib, sp.spmm_cost(g.layout, d, transpose=tr),
            f"E={m.n_edges} n={n_out} {label} weighted",
            also_replaces="src/repro/kernels/spmm.py:180",
            library_call="torch.sparse.mm (CSR)"))
    return _with_other_shape(*entries)


def _topk_inputs(torch, quantize, gen, b, n_items, d, *, ties):
    if ties:
        from repro_torch.core.quant import QTensor, pack_bits

        codes = torch.randint(0, 4, (n_items, d), generator=gen,
                              device=DEV).to(torch.uint8)
        items = QTensor(pack_bits(codes, 8),
                        torch.ones((n_items, 1), device=DEV),
                        torch.zeros((n_items, 1), device=DEV), 8, d)
        q = torch.randint(-2, 3, (b, d), generator=gen,
                          device=DEV).to(torch.float32)
    else:
        items = quantize(torch.randn((n_items, d), generator=gen,
                                     device=DEV) * 0.3, 0, bits=8)
        q = torch.randn((b, d), generator=gen, device=DEV) * 0.3
    excl = torch.randint(0, n_items, (b, 12), generator=gen, device=DEV,
                         dtype=torch.int32)
    excl[:, 9:] = -1
    return q, items, excl


def kernels_per_call(torch, tk, fn, name, reads: int = 8):
    """CUDA kernels one call of ``fn`` launches (``name``: the wrapper's
    ``LAUNCH_COUNTS`` key): as the C entry point counts them at launch
    (``backend.CUDA_KERNEL_COUNTS``; must be the same every call), and as
    ``torch.profiler`` records them in ``reads`` calls each way: bare (the
    call at the very start of the capture window) and with 25 ms of idle
    time on both sides (``obs.profiling.profiled_kernels``).
    Returns (launch count, the bare reads' counts, the padded reads'
    counts)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import backend
    from repro_torch.obs.profiling import profiled_kernels

    fn()
    torch.cuda.synchronize()
    started, bare, padded = set(), [], []
    for _ in range(reads):
        before = backend.CUDA_KERNEL_COUNTS[name]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        started.add(backend.CUDA_KERNEL_COUNTS[name] - before)
        bare.append(sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and ("scan_kernel" in e.name
                             or "merge_" in e.name)))
        before = backend.CUDA_KERNEL_COUNTS[name]
        padded.append(len(profiled_kernels(fn)))
        started.add(backend.CUDA_KERNEL_COUNTS[name] - before)
    check(len(started) == 1, f"{name}: the launches counted {started} CUDA "
          f"kernels in calls of one shape")
    return started.pop(), bare, padded


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device time per call of ``fn`` without the host's launch gaps: the
    stream is held by a spinning kernel while the host queues ``calls``
    calls, so they run back to back between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    spin = int(1e8)                       # about 50 ms of the card's clock
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        t0 = time.perf_counter()
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        if queued < 0.02:                 # queued well inside the spin
            return a.elapsed_time(b) / calls
        spin *= 4
    raise CheckFailed(f"could not queue {calls} calls inside the spin")


def _device_times(torch, kernel, library, label):
    """Log and return the device time per call of a kernel and its
    library call."""
    k, lib = device_ms(torch, kernel), device_ms(torch, library)
    log(f"  device time {label}: kernel {k:.4f} ms, library {lib:.4f} ms "
        f"(20 calls queued behind a held stream, CUDA events)")
    return dict(device_ms=k, library_device_ms=lib)


def _count_kernels(torch, tk, fn, b, items, m, coarse):
    """Print and check the CUDA kernels a wrapper call launches: counted at
    launch, and read from the profiler with margins, each equal to the
    plan's in every read; the bare reads' losses are printed."""
    p = tk.plan_for(b, items, m, device=DEV, coarse=coarse)
    note = (f"{p.route} route, query tile {p.qt}, {p.grid} CTAs, "
            f"{p.slots} lists of {p.list_len} a row")
    n, bare, padded = kernels_per_call(
        torch, tk, fn, "coarse_topm" if coarse else "topk_score")
    log(f"  B={b} I={items.rows} m={m}: {note}; CUDA kernels per call {n} "
        f"counted at launch (plan {p.n_kernels}); profiler, {len(padded)} "
        f"reads each: with margins {padded}, bare {bare} "
        f"({sum(x < n for x in bare)} bare reads lost an event)")
    check(n == p.n_kernels,
          f"{n} CUDA kernels a call against the plan's {p.n_kernels}")
    check(all(x == n for x in padded),
          f"the profiler read {padded} CUDA kernels a call with margins, "
          f"the launches {n}")
    check(max(bare) <= n, f"the bare profiler reads saw {bare} kernels, "
          f"more than the {n} launched")
    check(m > 128 or n <= 2, f"{n} CUDA kernels a call at m {m} <= 128")
    return n


def _tile_sweep(torch, tk, quantize, gen, n_items, d, k):
    """Device time of top-K at the engine's small buckets at every query
    tile the kernels have (padded rows cost FMAs): the results
    bit-identical, the plan's tile the smallest."""
    for b in (1, 2, 4):
        q, items, excl = _topk_inputs(torch, quantize, gen, b, n_items, d,
                                      ties=False)
        ref = tk.topk_cuda(q, items, excl, k=k)
        times = []
        for qt in QUERY_TILES:
            got = tk._topk_cuda(q, items, excl, k, qt)
            check(all(torch.equal(x, y) for x, y in zip(got, ref)),
                  f"topk B={b} at query tile {qt} differs")
            t = device_ms(torch, lambda: tk._topk_cuda(q, items, excl, k, qt))
            times.append(f"{t:.4f} ms at tile {qt}")
        log(f"  tile sweep B={b} (plan: tile "
            f"{tk.plan_for(b, items, k, device=DEV).qt}): device "
            + ", ".join(times) + " (bit-identical)")


def check_topk(torch, tk, gen):
    from repro_torch.core.quant import dequantize, quantize

    n_items, d, k = DATASET["n_items"], 256, 20
    log(f"[topk_score] kernel vs plain, I={n_items} d={d} k={k}, "
        f"12 exclusions")
    entries = []
    for b in TOPK_BATCH:
        q, items, excl = _topk_inputs(torch, quantize, gen, b, n_items, d,
                                      ties=True)
        kv, ki = tk.topk_cuda(q, items, excl, k=k)
        pv, pi = tk.topk_plain(q, items, excl, k=k)
        same = torch.equal(ki, pi) and torch.equal(kv, pv)
        log(f"  B={b} integer-valued ties: "
            f"{'bit-identical' if same else 'MISMATCH'}")
        check(same, f"topk tie case B={b} differs")

        q, items, excl = _topk_inputs(torch, quantize, gen, b, n_items, d,
                                      ties=False)
        kv, ki = tk.topk_cuda(q, items, excl, k=k)
        pv, pi = tk.topk_plain(q, items, excl, k=k)
        xhat = dequantize(items)
        scale = float(pv.abs().max())
        err = float((kv - pv).abs().max())
        dense = q @ xhat.T
        picked = torch.gather(dense, 1, ki.long())
        swapped = ki != pi
        ok_idx = bool(((kv - pv).abs()[swapped] <= TOL * scale).all())
        ok_pick = float((picked - kv).abs().max()) <= TOL * scale
        hit = (ki[:, :, None] == excl[:, None, :]).any()
        log(f"  B={b} random: values rel {err / scale:.3e}, "
            f"{int(swapped.sum())} index swaps (near-ties), "
            f"excluded ids returned: {bool(hit)}")
        check(err <= TOL * scale and ok_idx and ok_pick and not bool(hit),
              f"topk random case B={b} out of tolerance")

        n_k = _count_kernels(torch, tk, lambda: tk.topk_cuda(q, items, excl,
                                                             k=k),
                             b, items, k, False)
        ms = time_ms(lambda: tk.topk_cuda(q, items, excl, k=k), 50)
        plain = time_ms(lambda: tk.topk_plain(q, items, excl, k=k), 5)
        lib = time_ms(lambda: torch.topk(q @ dequantize(items).T, k), 50)
        dev = _device_times(
            torch, lambda: tk.topk_cuda(q, items, excl, k=k),
            lambda: torch.topk(q @ dequantize(items).T, k), f"B={b}")
        entries.append(_entry(
            "topk_score", "topk_score", "src/repro/kernels/topk_score.py:115",
            err, ms, plain, lib, tk.topk_cost(
                b, n_items, d, k, dp=items.packed.shape[1],
                n_excl=excl.numel()),
            f"B={b} I={n_items} d={d} k={k} int8", kernels_per_call=n_k,
            library_call="torch.topk(q @ dequantize(items).T)", **dev))
    _tile_sweep(torch, tk, quantize, gen, n_items, d, k)
    # k past 128: the rounds route (pass 1 sorts each item tile)
    for ties in (True, False):
        q, items, excl = _topk_inputs(torch, quantize, gen, ENGINE_BATCH,
                                      n_items, d, ties=ties)
        kv, ki = tk.topk_cuda(q, items, excl, k=LARGE_K)
        pv, pi = tk.topk_plain(q, items, excl, k=LARGE_K)
        scale = float(pv.abs().max())
        err = float((kv - pv).abs().max())
        near = bool(((kv - pv).abs()[ki != pi] <= TOL * scale).all())
        same = torch.equal(ki, pi) and torch.equal(kv, pv)
        log(f"  k={LARGE_K} B={ENGINE_BATCH} "
            f"{'integer-valued ties' if ties else 'random'}: "
            f"{'bit-identical' if same else f'values rel {err / scale:.3e}'}")
        check(same if ties else (err <= TOL * scale and near),
              f"topk k={LARGE_K} ties={ties} differs")
    _count_kernels(torch, tk, lambda: tk.topk_cuda(q, items, excl,
                                                   k=LARGE_K),
                   ENGINE_BATCH, items, LARGE_K, False)
    # the JSON line's shape: B=128, the streaming eval's calls
    return _with_other_shape(entries[-1], *entries[:-1])


def _unpack_affine(torch, q8, qmeta, items):
    """The coarse score matrix from library calls: unpack, one fp32
    product, the affine step."""
    from repro_torch.core.quant import unpack_bits

    codes = unpack_bits(items.packed, items.bits, items.dim).to(torch.float32)
    return ((q8 @ codes.T) * (qmeta[:, 0:1] * items.scale.T)
            + qmeta[:, 1:2] * items.zero.T)


def check_coarse(torch, tk, gen):
    """The coarse scan at the store's item-table shape: INT8 (dp 256) and
    INT4 (dp 128), B 1, the engine's batch and the eval's user chunk at m
    80, and the m = n_items anchor; bit-identical to the plain version.
    Timed on the full table at B 1, 8 and 128, and on a tier-2 shard's
    table at B 8."""
    from repro_torch.core.quant import QTensor, quantize
    from repro_torch.serving.scorer import quantize_query

    n_items, d = DATASET["n_items"], 256
    log(f"[coarse_topm] kernel vs plain (values and indices bit-identical), "
        f"I={n_items} d={d}, 12 exclusions")
    timed = {}
    for bits in (8, 4):
        for b, m in [(b, COARSE_M) for b in COARSE_BATCH] + [
                (ENGINE_BATCH, n_items)]:
            for ties in (True, False):
                q, items, excl = _topk_inputs(torch, quantize, gen, b,
                                              n_items, d, ties=ties)
                if bits == 4:
                    items = quantize(torch.randn((n_items, d), generator=gen,
                                                 device=DEV) * 0.3, 0,
                                     bits=4)
                q8, qmeta = quantize_query(q)
                kv, ki = tk.coarse_topm_cuda(q8, qmeta, items, excl, m=m)
                pv, pi = tk.coarse_topm_plain(q8, qmeta, items, excl, m=m)
                same = torch.equal(ki, pi) and torch.equal(kv, pv)
                log(f"  bits={bits} B={b} m={m} "
                    f"{'ties' if ties and bits == 8 else 'random'}: "
                    f"{'bit-identical' if same else 'MISMATCH'}")
                check(same, f"coarse_topm bits={bits} B={b} m={m} differs")
            if bits == 8 and m == COARSE_M:
                timed[b] = (q8, qmeta, items, excl)
    q8, qmeta, items, excl = timed[ENGINE_BATCH]
    shard = QTensor(items.packed[:SHARD_ITEMS], items.scale[:SHARD_ITEMS],
                    items.zero[:SHARD_ITEMS], items.bits, items.dim)
    ex = torch.where(excl < SHARD_ITEMS, excl, -1)
    same = all(torch.equal(a, b) for a, b in zip(
        tk.coarse_topm_cuda(q8, qmeta, shard, ex, m=COARSE_M),
        tk.coarse_topm_plain(q8, qmeta, shard, ex, m=COARSE_M)))
    log(f"  shard table I={SHARD_ITEMS} B={ENGINE_BATCH} m={COARSE_M}: "
        f"{'bit-identical' if same else 'MISMATCH'}")
    check(same, "coarse_topm on a shard-sized table differs")
    _count_kernels(torch, tk, lambda: tk.coarse_topm_cuda(q8, qmeta, items,
                                                          excl, m=n_items),
                   ENGINE_BATCH, items, n_items, True)
    entries = []
    shapes = [(b, timed[b][2], timed[b][3], timed[b][0], timed[b][1])
              for b in COARSE_BATCH]
    shapes.insert(2, (ENGINE_BATCH, shard, ex, q8, qmeta))
    for b, items, excl, q8, qmeta in shapes:
        m, n = COARSE_M, items.rows
        n_k = _count_kernels(
            torch, tk, lambda: tk.coarse_topm_cuda(q8, qmeta, items, excl,
                                                   m=m), b, items, m, True)
        ms = time_ms(lambda: tk.coarse_topm_cuda(q8, qmeta, items, excl,
                                                 m=m), 50)
        plain = time_ms(lambda: tk.coarse_topm_plain(q8, qmeta, items, excl,
                                                     m=m), 5)
        err = float((tk.coarse_topm_cuda(q8, qmeta, items, excl, m=m)[0]
                     - tk.coarse_topm_plain(q8, qmeta, items, excl, m=m)[0])
                    .abs().max())
        lib = time_ms(lambda: torch.topk(_unpack_affine(torch, q8, qmeta,
                                                        items), m), 50)
        dev = _device_times(
            torch, lambda: tk.coarse_topm_cuda(q8, qmeta, items, excl, m=m),
            lambda: torch.topk(_unpack_affine(torch, q8, qmeta, items), m),
            f"B={b} I={n}")
        entries.append(_entry(
            "coarse_topm", "coarse_topm",
            "src/repro/kernels/topk_score.py:129", err, ms, plain, lib,
            tk.coarse_topm_cost(b, n, d, m, items.packed.shape[1],
                                n_excl=excl.numel()),
            f"B={b} I={n} d={d} m={m} int8", kernels_per_call=n_k,
            library_call="torch.topk(affine(q8 @ unpack(packed).T), m), "
                         "no exclusions", **dev))
    # the JSON line's shape: B=128, the [accuracy] phase's two-stage calls
    return _with_other_shape(entries[-1], *entries[:-1])


def _with_other_shape(entry, *others):
    """``entry`` (the JSON line's shape) carrying the timings of ``others``
    (one: a dict; several: a list)."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "kernels_per_call", "device_ms",
            "library_device_ms", "select_ms", "select_device_ms",
            "spmm_route_device_ms", "longest_run", "kernels_per_launch")
    rows = [{k: o[k] for k in keys if k in o} for o in others]
    entry["other_shape"] = rows[0] if len(rows) == 1 else rows
    return entry


def check_dequant_unpack(torch, qp, gen):
    """Unpack + dequantize at the item table's shape (INT8 and INT4), bits 2
    and 1, padded packs and an unaligned base, every row and through the
    fused row gather (the re-rank's B*m candidates: unsorted, duplicate
    ids; int32 and int64); bit-identical to the plain version. Timed on the
    item table, and at the re-rank's 640 rows both fused and on the PR 13
    route (``QTensor.select``'s three gathers, then the kernel), with the
    device time of each (held stream)."""
    from repro_torch.core.quant import QTensor, quantize

    n_items, d = DATASET["n_items"], 256
    rerank_rows = ENGINE_BATCH * COARSE_M
    log(f"[dequant_unpack] kernel vs plain (bit-identical)")
    cand = torch.randint(0, n_items, (rerank_rows,), generator=gen,
                         device=DEV, dtype=torch.int32)
    cand[:8] = cand[8]
    tables = {}
    for rows, dim, bits, off in ((n_items, d, 8, 0), (n_items, d, 4, 0),
                                 (n_items, d, 8, 1), (4096, d, 2, 0),
                                 (4096, d, 1, 0), (4096, 37, 4, 0),
                                 (4096, 37, 2, 0)):
        q = quantize(torch.randn((rows, dim), generator=gen, device=DEV)
                     * 0.3, 0xD0 + bits, bits=bits, stochastic=True)
        if off:
            q = QTensor(_shifted(torch, q.packed, off), q.scale, q.zero,
                        bits, dim)
        idx = cand % rows
        same = []
        for i in (None, idx, idx.long()):
            got = qp.dequant_unpack_cuda(q.packed, q.scale, q.zero,
                                         bits=bits, dim=dim, idx=i)
            ref = qp.dequant_unpack_plain(q.packed, q.scale, q.zero,
                                          bits=bits, dim=dim, idx=i)
            same.append(torch.equal(got, ref))
        log(f"  {rows}x{dim} bits={bits} (dp {q.packed.shape[1]}"
            f"{f', base {off} byte off alignment' if off else ''}): every "
            f"row {'bit-identical' if same[0] else 'MISMATCH'}; "
            f"{rerank_rows} gathered rows (int32, int64) "
            f"{'bit-identical' if all(same[1:]) else 'MISMATCH'}")
        check(all(same), f"dequant_unpack {rows}x{dim} bits={bits} differs")
        if (rows, dim, bits, off) == (n_items, d, 8, 0):
            tables["item"] = q
    q = tables["item"]
    args = (q.packed, q.scale, q.zero)
    dp = q.packed.shape[1]

    def unpack():
        return qp.dequant_unpack_cuda(*args, bits=8, dim=d)

    def fused():
        return qp.dequant_unpack_cuda(*args, bits=8, dim=d, idx=cand)

    def select_route():
        s = q.select(cand.long())
        return qp.dequant_unpack_cuda(s.packed, s.scale, s.zero, bits=8,
                                      dim=d)

    check(torch.equal(fused(), select_route()), "fused gather vs select")
    entries = []
    for rows, fn, plain_fn, idx_bytes in (
            (n_items, unpack,
             lambda: qp.dequant_unpack_plain(*args, bits=8, dim=d), 0),
            (rerank_rows, fused,
             lambda: qp.dequant_unpack_plain(*args, bits=8, dim=d,
                                             idx=cand), 4)):
        err = float((fn() - plain_fn()).abs().max())
        ms = time_ms(fn, 100)
        plain = time_ms(plain_fn, 20)
        dev = device_ms(torch, fn)
        extra = dict(device_ms=dev)
        label = f"R={rows} d={d} int8"
        if rows == rerank_rows:
            sel_ms = time_ms(select_route, 100)
            sel_dev = device_ms(torch, select_route)
            extra.update(select_ms=sel_ms, select_device_ms=sel_dev)
            label = (f"{rows} gathered rows of I={n_items}, d={d} int8 "
                     f"(fused gather)")
            log(f"  re-rank's {rows} rows: fused gather {ms:.4f} ms (events)"
                f", device {dev:.4f} ms; PR 13 route (select, then the "
                f"kernel) {sel_ms:.4f} ms, device {sel_dev:.4f} ms")
        e = _entry("dequant_unpack", "dequant_unpack",
                   "src/repro/kernels/quant_pack.py:171", err, ms, plain,
                   None, qp.dequant_unpack_cost(rows, d, dp,
                                                idx_bytes=idx_bytes),
                   label, **extra)
        log(f"  {label}: device {dev:.4f} ms against the bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_ms'] / dev:.1%} of it)")
        entries.append(e)
    return _with_other_shape(entries[0], entries[1])   # the item table


def _sddmm_library(torch, g):
    """cuSPARSE SDDMM over the graph's coalesced CSR pattern (duplicate
    edges merged), and a map from each edge to its value's position."""
    m = g.layout.meta
    src, dst = g.src.long(), g.dst.long()
    with warnings.catch_warnings():      # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(
            torch.stack([dst, src]),
            torch.ones(m.n_edges, device=DEV), (m.n_dst, m.n_src)
        ).coalesce().to_sparse_csr()
    rows = torch.repeat_interleave(
        torch.arange(m.n_dst, device=DEV), a.crow_indices().diff())
    keys = rows * m.n_src + a.col_indices()
    pos = torch.searchsorted(keys, dst * m.n_src + src)

    def run(x, grad):
        return torch.sparse.sampled_addmm(a, grad, x.T, beta=0.0)

    return run, pos


def _entry(name, source, replaces, err, ms, plain, lib, cost, shape,
           **extra):
    bnd, by = bound_ms(cost)
    lib_s = "none (no single call)" if lib is None else f"{lib:.4f} ms"
    log(f"  time {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
        f"{lib_s}, bound {bnd:.4f} ms ({by}; {_cost_str(cost)})")
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/csrc/{source}.cu",
                replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
                shape=shape, **extra)


def check_sddmm(torch, sp, g, gen):
    """The fp32-residual SDDMM at full width: the FP32 layers' ∇ew (d 64)
    and the edge softmax's denominators (d 1, every schedule)."""
    log("[sddmm] kernel vs plain on the full-width KGAT graph")
    m = g.layout.meta
    lib_fn, pos = _sddmm_library(torch, g)
    entries = []
    for d in (64, 1):
        x = torch.randn((m.n_src, d), generator=gen, device=DEV) * 0.1
        grad = torch.randn((m.n_dst, d), generator=gen, device=DEV) * 1e-3
        out1 = sp.sddmm_cuda(x, grad, g.layout)
        same = torch.equal(out1, sp.sddmm_cuda(x, grad, g.layout))
        ref = sp.sddmm_plain(x, grad, g.layout)
        rel, err = _rel(out1, ref), float((out1 - ref).abs().max())
        log(f"  d={d}: rel {rel:.3e} (max abs {err:.3e}), two runs "
            f"{'bit-identical' if same else 'DIFFER'}")
        check(rel <= TOL and same,
              f"sddmm d={d}: rel {rel}, deterministic {same}")
        lib_rel = _rel(lib_fn(x, grad).values()[pos], ref)
        check(lib_rel <= TOL, f"library sampled_addmm disagrees ({lib_rel})")
        ms = time_ms(lambda: sp.sddmm_cuda(x, grad, g.layout), 20)
        plain = time_ms(lambda: sp.sddmm_plain(x, grad, g.layout), 5)
        lib = time_ms(lambda: lib_fn(x, grad), 20)
        entries.append(_entry(
            "sddmm", "sddmm", "src/repro/kernels/spmm.py:334", err, ms,
            plain, lib, sp.sddmm_cost(g.layout, d),
            f"E={m.n_edges} n={m.n_dst} d={d} fp32",
            library_call="torch.sparse.sampled_addmm (CSR)"))
    return _with_other_shape(*entries)


def spmm_route_segment_sum(torch, sp, y, levels):
    """The segment sum's earlier route, timed beside its own kernel: the
    SPMM kernel (csrc/spmm.cu) with x := y, gat := perm and no weights,
    one launch a level, each run summed whole by one group of lanes (not a
    counted launch: the port no longer takes this route)."""
    from repro_torch.kernels import backend

    fn = backend.kernel_fn("spmm", "spmm_launch", sp._ARGTYPES)
    for runs in levels:
        out = torch.empty((runs.n_out, y.shape[1]), device=y.device)
        backend.launch(fn, y.data_ptr(), y.shape[1], None,
                       runs.perm.data_ptr(), runs.perm.data_ptr(),
                       runs.row_start.data_ptr(), runs.row_end.data_ptr(),
                       runs.n_out, out.data_ptr(), backend.stream_of(y))
        y = out
    return y


def segment_sum_report(torch, sp, y, levels, library, cost, tag):
    """The segment-sum kernel on one grouping beside index_add_ and its
    earlier route (``spmm_route_segment_sum``): the longest run, the chunk
    C, the CUDA kernels each level's launch started (counted by the C entry
    point at each launch, ``backend.CUDA_KERNEL_COUNTS``; must equal the
    plan's one a level, two where it has a run longer than a chunk), and
    device times (20 calls behind a held stream, in
    turns with the earlier route) against the bound. Returns them for the
    kernels line."""
    from repro_torch.data.csr import SEG_CHUNK
    from repro_torch.kernels import backend

    longest = max(int((lv.row_end - lv.row_start).max()) if lv.n_out else 0
                  for lv in levels)
    plan = [1 + (lv.plan.n_parts > 0) for lv in levels]
    per_level, x = [], y
    for lv in levels:
        before = backend.CUDA_KERNEL_COUNTS["segment_sum"]
        x = sp.segment_sum_cuda(x, (lv,))
        per_level.append(backend.CUDA_KERNEL_COUNTS["segment_sum"] - before)
    check(per_level == plan, f"{tag}: the launches started {per_level} CUDA "
          f"kernels a level, the plan says {plan}")
    old = spmm_route_segment_sum(torch, sp, y, levels)
    old_rel = _rel(old, sp.segment_sum_plain(y, levels))

    def kernel():
        return sp.segment_sum_cuda(y, levels)

    def route():
        return spmm_route_segment_sum(torch, sp, y, levels)

    # in turns (route, kernel, kernel, route): each pair's spread is the
    # run's noise
    r1, k1, k2, r2 = (device_ms(torch, f)
                      for f in (route, kernel, kernel, route))
    k, rt = (k1 + k2) / 2, (r1 + r2) / 2
    lib = device_ms(torch, library)
    bnd, by = bound_ms(cost)
    log(f"  {tag}: longest run {longest} slots, C {SEG_CHUNK}, CUDA kernels "
        f"a launch {per_level} (counted at launch; plan {plan}); device "
        f"time kernel "
        f"{k:.4f} ms ({k1:.4f} / {k2:.4f}), index_add_ {lib:.4f} ms, SPMM "
        f"route {rt:.4f} ms ({r1:.4f} / {r2:.4f}; rel {old_rel:.2e} to the "
        f"plain version), bound {bnd:.4f} ms ({by}; 20 calls queued behind a "
        f"held stream, CUDA events, in turns)")
    return dict(longest_run=longest, chunk=SEG_CHUNK,
                kernels_per_launch=per_level, device_ms=k,
                library_device_ms=lib, spmm_route_device_ms=rt)


def check_segment_sum(torch, sp, g, gen):
    """The attention's gather backward at full width, on each grouping the
    training step sums over: by destination and by source (d 64, the basis
    projections), by relation (d 64 and d 4: the relation embeddings and
    the basis coefficients; chunked levels) and by destination at d 1 (the
    softmax denominators). The library call is ``index_add_`` over the
    edges' own ids (what ``index_select``'s backward runs)."""
    from repro_torch.data.csr import relation_runs

    log("[segment_sum] kernel vs plain on the full-width KGAT graph")
    m = g.layout.meta
    t0 = time.perf_counter()
    rel_one = relation_runs(g.rel.cpu().numpy(), g.n_relations,
                            chunk=m.n_edges + 1, device=DEV)
    log(f"  the relation grouping as one level (no host chunk levels): "
        f"built in {time.perf_counter() - t0:.2f} s")
    cases = (("dst", g.layout.runs(), g.dst, 64),
             ("src", g.layout.runs(transpose=True), g.src, 64),
             ("rel", g.rel_runs, g.rel, 64),
             ("rel", g.rel_runs, g.rel, 4),
             ("dst", g.layout.runs(), g.dst, 1))
    for d in (64, 4):
        y = torch.randn((m.n_edges, d), generator=gen, device=DEV) * 1e-3
        rel = _rel(sp.segment_sum_cuda(y, rel_one),
                   sp.segment_sum_cuda(y, g.rel_runs))
        one, levels = (device_ms(torch, lambda lv=lv: sp.segment_sum_cuda(
            y, lv)) for lv in (rel_one, g.rel_runs))
        log(f"  by relation d={d}, one level against {len(g.rel_runs)} "
            f"levels: device time {one:.4f} ms against {levels:.4f} ms, rel "
            f"{rel:.2e} (measured, not taken)")
    entries = []
    for kind, levels, ids, d in cases:
        y = torch.randn((m.n_edges, d), generator=gen, device=DEV) * 1e-3
        ids = ids.long()
        n_out = levels[-1].n_out
        out1 = sp.segment_sum_cuda(y, levels)
        same = torch.equal(out1, sp.segment_sum_cuda(y, levels))
        ref = sp.segment_sum_plain(y, levels)

        def library():
            return torch.zeros((n_out, d), device=DEV).index_add_(0, ids, y)

        rel, err = _rel(out1, ref), float((out1 - ref).abs().max())
        # against float64: index_add_ adds a relation's 1.4 M terms into one
        # row in the atomics' order, a long fp32 chain (rel 3.6e-5 measured)
        ref64 = torch.zeros((n_out, d), dtype=torch.float64,
                            device=DEV).index_add_(0, ids, y.double())
        k64, lib64 = _rel(out1.double(), ref64), _rel(library().double(),
                                                      ref64)
        log(f"  by {kind} d={d} ({len(levels)} level"
            f"{'s' if len(levels) > 1 else ''}, {n_out} rows): rel "
            f"{rel:.3e} (max abs {err:.3e}), two runs "
            f"{'bit-identical' if same else 'DIFFER'}; vs float64: kernel "
            f"{k64:.3e}, index_add_ {lib64:.3e}")
        check(rel <= TOL and same,
              f"segment_sum by {kind} d={d}: rel {rel}, deterministic {same}")
        check(k64 <= TOL and lib64 <= LIB_SUM_TOL,
              f"segment_sum by {kind} d={d}: kernel {k64} or index_add_ "
              f"{lib64} off float64")
        ms = time_ms(lambda: sp.segment_sum_cuda(y, levels), 20)
        plain = time_ms(lambda: sp.segment_sum_plain(y, levels), 5)
        lib = time_ms(library, 20)
        cost = sp.segment_sum_cost(levels, d)
        report = segment_sum_report(torch, sp, y, levels, library, cost,
                                    f"by {kind} d={d}")
        entries.append(_entry(
            "segment_sum", "segment_sum",
            "none: port-only, the backward of the attention's gathers "
            "(src/repro/models/kgnn.py:556-559 and :123 leave it to XLA's "
            "scatter-add)", err, ms, plain, lib, cost,
            f"E={m.n_edges} by {kind} n={n_out} d={d}",
            library_call="torch.Tensor.index_add_", **report))
    return _with_other_shape(*entries)


def check_dequant_sddmm(torch, sp, g, gen):
    """The packed-residual SDDMM (the INT-b ∇ew) at full width."""
    from repro_torch.core.quant import dequantize, quantize

    log("[dequant_sddmm] kernel vs plain on the full-width KGAT graph")
    m = g.layout.meta
    lib_fn, pos = _sddmm_library(torch, g)
    timed = {}
    for bits, d in ((8, 64), (4, 64), (1, 64), (2, 37), (2, 64)):
        x = torch.randn((m.n_src, d), generator=gen, device=DEV) * 0.1
        grad = torch.randn((m.n_dst, d), generator=gen, device=DEV) * 1e-3
        q = quantize(x, 0xACE + bits, bits=bits, stochastic=True)
        out1 = sp.dequant_sddmm_cuda(q, grad, g.layout)
        same = torch.equal(out1, sp.dequant_sddmm_cuda(q, grad, g.layout))
        ref = sp.dequant_sddmm_plain(q, grad, g.layout)
        rel, err = _rel(out1, ref), float((out1 - ref).abs().max())
        log(f"  bits={bits} d={d} (dp {q.packed.shape[1]}): rel {rel:.3e} "
            f"(max abs {err:.3e}), two runs "
            f"{'bit-identical' if same else 'DIFFER'}")
        check(rel <= TOL and same,
              f"dequant_sddmm bits={bits} d={d}: rel {rel}, "
              f"deterministic {same}")
        if d == 64:
            timed[bits] = q
    # timing: the main path's INT2 call at d 64 (the last case), and INT8
    entries = []
    for q in (q, timed[8]):
        ref = sp.dequant_sddmm_plain(q, grad, g.layout)
        lib_rel = _rel(lib_fn(dequantize(q), grad).values()[pos], ref)
        check(lib_rel <= TOL, f"library dequantize+sampled_addmm disagrees "
              f"({lib_rel})")
        err = float((sp.dequant_sddmm_cuda(q, grad, g.layout) - ref)
                    .abs().max())
        ms = time_ms(lambda: sp.dequant_sddmm_cuda(q, grad, g.layout), 20)
        plain = time_ms(lambda: sp.dequant_sddmm_plain(q, grad, g.layout),
                        5)
        lib = time_ms(lambda: lib_fn(dequantize(q), grad), 20)
        entries.append(_entry(
            "dequant_sddmm", "sddmm", "src/repro/kernels/spmm.py:398", err,
            ms, plain, lib,
            sp.dequant_sddmm_cost(g.layout, d, q.packed.shape[1]),
            f"E={m.n_edges} n={m.n_dst} d={d} INT{q.bits}",
            also_replaces="src/repro/kernels/spmm.py:466",
            library_call="dequantize + torch.sparse.sampled_addmm (CSR)"))
    return _with_other_shape(*entries)


def check_dequant_matmul(torch, dq, gen):
    """dW = dequant(q)ᵀ @ g at the training path's shape: every node's row,
    64 features in and out. Rows centred on 0 with g of mixed sign (an
    uncentred code/zero split would cancel) at bits 8/4/2/1 and a padded
    pack (d 37), and rows offset far from 0 (x = 4 + 0.05 randn: the zero
    term dominates) at INT2 and INT8: within 1e-5 relative of the plain
    version and bit-identical across two runs. Timed at INT2 (events and
    device time); the bound's operations are the three bf16 products at
    the bf16 tensor-core rate."""
    from repro_torch.core.quant import dequantize, quantize

    rows, n = DATASET["n_users"] + DATASET["n_items"] + DATASET["n_attrs"], 64
    log(f"[dequant_matmul] kernel vs plain, R={rows}, N={n}")
    for bits, d, table in ((8, 64, "centred"), (4, 64, "centred"),
                           (1, 64, "centred"), (2, 37, "centred"),
                           (8, 64, "offset"), (2, 64, "offset"),
                           (2, 64, "centred")):
        x = torch.randn((rows, d), generator=gen, device=DEV)
        x = 4.0 + 0.05 * x if table == "offset" else 0.1 * x
        grad = torch.randn((rows, n), generator=gen, device=DEV) * 1e-3
        q = quantize(x, 0xBEE + bits, bits=bits, stochastic=True)
        out1 = dq.dequant_matmul_cuda(q, grad)
        same = torch.equal(out1, dq.dequant_matmul_cuda(q, grad))
        ref = dq.dequant_matmul_plain(q, grad)
        rel, err = _rel(out1, ref), float((out1 - ref).abs().max())
        log(f"  bits={bits} d={d} rows {table}: rel {rel:.3e} (max abs "
            f"{err:.3e}), two runs {'bit-identical' if same else 'DIFFER'}")
        check(rel <= TOL and same,
              f"dequant_matmul bits={bits} d={d} {table}: rel {rel}, "
              f"deterministic {same}")

    def kernel():
        return dq.dequant_matmul_cuda(q, grad)

    def library():
        return dequantize(q).T @ grad

    ms = time_ms(kernel, 50)
    plain = time_ms(lambda: dq.dequant_matmul_plain(q, grad), 20)
    lib = time_ms(library, 50)
    dev = _device_times(torch, kernel, library, f"R={rows} {d}x{n} INT2")
    e = _entry("dequant_matmul", "dequant_matmul",
               "src/repro/kernels/dequant_matmul.py:35", err, ms, plain, lib,
               dq.dequant_matmul_cost(rows, d, n, q.packed.shape[1]),
               f"R={rows} {d}x{n} INT2",
               library_call="dequantize(q).T @ g (cuBLAS, "
               "no TF32)", **dev)
    log(f"  device {dev['device_ms']:.4f} ms against the bound "
        f"{e['bound_ms']:.4f} ms ({e['bound_by']}; "
        f"{e['bound_ms'] / dev['device_ms']:.1%} of it)")
    split = device_ms_by_kernel(torch, kernel, "dqmm_")
    log("  device time by CUDA kernel (torch.profiler, mean of 10 calls): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
    e["device_ms_by_kernel"] = split
    return e


def device_ms_by_kernel(torch, fn, prefix: str, calls: int = 10):
    """Mean device time per call of each CUDA kernel of ``fn`` whose name
    (namespace stripped) starts with ``prefix``, read from torch.profiler;
    fails where the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(\w+)\(", e.key)     # the kernel's own name
        name = m.group(1) if m else e.key
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and name.startswith(prefix)):
            out[name] = e.self_device_time_total / 1e3 / calls
    check(bool(out), f"torch.profiler saw no {prefix}* kernel")
    return out


def _shifted(torch, t, nbytes):
    """A contiguous copy of ``t`` whose storage starts ``nbytes`` past a
    16-byte boundary."""
    n = nbytes // t.element_size()
    buf = torch.empty(t.numel() + n, dtype=t.dtype, device=t.device)
    out = buf[n:].view(t.shape)
    out.copy_(t)
    return out


def check_reduced_rollout(torch):
    from repro_torch.configs import get
    from repro_torch.configs.smoke import reduced
    from repro_torch.launch.serve import reduced_dataset
    from repro_torch.models import kgnn

    cfg = reduced(get("kgat")).model_cfg
    ds = reduced_dataset(cfg)
    p_cpu = kgnn.init_params(cfg, seed=0, device="cpu")
    p_gpu = kgnn.init_params(cfg, seed=0, device=DEV)
    ref = kgnn.propagate(p_cpu, ds.graph("cpu"), cfg)
    got = kgnn.propagate(p_gpu, ds.graph(DEV), cfg).cpu()
    err = float((got - ref).abs().max())
    log(f"[rollout] reduced KGAT, card vs CPU plain versions: max abs "
        f"{err:.3e}")
    check(err <= TOL, f"reduced rollout differs from the CPU by {err}")


# -- the main path --------------------------------------------------------------


def run_main_path(torch, cfg, ds, g, params):
    from repro_torch.kernels import backend
    from repro_torch.launch.serve import serve_kgnn

    torch.cuda.reset_peak_memory_stats()
    backend.reset_counts()
    res = serve_kgnn(cfg, ds, params, bits=8, k=20, requests=REQUESTS,
                     device=DEV, graph=g, dense_users=DENSE_USERS, log=log)
    counts = dict(backend.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] LAUNCH_COUNTS {json.dumps(counts, sort_keys=True)}")
    for name, ph in res["phases"].items():
        log(f"[main] phase {name}: {ph['seconds']:.3f} s, launches "
            f"{json.dumps(ph['launches'], sort_keys=True)}")
    log(f"[main] streaming eval (all users, top-K at B {EVAL_BATCH}): "
        f"{res['phases']['eval']['seconds']:.3f} s")
    log(f"[main] torch.cuda.max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    log(f"[main] engine {res['stats']}")
    for name in SERVING:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on the serving path")

    store = res["store"]
    width = (cfg.n_layers + 1) * cfg.dim            # concat readout
    check(store.users.packed.shape == (cfg.n_users, width)
          and store.items.packed.shape == (ds.n_items, width),
          "store shapes")
    for t in (store.users, store.items):
        check(bool(torch.isfinite(t.scale).all() and
                   torch.isfinite(t.zero).all()), "non-finite store rows")
    check(0.0 <= res["recall"] <= 1.0 and 0.0 <= res["ndcg"] <= 1.0,
          "metrics out of range")
    check(res["dense_delta"] <= 1e-6,
          f"streaming eval vs dense reference |delta| {res['dense_delta']}")
    return counts, res


# -- serving tier 2 -------------------------------------------------------------


def zipf_stream(n_users: int, n: int, *, a: float, seed: int):
    """n user ids from a zipf(a) popularity law over a fixed permutation of
    the users (the request stream of the reference's serving bench)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    order = rng.permutation(n_users)
    pmf = 1.0 / np.arange(1, n_users + 1) ** a
    pmf /= pmf.sum()
    return order[rng.choice(n_users, size=n, p=pmf)].astype(np.int32)


@contextlib.contextmanager
def audit_cache_replays(engine_cls):
    """Record every response the engine replays from its cache: (user,
    entry stamp, live version, values, indices)."""
    seen = []
    orig = engine_cls._replay

    def audited(self, msg, ent):
        seen.append((msg[1], ent[0], self.version, ent[1], ent[2]))
        orig(self, msg, ent)

    engine_cls._replay = audited
    try:
        yield seen
    finally:
        engine_cls._replay = orig


def _close_topk(torch, gv, gi, rv, ri):
    """(values rel, index swaps, ok): values within TOL of the reference's
    scale, indices equal except between scores within it."""
    gv, gi, rv, ri = (torch.as_tensor(a) for a in (gv, gi, rv, ri))
    scale = float(rv[torch.isfinite(rv)].abs().max())
    diff = (gv - rv).abs()
    err = float(diff.max()) / scale
    swapped = gi != ri
    ok = err <= TOL and bool((diff[swapped] <= TOL * scale).all())
    return err, int(swapped.sum()), ok


def run_tier2_path(torch, cfg, ds, g, params):
    """The tier-2 serving path at full width through ``serve_kgnn``:
    two-stage C 4, 2 item shards, a 4,096-entry hot-user cache, 400
    zipfian requests, 2 FP32 BPR steps, a re-roll and a delta refresh, a
    second burst. Counts are reset just before and read just after."""
    import numpy as np

    from repro_torch.kernels import backend
    from repro_torch.launch.serve import serve_kgnn
    from repro_torch.obs import get_registry
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.store import padded_pos_lists

    users = zipf_stream(ds.n_users, REQUESTS, a=ZIPF_A, seed=0)
    with audit_cache_replays(ServingEngine) as replays:
        torch.cuda.synchronize()
        backend.reset_counts()
        res = serve_kgnn(cfg, ds, params, bits=8, k=20, users=users,
                         device=DEV, graph=g, dense_users=DENSE_USERS,
                         log=log, **TIER2)
        counts = dict(backend.LAUNCH_COUNTS)
    log(f"[tier2] LAUNCH_COUNTS {json.dumps(counts, sort_keys=True)}")
    for name, ph in res["phases"].items():
        log(f"[tier2] phase {name}: {ph['seconds']:.3f} s, launches "
            f"{json.dumps(ph['launches'], sort_keys=True)}")
    for name in TIER2_KERNELS:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on the tier-2 path")

    snap = get_registry().snapshot()
    lab = res["label"]
    stages = {st: snap["histograms"][f"serve/stage_ms{{engine={lab},"
                                     f"stage={st}}}"]
              for st in ("coarse", "rerank")}
    frac = snap["gauges"][f"serve/candidate_frac{{engine={lab}}}"]
    st1, st2 = res["stats"], res["stats_post"]
    # the single-stage, unsharded, uncached engine on the same requests
    exclude = padded_pos_lists(ds.train_pos, ds.n_users)
    with ServingEngine(res["store"], k=20, exclude=exclude,
                       buckets=(1, 2, 4, 8)) as base:
        base.warmup()
        futs = [base.submit(int(u)) for u in users]
        base_res = [f.result(timeout=300) for f in futs]
        st0 = base.stats()
    log(f"[tier2] {REQUESTS} zipfian requests (a {ZIPF_A}, seed 0, "
        f"{len(set(users.tolist()))} distinct users): tier-2 engine "
        f"{st1.qps:.1f} QPS, p50 {st1.p50_ms:.3f} ms, p99 {st1.p99_ms:.3f} "
        f"ms, {st1.n_batches} batches, cache hit rate "
        f"{st1.cache_hit_rate:.4f}; single-stage engine {st0.qps:.1f} QPS, "
        f"p50 {st0.p50_ms:.3f} ms, p99 {st0.p99_ms:.3f} ms, "
        f"{st0.n_batches} batches")
    for st, h in stages.items():
        log(f"[tier2] stage {st}: {h['count']} calls (per shard per "
            f"batch, both bursts; CUDA events on the shard's own stream), p50 {h['p50']:.3f} ms, p99 "
            f"{h['p99']:.3f} ms, mean {h['sum'] / max(h['count'], 1):.3f} "
            f"ms")
    log(f"[tier2] candidate_frac {frac:.6f}; post-refresh burst: "
        f"{st2.n_requests - st1.n_requests} requests, cumulative {st2}")

    # the tier-2 answers against the single-stage engine's (two-stage
    # recall: the same top-20 ids, as a share)
    same_ids = np.mean([len(set(a[1].tolist()) & set(b[1].tolist())) / 20
                        for a, b in zip(res["results"], base_res)])
    log(f"[tier2] first burst: share of the single-stage top-20 ids "
        f"served {same_ids:.4f}")

    # the refresh: the live store is the new rollout, bit for bit
    live, new = res["live_store"], res["new_store"]
    same = all(torch.equal(a, b) for s_t, n_t in
               ((live.users, new.users), (live.items, new.items))
               for a, b in ((s_t.packed, n_t.packed), (s_t.scale, n_t.scale),
                            (s_t.zero, n_t.zero)))
    log(f"[tier2] refresh {json.dumps(res['delta'], sort_keys=True)}; live "
        f"store vs new rollout: {'bit-identical' if same else 'MISMATCH'}")
    check(same, "the refreshed store is not the new rollout")
    check(res["delta"]["version"] == 1 and st2.store_version == 1,
          "store version after the refresh")

    # every cache hit: stamp == live version, and a fresh score agrees
    check(len(replays) > 0, "no cache hit on zipfian traffic")
    by_version = {0: res["store"], 1: live}
    n_exact = 0
    for v, store in by_version.items():
        hits = [r for r in replays if r[2] == v]
        check(all(r[1] == v for r in hits),
              f"a cache hit served under version {v} carries another stamp")
        if not hits:
            continue
        with ServingEngine(store, k=20, exclude=exclude,
                           buckets=(1, 2, 4, 8), two_stage_c=TIER2[
                               "two_stage"],
                           item_shards=TIER2["item_shards"]) as fresh:
            fv, fi = fresh.score_batch(np.array([r[0] for r in hits]))
        hv = np.stack([r[3] for r in hits])
        hi = np.stack([r[4] for r in hits])
        err, swaps, ok = _close_topk(torch, hv, hi, fv, fi)
        n_exact += int(sum(np.array_equal(a, b) and np.array_equal(c, d_)
                           for a, b, c, d_ in zip(hv, fv, hi, fi)))
        log(f"[tier2] version {v}: {len(hits)} cache hits, every stamp "
            f"v{v}; against a fresh score: values rel {err:.3e}, "
            f"{swaps} index swaps (near-ties)")
        check(ok, f"cache hits of version {v} differ from a fresh score")
    check(any(r[2] == 1 for r in replays),
          "no post-refresh cache hit carried the new version")
    log(f"[tier2] {len(replays)} cache hits checked, {n_exact} bit-identical "
        f"to the fresh score (the re-rank's batched product may sum in "
        f"another order at another batch size)")
    return counts, res


def check_tier2_served(torch, ds, res):
    """Hold what the tier-2 path served against plain versions: the coarse
    kernel on the served store's shard tables at the engine's batch sizes
    (bit-identical), and the first burst's responses against two-stage
    retrieval run on the plain versions per shard, merged on the host."""
    import numpy as np

    from repro_torch.core.quant import dequantize as dequantize_plain
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_score as tk
    from repro_torch.serving.engine import _shard_items
    from repro_torch.serving.scorer import (merge_topk, quantize_query,
                                            two_stage_topk)
    from repro_torch.serving.store import padded_pos_lists

    store, k, c = res["store"], res["k"], TIER2["two_stage"]
    shards = _shard_items(store.items, TIER2["item_shards"])
    offs = np.cumsum([0] + [s.rows for s in shards])[:-1]
    excl_all = torch.from_numpy(padded_pos_lists(ds.train_pos,
                                                 ds.n_users)).to(DEV)
    users = res["users"]
    for b in (1, 2, 4, 8):            # the engine's buckets
        ids = torch.from_numpy(users[:b]).to(DEV)
        q8, qmeta = quantize_query(store.user_vectors(ids))
        for off, sh in zip(offs, shards):
            m = max(k, min(c * k, sh.rows))
            ex = excl_all[ids] - int(off)
            kv, ki = tk.coarse_topm_cuda(q8, qmeta, sh, ex, m=m)
            pv, pi = tk.coarse_topm_plain(q8, qmeta, sh, ex, m=m)
            same = torch.equal(ki, pi) and torch.equal(kv, pv)
            check(same, f"coarse_topm on shard {off}+{sh.rows} at B={b} "
                  f"m={m} differs from plain")
    log(f"[tier2] coarse_topm on the served shard tables "
        f"({', '.join(str(s.rows) for s in shards)} items) at B 1/2/4/8, "
        f"m {max(k, c * k)}, the burst's users and exclusions: "
        f"bit-identical to plain")

    n = SERVED_USERS
    ids = torch.from_numpy(users[:n]).to(DEV)
    q, excl = store.user_vectors(ids), excl_all[ids]
    with plain_versions(ops, coarse_topm=tk.coarse_topm_plain,
                        dequantize=dequantize_plain,
                        dequantize_rows=lambda q, i: dequantize_plain(
                            q.select(i.long()))):
        parts = [two_stage_topk(q, sh, min(k, sh.rows), c=c,
                                exclude=excl - int(off))
                 for off, sh in zip(offs, shards)]
    pv, pi = merge_topk([p[0].cpu().numpy() for p in parts],
                        [p[1].cpu().numpy() + int(off)
                         for p, off in zip(parts, offs)], k)
    ev = np.stack([r[0] for r in res["results"][:n]])
    ei = np.stack([r[1] for r in res["results"][:n]])
    err, swaps, ok = _close_topk(torch, ev, ei, pv, pi)
    hit = bool((torch.from_numpy(ei).to(DEV)[:, :, None]
                == excl[:, None, :]).any())
    log(f"[tier2] first-burst responses for {n} users vs two-stage on the "
        f"plain versions (per shard, host merge): values rel {err:.3e}, "
        f"{swaps} index swaps (near-ties), excluded ids returned: {hit}")
    check(ok and not hit, "tier-2 responses differ from the plain two-stage "
          "retrieval")


def profile_serving_batch(torch, ds, store):
    """torch.profiler over engine batches of 8 users (``score_batch``) on
    the single-stage and the tier-2 engine: wall time per batch, device
    busy time, idle share, device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.store import padded_pos_lists

    exclude = padded_pos_lists(ds.train_pos, ds.n_users)
    ids = zipf_stream(ds.n_users, 8 * PROFILED_BATCHES, a=ZIPF_A, seed=1)
    for label, kw in (("single-stage", {}),
                      ("tier-2", dict(two_stage_c=TIER2["two_stage"],
                                      item_shards=TIER2["item_shards"]))):
        with ServingEngine(store, k=20, exclude=exclude,
                           buckets=(1, 2, 4, 8), **kw) as eng:
            eng.warmup()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for b in range(PROFILED_BATCHES):
                    eng.score_batch(ids[8 * b:8 * b + 8])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / PROFILED_BATCHES
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total
                   for e in kernels) / 1e3 / PROFILED_BATCHES
        log(f"[profile] {label} engine batch of 8 (mean of "
            f"{PROFILED_BATCHES}): wall {wall:.3f} ms, device busy "
            f"{busy:.3f} ms, idle share "
            + (f"{1 - busy / wall:.3f}" if busy > 0 else
               "not measured (no device events)"))
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
                f"x{e.count:<4d} {e.key[:100]}")


def check_two_stage_accuracy(torch, ds, store):
    """Two-stage recall@20 against single stage on all users (printed, not
    checked: a property of the weights), and the m = n_items anchor on
    256 users against the single-stage top-K kernel."""
    from repro_torch.serving.eval import streaming_eval_dataset
    from repro_torch.serving.scorer import topk_scores, two_stage_topk
    from repro_torch.serving.store import padded_pos_lists

    t0 = time.perf_counter()
    r1, n1 = streaming_eval_dataset(store, ds, k=20)
    t1 = time.perf_counter()
    r2, n2 = streaming_eval_dataset(store, ds, k=20,
                                    two_stage_c=TIER2["two_stage"])
    t2 = time.perf_counter()
    log(f"[accuracy] all {ds.n_users} users: recall@20 single-stage {r1:.6f} "
        f"({t1 - t0:.3f} s), two-stage C {TIER2['two_stage']} {r2:.6f} "
        f"({t2 - t1:.3f} s), ratio {r2 / max(r1, 1e-12):.4f}; ndcg@20 "
        f"{n1:.6f} / {n2:.6f}")
    excl_all = torch.from_numpy(padded_pos_lists(ds.train_pos, ds.n_users))
    c_all = -(-ds.n_items // 20)
    worst, swaps = 0.0, 0
    n_users = min(ANCHOR_USERS, ds.n_users)
    for u0 in range(0, n_users, 64):
        ids = torch.arange(u0, min(u0 + 64, n_users), device=DEV)
        q = store.user_vectors(ids)
        excl = excl_all.to(DEV)[ids]
        av, ai = two_stage_topk(q, store.items, 20, c=c_all, exclude=excl)
        sv, si = topk_scores(q, store.items, 20, exclude=excl)
        err, n_sw, ok = _close_topk(torch, av, ai, sv, si)
        worst, swaps = max(worst, err), swaps + n_sw
        check(ok, f"two-stage anchor (m = n_items) differs from single "
              f"stage for users from {u0}")
    log(f"[accuracy] anchor C {c_all} (m = n_items = {ds.n_items}) on "
        f"{n_users} users vs the single-stage kernel: values rel "
        f"{worst:.3e}, {swaps} index swaps (near-ties)")
    return r2 / max(r1, 1e-12)


def check_rerank(torch, ds, res, recall_ratio):
    """The tier-2 re-rank through the fused row gather
    (``ops.dequantize_rows``) against the PR 13 route (``QTensor.select``,
    then the unpack kernel): two-stage responses for 256 of the burst's
    users, engine batches of 8, on each served shard table, values and
    indices bit-identical. Prints them beside the two-stage recall ratio
    and the delta refresh, both checked by the phases before."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import _shard_items
    from repro_torch.serving.scorer import two_stage_topk
    from repro_torch.serving.store import padded_pos_lists

    def select_route(q, idx):
        return ops.dequantize(q.select(idx.long()))

    store, k, c = res["store"], res["k"], TIER2["two_stage"]
    shards = _shard_items(store.items, TIER2["item_shards"])
    offs = np.cumsum([0] + [s.rows for s in shards])[:-1]
    excl_all = torch.from_numpy(padded_pos_lists(ds.train_pos,
                                                 ds.n_users)).to(DEV)
    users = torch.from_numpy(res["users"][:SERVED_USERS]).to(DEV)
    n_same = n_calls = 0
    for u0 in range(0, len(users), ENGINE_BATCH):
        ids = users[u0:u0 + ENGINE_BATCH]
        q, excl = store.user_vectors(ids), excl_all[ids]
        for off, sh in zip(offs, shards):
            args = (q, sh, min(k, sh.rows))
            kw = dict(c=c, exclude=excl - int(off))
            fv, fi = two_stage_topk(*args, **kw)
            with plain_versions(ops, dequantize_rows=select_route):
                sv, si = two_stage_topk(*args, **kw)
            n_same += int(torch.equal(fv, sv) and torch.equal(fi, si))
            n_calls += 1
    log(f"[rerank] two-stage responses, fused row gather vs the PR 13 "
        f"route (select, then unpack), {len(users)} users in batches of "
        f"{ENGINE_BATCH} on {len(shards)} shard tables: {n_same} of "
        f"{n_calls} calls bit-identical; two-stage recall@20 ratio "
        f"{recall_ratio:.4f} ([accuracy]); delta refresh bit-exact "
        f"([tier2])")
    check(n_same == n_calls, "the fused re-rank changed a response")


# -- the training path -------------------------------------------------------


def train_quietly(train, name, *args, **kw):
    """``train`` (``train_kgnn`` or ``train_model``) with its trainer's
    lines kept, not printed; fails if a step failed (a rollback would hide
    it)."""
    lines = []
    res = train(*args, log=lines.append, **kw)
    failed = [x for x in lines if "failed" in x]
    check(not failed, f"{name}: a training step failed: {failed}")
    return res


def train_run(torch, tag, name, step, label, steps, *, exact=False,
              falls=False, keep_params=False):
    """``train_model`` on ``step`` under schedule ``label`` for ``steps``
    steps from its seed-0 parameters, the launch counts reset just before
    and read just after: losses finite (and falling, ``falls``), every
    kernel of the model's path launched (``exact``: those and no other),
    the same launches every step. Prints and returns the median step, the
    peak allocated memory, the ACT residual bytes (and their FP32 price)
    and the launches (and, ``keep_params``, the trained parameters)."""
    from repro_torch.core.policy import parse_schedule
    from repro_torch.kernels import backend
    from repro_torch.launch.train import train_model
    from repro_torch.models.registry import path_kernels

    params = step.init(0)
    torch.cuda.synchronize()
    backend.reset_counts()
    t0 = time.perf_counter()
    res = train_quietly(train_model, f"{tag} {name}", step, params,
                        parse_schedule(label), steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(backend.LAUNCH_COUNTS)
    hist = res["steps"]
    trained = res["params"] if keep_params else None
    del res, params
    losses = [r["loss"] for r in hist]
    act = hist[0]["act"]
    per_step = hist[-1]["launches"]
    r = dict(counts=counts, losses=losses, per_step=per_step,
             step_ms=statistics.median(x["seconds"] for x in hist) * 1e3,
             first_ms=hist[0]["seconds"] * 1e3, run_ms=wall * 1e3 / len(hist),
             peak=max(x["max_memory_allocated"] or 0 for x in hist),
             act_bytes=act["total_bytes"], act_fp32=act["total_fp32_bytes"])
    log(f"[{tag}] {name}: losses {[f'{v:.6f}' for v in losses]}")
    log(f"[{tag}] {name}: step {r['step_ms']:.2f} ms median of {len(hist)} "
        f"(first {r['first_ms']:.2f} ms; the run's wall time a step, data "
        f"waits and set-up included, {r['run_ms']:.2f} ms), "
        f"max_memory_allocated {r['peak']} B ({r['peak'] / 2**20:.1f} MiB), "
        f"ACT residual bytes {r['act_bytes']} ({r['act_bytes'] / 1e6:.1f} "
        f"MB; FP32-priced {r['act_fp32'] / 1e6:.1f} MB, "
        + (f"{r['act_fp32'] / r['act_bytes']:.2f}x)" if r["act_bytes"]
           else "no ACT site)"))
    log(f"[{tag}] {name}: launches per step "
        f"{json.dumps(per_step, sort_keys=True)}; run total "
        f"{json.dumps(counts, sort_keys=True)}")
    check(all(math.isfinite(v) for v in losses),
          f"[{tag}] {name}: non-finite loss")
    check(not falls or losses[-1] < losses[0],
          f"[{tag}] {name}: the loss did not fall: {losses}")
    model = "gcn" if step.family == "gnn" else step.cfg.model
    want = set(path_kernels(model, label != "fp32"))
    check(set(per_step) == want if exact else want <= set(counts),
          f"[{tag}] {name}: launched {sorted(counts)}, the path has "
          f"{sorted(want)}")
    check(all(x["launches"] == per_step for x in hist),
          f"[{tag}] {name}: launches differ between steps")
    if keep_params:
        r["params"] = trained
    return r


def _kg_step(cfg, ds, g):
    """The full-width BPR step of KG ``cfg.model`` on the built CKG ``g``."""
    from repro_torch.models.registry import arch_of, build_step

    return build_step(arch_of(cfg.model), ds=ds, cfg=cfg,
                      batch_size=TRAIN_BATCH, device=DEV, graph=g)


def run_training(torch, cfg, ds, g):
    """Train KGAT at full width under each schedule (``train_run``); exact
    ACT bytes: 5 sites a layer, each one (nodes, d) residual."""
    step = _kg_step(cfg, ds, g)
    runs = {label: train_run(torch, "train", label, step, label, TRAIN_STEPS)
            for label in SCHEDULES}
    n_sites = 5 * cfg.n_layers
    want = n_sites * cfg.n_nodes * cfg.dim * 4
    check(all(r["act_fp32"] == want for r in runs.values())
          and runs["fp32"]["act_bytes"] == want,
          f"FP32 ACT bytes are not {n_sites} sites x {cfg.n_nodes} x "
          f"{cfg.dim} fp32")
    check(runs["int2"]["act_bytes"] == n_sites * cfg.n_nodes
          * (cfg.dim * 2 // 8 + 8), "INT2 ACT bytes")
    log(f"[train] traced ACT bytes INT2 / FP32: "
        f"{runs['int2']['act_bytes']} / {runs['fp32']['act_bytes']} = 1 / "
        f"{runs['fp32']['act_bytes'] / runs['int2']['act_bytes']:.2f}")
    return runs


def profile_step(torch, cfg, ds, g, label="int2", top=15):
    """``profile_model_step`` on the full-width BPR step of KG
    ``cfg.model``."""
    name = label if cfg.model == "kgat" else f"{cfg.model} {label}"
    profile_model_step(torch, _kg_step(cfg, ds, g), name, label, top)


def profile_model_step(torch, step, name, label="int2", top=15):
    """torch.profiler over one steady training step of ``step``: device
    time by kernel (the ``top`` longest), busy time and idle share of the
    step's wall time; fails on an index_add_ scatter kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.training.optimizer import adam
    from repro_torch.training.step import make_train_step

    opt = adam(step.lr)
    params = step.init(0)
    train = make_train_step(step, opt, schedule=parse_schedule(label),
                            root_seed=ROOT_SEED)
    batches = step.batches()
    state = (params, opt.init(params))
    state, m = train(state, next(batches), 0)         # warm
    batch = next(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = train(state, batch, 1)
        float(m["loss"])
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {name} step: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share "
        + (f"{1 - busy / (wall * 1e3):.3f}" if busy > 0 else
           "not measured (no device events)"))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:110]}")
    check(busy > 0, f"{name} step: the profiler saw no device time")
    # index_add_ (index_select's backward) runs as indexFuncLargeIndex /
    # indexFuncSmallIndex; the step has no index_add_ left
    scatter = [e.key for e in kernels
               if "indexFunc" in e.key or "index_add" in e.key]
    log(f"[profile] {name} step: index_add_ scatter kernels: "
        f"{scatter if scatter else 'none'}")
    check(not scatter, f"{name} step still scatters with index_add_: "
          f"{scatter}")


def _clone_state(torch, state):
    """A deep copy of a (params, Adam state) pair: Adam updates in place."""
    def c(v):
        if isinstance(v, torch.Tensor):
            return v.detach().clone().requires_grad_(v.requires_grad)
        if isinstance(v, (list, tuple)):
            return type(v)(c(t) for t in v)
        if isinstance(v, dict):
            return {k: c(t) for k, t in v.items()}
        return v

    return c(state)


def check_two_steps(torch, tag, name, step, label):
    """Two steps of ``step`` under schedule ``label`` from one state
    (parameters and Adam moments after a first step) on one batch, without
    ``torch.use_deterministic_algorithms``: the loss, every parameter and
    every moment bit-identical."""
    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.models.layers import param_leaves
    from repro_torch.training.optimizer import adam
    from repro_torch.training.step import make_train_step

    check(not torch.are_deterministic_algorithms_enabled(),
          "deterministic algorithms are on")
    opt = adam(step.lr)
    batches = step.batches()
    train = make_train_step(step, opt, schedule=parse_schedule(label),
                            root_seed=ROOT_SEED)
    params = step.init(0)
    state, _ = train((params, opt.init(params)), next(batches), 0)
    batch = next(batches)
    (p1, o1), m1 = train(_clone_state(torch, state), batch, 1)
    (p2, o2), m2 = train(_clone_state(torch, state), batch, 1)
    leaves = list(zip(param_leaves(p1) + o1["mu"] + o1["nu"],
                      param_leaves(p2) + o2["mu"] + o2["nu"]))
    n_same = sum(bool(torch.equal(a, b)) for a, b in leaves)
    same_loss = bool(torch.equal(m1["loss"], m2["loss"]))
    worst = max(float((a - b).abs().max()) for a, b in leaves)
    log(f"[{tag}] {name}: two steps from one state: loss "
        f"{float(m1['loss']):.9f} / {float(m2['loss']):.9f} "
        f"({'bit-identical' if same_loss else 'DIFFER'}), {n_same} of "
        f"{len(leaves)} parameter and moment tensors bit-identical (max "
        f"|diff| {worst:.3e})")
    check(same_loss and n_same == len(leaves),
          f"[{tag}] {name}: two steps from one state differ")


def check_determinism(torch, cases, ds, g):
    """``check_two_steps`` at full width for each ``(cfg, schedule label)``
    of ``cases``."""
    for cfg, label in cases:
        check_two_steps(torch, "determinism", label if cfg.model == "kgat"
                        else f"{cfg.model} {label}", _kg_step(cfg, ds, g),
                        label)


def run_training_kg(torch, ds, g):
    """KGCN, KGIN (the paper's configs) and R-GCN (KGAT's config, 4 bases,
    readout sum) at full width on the same graph, each under FP32 and
    INT2 (``train_run``). Exact ACT bytes: every site of ``model_sites``
    saves one (nodes, d) residual a layer."""
    from repro_torch.models import kgnn
    from repro_torch.models.registry import model_config

    runs = {}
    for model in KG_MODELS:
        cfg = model_config(model)
        step = _kg_step(cfg, ds, g)
        n_sites = len(kgnn.model_sites(cfg)) * cfg.n_layers
        want = {"fp32": n_sites * cfg.n_nodes * cfg.dim * 4,
                "int2": n_sites * cfg.n_nodes * (cfg.dim * 2 // 8 + 8)}
        for label in KG_SCHEDULES:
            name = f"{model} {label}"
            r = runs[f"{model}_{label}"] = train_run(
                torch, "train-kg", name, step, label, KG_STEPS)
            check(r["act_fp32"] == want["fp32"] and r["act_bytes"]
                  == want[label], f"{name}: ACT bytes {r['act_bytes']} / "
                  f"{r['act_fp32']}, want {want[label]} / {want['fp32']} "
                  f"({n_sites} sites x {cfg.n_nodes} rows)")
    return runs


def check_reduced_kg(torch):
    """Three reduced INT2 steps of each KG model on the card against the
    CPU's plain versions: losses within 1e-4 relative (as
    tests/test_torch_cuda.py)."""
    from repro_torch.configs import get
    from repro_torch.configs.smoke import reduced
    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.serve import reduced_dataset
    from repro_torch.launch.train import train_kgnn
    from repro_torch.models import kgnn
    from repro_torch.models.registry import model_config

    for model in KG_MODELS:
        cfg = model_config(model, lambda a: reduced(get(a)))
        ds = reduced_dataset(cfg)
        losses = {}
        for dev in ("cpu", DEV):
            res = train_quietly(train_kgnn, f"reduced {model} on {dev}", cfg,
                                ds, kgnn.init_params(cfg, device=dev),
                                parse_schedule("int2"), 3, batch=64,
                                device=dev)
            losses[dev] = [r["loss"] for r in res["steps"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[DEV],
                                                       losses["cpu"]))
        log(f"[train-kg] reduced {model} INT2, card vs CPU plain versions: "
            f"losses {[f'{v:.6f}' for v in losses[DEV]]}, max rel {rel:.3e}")
        check(rel <= 1e-4, f"reduced {model} differs from the CPU by {rel}")


def check_replay(torch, cfg, ds, g):
    """Checkpoint, restore and replay at full width (KGAT, FP32 and INT2):
    a trainer takes 3 steps, checkpointing at step 2; step 3 from the step-2
    checkpoint, restored from disk into a fresh trainer, on step 3's batch,
    gives the same loss, parameters and Adam moments bit for bit. A failure
    injected before step 3 rolls back to step 2 and the run still ends at
    step 3."""
    import shutil
    import tempfile

    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.models.layers import param_leaves
    from repro_torch.models.registry import build_step
    from repro_torch.training.checkpoint import restore_checkpoint, \
        save_checkpoint
    from repro_torch.training.optimizer import adam
    from repro_torch.training.step import make_train_step, step_metadata, \
        trainable
    from repro_torch.training.trainer import Trainer, TrainerConfig

    step = build_step("kgat", ds=ds, cfg=cfg, batch_size=TRAIN_BATCH,
                      device=DEV, graph=g)
    opt = adam(step.lr)
    batches = [b for _, b in zip(range(4), step.batches())]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        tmp = Path(tmp)
        for label in ("fp32", "int2"):
            train = make_train_step(step, opt,
                                    schedule=parse_schedule(label),
                                    root_seed=ROOT_SEED)
            meta = step_metadata(step, label)

            def trainer(name, data, logs):
                p = trainable(step.init(0))
                return Trainer(train, (p, opt.init(p)), iter(data),
                               TrainerConfig(total_steps=3, ckpt_every=2,
                                             ckpt_dir=str(tmp / name)),
                               ckpt_meta=meta, log_fn=logs.append)

            clean = []
            first = trainer(f"{label}_a", batches[:3], clean)
            p1, o1 = first.run()
            (tmp / f"{label}_b").mkdir()
            shutil.copytree(tmp / f"{label}_a" / "step_0000000002",
                            tmp / f"{label}_b" / "step_0000000002")
            replay = trainer(f"{label}_b", batches[2:3],
                             clean).restore_if_available()
            check(replay.step == 2, f"{label}: restored step {replay.step}")
            p2, o2 = replay.run()
            check(not any("failed" in x for x in clean),
                  f"{label}: a step of the original or the replay failed: "
                  f"{clean}")
            leaves = list(zip(param_leaves(p1) + o1["mu"] + o1["nu"],
                              param_leaves(p2) + o2["mu"] + o2["nu"]))
            n_same = sum(bool(torch.equal(a, b)) for a, b in leaves)
            l1, l2 = first.history[2]["loss"], replay.history[0]["loss"]
            log(f"[replay] {label}: step 3 from the step-2 checkpoint on "
                f"step 3's batch: loss {l2:.9f} vs {l1:.9f} "
                f"({'bit-identical' if l1 == l2 else 'DIFFER'}), {n_same} of "
                f"{len(leaves)} parameter and moment tensors bit-identical")
            check(l1 == l2 and n_same == len(leaves)
                  and o1["step"] == o2["step"] == 3,
                  f"{label}: the replayed step differs")
            logs = []
            failing = trainer(f"{label}_c", batches, logs)
            failed = []

            def inject(i):
                if i == 2 and not failed:
                    failed.append(i)
                    return True
                return False

            failing.failure_injector = inject
            failing.run()
            rolled = [m for m in logs if "rolled back" in m]
            log(f"[replay] {label}: failure injected before step 3: "
                f"{rolled}, ends at step {failing.step} with "
                f"{len(failing.history)} step records")
            check(rolled == ["[trainer] rolled back to step 2"]
                  and failing.step == 3 and len(failing.history) == 3,
                  f"{label}: the injected failure did not roll back")
            del p1, o1, p2, o2, leaves, first, replay, failing
        p = trainable(step.init(0))
        state = (p, opt.init(p))
        n_bytes = sum(t.numel() * t.element_size()
                      for t in param_leaves(state[0]) + state[1]["mu"]
                      + state[1]["nu"])
        t0 = time.perf_counter()
        save_checkpoint(str(tmp / "sync"), 0, state)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore_checkpoint(str(tmp / "sync"), state)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    log(f"[replay] full-width KGAT state {n_bytes} B: synchronous save "
        f"{t_save:.3f} s, restore to the card {t_restore:.3f} s")


def check_launch(torch):
    """The launcher at its default (reduced) size on the card, in process:
    kgcn 4 steps with --ckpt, --metrics-out and --trace, then 8 steps on
    the same directory (it resumes at step 4); the step log, the summary
    (the port's validator) and the trace exist; a restore under another
    arch is refused. The second run's summary counts its 4 steps alone."""
    import tempfile

    from repro_torch.launch import train as launcher
    from repro_torch.obs import validate_summary

    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        ckpt, out = str(Path(tmp) / "ckpt"), Path(tmp) / "m"
        argv = ["--arch", "kgcn", "--bits", "2", "--ckpt", ckpt,
                "--metrics-out", str(out), "--trace",
                str(out / "trace.json")]
        t0 = time.perf_counter()
        launcher.main(argv + ["--steps", "4"])
        launcher.main(argv + ["--steps", "8"])
        wall = time.perf_counter() - t0
        rows = [json.loads(x) for x in
                (out / "steps.jsonl").read_text().splitlines()]
        summary = json.loads((out / "summary.json").read_text())
        validate_summary(summary)
        step_ms = summary["histograms"].get("train/step_ms", {})
        check(summary["run"]["kind"] == "train"
              and step_ms.get("count") == 4
              and summary["counters"].get("train/steps") == 4,
              "summary.json does not hold the second run's 4 steps alone")
        names = {e["name"] for e in json.loads(
            (out / "trace.json").read_text())["traceEvents"]}
        log(f"[launch] kgcn --steps 4 then 8 on one --ckpt ({wall:.1f} s): "
            f"second run's step lines {[r['step'] for r in rows]}, "
            f"act_total_bytes {rows[0].get('act_total_bytes')}, summary "
            f"train/step_ms {summary['histograms']['train/step_ms']}, "
            f"trace spans {sorted(names)}")
        check([r["step"] for r in rows] == [5, 6, 7, 8],
              "the second launcher run did not resume at step 4")
        check({"train", "train/step", "train/step/data",
               "train/step/update"} <= names, "trace lacks the train spans")
        try:
            launcher.main(["--arch", "kgin", "--bits", "2", "--steps", "8",
                           "--ckpt", ckpt])
            refused = None
        except ValueError as e:
            refused = str(e)
        log(f"[launch] --arch kgin on kgcn's checkpoints: {refused}")
        check(refused is not None and "written for a different run" in
              refused, "a restore under another arch was not refused")


def _grads(torch, step, params, batch, label):
    from repro_torch.core.context import act_context
    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.models.layers import param_leaves

    ctx = act_context(parse_schedule(label), ROOT_SEED, step=0)
    loss = step.loss(params, batch, ctx=ctx)
    grads = torch.autograd.grad(loss, param_leaves(params))
    return float(loss.detach()), grads


def _fp64_versions(torch, g):
    """SPMM and SDDMM over the graph's COO edges in the inputs' dtype (the
    float64 reference step of ``check_train_grads``)."""
    src, dst = g.src.long(), g.dst.long()

    def spmm(x, ew, layout, *, transpose=False):
        a, b = (dst, src) if transpose else (src, dst)
        m = layout.meta
        out = torch.zeros((m.n_src if transpose else m.n_dst,
                           x.shape[1]), dtype=x.dtype, device=x.device)
        msgs = x.index_select(0, a)
        if ew is not None:
            msgs = msgs * ew.to(x.dtype)[:, None]
        return out.index_add_(0, b, msgs)

    def grad_ew(res, grad, layout):
        return (res.index_select(0, src) * grad.index_select(0, dst)).sum(-1)

    return spmm, grad_ew


def _err64(got, ref):
    """(rms, max) of ``got - ref`` relative to ``ref``'s rms and max."""
    diff = got.double() - ref
    return (float(diff.square().mean().sqrt() / ref.square().mean().sqrt()),
            float(diff.abs().max() / ref.abs().max()))


def check_train_grads(torch, cfg, ds, g):
    """One full-width step of ``cfg.model`` with the kernels against the
    same step with every kernel's plain version (same seeds, parameters and
    batch), at FP32 and INT2; at FP32 both against the same step in
    float64, at INT2 the difference against the stochastic rounding's own
    noise (the INT2 step's distance from the FP32 step). The kernels' steps run as
    the training path runs them. The plain steps run under
    ``torch.use_deterministic_algorithms``: the plain versions still add
    with ``index_add_``, whose atomics' order on the card moved the plain
    error from run to run (a LeakyReLU input within 2e-8 of 0 flips with
    the order, and moves w2[0]'s error 25x); in that mode each row sums in
    a fixed order."""
    from repro_torch.core.quant import QTensor
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp
    from repro_torch.models.layers import param_leaves
    from repro_torch.models.registry import arch_of, build_step
    from repro_torch.training.step import trainable

    def grad_ew_plain(res, grad, layout):
        if isinstance(res, QTensor):
            return sp.dequant_sddmm_plain(res, grad, layout)
        return sp.sddmm_plain(res, grad, layout)

    step = build_step(arch_of(cfg.model), ds=ds, cfg=cfg,
                      batch_size=TRAIN_BATCH, device=DEV, graph=g)
    batch = next(step.batches())
    params = step.init(0)
    names = [f"{k}[{i}]" if isinstance(params[k], list) else k
             for k in sorted(params)
             for i in range(len(params[k]) if isinstance(params[k], list)
                            else 1)]
    check(len(names) == len(param_leaves(params)), "parameter names")
    got = {}
    for label in ("fp32", "int2"):
        got[label, "kernels"] = _grads(torch, step, params, batch, label)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for label in ("fp32", "int2"):
                with plain_versions(ops, spmm=sp.spmm_plain,
                                    segment_sum=sp.segment_sum_plain,
                                    quant_pack=qp.quant_pack_plain,
                                    spmm_grad_ew=grad_ew_plain,
                                    dequant_matmul=dq.dequant_matmul_plain):
                    got[label, "plain"] = _grads(torch, step, params, batch,
                                                 label)
            spmm64, grad_ew64 = _fp64_versions(torch, g)
            p64 = trainable({k: [t.double() for t in v]
                             if isinstance(v, list) else v.double()
                             for k, v in params.items()})
            with plain_versions(ops, spmm=spmm64, spmm_grad_ew=grad_ew64,
                                segment_sum=sp.segment_sum_plain):
                l64, g64 = _grads(torch, step, p64, batch, "fp32")
    finally:
        torch.use_deterministic_algorithms(False)
    for label in ("fp32", "int2"):
        (lk, gk), (lp, gp) = got[label, "kernels"], got[label, "plain"]
        tag = label if cfg.model == "kgat" else f"{cfg.model} {label}"
        check(abs(lk - lp) <= TOL * abs(lp),
              f"{tag} loss with kernels {lk} vs plain {lp}")
        worst = 0.0
        for i, name in enumerate(names):
            diff = float((gk[i] - gp[i]).abs().max())
            if label == "fp32":
                err_k, max_k = _err64(gk[i], g64[i])
                err_p, max_p = _err64(gp[i], g64[i])
                share = err_k / max(err_p, TOL / GRAD_FP64_RATIO)
                ok = err_k <= max(GRAD_FP64_RATIO * err_p, TOL)
                note = (f", error vs float64 (rms; max): kernels {err_k:.3e}"
                        f"; {max_k:.3e}, plain {err_p:.3e}; {max_p:.3e}")
            else:
                noise = float((gk[i] - got["fp32", "kernels"][1][i])
                              .abs().max())
                share = (diff / noise if noise else
                         0.0 if diff == 0 else math.inf)
                ok = share <= GRAD_NOISE_SHARE
                note = f", share of SR noise {share:.3e}"
            worst = max(worst, share)
            log(f"[grads] {tag} {name}: max |kernels - plain| {diff:.3e}, "
                f"rel {diff / float(gp[i].abs().max()):.3e}{note}")
            check(ok, f"{tag} gradient of {name} out of tolerance")
        log(f"[grads] {tag}: loss kernels {lk:.8f} plain {lp:.8f}"
            + (f" float64 {l64:.8f}; worst rms error ratio kernels / "
               f"max(plain, {TOL / GRAD_FP64_RATIO:g}) "
               f"{worst:.3f} (limit {GRAD_FP64_RATIO})"
               if label == "fp32" else
               f"; worst SR-noise share {worst:.3e} (limit "
               f"{GRAD_NOISE_SHARE})"))


@contextlib.contextmanager
def plain_versions(ops, **plain):
    """Route ``ops.<name>`` to the given plain version, CUDA tensors
    included (the reference runs of this script only)."""
    saved = {n: getattr(ops, n) for n in plain}
    try:
        for n, fn in plain.items():
            setattr(ops, n, fn)
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def check_served_path(torch, cfg, ds, g, params, res):
    """Hold what the main path served against plain versions at full width:
    the rollout, the packed store, and the engine's top-K responses."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp
    from repro_torch.kernels import topk_score as tk
    from repro_torch.models import kgnn
    from repro_torch.serving.store import (QuantizedEmbeddingStore,
                                           padded_pos_lists)

    reps = kgnn.propagate(params, g, cfg)
    with plain_versions(ops, spmm=sp.spmm_plain):
        reps_plain = kgnn.propagate(params, g, cfg)
    rel = _rel(reps, reps_plain)
    log(f"[served] full-width rollout, kernels vs plain SPMM: rel {rel:.3e}")
    check(rel <= TOL, f"full-width rollout differs from plain by {rel}")

    store = res["store"]
    n_u = cfg.n_users
    with plain_versions(ops, quant_pack=qp.quant_pack_plain):
        ref = QuantizedEmbeddingStore.from_arrays(
            reps[:n_u], reps[n_u:n_u + ds.n_items], bits=store.bits)
    same = all(torch.equal(a, b) for s_t, r_t in
               ((store.users, ref.users), (store.items, ref.items))
               for a, b in ((s_t.packed, r_t.packed), (s_t.scale, r_t.scale),
                            (s_t.zero, r_t.zero)))
    log(f"[served] store vs plain quant_pack of a second rollout: "
        f"{'bit-identical' if same else 'MISMATCH'}")
    check(same, "served store is not the plain packing of the rollout")

    n = SERVED_USERS
    users = res["users"][:n]
    ids = torch.from_numpy(users).to(DEV)
    excl = torch.from_numpy(padded_pos_lists(ds.train_pos, ds.n_users))
    excl = excl.to(DEV)[ids]
    pv, pi = tk.topk_plain(store.user_vectors(ids), store.items, excl,
                           k=res["k"])
    ev = torch.from_numpy(np.stack([r[0] for r in res["results"][:n]]))
    ei = torch.from_numpy(np.stack([r[1] for r in res["results"][:n]]))
    ev, ei = ev.to(DEV), ei.to(DEV)
    scale = float(pv.abs().max())
    err = float((ev - pv).abs().max())
    swapped = ei != pi
    near = bool(((ev - pv).abs()[swapped] <= TOL * scale).all())
    hit = bool((ei[:, :, None] == excl[:, None, :]).any())
    log(f"[served] engine responses for {n} users vs plain top-K on the "
        f"served store: values rel {err / scale:.3e}, "
        f"{int(swapped.sum())} index swaps (near-ties), excluded ids "
        f"returned: {hit}")
    check(err <= TOL * scale and near and not hit,
          "engine responses differ from the plain top-K")


# -- neighbour-sampled minibatch training -------------------------------------


def _sampled_step(zds, model):
    """The sampled ``ModelStep`` of KG ``model`` at the paper's width, one
    layer a fanout, with no full graph on the card."""
    import dataclasses

    from repro_torch.models.registry import arch_of, build_step, model_config

    cfg = dataclasses.replace(model_config(model),
                              n_layers=len(SAMPLED_FANOUTS))
    return build_step(arch_of(model), ds=zds, cfg=cfg, device=DEV,
                      device_graph=False)


def check_sampled_kernels(torch, sp, dq, qp, zds, gen):
    """Each training kernel on the first sampled batch's outermost block
    (batch 256, fanouts 15,10,5: about 135 k destinations, 811 k sources,
    676 k edges, trailing all-pad blocks, masked slots); see
    ``check_block_kernels``. Returns the timings by kernel name."""
    from repro_torch.data.minibatch import sampled_items

    t0 = time.perf_counter()
    item = next(sampled_items(zds, SAMPLED_FANOUTS, batch_size=SAMPLED_BATCH,
                              seed=0))
    sample_s = time.perf_counter() - t0
    sampler_ms, grads_ms, n_plans, n_rows = _plan_ms(item, zds.n_nodes)
    blk = item.view.blocks[0].to(DEV)
    m = blk.layout.meta
    n_real = int(blk.mask.sum())
    log(f"[sampled-kernels] segment-sum plans of one batch on the host: "
        f"{sampler_ms:.2f} ms in the sampler thread ({n_plans} groupings, "
        f"{n_rows} rows: both directions of each block's layout and its "
        f"relation levels; the batch took {sample_s * 1e3:.2f} ms to sample "
        f"in all) and {grads_ms:.2f} ms in the step's scatter "
        f"(``apply_grads``' grouping of the {len(item.input_nodes)} input "
        f"rows)")
    log(f"[sampled-kernels] first batch sampled in {sample_s:.2f} s; "
        f"outermost block {m.n_dst} <- {m.n_src} rows, {m.n_edges} slots "
        f"({n_real} sampled, {m.n_edges - n_real} masked), "
        f"{m.n_blocks} / {m.t_n_blocks} blocks of {m.block_e} "
        f"(static caps, pad slots {m.n_blocks * m.block_e - m.n_edges} / "
        f"{m.t_n_blocks * m.block_e - m.n_edges})")
    check(m.n_src > m.n_dst and n_real < m.n_edges
          and m.n_blocks * m.block_e > m.n_edges, "block shape")
    return check_block_kernels(torch, sp, dq, qp, blk, gen, "sampled")


def _plan_ms(item, n_nodes):
    """Host time of the segment-sum plans (``data.csr.segment_plan``) that
    one sampled batch builds, each rebuilt from its row pointers: those of
    the sampler thread (every block's layout, both directions, and its
    relation levels) and that of the tier store's scatter-back
    (``apply_grads``, on the step's own thread). Returns (sampler ms,
    scatter ms, groupings, rows)."""
    import numpy as np

    from repro_torch.data.csr import group_ids, segment_plan

    pairs = []
    for b in item.view.blocks:
        lay = b.layout
        pairs += [(lay.row_start, lay.row_end), (lay.t_row_start,
                                                 lay.t_row_end)]
        pairs += [(lv.row_start, lv.row_end) for lv in b.rel_runs]
    pairs = [(a.numpy(), b.numpy()) for a, b in pairs]
    t0 = time.perf_counter()
    for rs, re_ in pairs:
        segment_plan(rs, re_)
    sampler_ms = (time.perf_counter() - t0) * 1e3
    counts = group_ids(np.asarray(item.input_nodes, np.int64), n_nodes)[4]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    t0 = time.perf_counter()
    segment_plan(start, start + counts)
    grads_ms = (time.perf_counter() - t0) * 1e3
    return sampler_ms, grads_ms, len(pairs), sum(len(a) for a, _ in pairs)


def check_shard_kernels(torch, sp, dq, qp, ds, gen):
    """Each training kernel on the smaller shard of the full-width graph
    split over 2 ``data`` ranks (``data.csr.shard_graph_arrays``: the
    shard's 92,083 destination rows, its halo rows as sources, its 441,602
    pad edges masked and spread over the rows); see
    ``check_block_kernels``."""
    import types

    from repro_torch.data.csr import partition_edges, shard_graph_arrays

    t0 = time.perf_counter()
    part = partition_edges(ds.src, ds.dst, ds.rel, n_nodes=ds.n_nodes,
                           n_shards=2)
    s = int(part.edge_counts().argmin())     # the one with the most pads
    a = shard_graph_arrays(part, s, ds.n_relations, device=DEV)
    blk = types.SimpleNamespace(**{k: a[k] for k in (
        "src", "dst", "rel", "mask", "layout", "rel_runs")})
    m = blk.layout.meta
    runs = [int((blk.layout.row_end - blk.layout.row_start).max()),
            int((blk.layout.t_row_end - blk.layout.t_row_start).max())]
    log(f"[shard-kernels] data=2 shard {s}: {m.n_dst} destination rows <- "
        f"{m.n_src} halo rows ({a['halo_count']} real), {m.n_edges} edge "
        f"slots ({a['n_real']} real, {m.n_edges - a['n_real']} masked pads), "
        f"{m.n_blocks} / {m.t_n_blocks} blocks, longest run {runs[0]} by "
        f"destination, {runs[1]} by source "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    check(a["n_real"] == int(part.edge_counts()[s]), "shard edges")
    return check_block_kernels(torch, sp, dq, qp, blk, gen, "shard")


def spmm_case(torch, sp, layout, xin, ew, transpose, where=""):
    """The SPMM of ``xin`` over ``layout`` (weighted by ``ew``, or not) as a
    ``run_case`` case, with ``torch.sparse.mm`` as its library call. Bytes:
    the distinct rows the slots read, a source index (and a weight) a
    slot, the row pointers, the output once; a multiply-add (an add
    unweighted) a slot and column."""
    d = xin.shape[1]
    a = _spmm_library(torch, layout, ew, transpose)
    return (f"{where}spmm d={d}{' transpose' if transpose else ''}"
            f"{' unweighted' if ew is None else ''}", "spmm",
            lambda: sp.spmm_cuda(xin, ew, layout, transpose=transpose),
            lambda: sp.spmm_plain(xin, ew, layout, transpose=transpose),
            lambda: torch.sparse.mm(a, xin),
            sp.spmm_cost(layout, d, weighted=ew is not None,
                         transpose=transpose))


def rotation(x, copies: int = ROTATION):
    """``x`` and, where it fits the L2, copies in distinct memory, so that
    timed calls cycling over them never read a warm L2."""
    if x.numel() * x.element_size() > L2_BYTES:
        return [x]
    return [x] + [x.clone() for _ in range(copies - 1)]


def quant_case(qp, x, seed, where="", *, bits=2, stochastic=True):
    """The quant-pack of ``x`` (fp32 or bf16; INT2 SR unless asked) as a
    ``run_case`` case (no single library call); each kernel call takes the
    next input of ``rotation(x)``. Logs the launch's plan."""
    import torch

    rows, d = x.shape
    xs = rotation(x)
    turn = itertools.count()
    cost = qp.quant_pack_cost(rows, d, bits=bits, itemsize=x.element_size())
    bf16 = x.dtype == torch.bfloat16
    plan = qp.quant_pack_plan(rows, d, bits=bits, stochastic=stochastic,
                              dtype=x.dtype)
    rnd = "sr" if stochastic else "nearest"
    sass_key = f"{plan['route']} INT{bits} {rnd}" + (" bf16" if bf16 else "")
    log(f"  quant_pack {rows}x{d}{' bf16' if bf16 else ''} INT{bits} {rnd}: "
        f"{_plan_str(plan)}; timed calls rotate over {len(xs)} input(s); "
        + _budget_str(quant_pack_sass().get(sass_key), bound_ms(cost)[0],
                      rows * d))

    def kernel():
        return qp.quant_pack_cuda(xs[next(turn) % len(xs)], seed, bits=bits,
                                  stochastic=stochastic)

    return (f"{where}quant_pack INT{bits} {rnd} {rows}x{d}"
            f"{' bf16' if bf16 else ''}", "quant_pack", kernel,
            lambda: qp.quant_pack_plain(x.float(), seed, bits=bits,
                                        stochastic=stochastic),
            None, cost)


def dequant_matmul_case(torch, dq, q, g, where=""):
    """``dequant(q)ᵀ @ g`` as a ``run_case`` case, with the dequantized
    table's fp32 product as its library call."""
    from repro_torch.core.quant import dequantize

    rows, dim, n = q.rows, q.dim, g.shape[1]
    return (f"{where}dequant_matmul INT{q.bits} R={rows} {dim}x{n}",
            "dequant_matmul", lambda: dq.dequant_matmul_cuda(q, g),
            lambda: dq.dequant_matmul_plain(q, g),
            lambda: dequantize(q).T @ g,
            dq.dequant_matmul_cost(rows, dim, n, q.packed.shape[1]))


def run_case(torch, tag, case, *, shape="", pick=None, iters=20):
    """One kernel case ``(label, name, kernel, plain, library, cost)``
    (``cost`` a kernel module's ``*_cost``): the quant-pack's codes,
    scale and zero bit-identical to
    its plain version, any other kernel within ``TOL`` relative of it and
    the library call (``pick`` maps its result onto the kernel's) within
    ``LIB_SUM_TOL``; the same bits twice; kernel, plain version and
    library call timed (CUDA events) beside the bound. Returns the record
    of the kernels line (``shape`` prefixes its label)."""
    label, name, kernel, plain, library, cost = case
    got, again, ref = kernel(), kernel(), plain()
    if name == "quant_pack":
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = all(torch.equal(a, b) for a, b in zip(got, ref))
        rel = err = 0.0 if ok else math.inf
        what = (f"codes, scale and zero {'bit-identical' if ok else 'DIFFER'}"
                f" to the plain version")
    else:
        same = bool(torch.equal(got, again))
        rel, err = _rel(got, ref), float((got - ref).abs().max())
        ok = rel <= TOL
        what = f"rel {rel:.3e} (max abs {err:.3e})"
    lib_rel = None
    if library is not None:
        lib_out = library()
        lib_rel = _rel(lib_out if pick is None else pick(lib_out), ref)
        what += f"; library rel {lib_rel:.3e}"
        del lib_out
    log(f"[{tag}] {label}: {what}, two runs "
        f"{'bit-identical' if same else 'DIFFER'}")
    check(ok and same, f"{tag} {label}: {what}, deterministic {same}")
    check(lib_rel is None or lib_rel <= LIB_SUM_TOL,
          f"{tag} {label}: library call disagrees ({lib_rel})")
    del got, again, ref
    ms = time_ms(kernel, iters)
    plain_ms = time_ms(plain, max(iters // 4, 3))
    lib_ms = time_ms(library, iters) if library is not None else None
    bnd, by = bound_ms(cost)
    log(f"[{tag}]   time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{bnd:.4f} ms ({by}; {cost.bytes / 1e6:.3f} MB, "
        f"{cost.flops / 1e9:.3f} G ops)")
    rec = dict(shape=f"{shape}{label}", max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
               library_ms=lib_ms)
    if name == "quant_pack":
        rec["device_ms"] = dev = device_ms(torch, kernel)
        log(f"[{tag}]   device {dev:.4f} ms (held stream): {bnd / dev:.0%} "
            f"of the bound")
    return rec


def check_block_kernels(torch, sp, dq, qp, blk, gen, tag):
    """Each training kernel on one bipartite block (a sampled hop or a
    rank's shard: masked slots, sources != destinations): the SPMM (d 64,
    its transpose, d 1), the fp32 SDDMM (d 64), the packed SDDMM (INT2),
    the dequant-matmul (INT2, the block's destination rows), the segment
    sum (by relation d 64, by source d 64, by destination d 1) and the
    quant-pack (INT2 SR, the source rows), each through ``run_case``.
    Returns the records by kernel name (``<tag>_shape`` in the kernels
    line)."""
    from repro_torch.core.quant import dequantize, quantize

    m = blk.layout.meta
    ew = torch.rand(m.n_edges, generator=gen, device=DEV) * blk.mask
    x = torch.randn((m.n_src, 64), generator=gen, device=DEV) * 0.1
    g = torch.randn((m.n_dst, 64), generator=gen, device=DEV) * 1e-3
    ones = torch.ones((m.n_src, 1), device=DEV)
    q = quantize(x, 0x5A, bits=2, stochastic=True)
    xd = x[:m.n_dst].contiguous()
    qd = quantize(xd, 0x5B, bits=2, stochastic=True)
    y = torch.randn((m.n_edges, 64), generator=gen, device=DEV) * 1e-3
    sddmm_lib, pos = _sddmm_library(torch, blk)
    dp = q.packed.shape[1]
    E = m.n_edges
    seg_inputs = {}

    def seg_case(kind, levels, rows, d):
        ids = {"rel": blk.rel, "src": blk.src, "dst": blk.dst}[kind].long()
        n_out = levels[-1].n_out
        yy = rows[:, :d].contiguous()
        label = f"segment_sum by {kind} d={d}"
        seg_inputs[label] = (yy, levels)
        return (label, "segment_sum",
                lambda: sp.segment_sum_cuda(yy, levels),
                lambda: sp.segment_sum_plain(yy, levels),
                lambda: torch.zeros((n_out, d), device=DEV).index_add_(
                    0, ids, yy),
                sp.segment_sum_cost(levels, d))

    cases = [
        spmm_case(torch, sp, blk.layout, x, ew, False),
        spmm_case(torch, sp, blk.layout, g, ew, True),
        spmm_case(torch, sp, blk.layout, ones, ew, False),
        ("sddmm d=64", "sddmm", lambda: sp.sddmm_cuda(x, g, blk.layout),
         lambda: sp.sddmm_plain(x, g, blk.layout),
         lambda: sddmm_lib(x, g), sp.sddmm_cost(blk.layout, 64)),
        ("dequant_sddmm INT2 d=64", "dequant_sddmm",
         lambda: sp.dequant_sddmm_cuda(q, g, blk.layout),
         lambda: sp.dequant_sddmm_plain(q, g, blk.layout),
         lambda: sddmm_lib(dequantize(q), g),
         sp.dequant_sddmm_cost(blk.layout, 64, dp)),
        dequant_matmul_case(torch, dq, qd, g),
        seg_case("rel", blk.rel_runs, y, 64),
        seg_case("src", blk.layout.runs(transpose=True), y, 64),
        seg_case("dst", blk.layout.runs(), y, 1),
        quant_case(qp, x, 0x5C),
    ]
    out = {}
    for case in cases:
        label, name, library, cost = case[0], case[1], case[4], case[5]
        pick = ((lambda v: v.values()[pos])
                if name in ("sddmm", "dequant_sddmm") else None)
        rec = run_case(torch, f"{tag}-kernels", case, pick=pick,
                       shape=f"{tag} block E={E} n_dst={m.n_dst} "
                             f"n_src={m.n_src} ")
        if name == "segment_sum":
            yy, levels = seg_inputs[label]
            rec.update(segment_sum_report(torch, sp, yy, levels, library,
                                          cost,
                                          f"[{tag}-kernels] {label}"))
            if tag == "sampled" and label == "segment_sum by src d=64":
                check(rec["device_ms"] <= rec["library_device_ms"],
                      f"sampled {label}: kernel {rec['device_ms']} ms "
                      f"slower than index_add_'s "
                      f"{rec['library_device_ms']} ms (device time)")
        out.setdefault(name, []).append(rec)
    return out


def run_sampled(torch, zds, full_peak):
    """Sampled minibatch training at the paper's width on the zipf graph
    through ``run_sampled_training`` (fanouts 15,10,5, batch 256,
    hot_frac 0.1, Adam 3e-3, root seed 1): KGAT under FP32 and INT2, KGCN,
    KGIN and R-GCN under INT2, then KGAT INT2 with no hot tier. Launch
    counts are reset just before each run and read just after; every
    kernel of the model's path must have launched."""
    from repro_torch.core.policy import parse_schedule
    from repro_torch.kernels import backend
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.models.registry import path_kernels
    from repro_torch.training.tiering import run_sampled_training

    runs = {}
    for model, label, steps, hot in SAMPLED_RUNS:
        step = _sampled_step(zds, model)
        torch.cuda.synchronize()
        backend.reset_counts()
        rep, _, _ = run_sampled_training(
            step, fanouts=SAMPLED_FANOUTS, steps=steps,
            batch_size=SAMPLED_BATCH, hot_frac=hot,
            schedule=parse_schedule(label), root_seed=ROOT_SEED)
        torch.cuda.synchronize()
        counts = dict(backend.LAUNCH_COUNTS)
        key = f"{model}_{label}" + ("" if hot else "_hot0")
        name = key.replace("_", " ")
        check(all(v % steps == 0 for v in counts.values()),
              f"sampled {name}: launches differ between steps ({counts})")
        per_step = {k: v // steps for k, v in counts.items()}
        phases = {p: statistics.median(v) for p, v in rep.phase_ms.items()}
        act = rep.act
        r = runs[key] = dict(
            counts=counts, per_step=per_step, losses=rep.losses,
            step_ms=statistics.median(rep.step_ms_all),
            rows=rep.rows_transferred_per_step, hit=rep.hit_rate,
            peak=rep.peak_device_bytes)
        log(f"[sampled] {name}: losses {[f'{v:.6f}' for v in rep.losses]}")
        log(f"[sampled] {name}: step {r['step_ms']:.2f} ms median of "
            f"{steps} (first {rep.step_ms_all[0]:.2f} ms); spans "
            + ", ".join(f"{p} {v:.2f}" for p, v in phases.items())
            + f" ms; max_memory_allocated {r['peak']} B "
            f"({r['peak'] / 2**30:.2f} GiB; full-graph KGAT step "
            f"{full_peak / 2**30:.2f} GiB)")
        log(f"[sampled] {name}: hit rate {rep.hit_rate:.4f}, rows per step "
            f"{rep.rows_transferred_per_step:.1f}, hot tier "
            f"{rep.store_device_bytes / 2**20:.2f} MiB of "
            f"{rep.table_bytes / 2**20:.2f} MiB table; ACT residual bytes "
            f"{act['total_bytes']} (FP32 {act['total_fp32_bytes']}, "
            f"{act['total_fp32_bytes'] / act['total_bytes']:.2f}x); "
            f"launches per step {json.dumps(per_step, sort_keys=True)}; "
            f"store {json.dumps(rep.stats, sort_keys=True)}")
        check(all(math.isfinite(v) for v in rep.losses),
              f"sampled {name}: non-finite loss")
        for k in path_kernels(model, label != "fp32"):
            check(counts.get(k, 0) > 0,
                  f"kernel {k} never launched on the sampled {name} path")
        check(0 < r["peak"] < full_peak, f"sampled {name}: peak {r['peak']}")
        check(rep.hit_rate > 0 if hot else rep.hit_rate == 0,
              f"sampled {name}: hit rate {rep.hit_rate}")
    ratio = runs["kgat_int2"]["rows"] / runs["kgat_int2_hot0"]["rows"]
    log(f"[sampled] rows per step, hot_frac 0.1 / hot_frac 0: "
        f"{runs['kgat_int2']['rows']:.1f} / "
        f"{runs['kgat_int2_hot0']['rows']:.1f} = {ratio:.4f}")
    check(ratio < 1, "the hot tier moves no fewer rows")
    return runs


def check_sampled_determinism(torch, zds):
    """Two sampled KGAT INT2 runs of 4 steps from one seed, and a run on
    the sequential schedule (no prefetch, no patch): losses, dense
    parameters and the flushed entity table bit-identical, without
    torch.use_deterministic_algorithms; no kernel of the first run is an
    index_add_ scatter (torch.profiler), whose device busy time a step and
    idle share of the steps' wall time are printed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.models.layers import param_leaves
    from repro_torch.training.tiering import run_sampled_training

    check(not torch.are_deterministic_algorithms_enabled(),
          "deterministic algorithms are on")
    step = _sampled_step(zds, "kgat")

    def run(overlap):
        rep, dense, store = run_sampled_training(
            step, fanouts=SAMPLED_FANOUTS, steps=4, batch_size=SAMPLED_BATCH,
            hot_frac=0.1, schedule=parse_schedule("int2"),
            root_seed=ROOT_SEED, overlap=overlap)
        return (rep.losses, param_leaves(dense), store.flush().copy(),
                rep.step_ms_all)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ref = run(True)
    events = prof.key_averages()
    scatter = sorted({e.key for e in events
                      if "indexFunc" in e.key or "index_add" in e.key})
    n_kernels = sum(e.count for e in events)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    wall = sum(ref[3])
    log(f"[sampled-determinism] profiled kgat int2 run: device busy "
        f"{busy / len(ref[3]):.2f} ms a step, steps "
        f"{[round(t, 2) for t in ref[3]]} ms, idle share "
        f"{1 - busy / wall:.3f}; by kernel, a step: " + ", ".join(
            f"{e.key[:40]} {e.self_device_time_total / 1e3 / len(ref[3]):.2f}"
            for e in sorted(events, key=lambda e: -e.self_device_time_total)
            [:6]))
    for label, got in (("second run", run(True)),
                       ("sequential schedule", run(False))):
        same = [got[0] == ref[0],
                all(torch.equal(a, b) for a, b in zip(got[1], ref[1])),
                bool((got[2] == ref[2]).all())]
        log(f"[sampled-determinism] kgat int2, {label} against the first: "
            f"losses {'bit-identical' if same[0] else 'DIFFER'}, "
            f"{len(ref[1])} dense tensors "
            f"{'bit-identical' if same[1] else 'DIFFER'}, flushed entity "
            f"table {ref[2].shape} {'bit-identical' if same[2] else 'DIFFER'}")
        check(all(same), f"sampled kgat int2: {label} differs")
    log(f"[sampled-determinism] {n_kernels} device events in the first run; "
        f"index_add_ scatter kernels: {scatter if scatter else 'none'}")
    check(n_kernels > 0 and not scatter,
          f"sampled steps scatter with index_add_: {scatter}")


def check_sampled_reduced(torch):
    """Three reduced sampled INT2 steps of each KG model (zipf graph of 60
    users, d 16, fanouts 3,2, batch 16) on the card against the CPU's plain
    versions: losses within 1e-4 relative (as check_reduced_kg)."""
    from repro_torch.core.policy import parse_schedule
    from repro_torch.data.synthetic import gen_zipf_kg_dataset
    from repro_torch.models import kgnn
    from repro_torch.models.registry import arch_of, build_step
    from repro_torch.training.tiering import run_sampled_training

    ds = gen_zipf_kg_dataset(n_users=60, n_items=100, n_attrs=40,
                             n_triples=600, seed=0)
    for model in ("kgat",) + KG_MODELS:
        cfg = kgnn.KGNNConfig(
            model=model, n_users=ds.n_users, n_entities=ds.n_entities,
            n_relations=ds.n_relations, dim=16, n_layers=2,
            readout="concat" if model == "kgat" else "sum")
        losses = {}
        for dev in ("cpu", DEV):
            step = build_step(arch_of(model), ds=ds, cfg=cfg, device=dev,
                              device_graph=False)
            rep, _, _ = run_sampled_training(
                step, fanouts=(3, 2), steps=3, batch_size=16, hot_frac=0.2,
                refresh_every=2, schedule=parse_schedule("int2"),
                root_seed=1)
            losses[dev] = rep.losses
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[DEV],
                                                       losses["cpu"]))
        log(f"[sampled-reduced] {model} INT2, card vs CPU plain versions: "
            f"losses {[f'{v:.6f}' for v in losses[DEV]]}, max rel {rel:.3e}")
        check(rel <= 1e-4, f"reduced sampled {model} differs from the CPU "
              f"by {rel}")


# -- several ranks on the one card (--mesh) ------------------------------------


def dp_references(torch, cfg, ds, g):
    """The single-device FP32 rollout's rows and the FP32 step's loss and
    gradients (seed-0 parameters, the first batch of the training runs'
    stream, root seed 1) at full width, written beside the build for the
    ranks to hold theirs against."""
    import numpy as np

    from repro_torch.core.context import act_context
    from repro_torch.kernels.backend import BUILD_DIR
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.models import kgnn
    from repro_torch.models.layers import param_leaves
    from repro_torch.models.registry import build_step

    t0 = time.perf_counter()
    out = BUILD_DIR.parent / "dp_ref"
    out.mkdir(parents=True, exist_ok=True)
    step = build_step("kgat", ds=ds, cfg=cfg, batch_size=TRAIN_BATCH,
                      device=DEV, graph=g)
    params = step.init(0)
    np.save(out / "reps.npy", kgnn.propagate(params, g, cfg).cpu().numpy())
    with act_context(None, ROOT_SEED) as ctx:
        loss = step.loss(params, next(iter(step.batches())), ctx=ctx)
    grads = torch.autograd.grad(loss, param_leaves(params))
    np.savez(out / "grads.npz", loss=np.float64(loss.item()),
             **{f"g{i}": t.cpu().numpy() for i, t in enumerate(grads)})
    del params, grads, loss
    torch.cuda.empty_cache()
    log(f"[dp] single-device references (FP32 rollout, FP32 step at "
        f"batch {TRAIN_BATCH}) written to {out} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"reps": str(out / "reps.npy"), "grads": str(out / "grads.npz")}


def dp_rank_phase(rt, job):
    """What each rank of the [dp] phase runs (``launch.mesh.run_ranks``):
    the sharded FP32 forward and the exact all-reduce step held against
    the single-device references (on rank 0), then the training runs of
    ``DP_RUNS`` through the launcher's ``train_rank`` (each with its own
    checkpoint directory under ``job["ckpt"]``), then (1D only) one INT2
    step of KGCN, KGIN and R-GCN at the launcher's default size and the
    [dp-retry] run (``dp_retry_phase``)."""
    import numpy as np
    import torch

    from repro_torch.core.policy import parse_schedule
    from repro_torch.data.synthetic import gen_kg_dataset
    from repro_torch.launch.train import ROOT_SEED, dp_job, shard_setup, \
        train_rank
    from repro_torch.models import kgnn
    from repro_torch.models.layers import param_leaves
    from repro_torch.models.registry import arch_of, build_step
    from repro_torch.training import data_parallel as dp

    cfg, ds, mesh, dev = job["cfg"], job["ds"], rt.mesh, rt.device
    torch.backends.cuda.matmul.allow_tf32 = False
    cache, out = {}, {"checks": {}, "runs": {}}
    t0 = time.perf_counter()
    step = build_step("kgat", ds=ds, cfg=cfg, batch_size=TRAIN_BATCH,
                      device=dev, device_graph=False)
    spec = step.dp_spec
    part, view, model_axis = shard_setup(step, mesh, cache)
    out["setup_s"] = time.perf_counter() - t0
    params = step.init(0)
    if model_axis:
        params = dp.block_rows(dp.pad_row_sharded(
            params, spec, part, mesh.shape[model_axis]), spec, part, mesh)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    reps = dp.dp_forward_reps(step, params, part, mesh=mesh, view=view,
                              model_axis=model_axis)
    if rt.is_root:
        ref = torch.from_numpy(np.load(job["ref"]["reps"])).to(dev)
        out["checks"]["reps_equal"] = bool(torch.equal(reps, ref))
        out["checks"]["reps_rel"] = float(
            (reps - ref).abs().max() / ref.abs().max())
        del ref
    del reps
    loss, grads, _ = dp.dp_loss_and_grads(
        step, params, part, next(iter(step.batches())), mesh=mesh,
        view=view, model_axis=model_axis, root_seed=ROOT_SEED,
        compress_grads=False)
    if model_axis:
        grads = dp.unpad_row_sharded(dp.gather_row_blocks(
            grads, spec, part, mesh), spec, part.n_nodes)
    if rt.is_root:
        with np.load(job["ref"]["grads"]) as z:
            out["checks"]["loss"] = (float(loss), float(z["loss"]))
            rel = []
            for i, t in enumerate(param_leaves(grads)):
                r = torch.from_numpy(z[f"g{i}"]).to(dev)
                d = t - r
                rel.append((float(d.abs().max() / r.abs().max()),
                            float(d.norm() / r.norm())))
            out["checks"]["grads"] = rel
    out["checks"]["peak"] = (torch.cuda.max_memory_allocated(dev) if on_card
                             else 0)
    del grads, loss
    out["checks"]["int8"] = _int8_allreduce_check(torch, rt, step, params,
                                                  view, model_axis)
    del params
    torch.cuda.empty_cache()
    for label, allreduce in DP_RUNS:
        res = train_rank(rt, dp_job(
            cfg, ds, parse_schedule(label), DP_STEPS, batch=TRAIN_BATCH,
            allreduce=allreduce, schedule_spec=label, verbose=False,
            ckpt_dir=f"{job['ckpt']}/{label}_{allreduce}"), cache=cache)
        out["runs"][f"{label}_{allreduce}"] = res
        torch.cuda.empty_cache()
    out["plain_int8"] = {}
    for label, allreduce in DP_RUNS:
        if allreduce == "int8":
            out["plain_int8"][label] = _plain_int8_run(
                torch, rt, step, part, view, model_axis, label)
            torch.cuda.empty_cache()
    out["profile"] = _profile_dp_step(torch, rt, step, part, view,
                                      model_axis)
    if model_axis is None:
        sds = gen_kg_dataset(n_users=120, n_items=200, n_attrs=80, seed=0)
        for model in KG_MODELS:
            scfg = kgnn.KGNNConfig(
                model=model, n_users=sds.n_users, n_entities=sds.n_entities,
                n_relations=sds.n_relations, dim=32, n_layers=3,
                readout="sum")
            assert arch_of(model)
            out["runs"][f"{model}_int2_reduced"] = train_rank(rt, dp_job(
                scfg, sds, parse_schedule("int2"), 1, batch=512,
                schedule_spec="int2", verbose=False,
                ckpt_dir=f"{job['ckpt']}/{model}"), cache=cache)
        out["retry"] = dp_retry_phase(rt, sds, f"{job['ckpt']}/retry",
                                      cache)
    return out


def dp_retry_phase(rt, sds, ckpt_dir, cache):
    """[dp-retry] on one rank: a reduced KGAT INT2 run (d 32, 3 layers,
    the int8 all-reduce, ``DP_RETRY_STEPS`` steps, a checkpoint every
    ``DP_RETRY_EVERY``) through ``train_rank`` in which rank
    ``DP_RETRY_FAIL[0]`` fails step ``DP_RETRY_FAIL[1]``, and the same run
    with no failure on the batches the failed run kept."""
    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import dp_job, train_rank
    from repro_torch.models import kgnn

    rcfg = kgnn.KGNNConfig(
        model="kgat", n_users=sds.n_users, n_entities=sds.n_entities,
        n_relations=sds.n_relations, dim=32, n_layers=3, readout="concat")
    rjob = dp_job(rcfg, sds, parse_schedule("int2"), DP_RETRY_STEPS,
                  batch=512, schedule_spec="int2", verbose=False,
                  ckpt_dir=ckpt_dir, ckpt_every=DP_RETRY_EVERY,
                  fail_at=DP_RETRY_FAIL)
    run = train_rank(rt, rjob, cache=cache)
    back = DP_RETRY_FAIL[1] // DP_RETRY_EVERY * DP_RETRY_EVERY
    return dict(losses=[h["loss"] for h in run["steps"]], log=run["log"],
                counts=run["counts"],
                unfailed=_unfailed_dp_losses(rt, rjob, range(
                    back, DP_RETRY_FAIL[1] + 1), cache))


def _unfailed_dp_losses(rt, job, skip, cache):
    """The losses of ``job``'s run on this rank with no failure, set up as
    ``train_rank`` sets it up (seed-0 parameters, Adam, the launcher's root
    seed), on the batches the run that failed and rolled back kept: the
    stream without ``skip`` (the rolled-back steps' and the failed
    attempt's; the trainer does not rewind its data)."""
    from repro_torch.launch.train import ROOT_SEED, shard_setup
    from repro_torch.models.registry import arch_of, build_step
    from repro_torch.training import data_parallel as dp
    from repro_torch.training.optimizer import adam
    from repro_torch.training.step import trainable

    cfg = job["cfg"]
    step = build_step(arch_of(cfg.model), ds=job["ds"], cfg=cfg,
                      batch_size=job["batch"], device=rt.device,
                      device_graph=False)
    part, view, _ = shard_setup(step, rt.mesh, cache)
    opt = adam(step.lr)
    params = trainable(step.init(0))
    state = (params, opt.init(params))
    train = dp.make_dp_step(step, part, rt.mesh, opt,
                            schedule=job["schedule"], root_seed=ROOT_SEED,
                            mesh_spec=rt.mesh.spec,
                            compress_grads=job["allreduce"] == "int8",
                            view=view)
    batches = [b for i, (_, b) in enumerate(zip(
        range(job["steps"] + len(skip)), step.batches())) if i not in skip]
    losses = []
    for i, b in enumerate(batches[:job["steps"]]):
        state, m = train(state, b, i)
        losses.append(float(m["loss"]))
    return losses


def _int8_allreduce_check(torch, rt, step, params, view, model_axis):
    """The int8 all-reduce at full width on this rank's gradients of the
    first batch (FP32 sites), against the exact mean of the same
    gradients. Per leaf: the largest |int8 - exact| in codes (``scale /
    127``, the scale the ``pmax`` over the leaf's reduced axes): each
    rank's code lies within one of its exact value, so the mean does too;
    and over the entity leaf, the mean of int8 - exact in standard errors
    (SR is unbiased), the share of its nonzero exact elements whose int8
    mean is 0 (Adam leaves those where they are) and their share of the
    gradient's |mass|."""
    from repro_torch.core.context import act_context
    from repro_torch.kernels.backend import full_fp32
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.models.layers import param_leaves
    from repro_torch.sharding.comm import pmax
    from repro_torch.training.compress import all_reduce_grads, psum_seed, \
        restructure

    mesh, spec = rt.mesh, step.dp_spec
    batch = next(iter(step.batches()))
    b = batch["user"].shape[0] // mesh.shape["data"]
    i = mesh.index("data")
    with full_fp32(), act_context(None, ROOT_SEED):
        total, _ = spec.shard_loss(params, view, {
            k: v[i * b:(i + 1) * b] for k, v in batch.items()})
        local = restructure(params, list(torch.autograd.grad(
            total, param_leaves(params))))
    axes = ("data", model_axis) if model_axis else "data"
    sharded = spec.row_sharded() if model_axis else ()
    kw = dict(seed=psum_seed(ROOT_SEED, spec.scope, 0),
              placement={n: model_axis for n in sharded} or None)
    exact = all_reduce_grads(local, mesh, axes, compressed=False, **kw)
    int8 = all_reduce_grads(local, mesh, axes, compressed=True, **kw)
    codes = []
    for name in sorted(local):
        r_axes = "data" if name in sharded else axes
        for g, e, c in zip(*(t[name] if isinstance(t[name], list)
                             else [t[name]] for t in (local, exact, int8))):
            scale = pmax(g.abs().max(), mesh, r_axes) / 127.0
            codes.append(float((c - e).abs().max() / scale))
    e, c = exact["entity"].double(), int8["entity"].double()
    d = (c - e).reshape(-1)
    nz = e != 0
    return {"codes": codes,
            "bias_se": float(d.mean() / (d.std() / d.numel() ** 0.5)),
            "zero_share": float((c[nz] == 0).double().mean()),
            "zero_mass": float(e[nz & (c == 0)].abs().sum()
                               / e.abs().sum())}


def _plain_int8_run(torch, rt, step, part, view, model_axis, label):
    """The int8 all-reduce runs' plain reference: ``DP_STEPS`` Adam steps
    from the seed-0 parameters on this rank's shard, with the batches,
    step indices and ACT seeds of ``train_rank``'s run, but each gradient
    leaf mean-reduced by a plain stochastic-rounding int8 all-reduce of
    its own (the scale a ``pmax`` of max |g|, codes floor(x) + [u < frac]
    with ``u`` from a per-rank ``torch.Generator``, their sum, times
    scale / 127 / ranks) in place of ``training.compress``. Returns the
    losses, each taken before its update as the port's step takes them."""
    from repro_torch.core.context import act_context
    from repro_torch.core.policy import parse_schedule
    from repro_torch.kernels.backend import full_fp32
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.models.layers import param_leaves
    from repro_torch.sharding.comm import pmax, psum
    from repro_torch.training import data_parallel as dp
    from repro_torch.training.optimizer import adam
    from repro_torch.training.step import trainable

    mesh, spec = rt.mesh, step.dp_spec
    opt = adam(step.lr)
    params = step.init(0)
    state = (params, opt.init(params))
    sharded = spec.row_sharded() if model_axis else ()
    if model_axis:
        state = dp.block_rows(dp.pad_row_sharded(
            state, spec, part, mesh.shape[model_axis]), spec, part, mesh)
    params, opt_state = trainable(state[0]), state[1]
    names = [k for k in sorted(params) for _ in (
        params[k] if isinstance(params[k], list) else [params[k]])]
    axes = ("data", model_axis) if model_axis else ("data",)
    gen = torch.Generator(device=rt.device)
    gen.manual_seed(1000 + rt.rank)
    n, i = mesh.shape["data"], mesh.index("data")
    losses = []
    for k, batch in zip(range(DP_STEPS), step.batches()):
        b = batch["user"].shape[0] // n
        with full_fp32(), act_context(parse_schedule(label), ROOT_SEED,
                                      step=k):
            total, _ = spec.shard_loss(params, view, {
                key: v[i * b:(i + 1) * b] for key, v in batch.items()})
            grads = torch.autograd.grad(total, param_leaves(params))
        losses.append(float(psum(total.detach(), mesh, "data") / n))
        means = []
        for name, g in zip(names, grads):
            r_axes = ("data",) if name in sharded else axes
            scale = pmax(g.abs().max(), mesh, r_axes)
            x = g / scale * 127.0
            q = torch.floor(x)
            q += torch.rand(x.shape, generator=gen, device=x.device) < x - q
            means.append(psum(q, mesh, r_axes) * scale / 127.0
                         / mesh.size(r_axes))
        params, opt_state = opt.update(means, opt_state, params)
    return losses


def _profile_dp_step(torch, rt, step, part, view, model_axis):
    """torch.profiler (every rank) over one steady INT2 step with the int8
    all-reduce: the rank's wall time, device busy time, its kernels by
    device time, the host time inside the collectives (the profiler's
    ``c10d``/``gloo`` ranges) and any index_add_ scatter kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.training import data_parallel as dp
    from repro_torch.training.optimizer import adam
    from repro_torch.training.step import trainable

    opt = adam(step.lr)
    params = step.init(0)
    state = (params, opt.init(params))
    if model_axis:
        state = dp.block_rows(dp.pad_row_sharded(
            state, step.dp_spec, part, rt.mesh.shape[model_axis]),
            step.dp_spec, part, rt.mesh)
        state = (trainable(state[0]), state[1])
    train = dp.make_dp_step(step, part, rt.mesh, opt,
                            schedule=parse_schedule("int2"),
                            root_seed=ROOT_SEED, mesh_spec=rt.mesh.spec,
                            view=view)
    batches = step.batches()
    state, m = train(state, next(batches), 0)        # warm
    batch = next(batches)
    if rt.device.type == "cuda":
        torch.cuda.synchronize(rt.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = train(state, batch, 1)
        float(m["loss"])
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    comm = [e for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA
            and ("gloo" in e.key or "c10d" in e.key)]
    del state, m
    torch.cuda.empty_cache()
    return {"wall_ms": wall * 1e3,
            "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "top": [(e.key[:80], e.count, e.self_device_time_total / 1e3)
                    for e in sorted(kernels,
                                    key=lambda e: -e.self_device_time_total)
                    [:8]],
            "comm": [(e.key[:60], e.count, e.cpu_time_total / 1e3)
                     for e in sorted(comm, key=lambda e: -e.cpu_time_total)
                     [:4]],
            "scatter": sorted({e.key for e in kernels if "indexFunc" in e.key
                               or "index_add" in e.key})}


def check_dp_retry(res):
    """[dp-retry]: rank 1's injected failure before step 3 of a reduced
    KGAT INT2 run on ``data=2`` (the int8 all-reduce) reached both ranks at
    the step's agreement point: each logged it once and rolled back to the
    step-2 checkpoint; the run's losses equal, bit for bit, a run that never
    failed on the batches the failed run kept, and the ranks' losses
    agree."""
    rank, step = DP_RETRY_FAIL
    back = step // DP_RETRY_EVERY * DP_RETRY_EVERY
    for r, one in enumerate(res):
        run = one["retry"]
        failed = [m for m in run["log"] if "failed" in m]
        rolled = [m for m in run["log"] if "rolled back" in m]
        log(f"[dp-retry] rank {r}: {failed + rolled}; losses "
            f"{[f'{v:.9f}' for v in run['losses']]} against the unfailed "
            f"run's {[f'{v:.9f}' for v in run['unfailed']]}")
        check(len(failed) == 1 and f"step {step} failed (1/3)" in failed[0]
              and f"rank {rank} failed" in failed[0],
              f"dp-retry rank {r}: failure lines {failed}")
        check(rolled == [f"[trainer] rolled back to step {back}"],
              f"dp-retry rank {r}: rollback lines {rolled}")
        check(run["losses"] == run["unfailed"]
              and len(run["losses"]) == DP_RETRY_STEPS,
              f"dp-retry rank {r}: losses {run['losses']} vs the unfailed "
              f"run's {run['unfailed']}")
        check(run["losses"] == res[0]["retry"]["losses"],
              "dp-retry: the ranks' losses differ")


def run_dp(torch, cfg, ds, ref, single):
    """The [dp] phase: the paper's KGAT config at full width on ranks that
    share the one H100 over gloo, ``data=2`` and ``data=2,model=2``
    (``dp_rank_phase`` on each rank, one spawn a mesh). Holds the sharded
    FP32 rollout and the exact all-reduce step's loss and gradients to the
    single-device ones (``DP_LOSS_TOL``, ``DP_GRAD_TOL``), the exact
    all-reduce run's losses to the single-device run's (``single``: the
    [train] phase's) within ``DP_LOSS_TOL``; the int8 all-reduce's mean of
    the first step's gradients within one code (``DP_INT8_SLACK``) of the
    exact mean on every leaf of every rank and unbiased over the entity
    table (``DP_INT8_Z``); the int8 runs' first loss to the single-device
    run's, and their losses to a plain int8 all-reduce's run on the same
    mesh and schedule (``_plain_int8_run``) within ``DP_INT8_LOSS_TOL``
    (the issue's "a few 1e-3": the int8 runs' gap to the single-device
    run is the algorithm's, printed with the share of zero int8 means it
    comes from, so the plain version of the algorithm is what they are
    held to); every kernel of the path launched on every
    rank and the replicas equal after every step (each rank checks);
    prints the backend and route, each shard's edges
    and halo rows, each rank's peak memory, median step times (N ranks
    sharing one H100) and the all-reduce bytes a step, int8 and fp32.
    Returns the runs' launch counts, summed over the ranks, by path."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.registry import path_kernels

    import tempfile

    paths = {}
    for mesh in DP_MESHES:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as ck:
            res = run_ranks(dp_rank_phase, mesh, device=DEV, args=(dict(
                cfg=cfg, ds=ds, ref=ref, ckpt=ck),), timeout_s=900)
        wall = time.perf_counter() - t0
        root = res[0]
        n = len(res)
        first = next(iter(root["runs"].values()))
        sh, mi = first["shard"], first["mesh"]
        log(f"[dp] {mesh}: {n} ranks sharing one H100 ({mi['device']}): "
            f"backend {mi['backend']}, collective route {mi['route']} "
            f"(all-gather and reduce-scatter as all_reduce of a zero-filled "
            f"buffer); phase {wall:.1f} s, shard setup "
            f"{root['setup_s']:.1f} s on the host")
        log(f"[dp] {mesh}: edges per data shard {sh['edges_all']} (cap "
            f"{sh['e_cap']}), halo rows {sh['halo_all']} (cap {sh['h_cap']}),"
            f" {sh['rows']} rows a shard")
        if "retry" in root:
            check_dp_retry(res)
            paths[f"train_dp_{mesh}_retry"] = {
                k: sum(r["retry"]["counts"].get(k, 0) for r in res)
                for k in root["retry"]["counts"]}
        c = root["checks"]
        log(f"[dp] {mesh}: sharded FP32 rollout vs one device: "
            f"{'bit-identical' if c['reps_equal'] else 'differs'}, max rel "
            f"{c['reps_rel']:.3e}; exact all-reduce step loss "
            f"{c['loss'][0]:.9f} vs {c['loss'][1]:.9f}; gradients max rel "
            f"{max(r[0] for r in c['grads']):.3e}, per leaf (max rel, rms "
            f"rel) {[(f'{a:.2e}', f'{b:.2e}') for a, b in c['grads']]}; "
            f"peak per rank {[r['checks']['peak'] for r in res]} B")
        pr = root["profile"]
        log(f"[dp] {mesh}: profiled INT2 step (int8 all-reduce), rank 0: "
            f"wall {pr['wall_ms']:.2f} ms, device busy {pr['busy_ms']:.2f} "
            f"ms, idle share {1 - pr['busy_ms'] / pr['wall_ms']:.3f}; "
            f"collectives on the host (inclusive) "
            + ", ".join(f"{k} x{n} {t:.1f} ms" for k, n, t in pr["comm"])
            + "; kernels " + ", ".join(f"{k[:40]} x{n} {t:.2f} ms"
                                       for k, n, t in pr["top"]))
        check(pr["busy_ms"] > 0, f"dp {mesh}: the profiler saw no device "
              f"time")
        check(not any(r["profile"]["scatter"] for r in res),
              f"dp {mesh}: index_add_ scatter kernels "
              f"{[r['profile']['scatter'] for r in res]}")
        check(c["reps_rel"] <= 1e-6, f"dp {mesh}: rollout rel {c['reps_rel']}")
        check(abs(c["loss"][0] - c["loss"][1]) <= DP_LOSS_TOL,
              f"dp {mesh}: exact step loss {c['loss']}")
        q = [r["checks"]["int8"] for r in res]
        zero = statistics.fmean(x["zero_share"] for x in q)
        log(f"[dp] {mesh}: int8 all-reduce of the first step's gradients vs "
            f"the exact mean, per rank: max |int8 - exact| in codes "
            f"{[round(max(x['codes']), 4) for x in q]} (limit "
            f"{1 + DP_INT8_SLACK}); entity mean error "
            f"{[round(x['bias_se'], 3) for x in q]} standard errors (limit "
            f"{DP_INT8_Z}); zero int8 means "
            f"{[round(x['zero_share'], 4) for x in q]} of the entity "
            f"gradient's nonzero elements (mean {zero:.4f}), holding "
            f"{[round(x['zero_mass'], 4) for x in q]} of its |mass|")
        check(all(max(x["codes"]) <= 1 + DP_INT8_SLACK for x in q),
              f"dp {mesh}: int8 mean off the exact one by more than a "
              f"code: {[x['codes'] for x in q]}")
        check(all(abs(x["bias_se"]) <= DP_INT8_Z for x in q),
              f"dp {mesh}: int8 mean biased: {[x['bias_se'] for x in q]}")
        check(max(r[0] for r in c["grads"]) <= DP_GRAD_TOL,
              f"dp {mesh}: exact all-reduce gradients off the single-device "
              f"step by {c['grads']}")
        for key, run in root["runs"].items():
            hist = run["steps"]
            losses = [h["loss"] for h in hist]
            ms = statistics.median(h["seconds"] for h in hist) * 1e3
            peaks = [r["runs"][key]["peak"] or 0 for r in res]
            per_step = hist[-1]["launches"]
            total = {}
            for r in res:
                for k, v in r["runs"][key]["counts"].items():
                    total[k] = total.get(k, 0) + v
            paths[f"train_dp_{mesh}_{key}"] = total
            paths[f"train_dp_{mesh}_{key}_per_step"] = per_step
            label, allreduce = key.split("_")[:2]
            rep = run["allreduce_bytes"]
            b8, b32 = (sum(x["bytes"] for x in rep[w])
                       for w in ("int8", "fp32"))
            log(f"[dp] {mesh} {key}: losses {[f'{v:.6f}' for v in losses]}; "
                f"step {ms:.2f} ms median of {len(hist)} ({n} ranks sharing "
                f"one H100; first {hist[0]['seconds'] * 1e3:.2f} ms); peak "
                f"per rank {peaks} B (max {max(peaks) / 2**30:.2f} GiB); "
                f"launches per step (rank 0) "
                f"{json.dumps(per_step, sort_keys=True)}")
            s8, s32 = (sum(x["bytes"] for x in run["allreduce_sent"][w])
                       for w in ("int8", "fp32"))
            log(f"[dp] {mesh} {key}: all-reduce bytes a step (analytic, "
                f"per rank) int8 {b8}, fp32 {b32}, ratio {b8 / b32:.4f}: "
                + "; ".join(f"{x['axes']} {x['wire']} {x['bytes']}"
                            for w in ("int8", "fp32") for x in rep[w])
                + f"; sent to the all-reduce calls (int8 codes as int32) "
                  f"int8 {s8}, fp32 {s32}")
            check(all(math.isfinite(v) for v in losses),
                  f"dp {mesh} {key}: non-finite loss")
            check(all([h["loss"] for h in r["runs"][key]["steps"]] == losses
                      for r in res), f"dp {mesh} {key}: ranks' losses differ")
            model = key.split("_")[0] if key.endswith("reduced") else "kgat"
            for k in path_kernels(model, label != "fp32"
                                  or key.endswith("reduced")):
                check(all(r["runs"][key]["counts"].get(k, 0) > 0
                          for r in res),
                      f"dp {mesh} {key}: kernel {k} not launched on a rank")
            if key.endswith("reduced"):
                continue
            want = single[label]["losses"][:len(losses)]
            diff = max(abs(a - b) for a, b in zip(losses, want))
            exact = [h["loss"] for h in root["runs"]["fp32_fp32"]["steps"]]
            share = [(a - b) / (want[0] - b)
                     for a, b in zip(losses[1:], want[1:])]
            plain = root["plain_int8"].get(label)
            log(f"[dp] {mesh} {key}: losses vs one device's {label} run "
                f"{[f'{v:.6f}' for v in want]}: max |diff| {diff:.3e}"
                + ("" if allreduce == "fp32" else
                   f"; vs this mesh's exact all-reduce FP32 run: max |diff| "
                   f"{max(abs(a - b) for a, b in zip(losses, exact)):.3e}; "
                   f"gap as a share of the one-device run's fall "
                   f"{[round(x, 4) for x in share]} (zero int8 means "
                   f"{zero:.4f}); the plain int8 all-reduce's run "
                   f"{[f'{v:.6f}' for v in plain]}: max |diff| "
                   f"{max(abs(a - b) for a, b in zip(losses, plain)):.3e}"))
            check(abs(losses[0] - want[0]) <= DP_LOSS_TOL,
                  f"dp {mesh} {key}: first loss {losses[0]} vs {want[0]}")
            if allreduce == "fp32":
                check(diff <= DP_LOSS_TOL, f"dp {mesh} {key}: losses "
                      f"{losses} vs one device's {want}")
            else:
                check(all(abs(a - b) <= DP_INT8_LOSS_TOL
                          for a, b in zip(losses, plain)),
                      f"dp {mesh} {key}: int8 losses {losses} vs the plain "
                      f"int8 all-reduce's {plain}")
    return paths


# -- the GCN (gcn-cora) ---------------------------------------------------------


def gcn_host_graph(shape: str):
    """A GCN shape's graph, made on the host beside the kernel build:
    ``gnn_data`` at the shape's widths, and for a full graph its layout
    (on the host; the phase moves it to the card), for the sampled graph
    its CSR. Returns the pieces and the seconds each took."""
    from repro_torch.data.csr import build_spmm_layout
    from repro_torch.data.sampler import build_csr
    from repro_torch.models.registry import gnn_config, gnn_data

    t0 = time.perf_counter()
    cfg = gnn_config(shape)
    data = gnn_data(shape, cfg)
    t1 = time.perf_counter()
    n = len(data[0])
    extra = ({"csr": build_csr(data[1], data[2], n)} if shape == "minibatch_lg"
             else {"layout": build_spmm_layout(data[1], data[2], n_dst=n,
                                               device="cpu")})
    return dict(cfg=cfg, data=data, gen_s=t1 - t0,
                index_s=time.perf_counter() - t1, **extra)


def _gcn_shape_line(tag, shape, cfg, data):
    from repro_torch.configs import get

    p = get("gcn-cora").shape(shape).p()
    log(f"[{tag}] {shape}: {len(data[0])} nodes, {len(data[1])} edges with "
        f"self loops (the shape's {p['n_edges']}; no edge cut), d_in "
        f"{cfg.d_in}, d_hidden {cfg.d_hidden}, {cfg.n_classes} classes, "
        f"{cfg.n_layers} layers")


def check_gcn_kernels(torch, tag, cfg, x, layout, gen, shapes):
    """Every kernel of the full-graph GCN step at the shapes the step gives
    it, through ``run_case``: quant_pack on each dense site's input (INT2
    SR), the dequant-matmul at each layer's ∇W (INT2), the unweighted SPMM
    at each layer's aggregation width in both directions. Records under
    ``shapes`` by kernel name."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp

    n = x.shape[0]
    dims = [cfg.d_in, cfg.d_hidden, cfg.n_classes]
    log(f"[{tag}-kernels] kernels vs plain and library at the step's shapes")
    for l in range(cfg.n_layers):
        d_a, d_b = dims[l], dims[l + 1]
        d_agg = d_b if cfg.transform_first and d_a > d_b else d_a
        h = x if l == 0 else torch.randn((n, d_a), generator=gen,
                                         device=DEV).relu_()
        g = torch.randn((n, d_b), generator=gen, device=DEV) * 1e-2
        q = quantize(h, 0x6C + l, bits=2, stochastic=True)
        xa = torch.randn((n, d_agg), generator=gen, device=DEV)
        where = f"layer {l} "
        for case in (lambda: quant_case(qp, h, 0x6C + l, where),
                     lambda: dequant_matmul_case(torch, dq, q, g, where),
                     lambda: spmm_case(torch, sp, layout, xa, None, False,
                                       where),
                     lambda: spmm_case(torch, sp, layout, xa, None, True,
                                       where)):
            c = case()               # one library operand alive at a time
            shapes.setdefault(c[1], []).append(run_case(
                torch, f"{tag}-kernels", c, shape=f"{tag} ", iters=10))
            del c
        del h, q, g, xa


def gcn_train_runs(torch, tag, step, steps, *, falls=True):
    """``train_run`` on the GCN ``step`` under FP32 and INT2, exactly the
    GCN path's kernels launched; INT2's ACT bytes below FP32's at the same
    FP32 price."""
    runs = {label: train_run(torch, tag, label, step, label, steps,
                             exact=True, falls=falls)
            for label in ("fp32", "int2")}
    check(runs["int2"]["act_bytes"] < runs["fp32"]["act_bytes"]
          and runs["int2"]["act_fp32"] == runs["fp32"]["act_fp32"],
          f"[{tag}] ACT bytes INT2 vs FP32")
    log(f"[{tag}] ACT bytes INT2 / FP32: {runs['int2']['act_bytes']} / "
        f"{runs['fp32']['act_bytes']} = 1 / "
        f"{runs['fp32']['act_bytes'] / runs['int2']['act_bytes']:.2f}; peak "
        f"FP32 - INT2 {runs['fp32']['peak'] - runs['int2']['peak']} B")
    return runs


def check_gcn_grads(torch, tag, step, batch):
    """One step's gradients with the kernels against the same step with
    every kernel's plain version (same seeds, parameters and batch; the
    plain steps under torch.use_deterministic_algorithms: the plain SPMM
    adds with index_add_). FP32: within 1e-5 of each weight's max |grad|.
    INT2: within 1e-2 of the weight's SR quantization noise (max |INT2 -
    FP32| of the kernels' steps): a code can flip where the two SPMMs'
    summation orders move a quantization input across an SR threshold."""
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp

    params = step.init(0)
    got = {(label, "kernels"): _grads(torch, step, params, batch, label)
           for label in ("fp32", "int2")}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for label in ("fp32", "int2"):
                with plain_versions(ops, spmm=sp.spmm_plain,
                                    quant_pack=qp.quant_pack_plain,
                                    dequant_matmul=dq.dequant_matmul_plain):
                    got[label, "plain"] = _grads(torch, step, params, batch,
                                                 label)
    finally:
        torch.use_deterministic_algorithms(False)
    for label in ("fp32", "int2"):
        (lk, gk), (lp, gp) = got[label, "kernels"], got[label, "plain"]
        check(abs(lk - lp) <= TOL * abs(lp),
              f"[{tag}] {label} loss with kernels {lk} vs plain {lp}")
        for i in range(len(gk)):
            diff = float((gk[i] - gp[i]).abs().max())
            rel = diff / float(gp[i].abs().max())
            if label == "fp32":
                ok, note = rel <= TOL, f"limit {TOL}"
            else:
                noise = float((gk[i] - got["fp32", "kernels"][1][i])
                              .abs().max())
                share = diff / noise if noise else (0.0 if diff == 0
                                                    else math.inf)
                ok = share <= GRAD_NOISE_SHARE
                note = (f"share of SR noise {share:.3e} (limit "
                        f"{GRAD_NOISE_SHARE})")
            log(f"[{tag}] grads {label} w[{i}]: max |kernels - plain| "
                f"{diff:.3e}, rel {rel:.3e}; {note}")
            check(ok, f"[{tag}] {label} gradient of w[{i}] out of tolerance")
        log(f"[{tag}] grads {label}: loss kernels {lk:.8f} plain {lp:.8f}")


def run_gcn_full(torch, tag, shape, steps, gen, shapes, host=None):
    """[gcn] / [gcn-products]: a full-graph shape of gcn-cora at full
    width: its kernels, FP32 and INT2 training, two steps bit-identical,
    one step's gradients against the plain versions."""
    from repro_torch.data.csr import to_device
    from repro_torch.models.registry import build_step, gnn_config, \
        gnn_data

    t0 = time.perf_counter()
    if host is None:
        cfg = gnn_config(shape)
        host = dict(cfg=cfg, data=gnn_data(shape, cfg), layout=None)
    cfg, data = host["cfg"], host["data"]
    _gcn_shape_line(tag, shape, cfg, data)
    layout = host["layout"]
    step = build_step("gcn-cora", device=DEV, shape=shape, cfg=cfg,
                      data=data, layout=None if layout is None
                      else to_device(layout, DEV))
    torch.cuda.synchronize()
    m = step.data["layout"].meta
    deg = step.data["layout"].in_degree()
    log(f"[{tag}] set-up: layout {m.n_blocks} blocks x {m.block_e} slots, "
        f"in-degree max {int(deg.max())} mean {float(deg.float().mean()):.2f}"
        + (f"; host: graph {host['gen_s']:.1f} s, layout "
           f"{host['index_s']:.1f} s (beside the build)" if "gen_s" in host
           else "") + f"; this phase's set-up {time.perf_counter() - t0:.1f}"
        " s")
    check_gcn_kernels(torch, tag, cfg, step.data["features"],
                      step.data["layout"], gen, shapes)
    torch.cuda.empty_cache()
    runs = gcn_train_runs(torch, tag, step, steps)
    for label in ("fp32", "int2"):
        check_two_steps(torch, tag, label, step, label)
    check_gcn_grads(torch, tag, step, {})
    del step
    torch.cuda.empty_cache()
    return runs


def run_gcn_sampled(torch, host, gen, shapes):
    """[gcn-sampled]: minibatch_lg, fanout blocks sampled on the host a
    batch at a time: the kernels on the first batch's blocks against their
    plain versions and library calls, FP32 and INT2 training, two steps
    bit-identical."""
    import dataclasses

    from repro_torch.core.quant import quantize
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp
    from repro_torch.models.registry import build_step

    tag, cfg, data = "gcn-sampled", host["cfg"], host["data"]
    _gcn_shape_line(tag, "minibatch_lg", cfg, data)
    log(f"[{tag}] host: graph {host['gen_s']:.1f} s, CSR "
        f"{host['index_s']:.1f} s (beside the build)")
    step = build_step("gcn-cora", device=DEV, shape="minibatch_lg", cfg=cfg,
                      data=data, csr=host["csr"])
    host_s = []
    sample = step.batches

    def batches():
        it = sample()
        while True:
            t = time.perf_counter()
            b = next(it)
            host_s.append(time.perf_counter() - t)
            yield b

    step = dataclasses.replace(step, batches=batches)
    first = next(batches())
    lay = first["layouts"]
    log(f"[{tag}] first batch: blocks "
        + ", ".join(f"{m.meta.n_src} -> {m.meta.n_dst} ({m.meta.n_edges} "
                    f"edges, {m.rows_read[0]} sources read)" for m in lay)
        + f"; host {host_s[-1] * 1e3:.1f} ms (sampling and layouts)")
    x = step.data["features"].index_select(0, first["input_nodes"])
    n0, n1 = lay[0].meta.n_dst, lay[1].meta.n_dst
    h = sp.spmm_cuda(x, None, lay[0]) / lay[0].in_degree().float()[:, None]
    q = quantize(h, 0x5B, bits=2, stochastic=True)
    g = torch.randn((n0, cfg.d_hidden), generator=gen, device=DEV) * 1e-2
    h1 = torch.randn((n0, cfg.d_hidden), generator=gen, device=DEV)
    g1 = torch.randn((n1, cfg.d_hidden), generator=gen, device=DEV)
    log(f"[{tag}-kernels] kernels vs plain and library on the first "
        f"batch's blocks")
    for case in (
            lambda: spmm_case(torch, sp, lay[0], x, None, False, "block 0 "),
            lambda: quant_case(qp, h, 0x5B, "block 0 "),
            lambda: dequant_matmul_case(torch, dq, q, g, "block 0 "),
            lambda: spmm_case(torch, sp, lay[1], h1, None, False, "block 1 "),
            lambda: spmm_case(torch, sp, lay[1], g1, None, True, "block 1 ")):
        c = case()
        shapes.setdefault(c[1], []).append(run_case(
            torch, f"{tag}-kernels", c, shape=f"{tag} ", iters=10))
        del c
    del x, h, q, g, h1, g1
    host_s.clear()
    runs = gcn_train_runs(torch, tag, step, GCN_SAMPLED_STEPS, falls=False)
    log(f"[{tag}] host time a batch (sampling and layouts, in the "
        f"trainer's prefetch thread): median "
        f"{statistics.median(host_s) * 1e3:.1f} ms of {len(host_s)} batches")
    for label in ("fp32", "int2"):
        check_two_steps(torch, tag, label, step, label)
    del step, first
    torch.cuda.empty_cache()
    return runs


def run_gcn_molecule(torch, gen, shapes):
    """[gcn-molecule]: 128 graphs of 30 nodes and 64 edges (plus self
    loops), d 32, 2 classes: the readout's segment sum against its plain
    version and index_add_ (``run_case``); one forward and backward (INT2)
    with the counts reset just before and read just after; no index_add_
    in the profile of that forward and backward."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import backend
    from repro_torch.kernels import spmm as sp
    from repro_torch.models.registry import build_step, path_kernels

    tag = "gcn-molecule"
    step = build_step("gcn-cora", device=DEV, shape="molecule")
    levels = step.data["runs"]
    n, c = step.data["features"].shape[0], step.cfg.n_classes
    n_out = levels[-1].n_out
    ids = step.data["graph_ids"].long()
    log(f"[{tag}] {len(step.data['labels'])} graphs, {n} nodes, "
        f"{step.data['n_edges']} edges with self loops, d_in "
        f"{step.cfg.d_in}, {c} classes")
    y = torch.randn((n, c), generator=gen, device=DEV)
    shapes.setdefault("segment_sum", []).append(run_case(
        torch, f"{tag}-kernels",
        (f"readout segment_sum {n} -> {n_out} rows d={c}", "segment_sum",
         lambda: sp.segment_sum_cuda(y, levels),
         lambda: sp.segment_sum_plain(y, levels),
         lambda: torch.zeros((n_out, c), device=DEV).index_add_(0, ids, y),
         sp.segment_sum_cost(levels, c)), shape=f"{tag} "))
    params = step.init(0)
    _grads(torch, step, params, {}, "int2")          # warm
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        _grads(torch, step, params, {}, "int2")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[{tag}] int2 forward and backward: wall "
        f"{statistics.median(walls) * 1e3:.2f} ms median of 5")
    backend.reset_counts()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, grads = _grads(torch, step, params, {}, "int2")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(backend.LAUNCH_COUNTS)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    scatter = [e.key for e in kernels
               if "indexFunc" in e.key or "index_add" in e.key]
    log(f"[{tag}] int2 forward and backward: loss {loss:.6f}, wall "
        f"{wall * 1e3:.2f} ms (profiled), device busy {busy:.3f} ms; "
        f"launches {json.dumps(counts, sort_keys=True)}; index_add_ "
        f"scatter kernels: {scatter if scatter else 'none'}")
    check(busy > 0, f"[{tag}] the profiler saw no device time")
    check(math.isfinite(loss) and all(bool(torch.isfinite(g).all())
                                      for g in grads),
          f"[{tag}] non-finite loss or gradient")
    check(not scatter, f"[{tag}] the readout scatters with index_add_")
    want = set(path_kernels("gcn", True)) | {"segment_sum"}
    check(set(counts) == want, f"[{tag}] launched {sorted(counts)}, the "
          f"batched path has {sorted(want)}")
    return {"gcn_molecule": {"counts": counts, "per_step": counts}}


def run_gcn(torch, host, gen):
    """The GCN phases ([gcn], [gcn-products], [gcn-sampled],
    [gcn-molecule]); returns the runs by path key and the kernels' checks
    at the GCN shapes by kernel name."""
    shapes, runs = {}, {}
    for tag, shape, steps in GCN_FULL:
        got = run_gcn_full(torch, tag, shape, steps, gen, shapes,
                           host.pop(shape, None))
        key = tag.replace("-", "_")
        runs.update({f"{key}_{label}": r for label, r in got.items()})
    got = run_gcn_sampled(torch, host.pop("minibatch_lg"), gen, shapes)
    runs.update({f"gcn_sampled_{label}": r for label, r in got.items()})
    runs.update(run_gcn_molecule(torch, gen, shapes))
    return runs, shapes


def _recsys_cfg(arch):
    """The card's config of ``arch``: full width, DLRM's tables capped."""
    from repro_torch.models.registry import recsys_config

    return recsys_config(arch, row_cap=RECSYS_ROW_CAP.get(arch))


def recsys_topk_case(torch, tk, gen, d, shapes):
    """Top-32 of 8 queries over 1,000,000 INT8 item rows of width ``d`` (a
    recsys tower): kernel against its plain version (values within TOL,
    indices equal except between near-ties, the values the dense scores of
    the returned ids; two runs bit-identical), timed beside the plain
    version, the library call and the bound (as ``check_topk``)."""
    from repro_torch.core.quant import dequantize, quantize

    n_items, b, k = RECSYS_RETRIEVAL["n_cand"], ENGINE_BATCH, \
        RECSYS_RETRIEVAL["k"]
    items = quantize(torch.randn((n_items, d), generator=gen, device=DEV)
                     * 0.3, 0, bits=8)
    q = torch.randn((b, d), generator=gen, device=DEV) * 0.3
    excl = torch.full((b, 1), -1, dtype=torch.int32, device=DEV)

    def kernel():
        return tk.topk_cuda(q, items, excl, k=k)

    def library():
        return torch.topk(q @ dequantize(items).T, k)

    kv, ki = kernel()
    kv2, ki2 = kernel()
    pv, pi = tk.topk_plain(q, items, excl, k=k)
    err, swaps, ok = _close_topk(torch, kv, ki, pv, pi)
    dense = q @ dequantize(items).T
    picked = float((torch.gather(dense, 1, ki.long()) - kv).abs().max())
    same = torch.equal(kv, kv2) and torch.equal(ki, ki2)
    label = f"topk_score I={n_items} d={d} k={k} B={b} int8"
    log(f"[recsys-kernels] {label}: values rel {err:.3e}, {swaps} index "
        f"swaps (near-ties), two runs "
        f"{'bit-identical' if same else 'DIFFER'}")
    check(ok and same and picked <= TOL * float(pv.abs().max()),
          f"[recsys-kernels] {label} out of tolerance")
    ms = time_ms(kernel, 20)
    plain = time_ms(lambda: tk.topk_plain(q, items, excl, k=k), 3, warmup=1)
    lib = time_ms(library, 20)
    dev = _device_times(torch, kernel, library, label)
    shapes.setdefault("topk_score", []).append(_entry(
        "topk_score", "topk_score", "src/repro/kernels/topk_score.py:115",
        err * float(pv.abs().max()), ms, plain, lib,
        tk.topk_cost(b, n_items, d, k, dp=items.packed.shape[1],
                     n_excl=excl.numel()), f"recsys {label}",
        library_call="torch.topk(q @ dequantize(items).T)", **dev))


def recsys_kernel_cases(torch, gen, shapes):
    """[recsys-kernels]: every kernel of the recsys paths at the shapes the
    full-width models give it, through ``run_case`` (top-K through
    ``recsys_topk_case``): the quant-pack (INT2 SR) at xDeepFM's CIN
    residuals at batch 4,096 (R = B·k = 40,960 rows of 7,800 and 1,521),
    DLRM's dense input (4,096 x 13) and Wide&Deep's first MLP input (4,096
    x 1,280); the dequant-matmul (INT2) at the CIN's ∇W ((40,960, 7,800,
    200): 488 output tiles over 264 CTAs, one row chunk each; (40,960,
    1,521, 200)), an MLP's last layer (4,096, 256, 1) and DLRM's bottom
    fc0 (4,096, 13, 512); the top-K at tower widths 11, 33 and 129 over
    1,000,000 INT8 candidates; the segment sum on each model's table
    gradient (``recsys_table_grad_cases``). Records under ``shapes`` by
    kernel name."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import topk_score as tk

    tag = "recsys-kernels"
    log(f"[{tag}] kernels vs plain and library at the recsys shapes "
        f"(batch {RECSYS_BATCH})")
    rows = RECSYS_BATCH * 10                     # xDeepFM: B * k
    for where, r, dim, n in (("xDeepFM cin1 ", rows, 7800, 200),
                             ("xDeepFM cin0 ", rows, 1521, 200),
                             ("DLRM bot fc0 ", RECSYS_BATCH, 13, 512),
                             ("Wide&Deep deep fc0 ", RECSYS_BATCH, 1280,
                              1024),
                             ("DLRM top fc4 ", RECSYS_BATCH, 256, 1)):
        x = torch.randn((r, dim), generator=gen, device=DEV)
        seed = 0x7EC + dim
        if where != "DLRM top fc4 ":
            c = quant_case(qp, x, seed, where)
            shapes.setdefault("quant_pack", []).append(run_case(
                torch, tag, c, shape="recsys ", iters=10))
            del c
        if where != "Wide&Deep deep fc0 ":
            q = quantize(x, seed, bits=2, stochastic=True)
            g = torch.randn((r, n), generator=gen, device=DEV) * 1e-2
            c = dequant_matmul_case(torch, dq, q, g, where)
            shapes.setdefault("dequant_matmul", []).append(run_case(
                torch, tag, c, shape="recsys ", iters=10))
            del c, q, g
        del x
        torch.cuda.empty_cache()
    for d in (11, 33, 129):
        recsys_topk_case(torch, tk, gen, d, shapes)
    torch.cuda.empty_cache()
    for archs in (("fm", "xdeepfm"), ("wide-deep",), ("dlrm-mlperf",)):
        recsys_table_grad_cases(torch, gen, archs, shapes)
        torch.cuda.empty_cache()


def recsys_table_grad_cases(torch, gen, archs, shapes):
    """The tables' gradient on the lookup plan of the first training batch
    of ``archs`` (``criteo_batches(seed=3)`` at batch 4,096; FM and xDeepFM
    share their fields, widths and batches): the segment sum of the
    positions' gradients by distinct row (``run_case`` and
    ``segment_sum_report``: its hub rows of more than a chunk take the
    two-kernel route), at the embedding width and, where the model reads
    the linear term, at width 1; then the whole lookup forward and backward
    (``gather_rows`` with ``rows=``: the sums copied into the dense table
    gradient) against its plain version and ``index_select``'s backward,
    ``index_add_`` into the table. Records under ``shapes``."""
    from repro_torch.core.act import gather_rows
    from repro_torch.data.synthetic import criteo_batches
    from repro_torch.kernels.backend import KernelCost
    from repro_torch.kernels import ops
    from repro_torch.kernels import spmm as sp
    from repro_torch.models import recsys
    from repro_torch.models.registry import RECSYS_DATA_SEED

    tag = "recsys-kernels"
    cfg = _recsys_cfg(archs[0])
    b = next(criteo_batches(batch=RECSYS_BATCH, n_dense=max(cfg.n_dense, 1),
                            vocab_sizes=cfg.vocab_sizes,
                            seed=RECSYS_DATA_SEED))
    plan = recsys.lookup_plan(b["sparse"], cfg, DEV)
    levels, E = plan.runs, plan.ids.numel()
    n_out, n_rows = levels[-1].n_out, cfg.total_vocab
    inv = torch.searchsorted(plan.rows, plan.ids)    # position -> its run
    who = "/".join(archs)
    log(f"[{tag}] {who} table gradient: {E:,} positions ({RECSYS_BATCH} x "
        f"{cfg.n_sparse} fields), {n_out:,} distinct rows of {n_rows:,}")
    widths = (cfg.embed_dim,) + ((1,) if cfg.model != "dlrm" else ())
    for d in widths:
        y = torch.randn((E, d), generator=gen, device=DEV) * 1e-3
        label = f"{who} lookup segment_sum d={d}"

        def library(y=y, d=d):
            return torch.zeros((n_out, d), device=DEV).index_add_(0, inv, y)

        cost = sp.segment_sum_cost(levels, d)
        rec = run_case(torch, tag, (
            label, "segment_sum", lambda y=y: sp.segment_sum_cuda(y, levels),
            lambda y=y: sp.segment_sum_plain(y, levels), library, cost),
            shape="recsys ", iters=10)
        rec.update(segment_sum_report(torch, sp, y, levels, library, cost,
                                      f"[{tag}] {label}"))
        shapes.setdefault("segment_sum", []).append(rec)
    d = cfg.embed_dim
    table = torch.zeros((n_rows, d), device=DEV, requires_grad=True)
    g = torch.randn((E, d), generator=gen, device=DEV) * 1e-3

    def lookup():
        out = gather_rows(table, plan.ids, levels, rows=plan.rows)
        return torch.autograd.grad(out, table, g)[0]

    def lookup_plain():
        with plain_versions(ops, segment_sum=sp.segment_sum_plain):
            return lookup()

    def lookup_library():
        return torch.autograd.grad(table.index_select(0, plan.ids), table,
                                   g)[0]

    # the forward's gather (ids, rows read, rows written), the backward's
    # gradient, permutation and runs, the sums, the distinct rows and the
    # whole dense gradient written once
    n_bytes = (E * 8 + 3 * E * d * 4 + E * 4 + n_out * 8 + n_out * d * 4
               + n_out * 8 + n_rows * d * 4)
    shapes["segment_sum"].append(run_case(torch, tag, (
        f"{who} lookup forward and backward (gather_rows rows=) d={d}, "
        f"{n_rows:,}-row table", "segment_sum", lookup, lookup_plain,
        lookup_library, KernelCost(E * d, n_bytes, "fp32")),
        shape="recsys ", iters=10))
    del table, g


def recsys_reduced(torch):
    """Three reduced INT2 steps of each recsys model on the card against
    the CPU's plain versions from the same parameters: losses within 1e-4
    relative (``reduced_recsys_losses`` of tests/test_torch_cuda.py, whose
    card test holds the same)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import reduced_recsys_losses

    for arch in RECSYS_ARCHS:
        losses = reduced_recsys_losses(arch, DEV)[0]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[str(DEV)],
                                                       losses["cpu"]))
        log(f"[recsys] reduced {arch} INT2, card vs CPU plain versions: "
            f"losses {[f'{v:.6f}' for v in losses[str(DEV)]]}, max rel "
            f"{rel:.3e}")
        check(rel <= 1e-4, f"reduced {arch} differs from the CPU by {rel}")


def _heldout_auc(torch, step, params):
    """AUC of ``params`` on a held-out batch (``criteo_batches`` from
    another seed, the step's batch size)."""
    from repro_torch.data.synthetic import criteo_batches
    from repro_torch.models import recsys
    from repro_torch.training.metrics import auc

    cfg = step.cfg
    b = next(criteo_batches(batch=step.data["batch"],
                            n_dense=max(cfg.n_dense, 1),
                            vocab_sizes=cfg.vocab_sizes,
                            seed=RECSYS_HELDOUT_SEED))
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in b.items()}
    with torch.no_grad():
        logits = recsys.forward(params, batch, cfg)
    check(bool(torch.isfinite(logits).all()), "non-finite held-out logits")
    return auc(logits, batch["label"])


def recsys_train(torch):
    """[recsys] training: each model at full width (DLRM's tables capped at
    ``RECSYS_ROW_CAP``), batch 4,096, ``RECSYS_STEPS`` steps under FP32
    and INT2 (``train_run``: exactly the path's kernels, the same every
    step), AUC on a held-out batch; xDeepFM at batch 16,384 under FP32 and
    INT2 (the peak memory ACT sells at the CIN); two xDeepFM INT2 steps
    from one state bit-identical ([determinism])."""
    from repro_torch.configs import get
    from repro_torch.models.registry import build_step

    runs = {}
    for arch in RECSYS_ARCHS:
        cfg = _recsys_cfg(arch)
        full = int(sum(get(arch).model_cfg.vocab_sizes))
        step = build_step(arch, device=DEV, cfg=cfg, batch_size=RECSYS_BATCH)
        rows = int(sum(cfg.vocab_sizes))
        cap = RECSYS_ROW_CAP.get(arch)
        log(f"[recsys] {arch} ({cfg.model}): {cfg.n_sparse} fields, "
            f"{rows:,} table rows x d {cfg.embed_dim} = "
            f"{rows * cfg.embed_dim * 4 / 1e9:.2f} GB"
            + (f" (reduced: each table capped at {cap:,} rows; the full "
               f"{full:,} rows x {cfg.embed_dim} x 4 B = "
               f"{full * cfg.embed_dim * 4 / 1e9:.1f} GB do not fit one "
               f"card)" if cap else " (full vocabulary)")
            + f", batch {RECSYS_BATCH}, Adam {step.lr}")
        got = {}
        for label in ("fp32", "int2"):
            r = train_run(torch, "recsys", f"{arch} {label}", step, label,
                          RECSYS_STEPS, exact=True, keep_params=True)
            r["auc"] = _heldout_auc(torch, step, r.pop("params"))
            log(f"[recsys] {arch} {label}: held-out AUC {r['auc']:.4f} "
                f"(batch {RECSYS_BATCH}, after {RECSYS_STEPS} steps)")
            got[label] = r
            torch.cuda.empty_cache()
        if cfg.model != "fm":
            check(got["int2"]["act_bytes"] < got["fp32"]["act_bytes"]
                  and got["int2"]["act_fp32"] == got["fp32"]["act_fp32"],
                  f"[recsys] {arch} ACT bytes INT2 vs FP32")
        key = arch.replace("-", "_")
        runs.update({f"recsys_{key}_{label}": r for label, r in got.items()})
        profile_model_step(torch, step, f"{arch} int2", top=10)
        del step
        torch.cuda.empty_cache()
    step = build_step("xdeepfm", device=DEV, batch_size=RECSYS_PEAK_BATCH)
    peak = {label: train_run(torch, "recsys", f"xdeepfm batch "
                             f"{RECSYS_PEAK_BATCH} {label}", step, label,
                             RECSYS_PEAK_STEPS, exact=True)
            for label in ("fp32", "int2")}
    log(f"[recsys] xdeepfm batch {RECSYS_PEAK_BATCH}: peak FP32 "
        f"{peak['fp32']['peak'] / 2**30:.2f} GiB, INT2 "
        f"{peak['int2']['peak'] / 2**30:.2f} GiB (-"
        f"{(peak['fp32']['peak'] - peak['int2']['peak']) / 2**30:.2f} GiB); "
        f"ACT residual bytes {peak['fp32']['act_bytes'] / 2**30:.2f} -> "
        f"{peak['int2']['act_bytes'] / 2**30:.2f} GiB")
    check(peak["int2"]["peak"] < peak["fp32"]["peak"],
          "[recsys] xDeepFM's INT2 peak is not below FP32's")
    runs.update({f"recsys_xdeepfm_b{RECSYS_PEAK_BATCH}_{label}": r
                 for label, r in peak.items()})
    del step
    torch.cuda.empty_cache()
    check_two_steps(torch, "determinism", "xdeepfm int2",
                    build_step("xdeepfm", device=DEV,
                               batch_size=RECSYS_BATCH), "int2")
    torch.cuda.empty_cache()
    return runs


def recsys_serve(torch):
    """[recsys-serve]: each model at full width (DLRM capped), random seed-0
    parameters: ``serve_recsys`` at ``serve_p99`` (512 examples,
    ``RECSYS_P99_REQUESTS`` batches) and ``serve_bulk`` (262,144, or
    16,384 for xDeepFM, whose CIN inputs at 262,144 would not fit;
    ``RECSYS_BULK_REQUESTS`` batches), ids drawn per field from each
    field's vocabulary (``serve._recsys_queries``). Forward only: no ACT
    residual and no gradient, so no kernel launches."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import serve_recsys
    from repro_torch.models import recsys

    out = {}
    for arch in RECSYS_ARCHS:
        cfg = _recsys_cfg(arch)
        p = get(arch)
        params = recsys.init_params(cfg, seed=0, device=DEV)
        bulk = p.shape("serve_bulk").p()["batch"]
        why = ""
        if cfg.cin_layers:
            # a layer's (B, k, H·F) CIN input is made while the previous
            # layer's is still held: the widest consecutive pair
            widths = [cfg.n_sparse] + list(cfg.cin_layers[:-1])
            per = [h * cfg.n_sparse * cfg.embed_dim * 4 for h in widths]
            pair = max(a + b for a, b in zip(per, per[1:] + [0]))
            total = torch.cuda.get_device_properties(0).total_memory
            if bulk * pair > total:
                why = (f" (serve_bulk's {bulk:,} would hold (B, k, H·F) "
                       f"CIN inputs of {bulk * max(per) / 1e9:.1f} and "
                       f"{bulk * (pair - max(per)) / 1e9:.1f} GB at once, "
                       f"more than the card's {total / 1e9:.1f} GB: run at "
                       f"{RECSYS_XDEEPFM_BULK:,})")
                bulk = RECSYS_XDEEPFM_BULK
        res = {}
        for shape, batch, n in (("serve_p99", p.shape("serve_p99").p()
                                 ["batch"], RECSYS_P99_REQUESTS),
                                ("serve_bulk", bulk, RECSYS_BULK_REQUESTS)):
            torch.cuda.reset_peak_memory_stats()
            r = serve_recsys(cfg, params, batch=batch, requests=n,
                             device=DEV,
                             name=f"{arch} {shape}", log=lambda _: None)
            r["peak"] = torch.cuda.max_memory_allocated()
            log(f"[recsys-serve] {arch} {shape}: batch {batch:,}, "
                f"{n} batches: p50 {r['p50_ms']:.3f} ms, p99 "
                f"{r['p99_ms']:.3f} ms ({batch / r['p50_ms'] * 1e3:,.0f} "
                f"examples/s at p50), peak {r['peak'] / 2**30:.2f} GiB"
                + (why if shape == "serve_bulk" else ""))
            res[shape] = r
        counts = [r["launches"] for r in res.values()]
        log(f"[recsys-serve] {arch}: kernel launches of the timed batches "
            f"{json.dumps(counts) if any(counts) else 'none (forward only)'}")
        check(all(math.isfinite(r["p50_ms"]) for r in res.values()),
              f"[recsys-serve] {arch}: no latency")
        out[arch] = res
        del params
        torch.cuda.empty_cache()
    return out


def recsys_retrieval(torch):
    """[recsys-retrieval]: the two-stage path at full width
    (``serve_recsys_two_stage``): xDeepFM's towers over 1,000,000
    candidates of field 2 (vocab 10,131,227), the item tower packed at
    INT8, top-32 through the engine for ``RECSYS_RETRIEVAL["requests"]``
    requests, counts reset just before and read just after (the quant-pack
    and the top-K must have launched); the engine's responses for the
    first 16 requests against the plain top-K on the served store (values
    within TOL, indices equal except between near-ties); the recall against
    a dense fp32 top-32 of the same towers and the re-rank's times."""
    from repro_torch.kernels import backend
    from repro_torch.kernels import topk_score as tk
    from repro_torch.launch.serve import serve_recsys_two_stage
    from repro_torch.models import recsys

    cfg = _recsys_cfg("xdeepfm")
    params = recsys.init_params(cfg, seed=0, device=DEV)
    rc = RECSYS_RETRIEVAL
    torch.cuda.synchronize()
    backend.reset_counts()
    res = serve_recsys_two_stage(
        cfg, params, n_cand=rc["n_cand"], k=rc["k"],
        requests=rc["requests"], bits=rc["bits"],
        item_field=rc["item_field"], device=DEV, name="xdeepfm",
        log=lambda m: log(m.replace("[serve]", "[recsys-retrieval]")))
    torch.cuda.synchronize()
    counts = dict(backend.LAUNCH_COUNTS)
    for name, ph in res["phases"].items():
        log(f"[recsys-retrieval] phase {name}: {ph['seconds'] * 1e3:.1f} ms"
            f", launches {json.dumps(ph['launches'], sort_keys=True)}")
    check({"quant_pack", "topk_score"} <= set(counts),
          f"[recsys-retrieval] launched {sorted(counts)}")
    store = res["store"]
    n = 16
    users = store.user_vectors(torch.arange(n, device=DEV))
    excl = torch.full((n, 1), -1, dtype=torch.int32, device=DEV)
    pv, pi = tk.topk_plain(users, store.items, excl, k=rc["k"])
    err, swaps, ok = _close_topk(torch, res["retrieved_values"][:n],
                                 res["retrieved"][:n], pv.cpu(), pi.cpu())
    log(f"[recsys-retrieval] the engine's top-{rc['k']} of the first {n} "
        f"requests against the plain top-K on the served store: values rel "
        f"{err:.3e}, {swaps} index swaps (near-ties); recall@{rc['k']} "
        f"{res['recall']:.4f} against the dense fp32 top-{rc['k']} of the "
        f"same towers; re-rank of a top-{rc['k']}: p50 "
        f"{res['rerank_p50_ms']:.3f} ms, p99 {res['rerank_p99_ms']:.3f} ms")
    check(ok, "[recsys-retrieval] the engine's responses differ from the "
          "plain top-K")
    check(0.0 < res["recall"] <= 1.0, "[recsys-retrieval] no recall")
    out = {key: res[key] for key in ("recall", "rerank_p50_ms",
                                     "rerank_p99_ms", "stats", "phases")}
    del res, store, params
    torch.cuda.empty_cache()
    return out, counts


def run_recsys(torch, gen, shapes):
    """The recsys phases ([recsys-kernels], [recsys] with the reduced
    steps, the training runs and xDeepFM's [determinism] pair,
    [recsys-serve], [recsys-retrieval]); returns the training runs by path
    key, the retrieval's launches and the figures printed."""
    t0 = time.perf_counter()
    recsys_kernel_cases(torch, gen, shapes)
    recsys_reduced(torch)
    runs = recsys_train(torch)
    serve = recsys_serve(torch)
    retrieval, counts = recsys_retrieval(torch)
    log(f"[recsys] phase {time.perf_counter() - t0:.1f} s")
    return runs, counts, serve, retrieval


# -- the LM families (dense GQA and MoE transformers) --------------------------


def lm_kernel_cases(torch, gen, shapes):
    """[lm-kernels]: the kernels of the LM training path at the shapes the
    card configs give them: the quant-pack (INT2 SR) at each block's saved
    input, 8,192 x 5,120 (stablelm) and 8,192 x 2,048 (moonshot), from bf16
    as the step hands it over, from bf16 through an fp32 copy (what the
    wrapper did before it read bf16) and from fp32; the segment sum on the
    embedding gradient of each config's first training batch (8,192
    positions over the distinct token ids), beside ``index_add_`` into the
    same distinct rows (``segment_sum_report``). Records under ``shapes``
    by kernel name."""
    from repro_torch.data.csr import lookup_plan
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp
    from repro_torch.models.registry import LM_CARD_BATCH, LM_CARD_SEQ, \
        lm_config

    tag = "lm-kernels"
    rows = LM_CARD_BATCH * LM_CARD_SEQ
    log(f"[{tag}] kernels vs plain and library at the LM shapes "
        f"({LM_CARD_BATCH} x {LM_CARD_SEQ} tokens a step)")
    for arch in LM_TRAIN:
        cfg = lm_config(arch)
        d = cfg.d_model
        x = torch.randn((rows, d), generator=gen, device=DEV) * 0.3
        xb = x.to(torch.bfloat16)
        seed = 0x1A + d
        for where, xin in ((f"{arch} block input ", xb),
                           (f"{arch} block input ", x)):
            c = quant_case(qp, xin, seed, where)
            shapes.setdefault("quant_pack", []).append(run_case(
                torch, tag, c, shape="lm ", iters=10))
        label, name, _, plain, _, cost = quant_case(
            qp, xb, seed, f"{arch} block input via fp32 copy ")

        def copied(xb=xb, seed=seed):
            return qp.quant_pack_cuda(xb.float(), seed, bits=2,
                                      stochastic=True)

        rec = run_case(torch, tag, (label, name, copied, plain, None, cost),
                       shape="lm ", iters=10)
        shapes["quant_pack"].append(rec)
        del x, xb
        b = next(lm_batches(vocab=cfg.vocab, batch=LM_CARD_BATCH,
                            seq=LM_CARD_SEQ, seed=0))
        plan = lookup_plan(b["tokens"][:, :-1], cfg.vocab, DEV)
        levels, E = plan.runs, plan.ids.numel()
        n_out = levels[-1].n_out
        inv = torch.searchsorted(plan.rows, plan.ids)
        log(f"[{tag}] {arch} embedding gradient: {E:,} positions, {n_out:,} "
            f"distinct ids of {cfg.vocab:,} rows, d {d}")
        y = torch.randn((E, d), generator=gen, device=DEV) * 1e-3

        def library(y=y, inv=inv, n_out=n_out, d=d):
            return torch.zeros((n_out, d), device=DEV).index_add_(0, inv, y)

        cost = sp.segment_sum_cost(levels, d)
        label = f"{arch} embedding segment_sum d={d}"
        rec = run_case(torch, tag, (
            label, "segment_sum",
            lambda y=y, lv=levels: sp.segment_sum_cuda(y, lv),
            lambda y=y, lv=levels: sp.segment_sum_plain(y, lv), library,
            cost), shape="lm ", iters=10)
        rec.update(segment_sum_report(torch, sp, y, levels, library, cost,
                                      f"[{tag}] {label}"))
        shapes.setdefault("segment_sum", []).append(rec)
        del y, plan, inv
        torch.cuda.empty_cache()


def lm_reduced(torch):
    """[lm]: three reduced INT2 steps of each of the five LM archs on the
    card against the CPU's plain versions from the same parameters, losses
    within 1e-5 relative, exactly the path's kernels every step
    (``reduced_lm_losses`` of tests/test_torch_cuda.py)."""
    from repro_torch.models.registry import path_kernels

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import reduced_lm_losses

    for arch in LM_ARCHS:
        losses, step, run = reduced_lm_losses(arch, DEV)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[str(DEV)],
                                                       losses["cpu"]))
        want = set(path_kernels(step.cfg.model, True))
        got = [sorted(r["launches"]) for r in run["steps"]]
        log(f"[lm] reduced {arch} INT2, card vs CPU plain versions: losses "
            f"{[f'{v:.6f}' for v in losses[str(DEV)]]}, max rel {rel:.3e}; "
            f"launches per step {json.dumps(run['steps'][-1]['launches'])}")
        check(rel <= TOL, f"reduced {arch} differs from the CPU by {rel}")
        check(all(set(g) == want for g in got),
              f"reduced {arch} launched {got}, the path has {sorted(want)}")


def _to_cpu_state(state):
    """A (params, Adam state) pair's tensors, copied to the host."""
    from repro_torch.models.layers import param_leaves

    params, opt = state
    return [t.detach().cpu() for t in param_leaves(params)
            + opt["mu"] + opt["nu"]]


def lm_two_steps(torch, name, step, label="int2"):
    """Two steps of ``step`` under ``label`` from one state (after a first
    step) on one batch: the loss, every parameter and every Adam moment
    bit-identical. The first run's results wait on the host, so that the
    card holds the state twice, not three times."""
    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.training.optimizer import adam
    from repro_torch.training.step import make_train_step

    opt = adam(step.lr)
    batches = step.batches()
    train = make_train_step(step, opt, schedule=parse_schedule(label),
                            root_seed=ROOT_SEED)
    params = step.init(0)
    state, _ = train((params, opt.init(params)), next(batches), 0)
    del params
    batch = next(batches)
    s1, m1 = train(_clone_state(torch, state), batch, 1)
    first = _to_cpu_state(s1)
    del s1
    s2, m2 = train(_clone_state(torch, state), batch, 1)
    del state
    pairs = list(zip(first, _to_cpu_state(s2)))
    del s2
    n_same = sum(bool(torch.equal(a, b)) for a, b in pairs)
    same_loss = bool(torch.equal(m1["loss"], m2["loss"]))
    log(f"[determinism] {name}: two steps from one state: loss "
        f"{float(m1['loss']):.9f} / {float(m2['loss']):.9f} "
        f"({'bit-identical' if same_loss else 'DIFFER'}), {n_same} of "
        f"{len(pairs)} parameter and moment tensors bit-identical")
    check(same_loss and n_same == len(pairs),
          f"[determinism] {name}: two steps from one state differ")
    torch.cuda.empty_cache()


@contextlib.contextmanager
def moe_routing_log():
    """While open, every MoE group's routing is appended to the list it
    yields, in call order (layer by layer, group by group): the group's
    (Tg, k) expert choices and whether each choice is within capacity
    (``models.moe._routing``, wrapped)."""
    from repro_torch.models import moe

    inner, log_ = moe._routing, []

    def routing(idx, E, C):
        slot_src, choice_slot = inner(idx, E, C)
        log_.append((idx.clone(), (choice_slot < E * C).reshape(idx.shape)))
        return slot_src, choice_slot

    moe._routing = routing
    try:
        yield log_
    finally:
        moe._routing = inner


def _same_routing(torch, a, b, n_layers):
    """(n_layers, T) bool from two ``moe_routing_log``s of one forward:
    whether a token's routing in a layer is the same in both, as the set
    of its (expert, within capacity) pairs (the order of a token's k
    choices does not change where it goes)."""
    same = []
    for (ia, ka), (ib, kb) in zip(a, b, strict=True):
        sa, oa = ia.sort(-1)
        sb, ob = ib.sort(-1)
        same.append((sa == sb).all(-1)
                    & (ka.gather(-1, oa) == kb.gather(-1, ob)).all(-1))
    return torch.cat(same).reshape(n_layers, -1)


def _layerwise_bf16(torch, cfg, cfg32, p16, p32, tokens):
    """Each block of the bf16 model and of the fp32 model on one input, the
    fp32 model's hidden state (cast to bf16 for the bf16 block), then the
    final norm and head the same way, so that no stage inherits an earlier
    stage's difference: per stage, each token's largest |diff| of the
    stage's output, of the fp32 output's max |value| (a (T,) tensor), and
    for each block whether each token's routing is the same in both ((T,)
    bool; all True for a dense block)."""
    from repro_torch.models import transformer as tf

    pos = torch.arange(tokens.shape[1], device=DEV)
    f16, f32 = tf._block_fwd(cfg), tf._block_fwd(cfg32)
    x = p32["emb"][tokens.long()]
    errs, same = [], []

    def err(a, b):
        return ((a.float() - b).abs().amax(-1) / b.abs().max()).flatten()

    for i in range(cfg.n_layers):
        with moe_routing_log() as r16:
            y16 = f16(tf.layer_params(p16, i), x.to(torch.bfloat16), pos)
        with moe_routing_log() as r32:
            y32 = f32(tf.layer_params(p32, i), x, pos)
        errs.append(err(y16, y32))
        same.append(_same_routing(torch, r16, r32, 1)[0] if r32
                    else torch.ones_like(errs[-1], dtype=torch.bool))
        x = y32
        del y16, r16, r32
    l16 = tf._rmsnorm(x.to(torch.bfloat16), p16["ln_f"], cfg.norm_eps) \
        @ p16["head"]
    l32 = tf._rmsnorm(x, p32["ln_f"], cfg.norm_eps) @ p32["head"]
    errs.append(err(l16, l32))
    return errs, same


def lm_bf16_check(torch, arch, step):
    """The bf16 forward of the card config against the same weights in
    fp32 on the card, first batch, no ACT. The whole forward: losses
    within ``LM_BF16_LOSS_TOL`` relative, and for a dense model the logits
    within ``LM_BF16_TOL`` of the fp32 logits' max |value| at every token
    (bf16 keeps 8 bits of mantissa in every product's inputs and in every
    activation between the fp32 accumulations). A MoE token whose routing
    differs between the two (a near-tie between its k-th and (k+1)-th
    expert, or a capacity cut that moves with one) goes to other experts
    and changes wholesale, and causal attention carries that change into
    every later token of its sequence in the next layer, whatever their
    own routing. So each stage is also held alone (``_layerwise_bf16``):
    every block's output at every token routed the same in that block, and
    the head's logits at every token, within ``LM_BF16_TOL``; and the share
    of tokens routed otherwise in some layer of the whole forward (the
    routing recorded in both, ``moe_routing_log``) at most
    ``LM_ROUTER_FLIP_MAX``."""
    import dataclasses

    from repro_torch.models import transformer as tf

    cfg = step.cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = next(step.batches())
    toks = batch["tokens"]
    with torch.no_grad():
        p16 = tf.init_params(cfg, seed=0, device=DEV)
        p32 = {k: [t.float() for t in v] if isinstance(v, list)
               else v.float() for k, v in p16.items()}
        out, routes = {}, {}
        for c, p in ((cfg, p16), (cfg32, p32)):
            with moe_routing_log() as routes[c.dtype]:
                logits = tf.forward(p, toks[:, :-1], c).float()
            logz = torch.logsumexp(logits, -1)
            gold = torch.gather(logits, -1, toks[:, 1:, None].long())[..., 0]
            out[c.dtype] = (float((logz - gold).mean()), logits)
            del logits, logz, gold
        l16, lg16 = out.pop("bfloat16")
        l32, lg32 = out.pop("float32")
        # per token: the largest |diff| of its logits, of the max |logit|
        tok = ((lg16 - lg32).abs().amax(-1) / lg32.abs().max()).flatten()
        del lg16, lg32
        errs, same_l = _layerwise_bf16(torch, cfg, cfg32, p16, p32,
                                       toks[:, :-1])
        del p16, p32
    err, med = float(tok.max()), float(tok.median())
    off = float((tok > LM_BF16_TOL).float().mean())
    lrel = abs(l16 - l32) / abs(l32)
    stage = [float(e[s].max()) for e, s in zip(errs, same_l)] \
        + [float(errs[-1].max())]
    msg = (f"[lm-train] {arch} bf16 forward against the same weights in "
           f"fp32 on the card: logits max |diff| {err:.3e} of max |logit| "
           f"(median token {med:.3e}; tol {LM_BF16_TOL}; tokens past it "
           f"{off:.2%}), loss {l16:.6f} / {l32:.6f} (rel {lrel:.3e}, tol "
           f"{LM_BF16_LOSS_TOL}); each stage alone from the fp32 input, max "
           f"|diff| of its max |output|: blocks "
           + ", ".join(f"{e:.3e}" for e in stage[:-1])
           + f", head {stage[-1]:.3e} (tol {LM_BF16_TOL})")
    worst, flips = max([err] + stage), 0.0
    if cfg.moe is not None:
        same = _same_routing(torch, routes["bfloat16"], routes["float32"],
                             cfg.n_layers)
        flips = 1.0 - float(same.all(0).float().mean())
        worst = max(stage)
        by_layer = ", ".join(f"{1 - float(r.float().mean()):.2%}"
                             for r in same)
        alone = ", ".join(f"{1 - float(s.float().mean()):.2%}"
                          for s in same_l)
        msg += (f" at the tokens routed the same in that block (routed "
                f"otherwise there: {alone}); in the whole forward the "
                f"routing differs for {flips:.2%} of tokens in some layer "
                f"(by layer {by_layer}; limit {LM_ROUTER_FLIP_MAX:.0%})")
    log(msg)
    check(worst <= LM_BF16_TOL and lrel <= LM_BF16_LOSS_TOL
          and flips <= LM_ROUTER_FLIP_MAX,
          f"[lm-train] {arch}: bf16 forward off fp32 by {worst} / {lrel}, "
          f"routing differs for {flips:.2%} of tokens")
    del routes, errs, same_l
    torch.cuda.empty_cache()


def lm_held_bytes(torch, step, label):
    """The bytes the block stack's autograd graph holds for its backward
    under ``label``'s block policy, after the stack's forward on one batch
    of random inputs: the storages of the tensors it saves (a
    ``saved_tensors_hooks`` pack hook sees each; non-reentrant checkpoint
    saves the block inputs so) and of the packed residuals (``QTensor``)
    an ACT Function keeps on its context (read off the graph's nodes),
    each storage once, the parameters' not counted. The stack's input is a
    product with a leaf, which saves nothing, as the embedding's output
    in a step."""
    from repro_torch.core.act import act_remat
    from repro_torch.core.policy import parse_schedule
    from repro_torch.core.quant import QTensor
    from repro_torch.models import transformer as tf
    from repro_torch.training.step import trainable

    cfg = step.cfg
    B, S = step.data["batch"], step.data["seq"]
    params = trainable(tf.init_params(cfg, seed=0, device=DEV))
    layers = [tf.layer_params(params, i) for i in range(cfg.n_layers)]
    pol = parse_schedule(label).resolve("remat", "lm/block")
    block = act_remat(tf._block_fwd(cfg), pol, repeat=cfg.n_layers)
    leaf = torch.randn((B, S, cfg.d_model), device=DEV,
                       dtype=getattr(torch, cfg.dtype), requires_grad=True)
    positions = torch.arange(S, device=DEV)
    held = {}
    skip = {t.untyped_storage().data_ptr()
            for v in params.values() for t in (v if isinstance(v, list)
                                               else [v])}

    def keep(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            held[st.data_ptr()] = st.nbytes()

    def pack(t):
        keep(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = block(layers, leaf * 1, list(range(cfg.n_layers)),
                  consts=positions)
    seen, todo = set(), [y.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        q = getattr(node, "q", None)
        if isinstance(q, QTensor):
            for t in (q.packed, q.scale, q.zero):
                keep(t)
        todo.extend(f for f, _ in node.next_functions)
    del y, leaf, layers, params
    torch.cuda.empty_cache()
    return sum(held.values())


def lm_train(torch):
    """[lm-train]: stablelm-12b and moonshot-v1-16b-a3b at the card configs
    (published widths in bf16, 2 layers, batch 2 x 4,096), ``LM_STEPS``
    steps under FP32 and INT2 each (``train_run``: finite losses, exactly
    the path's kernels, the same every step; median step, peak memory,
    ACT bytes). Checks: the first loss near ln V + 0.5 (the random head's
    logits have unit variance), INT2's residual bytes below FP32's
    pricing, the bytes the block stack's graph holds (``lm_held_bytes``);
    then an INT2 step profiled
    (no ``index_add_``), two INT2 steps bit-identical ([determinism]) and
    the bf16 forward against fp32."""
    from repro_torch.models.registry import build_step

    runs = {}
    for arch in LM_TRAIN:
        step = build_step(arch, device=DEV)
        cfg = step.cfg
        log(f"[lm-train] {arch}: d {cfg.d_model}, {cfg.n_heads} heads over "
            f"{cfg.n_kv_heads} KV heads of {cfg.d_head}, "
            + (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
               f"{cfg.moe.d_ff}" if cfg.moe else f"d_ff {cfg.d_ff}")
            + f", vocab {cfg.vocab:,}, {cfg.n_layers} layers (cut from "
            f"{LM_FULL_LAYERS[arch]}), {cfg.n_params / 1e9:.3f} B "
            f"parameters ({cfg.n_active_params / 1e9:.3f} B active) in "
            f"{cfg.dtype}; batch {step.data['batch']} x {step.data['seq']}")
        rows = step.data["batch"] * step.data["seq"]
        got = {}
        for label in ("fp32", "int2"):
            r = train_run(torch, "lm-train", f"{arch} {label}", step, label,
                          LM_STEPS, exact=True)
            first = r["losses"][0]
            want = math.log(cfg.vocab) + 0.5
            held = lm_held_bytes(torch, step, label)
            r["act_held"] = held
            log(f"[lm-train] {arch} {label}: first loss {first:.4f} (ln V + "
                f"0.5 = {want:.4f}); ACT residual bytes priced as the "
                f"reference prices them {r['act_bytes']:,} (FP32 pricing "
                f"{r['act_fp32']:,}), held by the block stack's graph "
                f"{held:,} (measured: the storages its saved tensors and "
                f"packed residuals hold; "
                f"{rows * cfg.d_model * 2 * cfg.n_layers:,} are the "
                f"{cfg.n_layers} bf16 block inputs); peak "
                f"{r['peak'] / 2**30:.2f} GiB")
            check(abs(first - want) <= LM_FIRST_LOSS_TOL,
                  f"[lm-train] {arch} {label}: first loss {first} is not "
                  f"near ln V + 0.5 = {want}")
            got[label] = r
            torch.cuda.empty_cache()
        check(got["int2"]["act_bytes"] < got["fp32"]["act_bytes"]
              and got["int2"]["act_fp32"] == got["fp32"]["act_fp32"],
              f"[lm-train] {arch} ACT bytes INT2 vs FP32")
        key = arch.split("-")[0]
        runs.update({f"lm_{key}_{label}": r for label, r in got.items()})
        profile_model_step(torch, step, f"{arch} int2", top=10)
        torch.cuda.empty_cache()
        lm_two_steps(torch, f"{arch} int2", step)
        lm_bf16_check(torch, arch, step)
        del step
        torch.cuda.empty_cache()
    return runs


def lm_serve(torch):
    """[lm-serve]: ``serve_lm`` at the card configs (2 layers, seed-0
    weights): stablelm-12b's prefill of one 32,768-token prompt
    (``prefill_32k``, batch 32 cut to 1); its decode at batch 8
    (``decode_32k``, batch 128 cut to 8: a 32,704-token prompt, then 64
    greedy steps) with the bf16 cache and with the int8 cache: ms a token
    and the cache's bytes (int8 at most 0.53x bf16); then both caches
    teacher-forced with the bf16 run's prompt and tokens
    (``teacher_forced_logits`` of tests/test_torch_cuda.py): the largest
    logit difference and the share of steps whose top-1 agrees;
    moonshot-v1-16b-a3b at batch 8, a 4,096-token
    prompt and 32 steps (capacity 1 at decode: colliding tokens are
    dropped, as in the reference). Forward only: no kernel launches."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels import backend
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import lm_config

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import teacher_forced_logits

    out = {}
    cfg = lm_config("stablelm-12b")
    params = tf.init_params(cfg, seed=0, device=DEV)
    quiet = dict(device=DEV, log=lambda _: None)
    backend.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    b, s = LM_PREFILL
    r = serve_lm(cfg, params, batch=b, tokens=1, prompt_len=s,
                 name="stablelm-12b prefill_32k", **quiet)
    log(f"[lm-serve] stablelm-12b prefill of {b} x {s:,} tokens: "
        f"{r['prefill_ms']:.1f} ms ({b * s / r['prefill_ms'] * 1e3:,.0f} "
        f"tokens/s), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    out["prefill_ms"] = r["prefill_ms"]
    del r
    torch.cuda.empty_cache()
    b, s, n = LM_DECODE
    res = {}
    for bits in (None, 8):
        c = dataclasses.replace(cfg, kv_cache_bits=bits)
        torch.cuda.reset_peak_memory_stats()
        r = serve_lm(c, params, batch=b, tokens=n + 1, prompt_len=s - n,
                     name=f"stablelm-12b decode_32k kv {bits or 'bf16'}",
                     **quiet)
        r["peak"] = torch.cuda.max_memory_allocated()
        log(f"[lm-serve] stablelm-12b decode at batch {b}, "
            f"{s - n:,}-token prompt then {n} steps, "
            f"{'int8' if bits else 'bf16'} cache: prefill "
            f"{r['prefill_ms']:.1f} ms, {r['ms_per_token']:.3f} ms a token "
            f"({b / r['ms_per_token'] * 1e3:,.0f} tokens/s), cache "
            f"{r['cache_bytes']:,} B ({r['cache_bytes'] / 1e9:.3f} GB), peak "
            f"{r['peak'] / 2**30:.2f} GiB")
        res[bits] = r
        torch.cuda.empty_cache()
    ratio = res[8]["cache_bytes"] / res[None]["cache_bytes"]
    # the prompt serve_lm drew, and the bf16 run's tokens fed to both
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s - n))).to(DEV)
    feed = res[None]["tokens"][:, :-1]
    logits = {bits: teacher_forced_logits(
                  dataclasses.replace(cfg, kv_cache_bits=bits), params,
                  prompt, feed) for bits in (None, 8)}
    torch.cuda.empty_cache()
    diffs = [float((a.float() - c.float()).abs().max())
             for a, c in zip(logits[8], logits[None])]
    agree = [bool(torch.equal(a.argmax(-1), c.argmax(-1)))
             for a, c in zip(logits[8], logits[None])]
    share = sum(agree) / len(agree)
    log(f"[lm-serve] int8 cache against bf16 over the prefill and {n} "
        f"steps (teacher forcing): cache bytes {ratio:.4f}x, largest logit "
        f"difference {max(diffs):.4f} (max |logit| "
        f"{max(float(x.float().abs().max()) for x in logits[None]):.3f}"
        f"), top-1 agrees on {share:.2%} of steps (all {b} rows)")
    check(ratio <= 0.53, f"[lm-serve] int8 cache takes {ratio:.4f}x bf16's")
    check(all(math.isfinite(d) for d in diffs), "[lm-serve] non-finite logits")
    out.update(decode_ms_bf16=res[None]["ms_per_token"],
               decode_ms_int8=res[8]["ms_per_token"],
               cache_bytes_bf16=res[None]["cache_bytes"],
               cache_bytes_int8=res[8]["cache_bytes"],
               max_logit_diff=max(diffs), top1_share=share)
    del res, logits, params
    torch.cuda.empty_cache()
    cfg = lm_config("moonshot-v1-16b-a3b")
    params = tf.init_params(cfg, seed=0, device=DEV)
    b, s, n = LM_MOE_SERVE
    r = serve_lm(cfg, params, batch=b, tokens=n + 1, prompt_len=s,
                 name="moonshot-v1-16b-a3b", **quiet)
    log(f"[lm-serve] moonshot-v1-16b-a3b at batch {b}, {s:,}-token prompt, "
        f"{n} steps: prefill {r['prefill_ms']:.1f} ms, "
        f"{r['ms_per_token']:.3f} ms a token, cache "
        f"{r['cache_bytes'] / 1e9:.3f} GB (bf16)")
    check(math.isfinite(r["ms_per_token"]), "[lm-serve] moonshot: no time")
    out.update(moe_prefill_ms=r["prefill_ms"], moe_ms_per_token=r[
        "ms_per_token"])
    counts = dict(backend.LAUNCH_COUNTS)
    log(f"[lm-serve] kernel launches of the serving runs: "
        f"{json.dumps(counts) if counts else 'none (forward only)'}")
    del params, r
    torch.cuda.empty_cache()
    return out


def run_lm(torch, gen, shapes):
    """The LM phases ([lm-kernels], [lm] reduced, [lm-train] with the
    [determinism] pairs, [lm-serve]); returns the training runs by path
    key."""
    t0 = time.perf_counter()
    lm_kernel_cases(torch, gen, shapes)
    lm_reduced(torch)
    runs = lm_train(torch)
    lm_serve(torch)
    log(f"[lm] phase {time.perf_counter() - t0:.1f} s")
    return runs


# -- the tooling layer: autotuner, dry run and report, embedding_bag, the
# train_kgnn example -----------------------------------------------------------

TUNE_CASES = (("topk_score", 1, 20), ("topk_score", 8, 20),
              ("topk_score", 128, 20), ("coarse_topm", 1, COARSE_M),
              ("coarse_topm", 8, COARSE_M), ("coarse_topm", 128, COARSE_M))
TUNE_WIDE = (8, 33, 32)      # B, width, k over RECSYS_RETRIEVAL's 1,000,000
DRY_PEAK_TOL = 0.05          # dry-run peak vs the training phase's
DRY_FLOP_TOL = 0.05          # stablelm's traced FLOPs vs lm_train_flops
BAG = dict(bags=4096, max_len=64, rows=2097152, dim=128)
EXAMPLE_STEPS = 20


def lm_train_flops(cfg, batch: int, seq: int) -> int:
    """The matmul FLOPs of one LM training step, counted from the config:
    per token and layer the QKV, output and SwiGLU projections (2·M·N·K
    each), per layer the chunked causal attention's two products over the
    chunk pairs ``chunked_causal_attention`` runs (each query chunk only
    its triangle of key chunks), the head's 2·T·d·V; the block stack runs
    its forward twice (the step, then the remat's recomputation in the
    backward) and its backward (2x the forward), the head forward and
    backward: 4·blocks + 3·head."""
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    tokens = batch * seq
    proj = 2 * d * (h + 2 * kh) * dh + 2 * h * dh * d + 3 * 2 * d * cfg.d_ff
    qc, kc = min(cfg.q_chunk, seq), min(cfg.kv_chunk, seq)
    lcm = math.lcm(qc, kc)
    s_pad = -(-seq // lcm) * lcm
    pairs = sum(min(((i + 1) * qc - 1) // kc + 1, s_pad // kc)
                for i in range(s_pad // qc))
    attn = batch * h * pairs * 2 * (2 * qc * kc * dh)
    blocks = cfg.n_layers * (tokens * proj + attn)
    head = 2 * tokens * d * cfg.vocab
    return 4 * blocks + 3 * head


def tooling_autotune(torch, gen):
    """The autotuner's sweep over the query tiles at the engine's and the
    eval's batches over KGAT's item table (top-K k 20, coarse m 80) and at
    B 8, k 32 over 1,000,000 INT8 rows of width 33: every candidate's
    values and indices the default's (qt 0) bit for bit, each candidate's
    device time, the winner cached and returned by a second tuner on the
    file with no sweep."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import autotune
    from repro_torch.kernels import topk_score as tk
    from repro_torch.kernels.backend import BUILD_DIR
    from repro_torch.serving.scorer import quantize_query

    path = BUILD_DIR.parent / "autotune_smoke.json"
    path.unlink(missing_ok=True)
    tuner = autotune.Autotuner(str(path), sweep=True)
    log(f"[tooling] autotune: fingerprint {tuner.fingerprint}; query tiles "
        f"{autotune.QUERY_TILES}, {tuner.reps} calls a candidate after a "
        f"warm-up, queued behind a held stream (CUDA events)")
    n_items, d = QUANT_ROWS[1], 256     # the served item table (INT8)
    cases = [(op, b, n_items, d, m, 8) for op, b, m in TUNE_CASES]
    cases.append(("topk_score", TUNE_WIDE[0], RECSYS_RETRIEVAL["n_cand"],
                  TUNE_WIDE[1], TUNE_WIDE[2], 8))
    picked, inputs = {}, {}
    for op, b, n, width, m, bits in cases:
        key = (n, width)
        if key not in inputs:
            inputs[key] = quantize(torch.randn((n, width), generator=gen,
                                               device=DEV) * 0.3, 0,
                                   bits=bits)
        items = inputs[key]
        q = torch.randn((b, width), generator=gen, device=DEV) * 0.3
        excl = torch.randint(-1, n, (b, 12), generator=gen, device=DEV,
                             dtype=torch.int32)
        q8, qmeta = quantize_query(q)

        def run(qt, op=op, q=q, q8=q8, qmeta=qmeta, items=items, excl=excl,
                m=m):
            if op == "coarse_topm":
                return tk._coarse_topm_cuda(q8, qmeta, items, excl, m, qt)
            return tk._topk_cuda(q, items, excl, m, qt)

        want = run(0)
        for t in autotune.QUERY_TILES:
            got = run(t)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1]),
                  f"[tooling] {op} B={b} I={n} d={width}: query tile {t} "
                  f"differs from the default's bits")
        spec = dict(shapes=(b, n, width), bits=bits, extra=f"k{m}",
                    candidates=[{"qt": t} for t in autotune.QUERY_TILES],
                    measure=lambda p, run=run: run(p["qt"]),
                    default={"qt": 0})
        before = tuner.n_sweeps
        win = tuner.pick(op, **spec)
        key = tuner.key(op, spec["shapes"], bits=bits, extra=f"k{m}")
        us = tuner.timings(key)
        planned = tk.plan_for(b, items, m, device=DEV,
                              coarse=op == "coarse_topm").qt
        check(tuner.n_sweeps - before == len(autotune.QUERY_TILES),
              f"[tooling] {op} {key}: swept {tuner.n_sweeps - before} "
              f"candidates")
        log(f"[tooling] autotune {op} B={b} I={n} d={width} m={m} INT{bits}"
            f" ({key}): device us a call "
            + ", ".join(f"qt {json.loads(c)['qt']} {v:.3f}"
                        for c, v in us.items())
            + f"; planner's tile {planned}; winner qt {win['qt']}; every "
            f"tile bit-identical to the default's")
        picked[key] = (op, spec, win)
    again = autotune.Autotuner(str(path), sweep=True)
    for key, (op, spec, win) in picked.items():
        check(again.pick(op, **spec) == win,
              f"[tooling] the second tuner's {key} is not the winner")
    check(again.n_sweeps == 0, f"[tooling] the second tuner swept "
          f"{again.n_sweeps} candidates")
    log(f"[tooling] autotune: a second Autotuner on {path.name} returned "
        f"the {len(picked)} winners with n_sweeps {again.n_sweeps}")
    del inputs


def tooling_dryrun(torch, ds, peaks):
    """``launch.dryrun.run_cell`` on KGAT INT2 over this script's
    Amazon-Book CKG (batch 1,024), xDeepFM INT2 (batch 4,096) and
    stablelm-12b INT2 (2 layers, 2 x 4,096): each record ok, its peak and
    one copy of the parameters (the training phases' callers hold the
    untrained ones beside the copy ``train_model`` trains) within
    ``DRY_PEAK_TOL`` of the same step's peak in the training phases
    (``peaks``), stablelm's traced FLOPs within ``DRY_FLOP_TOL`` of
    ``lm_train_flops``; then the report rendered (``launch.report``)."""
    from repro_torch.launch import dryrun, report
    from repro_torch.models.registry import LM_CARD_BATCH, LM_CARD_SEQ, \
        lm_config

    cells = (("kgat", "paper_full", dict(ds=ds, batch_size=TRAIN_BATCH)),
             ("xdeepfm", "train_batch", None),
             ("stablelm-12b", "train_4k", None))
    out = dryrun.DEFAULT_OUT
    for arch, shape, kw in cells:
        rec = dryrun.run_cell(arch, shape, bits=2, device=DEV, hw=HW,
                              out_dir=out, step_kw=kw)
        check(rec["ok"], f"[tooling] dry run {arch}: {rec.get('error')}\n"
              f"{rec.get('traceback')}")
        mem, rf = rec["memory"], rec["roofline"]
        # train_model trains a copy of the parameters it is given, and the
        # training phase's caller holds the originals through the run: its
        # peak counts them once more than the dry run's step does
        peak, want = mem["peak_gb"], peaks[arch] / 2**30
        log(f"[tooling] dryrun {arch}/{shape} INT2: build {rec['build_s']} "
            f"s, first step {rec['first_step_s']} s, peak {peak:.3f} GiB; "
            f"with the caller's copy of the parameters "
            f"({mem['params_gb']:.3f} GiB) {peak + mem['params_gb']:.3f} "
            f"GiB against the training phase's {want:.3f}; arguments "
            f"{mem['argument_gb']:.3f} GiB, ACT "
            f"{rec['memory']['act_gb'] * 2**10:.2f} MiB; traced "
            f"{rf['hlo_flops'] / 1e12:.4f} TFLOP, {rf['hlo_bytes'] / 1e9:.3f}"
            f" GB: compute {rf['compute_s'] * 1e3:.3f} ms, memory "
            f"{rf['memory_s'] * 1e3:.3f} ms -> {rf['dominant']}; kernels "
            + json.dumps({k: v[0] for k, v in rec["kernels"].items()},
                         sort_keys=True))
        check(abs(peak + mem["params_gb"] - want) <= DRY_PEAK_TOL * want,
              f"[tooling] dry run {arch}: peak {peak:.3f} GiB and "
              f"{mem['params_gb']:.3f} GiB of parameters against the "
              f"training phase's {want:.3f}")
        if arch == "stablelm-12b":
            flops = lm_train_flops(lm_config(arch), LM_CARD_BATCH,
                                   LM_CARD_SEQ)
            log(f"[tooling] stablelm-12b: traced {rf['hlo_flops']:.6e} "
                f"FLOPs against the analytic {flops:.6e} "
                f"({rf['hlo_flops'] / flops:.4f}x)")
            check(abs(rf["hlo_flops"] - flops) <= DRY_FLOP_TOL * flops,
                  "[tooling] stablelm-12b's traced FLOPs are not the "
                  "analytic count")
        torch.cuda.empty_cache()
    report.main(["--dryrun", out])
    with open(report.DEFAULT_REPORT) as f:
        for line in f.read().splitlines():
            if line.startswith("|") and "---" not in line:
                log(f"[tooling] report {line}")


def tooling_embedding_bag(torch, gen):
    """``models.layers.embedding_bag`` at ``BAG``: 4,096 weighted bags of
    1-64 lookups over a 2,097,152 x 128 table, sum and mean; forward and
    the table's gradient within ``TOL`` of the plain versions, exactly two
    segment sums launched (the bag sums, the table's gradient) and no
    index_add_ kernel in the profile."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import backend, ops
    from repro_torch.kernels import spmm as sp
    from repro_torch.models.layers import bag_plan, embedding_bag

    rng = np.random.default_rng(7)
    lens = rng.integers(1, BAG["max_len"] + 1, BAG["bags"])
    seg = np.repeat(np.arange(BAG["bags"]), lens)
    idx = rng.integers(0, BAG["rows"], len(seg))
    plan = bag_plan(idx, seg, BAG["bags"], BAG["rows"], DEV)
    table = (torch.randn((BAG["rows"], BAG["dim"]), generator=gen,
                         device=DEV) * 0.1).requires_grad_(True)
    w = torch.rand(len(seg), generator=gen, device=DEV)
    cot = torch.randn((BAG["bags"], BAG["dim"]), generator=gen, device=DEV)
    for combiner in ("sum", "mean"):
        def run():
            out = embedding_bag(table, None, None, BAG["bags"], weights=w,
                                combiner=combiner, plan=plan)
            grad, = torch.autograd.grad(out, table, cot)
            return out.detach(), grad

        torch.cuda.synchronize()
        backend.reset_counts()
        out, grad = run()
        torch.cuda.synchronize()
        counts = dict(backend.LAUNCH_COUNTS)
        with plain_versions(ops, segment_sum=sp.segment_sum_plain):
            pout, pgrad = run()
        rel = max(_rel(out, pout), _rel(grad, pgrad))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        scatter = [e.key for e in prof.key_averages()
                   if "indexFunc" in e.key or "index_add" in e.key]
        ms = time_ms(run, 10)
        with plain_versions(ops, segment_sum=sp.segment_sum_plain):
            plain_ms = time_ms(run, 10)
        log(f"[tooling] embedding_bag {combiner}: {BAG['bags']} bags of "
            f"1-{BAG['max_len']} lookups ({len(seg):,}) over "
            f"{BAG['rows']:,} x {BAG['dim']}: forward and table gradient "
            f"rel {rel:.3e} to the plain versions; launches {counts}; "
            f"index_add_ kernels {scatter or 'none'}; forward and backward "
            f"{ms:.3f} ms (plain versions {plain_ms:.3f} ms)")
        check(rel <= TOL, f"[tooling] embedding_bag {combiner}: rel {rel}")
        check(counts == {"segment_sum": 2}, f"[tooling] embedding_bag "
              f"{combiner} launched {counts}")
        check(not scatter, f"[tooling] embedding_bag {combiner}: {scatter}")
    del table, plan, w, cot


def tooling_example(torch):
    """``python -m repro_torch.examples.train_kgnn`` for ``EXAMPLE_STEPS``
    steps at scale 1.0 (600k entities x d 160, batch 4,096, INT2, Adam
    with a cosine warm-up and clipping): finite and falling loss."""
    from repro_torch.examples import train_kgnn
    from repro_torch.kernels.backend import BUILD_DIR

    ckpt = BUILD_DIR.parent / "example_ckpt"
    subprocess.run(["rm", "-rf", str(ckpt)], check=True)
    t0 = time.perf_counter()
    res = train_kgnn.main(["--steps", str(EXAMPLE_STEPS), "--ckpt",
                           str(ckpt)])
    losses = res["losses"]
    log(f"[tooling] train_kgnn example: {res['n_params'] / 1e6:.1f} M "
        f"parameters, losses {[f'{v:.4f}' for v in losses]}, median step "
        f"{statistics.median(r['seconds'] for r in res['steps']) * 1e3:.2f}"
        f" ms, recall@20 {res['recall@20']:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(len(losses) == EXAMPLE_STEPS
          and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0],
          f"[tooling] train_kgnn example: losses {losses}")
    subprocess.run(["rm", "-rf", str(ckpt)], check=True)


def run_tooling(torch, gen, ds, peaks):
    """[tooling]: the autotuner, the dry run and report, embedding_bag and
    the train_kgnn example (``tooling_*``)."""
    t0 = time.perf_counter()
    tooling_autotune(torch, gen)
    torch.cuda.empty_cache()
    tooling_dryrun(torch, ds, peaks)
    torch.cuda.empty_cache()
    tooling_embedding_bag(torch, gen)
    torch.cuda.empty_cache()
    tooling_example(torch)
    torch.cuda.empty_cache()
    log(f"[tooling] phase {time.perf_counter() - t0:.1f} s")


# quant_pack in turns against another tree's kernel: (label, rows, d, bits,
# SR) of every shape this script times the quant-pack at
QUANT_TURN_SHAPES = (
    ("serving store, user table", 70679, 256, 8, False),
    ("KGAT INT2 site", 184166, 64, 2, True),
    ("data=2 shard's sources", 184160, 64, 2, True),
    ("sampled KG block's sources", 811008, 64, 2, True),
    ("Cora layer 0", 2708, 1433, 2, True),
    ("Cora layer 1", 2708, 16, 2, True),
    ("ogbn-products layer 0", 2449029, 100, 2, True),
    ("ogbn-products layer 1", 2449029, 16, 2, True),
    ("sampled GCN block 0", 16384, 602, 2, True),
)


def quant_pack_turns(torch, other: Path) -> None:
    """``--quant-pack-against DIR``: build ``DIR``'s
    ``src/repro_torch/csrc/quant_pack.cu`` (another tree, e.g. the parent
    commit's ``git archive``) beside this tree's, and at every shape of
    ``QUANT_TURN_SHAPES`` hold the two to the same bits and take their
    device times (held stream, inputs rotated where they fit the L2) in
    turns: other, this, this, other."""
    import ctypes

    from repro_torch.kernels import backend
    from repro_torch.kernels import quant_pack as qp

    src = other / "src" / "repro_torch" / "csrc"
    check((src / "quant_pack.cu").is_file(), f"no quant_pack.cu under {src}")
    out = backend.BUILD_DIR / "against" / "quant_pack.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([backend._nvcc(), *backend.NVCC_FLAGS, "-o", str(out),
                    str(src / "quant_pack.cu")], check=True, timeout=600,
                   capture_output=True)
    theirs = ctypes.CDLL(str(out)).quant_pack_launch
    theirs.argtypes, theirs.restype = list(qp._ARGTYPES), ctypes.c_int
    ours = backend.kernel_fn("quant_pack", "quant_pack_launch", qp._ARGTYPES)
    gen = torch.Generator(device=DEV).manual_seed(0)
    log(f"[quant_pack-turns] this tree against {other}: device ms (held "
        f"stream), other / this / this / other")
    for label, rows, d, bits, sr in QUANT_TURN_SHAPES:
        xs = rotation(torch.randn((rows, d), generator=gen, device=DEV) * 0.3)
        dp = -(-d // (8 // bits))

        def call(fn, turn=itertools.count()):
            x = xs[next(turn) % len(xs)]
            res = (torch.empty((rows, dp), dtype=torch.uint8, device=DEV),
                   torch.empty((rows, 1), device=DEV),
                   torch.empty((rows, 1), device=DEV))
            backend.launch(fn, x.data_ptr(), rows, d, bits, int(sr), 0x5EED,
                           *(t.data_ptr() for t in res),
                           backend.stream_of(x))
            return res

        a, b = call(theirs), call(ours)
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        check(same, f"quant_pack {label}: the two trees' bits differ")
        del a, b
        t = [device_ms(torch, lambda f=f: call(f))
             for f in (theirs, ours, ours, theirs)]
        bnd, _ = bound_ms(qp.quant_pack_cost(rows, d, bits=bits))
        other_ms, this_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        log(f"  {label} {rows}x{d} INT{bits} {'sr' if sr else 'nearest'}: "
            f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms; other "
            f"{other_ms:.4f}, this {this_ms:.4f} ({other_ms / this_ms:.2f}x)"
            f"; bound {bnd:.4f} ms: this {bnd / this_ms:.0%}, other "
            f"{bnd / other_ms:.0%}; bits identical")
        del xs


SERVE_HOST_BATCHES = (1, 8)   # the engine's served batches (launch-bound)
SERVE_HOST_CALLS = 100        # calls queued behind one held stream
SERVE_HOST_PAIRS = 10         # process pairs, the first of each alternating


def serve_host_one(torch, tree: Path) -> None:
    """``--serve-host-one DIR``: with ``DIR/src`` first on the path, the
    host time a call of ``ops.topk`` (k 20) and ``ops.coarse_topm`` (m 80)
    takes over the served 24,915 x 256 INT8 item table at each batch of
    ``SERVE_HOST_BATCHES``: the calls are queued behind a spinning kernel,
    so the loop reads the wrappers' Python and launch cost alone, not the
    card's; median of 9 loops of ``SERVE_HOST_CALLS``. Where the tree has
    them, also the host time of the pieces a served top-K call gained with
    the autotuner and the cost bracket (``piece_*``). Prints one JSON
    line."""
    import ctypes
    import timeit

    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core.quant import QTensor, quantize
    from repro_torch.kernels import backend, ops
    from repro_torch.kernels import topk_score as tk
    from repro_torch.serving.scorer import quantize_query

    gen = torch.Generator().manual_seed(0)
    q_cpu = quantize(torch.randn((24915, 256), generator=gen) * 0.3, 0,
                     bits=8)
    items = QTensor(q_cpu.packed.to(DEV), q_cpu.scale.to(DEV),
                    q_cpu.zero.to(DEV), 8, 256)
    out = {"tree": str(tree)}
    for b in SERVE_HOST_BATCHES:
        q = (torch.randn((b, 256), generator=gen) * 0.3).to(DEV)
        q8, qmeta = quantize_query(q)
        excl = torch.randint(0, 24915, (b, 12), generator=gen,
                             dtype=torch.int32).to(DEV)
        for name, call in (
                ("topk", lambda: ops.topk(q, items, excl, k=20)),
                ("coarse", lambda: ops.coarse_topm(q8, qmeta, items, excl,
                                                   m=80))):
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            loops = []
            for _ in range(9):
                torch.cuda._sleep(int(2e8))
                t = time.perf_counter()
                for _ in range(SERVE_HOST_CALLS):
                    call()
                loops.append((time.perf_counter() - t) / SERVE_HOST_CALLS)
                torch.cuda.synchronize()
            out[f"{name}_b{b}_us"] = statistics.median(loops) * 1e6
    if hasattr(tk, "_tuned_qt"):
        from repro_torch.obs import cost

        def bracket():
            with cost.kernel("topk_score", ops._topk_call_cost, q, items,
                             excl, 20):
                pass

        def count():
            started = ctypes.c_int(0)
            ctypes.byref(started)
            backend.count_launch("topk_score", kernels=started.value)

        for name, fn in (("tuned_qt", lambda: tk._tuned_qt(
                "topk_score", 8, items, 20, None)), ("bracket", bracket),
                ("count", count)):
            out[f"piece_{name}_us"] = statistics.median(
                timeit.repeat(fn, number=10000, repeat=5)) / 10000 * 1e6
    print(json.dumps(out), flush=True)


def serve_host_turns(other: Path) -> None:
    """``--serve-host-against DIR``: ``serve_host_one`` on ``DIR`` (another
    tree, e.g. the parent commit's ``git archive``) and on this tree, each
    in a process of its own (each tree builds its kernels into its own
    ``build/``), in ``SERVE_HOST_PAIRS`` pairs whose first process
    alternates between the trees. Prints each pair, then each key's
    medians, the pairs this tree's call is the cheaper in, and the spread
    (interquartile distance) of the other tree's runs."""
    check((other / "src" / "repro_torch").is_dir(),
          f"no src/repro_torch under {other}")
    this = Path(__file__).resolve().parent
    env = dict(os.environ,
               REPRO_TORCH_AUTOTUNE_CACHE=str(this / "build"
                                              / "autotune_turns.json"))

    def run(tree):
        r = subprocess.run([sys.executable, __file__, "--serve-host-one",
                            str(tree)], env=env, capture_output=True,
                           text=True, timeout=600)
        check(r.returncode == 0, f"--serve-host-one {tree}: rc "
              f"{r.returncode}\n{r.stderr[-4000:]}")
        return json.loads(r.stdout.strip().splitlines()[-1])

    pairs = []
    for i in range(SERVE_HOST_PAIRS):
        order = (other, this) if i % 2 == 0 else (this, other)
        got = {str(t): run(t) for t in order}
        pairs.append((got[str(other)], got[str(this)]))
        first = "other" if i % 2 == 0 else "this"
        log(f"[serve-host-turns] pair {i} ({first} first), other / this: "
            + "; ".join(f"{k[:-3]} {a[k]:.2f} / {b[k]:.2f}"
                        for a, b in pairs[-1:] for k in a
                        if k.endswith("_us")))
    log(f"[serve-host-turns] this tree against {other}: host us a call "
        f"(calls queued behind a held stream), {SERVE_HOST_PAIRS} pairs")
    for key in [k for k in pairs[0][0] if k.endswith("_us")]:
        o = [a[key] for a, _ in pairs]
        t = [b[key] for _, b in pairs]
        q1, _, q3 = statistics.quantiles(o, n=4)
        log(f"  {key[:-3]}: median other {statistics.median(o):.2f}, this "
            f"{statistics.median(t):.2f} "
            f"({statistics.median(t) - statistics.median(o):+.2f} us); "
            f"this cheaper in {sum(b < a for a, b in zip(o, t))} of "
            f"{len(o)} pairs; other's spread (Q3 - Q1) {q3 - q1:.2f}")
    for key in [k for k in pairs[0][1] if k.startswith("piece_")]:
        log(f"  this tree's {key[6:-3]}: median "
            f"{statistics.median(b[key] for _, b in pairs):.3f} us a call")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    if sys.argv[1:2] == ["--serve-host-one"] and len(sys.argv) == 3:
        serve_host_one(torch, Path(sys.argv[2]).resolve())
        return 0
    if sys.argv[1:2] == ["--serve-host-against"] and len(sys.argv) == 3:
        serve_host_turns(Path(sys.argv[2]).resolve())
        print(smi)
        return 0
    if sys.argv[1:2] == ["--quant-pack-against"] and len(sys.argv) == 3:
        quant_pack_turns(torch, Path(sys.argv[2]).resolve())
        print(smi)
        return 0
    check(len(sys.argv) == 1, f"unknown arguments {sys.argv[1:]}")

    from repro_torch.configs import get
    from repro_torch.data.synthetic import gen_kg_dataset
    from repro_torch.kernels import backend
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp
    from repro_torch.kernels import topk_score as tk
    from repro_torch.models import kgnn
    from repro_torch.models.registry import model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = backend.probe()
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {info.name} sm_{info.capability[0]}{info.capability[1]} "
        f"count {info.count}")
    backend.require_sm90(torch.device("cuda", 0))
    # the main path runs at the planner's query tiles: an empty tile cache
    # of its own, no sweeps ([tooling] sweeps into another)
    from repro_torch.kernels import autotune

    main_cache = backend.BUILD_DIR.parent / "autotune_main.json"
    main_cache.unlink(missing_ok=True)
    autotune.reset(str(main_cache), sweep=False)

    def zipf_graph():
        import numpy as np

        from repro_torch.configs.kgnn_paper import AMAZON_BOOK_ZIPF
        from repro_torch.data.synthetic import gen_zipf_kg_dataset

        t = time.perf_counter()
        zds = gen_zipf_kg_dataset(**AMAZON_BOOK_ZIPF)
        return zds, int(np.bincount(zds.dst).max()), time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=4) as pool:
        t0 = time.perf_counter()
        build = pool.submit(backend.build)
        zipf = pool.submit(zipf_graph)
        gcn_graphs = {shape: pool.submit(gcn_host_graph, shape)
                      for shape in ("ogb_products", "minibatch_lg")}
        cfg = get("kgat").model_cfg
        ds = gen_kg_dataset(**DATASET)
        log(f"[data] CKG: {ds.n_nodes} nodes, {len(ds.src)} edges, "
            f"{ds.n_relations} relations, {len(ds.train_pos)} train / "
            f"{len(ds.test_pos)} test pairs "
            f"({time.perf_counter() - t0:.1f} s)")
        check(ds.n_nodes == cfg.n_nodes and ds.n_relations == cfg.n_relations
              and ds.n_users == cfg.n_users, "dataset does not fit the config")
        logs = build.result()
        zds, max_deg, zipf_s = zipf.result()
        gcn_host = {k: f.result() for k, f in gcn_graphs.items()}
    log(f"[data-gcn] " + "; ".join(
        f"{k}: {len(h['data'][0])} nodes, {len(h['data'][1])} edges, graph "
        f"{h['gen_s']:.1f} s, {'CSR' if 'csr' in h else 'layout'} "
        f"{h['index_s']:.1f} s" for k, h in gcn_host.items())
        + f" (beside the build; all data {time.perf_counter() - t0:.1f} s)")
    log(f"[data-zipf] zipf CKG (a 1.1) of the same size: {zds.n_nodes} "
        f"nodes, {len(zds.src)} edges, {zds.n_relations} relations, max "
        f"in-degree {max_deg}, {len(zds.train_pos)} train pairs "
        f"({zipf_s:.1f} s, beside the build)")
    check(zds.n_nodes == cfg.n_nodes and zds.n_relations == cfg.n_relations
          and zds.n_users == cfg.n_users, "zipf dataset does not fit the "
          "config")
    log(f"[build] nvcc {' '.join(backend.NVCC_FLAGS)} "
        f"({time.perf_counter() - t0:.1f} s incl. data)")
    for name, text in logs.items():
        log(f"  {name}: src/repro_torch/csrc/{name}.cu -> "
            f"{backend.lib_path(name).relative_to(root)} "
            f"({'compiled now' if text else 'already built'})")
        logs[name] = text = text or backend.build_log(name)
        for line in text.splitlines():
            if ("ptxas info" in line and ("Used" in line
                                          or "Compiling" in line)
                    or "spill" in line):
                log(f"  {name}: {line.strip()}")
    for name in ("quant_pack", "dequant_matmul", "dequant_unpack",
                 "segment_sum"):
        spills = [ln for ln in logs[name].splitlines() if "spill" in ln]
        check(bool(spills), f"{name}.cu: no ptxas spill report")
        check(all("0 bytes spill stores, 0 bytes spill loads" in ln
                  for ln in spills), f"{name}.cu: ptxas reports spills")

    t0 = time.perf_counter()
    g = ds.graph(DEV)
    m = g.layout.meta
    runs = [int((end - start).max()) for start, end in
            ((g.layout.row_start, g.layout.row_end),
             (g.layout.t_row_start, g.layout.t_row_end))]
    log(f"[data] layout: {m.n_blocks} blocks x {m.block_e} slots, "
        f"{m.n_tiles} tiles, longest run {runs[0]} slots by destination, "
        f"{runs[1]} by source; {len(g.rel_runs)} levels by relation "
        f"({time.perf_counter() - t0:.1f} s)")
    params = kgnn.init_params(cfg, seed=0, device=DEV)

    gen = torch.Generator(device=DEV).manual_seed(0)
    entries = [check_quant_pack(torch, qp, gen),
               check_spmm(torch, sp, g, params["entity"], gen),
               check_topk(torch, tk, gen),
               check_sddmm(torch, sp, g, gen),
               check_segment_sum(torch, sp, g, gen),
               check_dequant_sddmm(torch, sp, g, gen),
               check_dequant_matmul(torch, dq, gen),
               check_coarse(torch, tk, gen),
               check_dequant_unpack(torch, qp, gen)]
    sampled_shapes = check_sampled_kernels(torch, sp, dq, qp, zds, gen)
    shard_shapes = check_shard_kernels(torch, sp, dq, qp, ds, gen)
    for e in entries:
        if e["name"] in sampled_shapes:
            e["sampled_shape"] = sampled_shapes[e["name"]]
        if e["name"] in shard_shapes:
            e["shard_shape"] = shard_shapes[e["name"]]
    check_reduced_rollout(torch)

    counts, res = run_main_path(torch, cfg, ds, g, params)
    check_served_path(torch, cfg, ds, g, params, res)
    del res
    counts_t2, res = run_tier2_path(torch, cfg, ds, g, params)
    check_tier2_served(torch, ds, res)
    ratio = check_two_stage_accuracy(torch, ds, res["store"])
    check_rerank(torch, ds, res, ratio)
    profile_serving_batch(torch, ds, res["store"])
    del res
    runs = run_training(torch, cfg, ds, g)
    profile_step(torch, cfg, ds, g)
    check_reduced_kg(torch)
    runs_kg = run_training_kg(torch, ds, g)
    kg_cfgs = [model_config(m) for m in KG_MODELS]
    for kg_cfg in kg_cfgs:
        profile_step(torch, kg_cfg, ds, g, top=8)
    check_determinism(torch, [(cfg, "fp32"), (cfg, "int2")]
                      + [(c, "int2") for c in kg_cfgs], ds, g)
    for c in [cfg] + kg_cfgs:
        check_train_grads(torch, c, ds, g)
        torch.cuda.empty_cache()
    check_replay(torch, cfg, ds, g)
    check_launch(torch)
    dp_ref = dp_references(torch, cfg, ds, g)
    del g
    torch.cuda.empty_cache()
    runs_s = run_sampled(torch, zds, runs["int2"]["peak"])
    check_sampled_determinism(torch, zds)
    check_sampled_reduced(torch)
    torch.cuda.empty_cache()
    runs_dp = run_dp(torch, cfg, ds, dp_ref, runs)
    torch.cuda.empty_cache()
    runs_gcn, gcn_shapes = run_gcn(torch, gcn_host, gen)
    torch.cuda.empty_cache()
    recsys_shapes = {}
    runs_rs, counts_rs, _, _ = run_recsys(torch, gen, recsys_shapes)
    torch.cuda.empty_cache()
    lm_shapes = {}
    runs_lm = run_lm(torch, gen, lm_shapes)
    torch.cuda.empty_cache()
    run_tooling(torch, gen, ds, {
        "kgat": runs["int2"]["peak"],
        "xdeepfm": runs_rs["recsys_xdeepfm_int2"]["peak"],
        "stablelm-12b": runs_lm["lm_stablelm_int2"]["peak"]})
    # launches: the sum over the main-path runs (serving, then training
    # KGAT under each schedule and KGCN, KGIN, R-GCN under FP32 and INT2,
    # then the sampled, multi-rank and GCN runs), each counted from 0 just
    # before it
    for e in entries:
        by_path = {"serve": counts.get(e["name"], 0),
                   "serve_tier2": counts_t2.get(e["name"], 0)}
        by_path.update({f"train_{label}": r["counts"].get(e["name"], 0)
                        for label, r in runs.items()})
        by_path.update({f"train_{key}": r["counts"].get(e["name"], 0)
                        for key, r in runs_kg.items()})
        by_path.update({f"train_sampled_{key}": r["counts"].get(e["name"], 0)
                        for key, r in runs_s.items()})
        by_path.update({key: c.get(e["name"], 0) for key, c in runs_dp.items()
                        if not key.endswith("_per_step")})
        by_path.update({f"train_{key}": r["counts"].get(e["name"], 0)
                        for key, r in runs_gcn.items()})
        by_path.update({f"train_{key}": r["counts"].get(e["name"], 0)
                        for key, r in {**runs_rs, **runs_lm}.items()})
        by_path["serve_recsys_retrieval"] = counts_rs.get(e["name"], 0)
        e["launches_by_path"] = by_path
        e["launches_per_train_step"] = {
            label: r["per_step"].get(e["name"], 0)
            for label, r in {**runs, **runs_kg}.items()}
        e["launches_per_train_step"].update({
            f"train_sampled_{key}": r["per_step"].get(e["name"], 0)
            for key, r in runs_s.items()})
        e["launches_per_train_step"].update({
            key[:-len("_per_step")]: c.get(e["name"], 0)
            for key, c in runs_dp.items() if key.endswith("_per_step")})
        e["launches_per_train_step"].update({
            f"train_{key}": r["per_step"].get(e["name"], 0)
            for key, r in {**runs_gcn, **runs_rs, **runs_lm}.items()})
        if e["name"] in gcn_shapes:
            e["gcn_shape"] = gcn_shapes[e["name"]]
        if e["name"] in recsys_shapes:
            e["recsys_shape"] = recsys_shapes[e["name"]]
        if e["name"] in lm_shapes:
            e["lm_shape"] = lm_shapes[e["name"]]
        e["launches"] = sum(by_path.values())
        check(e["launches"] > 0, f"kernel {e['name']} never launched")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_by_path", "launches_per_train_step")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    optional = ("also_replaces", "other_shape", "sampled_shape",
                "shard_shape", "gcn_shape", "recsys_shape", "lm_shape",
                "sass_per_element",
                "library_call",
                "kernels_per_call", "device_ms", "library_device_ms",
                "device_ms_by_kernel", "spmm_route_device_ms",
                "longest_run", "chunk", "kernels_per_launch")
    print(json.dumps({"kernels": [
        {k: e[k] for k in keys + tuple(o for o in optional if o in e)}
        for e in entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
