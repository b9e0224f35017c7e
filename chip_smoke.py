"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --rounds-against DIR
    python3 chip_smoke.py --kernels-against DIR

The second times the FEEL rounds of DIR's tree (DIR/src, e.g. the parent
commit's ``git archive``) and of this one in turns and does nothing else
(``rounds_against``); the third builds DIR's ``bi_gemm`` and ``bi_reduce``
beside this tree's, holds them equal bit for bit (the sums, logsumexp
and argmax at every phase 3 shape, and logsumexp and argmax on the edge
rows) and times them and the library's call in turns at phase 3's timed
shapes (``kernels_against``); then DIR's ``flash_attention`` (K3): its
float32 route held bit for bit against this tree's at every float32 shape
of phase 3, every B the LM path launches and edge inputs (exps that
underflow, infinite logits, +-inf and NaN in V, misaligned operands), one
bf16 shape too, and both trees and SDPA timed in turns (``k3_against``);
then it builds DIR's ``moe_gemm`` (K5) too,
times both trees' and ``torch.bmm`` in turns at qwen2-moe-a2.7b's and
deepseek-v3-671b's decode products, on a decode step's dispatch and with
every expert occupied, and at qwen2-moe's prefill (``k5_against``), and
decodes both models at full width (DeepSeek cut to 4 layers) with each
tree's K5 in turns: tokens/s, the device's idle share and K5's device time
a step (``decode_steps_against``).
The first runs these phases; any failure raises and exits non-zero, and no
phase catches one:

 1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
 2. build every kernel of the port from its source with nvcc (one process
    a source, all at once), timed, with each kernel's registers and spills;
    the SASS of K2–K6 read back (``cuobjdump``): K3's bf16 kernels must
    issue HMMA (``mma.sync``) and its float32 instances (D, a row's
    threads, a block's warps) FFMA from LDS.128 fed by LDGSTS, no HMMA or
    HGMMA, at most one spill, K5's wgmma kernels HGMMA fed by UTMALDG (TMA
    tensor loads), K4's tensor-core kernels HMMA fed by LDGSTS
    (``cp.async``), K6's chunk-state and chunk-scan kernels HMMA, and K2's
    instances up to 64 rows no shared- or local-memory access (LDS, STS,
    LDL, STL: the sort stays in registers), each looked up by name, K2's
    with its registers and spills; ``bi_gemm``'s twenty instances (four
    tiles, five ways of staging a and b) cp.async (LDGSTS) and FFMA from
    128-bit shared loads, no HMMA or HGMMA, no spill (LDL, STL), and
    ``bi_reduce``'s long-row sum LDGSTS, its logsumexp and argmax tiles
    (three tile heights, 16- and 4-byte copies) LDGSTS, walked by LDS.128
    where the copies are 16 bytes;
 3. hold each kernel against its plain PyTorch version on the card — the
    main paths' shapes, ragged and misaligned shapes, bf16 and one
    bandwidth-sized case — with its time, the plain version's, one PyTorch
    library call's (a yardstick the port never calls) and its bound.
    ``weighted_aggregate`` (K1) within 1e-6·max|x|, ``robust_aggregate``
    (K2) bit for bit — and to the bit, zero signs included, against its
    algorithm in plain PyTorch — at its size-class boundaries, with NaN of
    either sign, +-inf, +-0, ties and garbage in the unread rows,
    ``flash_attention`` (K3) within 2e-5 (f32) / 2e-2
    (bf16) — every head dim at a ragged S and T, windowed and not, with
    grouped KV heads — and K3's gradient through its autograd Function
    equal to the plain version's within 1e-5, grouped KV heads too (and at
    starcoder2-15b's prefill shape, 48 query over 4 KV heads, and
    qwen2-moe-a2.7b's), at seamless-m4t-medium's prefill causal and
    bidirectional, and with S > T unmasked (the cross-attention of a target
    longer than its source); ``decode_attention`` (K4) within
    2e-5 / 2e-2 at tests/test_kernels.py's shapes, at every group size of
    the zoo (G 1, 5, 7, 8, 12) and head dim (16–128) at a ragged length, at
    starcoder2-15b's GQA, qwen2-moe-a2.7b's and seamless-m4t-medium's
    serving shapes (its cross-attention over 2,048 frames), on a
    window's view and a ring's prefix;
    ``ssd_scan`` (K6) within 5e-4 (the final state; y too in float32,
    2e-2 in bf16) at tests/test_kernels.py's shapes, at mamba2-370m's
    prefill shape with and without an initial state, at Jamba's grouping
    (8 B/C groups over 64 heads), at chunks of 64 and 128, and at a bf16
    shape the tensor-core route does not take (N 8);
    ``moe_gemm`` (K5) within 1e-4 (f32) / 2e-1 (bf16) at
    tests/test_kernels.py's shapes, ragged shapes, either side of its
    launcher's C threshold (the wgmma route from C = 128),
    qwen2-moe-a2.7b's prefill and decode shapes and deepseek-v3-671b's
    (256 experts, d 7,168, f 2,048, C 640 at prefill), with the largest
    difference in bf16 ulps; both decodes again on the x that one MoE
    layer's dispatch of a decode step's 8 tokens gives K5 at full width
    (``moe_decode_checks``): the empty experts' rows bit-equal to the plain
    version's and +0, the rest within 2e-1, the rolled-experts control
    rejected, the occupied experts counted and timed against their bytes
    bound and every expert's, and P31 (an empty expert with an inf weight:
    the kernel +0, the plain version NaN); the task plane's
    batch-invariant kernels at
    the §V MLP's and ``lm_tiny``'s training and evaluation shapes:
    ``bi_gemm`` within 1e-5·max|c| of ``torch.matmul``, its matrix 0
    equal bit for bit to a batch of 1's, the product equal bit for bit with
    a or b stored transposed, with a misaligned and with zeros appended to
    K, and at the ragged and training shapes to its order in plain PyTorch
    (``bi_gemm_chain_ref``: the FFMA chain, each step rounded once);
    ``bi_reduce`` (sums, logsumexp) within 1e-5 of torch's, argmax exact,
    row 0 equal to one row's call and every row to a misaligned x's, a
    sum unchanged by appended zeros and equal bit for bit to
    ``bi_reduce_chain_ref``, a logsumexp to ``bi_logsumexp_chain_ref``
    (at lm_tiny's attention backward too: 24,576 rows of 32 scores, the
    causal band at -1e30); logsumexp and argmax on edge rows (NaN, +-inf,
    -1e30, ties, +-0) at M = 1 to 500, aligned and misaligned: the
    logsumexp equal to its twin, and to torch's +-inf where the row's
    maximum is infinite, the argmax equal to ``torch.argmax``; the NLL
    and attention backwards on rows whose maximum is +-inf, NaN where
    the CPU's are NaN, and attention's every finite element bit-equal to
    its formula before the P30 repair (``vjp_before_p30``);
 4. the undefended main path at the paper's §V scale: K = 50 UEs,
    50,000/10,000 synthetic MNIST, 5 label flippers, DQS on the host
    control plane, the vectorized engine, 3 rounds on the GPU. Every
    kernel's launch count is set to 0 just before and read just after
    (K1 once a round; the task plane's ``bi_gemm`` and ``bi_reduce`` at
    least once: every product and sum of its training and evaluation;
    ``bi_reduce`` by mode, each of sum, logsumexp and argmax at least
    once, as on the LM path's);
    then one round split into its phases and one under ``torch.profiler``
    say where the time goes, and one more the host ms of the task plane's
    batch-invariant route by entry point, Function and kernel wrapper
    (``route_host_split``), and the host µs of one routed call layer by
    layer, beside torch's own op (``bi_host_cost``); the zoo's phases 12
    to 17 then launch neither ``bi_gemm`` nor ``bi_reduce`` (counted from
    0 across them);
 5. the defended path at the same scale through ``run_experiment``:
    (a) ``sign_flip`` under ``trimmed_mean+validation`` and (b)
    ``noise_0.8`` under ``median``, 3 rounds each, K2 launched once a round
    and K1 never; one round of (a) split into its phases and one profiled;
 6. K1's defended routes (``norm_clip``, ``krum``, ``validation``) at
    K = 10, 2 rounds each, K1 launched once a round; and the loop engine
    under ``trimmed_mean`` and ``median``, K2 launched once a round;
 7. small runs on the GPU and on the CPU, undefended and under
    ``trimmed_mean+validation``: the same selections and defense counts,
    accuracies within 1e-2;
 8. the LM path: federated fine-tuning of ``lm_tiny`` through
    ``run_experiment(task="lm_tiny")`` in the regime of
    ``examples/federated_llm.py`` (K = 20, 6 malicious, the
    vocabulary-collapse attack, 2,000/400 windows, DQS, 3 rounds; every
    attention forward through K3, FedAvg of the 82,240-parameter updates
    through K1 once a round), then ``policy="random"`` beside it; one round
    split into phases, one profiled, one with the route's host ms split
    (``route_host_split``); K3 again at the shape the run
    launched it at most; and a K = 8 run on the GPU and the CPU: the same
    selections, loss and accuracy within 1e-3;
 9. the batched control plane and the multi-run sweep: ``schedule_runs``
    and ``finalize_runs`` (penalties on every other run) in the "device"
    layout on the card against the "hybrid" layout on the host at R = 12
    and 64 runs, K = 50, every policy, and a round where no UE is
    feasible — integers exact, floats within 4 ulp — with the median ms a
    call of each, the card's own sort against numpy's on NaN keys and
    signed zeros (``card_sort_order``), and two rounds with NaN priority
    keys (NaN reputations of both signs and payloads), "device" equal to
    "hybrid" bit for bit;
    then ``run_sweep`` on the card: the paper's Fig. 3
    setting (``examples/poisoning_study.py``: dqs, random, best_channel
    and max_count x seeds 0-2 under the (6, 2) label flip, K = 50,
    50,000/10,000, the 5 MB update, 3 rounds), K1 launched 12 times a
    round, each round timed and the last profiled, its four seed-0 runs
    held against their sequential ``run_experiment`` (host control):
    the same selections, accuracies and losses bit for bit; a defended
    sweep
    (``sign_flip`` under none, ``trimmed_mean+validation`` and
    ``median``, dqs and random x seeds 0-1, 12,000/2,000, 2 rounds) with
    K1 4 and K2 8 times a round and two runs held the same way; an
    ``lm_tiny`` sweep (K = 8, ``token_flip_1to5``, dqs and random, 2
    rounds) launching K3 every round, its two seed-0 runs held the same
    way; and a K = 10 sweep on the GPU and
    the CPU: the same selections, accuracies within 1e-4;
10. the population plane and the async plane: (a) the top-M prefilter at
    the reference bench's grid (benchmarks/bench_round.py's population
    instance: R = 5 runs cycling the five policies, K = 64, N = 10^4, 10^5
    and 10^6, 2 rounds each after a warm-up; first the budget walk
    ``pack_scan`` against the N-step walk it replaced, in turns, at
    K = 50 and at N = 10^4), the "device" layout on the
    card held against the exact "device" schedule (every output bit for
    bit) and against both layouts on the host (integers exact, floats
    within 4 ulp, the same escalations), with the ms a round of each path,
    M, the escalations, the budget walk's steps, the state's bytes and the
    peak device memory, one more call of each "device" path at N = 10^6
    under the profiler (the device traced alone: busy, copies, idle), one
    round at N = 10^4 with NaN priority keys filling a run's kept prefix
    (the prefilter equal to the exact schedule, "device" to "hybrid"),
    then one round at N = 10^6 forced to escalate (M = min_selected); (b) ``run_experiment(population=500)`` at the §V
    scale (K = 50, 50,000/10,000, the (6, 2) label flip, DQS, 3 rounds, K1
    once a round) with the selections of its ``control="host"`` run,
    ``population=50`` equal to ``population=None`` on every curve, and a
    ``run_sweep`` of dqs, random, best_channel and max_count at seed 0 over
    500 candidates (K1 4 times a round), each run held against its
    sequential run; (c) the async plane at the §V scale: zero-latency wave
    runs equal to the sync runs on acc, loss, rep_gap, objective and
    malicious_selected under both control planes (K1 once an
    aggregation), the CLI's documented run (``launch.serve.main``: 8
    aggregations, buffer 4, ``stale_rider_2`` under ``validation``, K1 8
    times) with its simulated clock, triggers, mean ages and wall ms an
    aggregation, a deadline run whose deadline trigger fires, a
    ``trimmed_mean`` run (K2 once an aggregation, K1 never), a zero-latency
    ``lm_tiny`` run (K = 8, ``token_flip_1to5``, K3 every aggregation)
    equal to its sync twin, and a K = 10 async run on the GPU and the CPU:
    the same selections, triggers, ages and simulated clock, accuracies
    within 1e-2;
11. the observability plane (``repro_torch.obs``), each traced run beside
    its untraced twin: two §V main paths (``quickstart``, 2 rounds under
    the profiler, one untraced and one traced) with equal selections,
    bit-equal params, K1 launched twice in each and the same host waits,
    then 4 more rounds of each in turns for their walls, with the host
    cost of one span; the traced rounds' phase summary and the schedule
    and train phases on the H100's roofline (``obs.report``); defended run
    (a) traced (3 ``defense.aggregate``, ``defense.detect`` and
    ``eval.validation`` spans, K2 3 times, the untraced run's
    selections); and the serve CLI's documented run with ``--trace``: the
    untraced run's result, the simulated clock on every span of the event
    loop, well-formed nesting, ``python -m repro_torch.obs.report`` exit 0;
12. serving the decoder-only zoo: ``starcoder2-15b`` (all 40 layers, bf16,
    22 B parameters drawn on the card) and ``mamba2-370m`` (48 layers)
    each take 8 prompts of 2,048 tokens through ``api.prefill`` and 32
    greedy ``api.decode_step`` calls, every launch count set to 0 just before
    and read just after (K3 40 times at prefill and K4 40 times a step;
    K6 48 times at prefill), with prefill and per-token times, peak
    memory, and one uncounted prefill and one decode step profiled; check
    1 runs the same steps with K4's (K6's) plain version (logits within
    0.06·max|plain|, greedy tokens equal but for near ties of 8 bf16
    ulps) and must reject a negative control, a deliberately wrong plain
    version (K4 with the wrong GQA grouping, K6 without the inter-chunk
    term); check 2 runs each at full width, 2 layers, float32, prefill
    plus decode against ``lm_forward`` within 1e-3·max|logit| + 1e-3;
    then reduced configs on
    the GPU and the CPU (starcoder2's ring cache, qwen2.5 and mamba2
    greedy generation): the same tokens, logits within 1e-4;
13. serving the mixture-of-experts zoo: ``qwen2-moe-a2.7b`` (all 24
    layers, bf16, 14.3 B parameters drawn on the card) with the same
    traffic, every launch count set to 0 just before and read just after
    (K3 24 times at prefill, K4 24 times a step, K5 72 times at prefill
    and 72 times a step), the share of routes dropped at prefill, one
    decode step profiled; check 1 holds every MoE layer of the prefill
    and the decode steps, on its own input, against the same layer with
    K5's plain version (within ``MOE_LAYER_TOL``·max|plain|) and must
    reject a negative control (K5's plain version with the experts rolled
    by one) at every layer; the whole run with K5's plain version is
    reported beside it (logit gap, the (layer, token) expert sets that
    differ), not held to a tolerance; check 2
    at full width, 2 layers, float32, capacity factor 15 (E/top_k: every
    route kept, ``consistency_phase``); then the
    reduced qwen2-moe (also ``optimized``: group-local dispatch),
    moonshot and Jamba on the GPU and the CPU — the same tokens, logits
    within 1e-4, the Jamba run launching K3, K4, K5 and K6;
14. serving the rest of the zoo with the same traffic, every launch count
    set to 0 just before and read just after each path:
    ``deepseek-v3-671b`` at full width (d 7,168, 128 MLA heads, 256
    experts top-8 + 1 shared, vocab 129,280, the MTP head initialised),
    its depth cut from 61 to 4 (the 3 leading dense layers and 1 MoE
    layer, 15.8 B parameters, bf16): MLA in plain PyTorch as in the
    reference, K5 3 times a prefill and 3 a step; check 1 layer by layer
    as for qwen2-moe, check 2 at 1 dense + 1 MoE layer in float32
    (14.6 B parameters) at capacity factor 32 (E/top_k: at 8.0 its full
    forward over 64 tokens drops routes that decode keeps); then
    ``seamless-m4t-medium``, all 12 encoder and 12 decoder layers (bf16,
    0.98 B parameters) after 8 x 2,048 source frames from a seed: K3 36
    times a prefill (12 encoder bidirectional, 12 decoder causal, 12
    cross), K4 24 times a step (12 self, 12 cross over the 2,048 frames);
    check 1 with K3's and K4's plain versions (within 0.06·max|plain|)
    and its negative control (K3's plain version causal everywhere),
    check 2 at all 24 layers in float32 against ``encdec_forward``; then
    both reduced on the GPU and the CPU (the same tokens, logits within
    1e-4);
16. training the zoo (after 14, before the summary): (a) gradients
    through the kernels' autograd Functions on the card against their
    plain versions' autograd, within 1e-2·max|plain| in bf16 (a bf16 ulp
    is 2^-8 to 2^-7 of a value) and 1e-3 in float32: K5 (dx and dw, two
    more K5 launches) at ``qwen2-moe-a2.7b``'s training products — gate/up
    (60, 688, 2,048, 1,408) and down (60, 688, 1,408, 2,048), C 688 for 2
    x 4,096 tokens — at a ragged capacity and in float32, with their
    backward launches timed beside ``torch.bmm``; a deliberately wrong K5
    backward (dw laid out transposed) must fail the check; K6 at
    ``mamba2-370m``'s training shape (2, 4,096, 32, 64, N 128, G 1, Q 256)
    against autograd through the sequential recurrence, all five input
    gradients; K3 at (2, 16, 4,096, 128) causal bf16; (b)
    ``qwen2-moe-a2.7b`` at full width cut from 24 to 4 layers (2.9 B
    parameters, bf16, AdamW, remat) and (c) ``mamba2-370m`` uncut, each 5
    steps through ``launch/steps.make_train_step`` on
    ``data/tokens.batches`` at train_4k's sequence of 4,096 and batch 2,
    every launch count set to 0 just before each step and read just after
    (qwen2-moe: K3 4 forward + 4 recompute, K5 12 + 12 + 24 backward;
    mamba2: K6 48 + 48), step ms, tokens/s, peak memory and each step's
    loss (finite, the last below the first), then one more step under the
    profiler split by phase at ``TrainProbe``'s markers (each device
    event placed by its launch's host call, through the correlation id,
    after the last marker's ``record_function`` range; a step that cannot
    be split is profiled again, at most twice, then fails the phase):
    K3/K5/K6 forward and recompute, K5's backward, the plain VJPs of K3
    and K6, the optimizer, idle; (e) a remat step against a no-remat step
    of qwen2-moe at full width and 1 layer (the same routes, the same
    loss, grad norms within 1e-3) and one step of each of the ten reduced
    archs in float32, remat on and off, on the GPU and the CPU (loss and
    grad norm within 1e-4 relative); (f) the training CLI
    (``launch/train.py --arch qwen2-moe-a2.7b --smoke --steps 4 --batch 2
    --ckpt DIR --ckpt-every 2``) through its ``main``, then again from its
    step-2 checkpoint: the restored state bit-equal to the saved one, the
    resumed losses and parameters within 1e-4 of the uninterrupted run's;
17. the step-cost plane (after 16, before the summary): (a) the full dry
    run, ``python -m repro_torch.launch.dryrun --all`` (every arch x
    shape traced on ``meta`` tensors, 40 records: no error, skipped
    exactly where ``api.supports_shape`` refuses, each record's FLOPs,
    bytes, peak, roofline terms, dominant term and useful-FLOP share
    printed), and (d) the hillclimb over ``mamba2-370m`` ``train_4k``
    (baseline, chunk128, ssd_bf16, remat_off, bf16_opt, baseline: the last
    baseline equal to the first), both started right after phase 2 in
    subprocesses that see no device and collected here; (b) the dry run
    against the card: ``qwen2-moe-a2.7b`` at 4 layers and ``mamba2-370m``,
    one train step each at 2 x 4,096 tokens (AdamW, remat), and
    ``starcoder2-15b``'s prefill of 8 x 2,048, each traced on ``meta`` and
    then run once on the card under the same counter — FLOPs equal
    operator by operator, bytes within 1% (the operators that differ
    named), ``max_memory_allocated`` over the step within 15% of the
    traced peak — and timed, no faster than its roofline floor; (c) K6's
    bf16-compute route (``ssm.compute_dtype="bfloat16"``: every operand of
    an mma one bf16) against its plain version (the bf16 chunked form) at
    mamba2's prefill and training shapes within 2e-2·max|plain|, timed
    beside the hi/lo route in turns with its bound, its kernels' HMMA, its
    gradient within 1e-2·max|plain|, and mamba2's prefill at bf16 compute
    against float32 compute (logits within 0.06·max|logit|, both timed, K6
    48 times); K3's backward at (2, 16, 4,096, 128) beside SDPA's forward
    and backward with its bound; one K4 call's host time before the op
    layer, through it and through a ``torch.library.custom_op``; the dry
    run's serving trace of ``moonshot-v1-16b-a3b`` at full width (its
    peak beside the card's memory);
18. the contract checker (after 17, before the summary): (a) ``python -m
    repro_torch.check --strict --device cuda --json`` in a subprocess —
    every checker of the port, its trace pass on the card — exit 0 and
    ``contracts: clean``, the report under ``chiprun_out/``; (b) the trace
    entries in process on the card, every launch count set to 0 just
    before and read just after (K1 twice: ``fedavg_stacked`` and its own
    entry; K2 twice: trimmed mean and median), each entry's operators
    emitted, ``repro_torch.weighted_aggregate`` and
    ``repro_torch.robust_aggregate`` among them, no float64 on the data
    plane, float64 outputs from the control entries, and the negative
    control (``ModelAttack.apply_stacked`` given one ``.double()`` leaf)
    reported; (c) K1-K6's public wrappers once each under
    ``torch.cuda.set_sync_debug_mode("error")`` at phase 3's main-path
    shapes (K1 at the §V MLP's M, K2 at run (a)'s rows, K3 at lm_tiny's
    f32 and starcoder2-15b's bf16 prefill, K4 at starcoder2-15b's decode,
    K5 at qwen2-moe-a2.7b's decode, K6 at mamba2-370m's prefill), then
    one forward and backward each of K3 (lm_tiny f32: the plain VJP), K5
    (qwen2-moe-a2.7b's decode gate/up: two more K5 launches) and K6
    (mamba2-370m's heads over 512 positions: the chunked VJP), then one
    routed masked SGD step of the §V MLP (50 clients) and one of lm_tiny
    (24 clients) on the task plane's route (every product and sum
    ``bi_gemm`` or ``bi_reduce``, forward and backward), counted (K1, K2,
    K4 once, K3 3 times and once an lm_tiny layer, K5 4, K6 2; ``bi_gemm``
    and ``bi_reduce`` as often as the same steps unarmed): none
    synchronises with the host, while ``.item()`` under the same mode
    raises;
19. the sharded plane (after 18, before the summary): an NCCL process
    group of one rank in process (a ``HashStore``, no network; its
    default backend ``cpu:gloo,cuda:nccl``, so that CUDA tensors go to
    NCCL and the CPU twin of the step below to gloo, NCCL checked as the
    card's backend), ``launch.mesh.make_host_mesh()`` as a ("data",
    "model") (1, 1) ``DeviceMesh`` on the card, destroyed at the end;
    ``federated.distributed.make_cohort_step`` at the paper's §V scale:
    K = 50 clients on the rank, 256 synthetic MNIST samples each, the
    weights the quickstart clients' D_k, the mask the DQS selection x_k
    of phase 4's first round, lr 0.1, 5 local steps, float32; every
    launch count set to 0 just before one step and read just after (K1
    once); checks: (1) within 2e-5 abs/rel of each client's local SGD
    one at a time through ``torch.autograd.grad``, then
    ``weighted_aggregate_ref`` over the masked weights divided by
    max(sum w·s, 1e-9), (2) an unselected client's batch replaced by
    finite garbage leaves the output bit-equal, (3) within 1e-4 of the
    same step on the CPU, (4) ``agg_dtype=torch.bfloat16`` within
    1e-2·max|out| of float32, (5) K1 once a step call, (6) no raise under
    ``torch.cuda.set_sync_debug_mode("error")``, (7) ``count_step`` of the
    step on the card reads the FLOPs, bytes and collective bytes of the
    meta trace of the same step, (8) the check-1 oracle without the mask
    (a wrong plain version) is rejected; then the step's median ms over
    15 calls, K1 at (50, 50,890) float32 beside its bound and cuBLAS's
    GEMV, and the ``all_reduce``'s device time, the card's name and power
    limit beside each;
20. the sharded zoo (after 19, on its group, before the summary): (a)
    ``launch/train.py``'s ``main`` in process, 3 steps at 2 x 4,096
    tokens (AdamW, remat) of ``qwen2-moe-a2.7b`` at full width cut to 4
    layers and of ``mamba2-370m``, first on one device and then with
    ``--host-mesh`` (the (1, 1) mesh over phase 19's group, the params and
    optimizer state ``DTensor``s placed by the reference's rules) from the
    same seed and batches: the losses bit-equal (else within 1e-3
    relative), each step's launches the plain step's (K3 8 and K5 48; K6
    96), the median ms of steps 2 and 3 beside the plain step's (DTensor's
    host cost); (b) one prefill of 8 x 2,048 tokens and 8 decode steps of
    ``qwen2-moe-a2.7b`` at 4 layers, plain and with the params and caches
    ``DTensor``s under the reference's activation specs (K3, K4 and K5
    through their DTensor rules): every logit bit-equal, the same
    launches; (c) the dry run on the production meshes, ``--mesh both``,
    for ``qwen2-moe-a2.7b`` ``train_4k``, ``mamba2-370m`` ``train_4k``,
    ``starcoder2-15b`` ``prefill_32k`` and ``qwen2-moe-a2.7b``
    ``decode_32k`` (subprocesses started after phase 2): each record a
    ``dryrun_sharded`` line, ``ok``, with collectives, FLOPs a chip times
    the chips at least the one-device trace's (phase 17's), a chip's peak
    below the one-device peak, and 2x16x16's FLOPs a chip at most 16x16's;
21. the last slice (after 20, before the summary): (a) on phase 19's
    group, ``core.population.population_mesh()`` (a ("data", "model")
    (1, 1) ``DeviceMesh`` on the card) and
    ``prefilter_schedule_runs(..., mesh=)`` at phase 10's grid (R = 5
    cycling the five policies, K = 64, N = 10^4, 10^5 and 10^6, a warm-up
    and 2 rounds), in turns with the mesh-less "device" prefilter: every
    output bit for bit against it, the selections, costs and ``forced``
    equal to the exact "device" schedule, ms a round of each path, the
    collectives' bytes (``launch.dryrun.count_step``), then one round at
    N = 10^6 forced to escalate (M = ``min_selected``); no K1-K6 launch;
    (b) the example drivers' torch twins on the card, every launch count
    set to 0 just before each and read just after, in a temporary working
    directory: ``examples/quickstart_torch.py``'s ``main`` whole (12,000 /
    2,000 samples, 6 rounds, K1 once a round, the accuracy higher at round
    5 than at round 0, the first 2 rounds' selections those of the same
    driver on the CPU), then through their functions at seed 0 and 2
    rounds: ``poisoning_study_torch.curve`` (DQS, the constrained 5 MB
    regime, omega (0.5, 0.5): K1), ``robustness_extensions_torch.matrix``
    (the 9 scenarios x 2 defenses x 2 policies: K1 and K2) and
    ``federated_llm_torch``'s three legs (``dqs_vs_random([0], 2)``,
    ``loop_parity(2)``: the loop engine's loss, accuracy and selections
    those of the vectorized engine bit for bit, as on the CPU,
    ``flash_leg(1)``: K3 and K1), each timed beside the card's name and
    power limit; before the LM legs, a float32 product alone and as
    matrix 0 of a ``bmm`` / ``bi_gemm`` of 1, 2, 8 and 50 at
    ``lm_tiny``'s and the §V MLP's shapes (cuBLAS parts them, ``bi_gemm``
    must not) and ``invariance_probe``: one masked SGD step of the §V
    MLP and of ``lm_tiny`` for a stack of 1, 8 and 50 under a
    ``TorchDispatchMode``, the first operator whose client-0 slice
    differs, with the task plane's batch-invariant route off (printed)
    and on (none may; the loop oracle's step equal to the stack's);
22. the model init (after 21, before the summary): the reference's
    threefry draw (``repro_torch.random``) on the card against the same
    draw on the CPU — keys, splits and bits (past the flat index 2^32
    too) equal, uniforms and a (1,024, 1,024) truncated normal within 2
    ulp, the count of elements not bit-equal printed — for three seeds;
    the MLP's, ``lm_tiny``'s and reduced ``deepseek-v3-671b``'s initial
    params (bf16 and float32) likewise; the card's init seconds for the
    MLP, ``lm_tiny`` and ``starcoder2-15b`` at full width (phase 12's)
    beside the ``torch.Generator`` draw they replace; then
    ``federated_llm_torch.py --fast``'s leg 1 (seeds 0 and 1, 6 rounds)
    from the new init at init-seed offset 0
    (``examples/federated_llm_init_spread_torch.py``'s ``margin``; offset
    0 is the leg), its margin printed with whether it passes the
    driver's assertion, K3 and K1 counted;
15. one JSON line of per-kernel numbers (K6's bf16-compute route a row
    of its own), then the result line.

Exits non-zero without printing a result where CUDA is absent. A kernel's
time is its device time from ``torch.profiler`` over back-to-back calls
(warm L2, as the main path leaves the freshly stacked updates in L2),
reported beside the CUDA-event time per call, which includes the host's
launch overhead.
"""
import atexit
import bisect
import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import math
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.configs.base import (FeelConfig, InputShape,  # noqa: E402
                                      SHAPES, TrainConfig)
from repro_torch.core import attacks as atk  # noqa: E402
from repro_torch.core import control as ctl  # noqa: E402
from repro_torch.core import population as tpop  # noqa: E402
from repro_torch.core import scheduler as tsc  # noqa: E402
from repro_torch.core.poisoning import (EASY_PAIR, LabelFlipAttack,  # noqa: E402
                                        pick_malicious)
from repro_torch.data.partition import partition  # noqa: E402
from repro_torch.data.synthetic_mnist import generate  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.defenses import TrimmedMean  # noqa: E402
from repro_torch.core.scheduler import POLICY_IDS  # noqa: E402
from repro_torch.core.wireless import WirelessModel, cost_bisect  # noqa: E402
from repro_torch.data.tokens import batches, make_stream  # noqa: E402
from repro_torch.federated import simulation  # noqa: E402
from repro_torch.federated.aggregation import (  # noqa: E402
    flatten_stacked, unflatten)
from repro_torch.federated.async_engine import AsyncFeelEngine  # noqa: E402
from repro_torch.federated.distributed import (  # noqa: E402
    cohort_input_specs, make_cohort_step)
from repro_torch.federated.cohort import pad_count  # noqa: E402
from repro_torch.federated.server import FeelServer  # noqa: E402
from repro_torch.federated.task import LM_TINY  # noqa: E402
from repro_torch.kernels import bi_gemm as kbg  # noqa: E402
from repro_torch.kernels import bi_reduce as kbr  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as k4  # noqa: E402
from repro_torch.kernels import flash_attention as k3  # noqa: E402
from repro_torch.kernels import moe_gemm as k5  # noqa: E402
from repro_torch.kernels import ssd_scan as k6  # noqa: E402
from repro_torch.kernels.robust_aggregate import (  # noqa: E402
    SIZE_CLASSES, robust_aggregate, robust_aggregate_network,
    robust_aggregate_ref)
from repro_torch.kernels.robust_aggregate import \
    cost as robust_aggregate_cost  # noqa: E402
from repro_torch.kernels.weighted_aggregate import (  # noqa: E402
    weighted_aggregate, weighted_aggregate_ref)
from repro_torch.kernels.weighted_aggregate import \
    cost as weighted_aggregate_cost  # noqa: E402
from repro_torch.launch import dryrun, serve, steps  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import (ADAFACTOR_ARCHS, HBM_BW,  # noqa: E402
                                     PEAK_FLOPS_BF16, PEAK_FLOPS_F32,
                                     make_host_mesh)
from repro_torch.models import api  # noqa: E402
from repro_torch.models import batch_invariant as bi  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.random import PRNGKey  # noqa: E402
from repro_torch.sharding import dtensor  # noqa: E402
from repro_torch.sharding.ctx import activation_specs  # noqa: E402

# the H100 SXM5's data-sheet peaks: device memory, float32 outside the
# tensor cores, bf16 on the tensor cores (dense)
HBM_BYTES_PER_S = HBM_BW
F32_FLOPS = PEAK_FLOPS_F32
BF16_FLOPS = PEAK_FLOPS_BF16
# one 32-bit instruction (a comparison, an add) a lane a clock: half the
# float32 FLOP rate, which counts an FMA as two
INSTR_PER_S = F32_FLOPS / 2
M_MLP = 784 * 64 + 64 + 64 * 10 + 10   # flattened MLP update, 50,890
KERNELS = {
    "weighted_aggregate": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/weighted_aggregate.cu",
        "replaces": "src/repro/kernels/weighted_aggregate.py:21"},
    "robust_aggregate": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/robust_aggregate.cu",
        "replaces": "src/repro/kernels/robust_aggregate.py:31"},
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26"},
    "decode_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:22"},
    "moe_gemm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm.py:18"},
    "ssd_scan": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:26"},
    # the port's own kernels, no TPU kernel's port: what they stand in for
    # is XLA's product and reductions of the reference's task plane
    "bi_gemm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bi_gemm.cu",
        "replaces": "src/repro/models/mlp.py:26 (an XLA product; no TPU "
                    "kernel)"},
    "bi_reduce": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bi_reduce.cu",
        "replaces": "src/repro/models/common.py:91 (an XLA reduction; no "
                    "TPU kernel)"}}
# the kernels line's rows: each kernel, and K6's bf16-compute route (the
# same source and counter, its own row)
BF16_ROUTE = "ssd_scan_bf16_compute"
ROUTES = {**KERNELS, BF16_ROUTE: KERNELS["ssd_scan"]}
LAUNCH_COUNTERS = {"weighted_aggregate": weighted_aggregate,
                   "robust_aggregate": robust_aggregate,
                   "flash_attention": k3.flash_attention,
                   "decode_attention": k4.decode_attention,
                   "moe_gemm": k5.moe_gemm,
                   "ssd_scan": k6.ssd_scan}
# the task plane's batch-invariant kernels, counted apart: ``only`` holds
# K1–K6's counts as before, and these are read where the task plane runs
# (and must read 0 where it does not)
BI_COUNTERS = {"bi_gemm": kbg.bi_gemm, "bi_reduce": kbr.bi_reduce}
# examples/federated_llm.py's regime: the uplink of lm_tiny's 82,240 f32
# parameters over a 100 kHz cell binds the knapsack at K = 20
LM_CFG = dict(n_ues=20, n_malicious=6, deadline_s=60.0,
              model_size_bits=LM_TINY.param_count() * 32.0,
              bandwidth_hz=1e5)
# its vocabulary-collapse attack: malicious streams collapse to token 0
COLLAPSE = atk.AttackScenario(
    "token_collapse_all",
    data=atk.TokenFlip(tuple((s, 0) for s in range(1, 64))), watch=(1, 0))


def emit(**kw):
    print(json.dumps(kw), flush=True)


_BUILTIN = {"f": "float", "d": "double", "i": "int", "b": "bool"}


def _source_name(fn, i):
    """The <source-name> of a mangled name at ``i`` (its length in digits,
    then that many characters), and the index after it."""
    j = i
    while fn[j].isdigit():
        j += 1
    return fn[j:j + int(fn[i:j])], j + int(fn[i:j])


def _short(fn):
    """A kernel's name and template arguments from its mangled name
    (Itanium ABI, as nvcc, ptxas and cuobjdump print it): the last
    component of its nested name, e.g. ``flash_bf16_kernel<128>`` from
    ``_ZN12_GLOBAL__N_117flash_bf16_kernelILi128EEEvPK...``."""
    if not fn.startswith("_Z"):
        return fn
    nested = fn[2] == "N"
    i, name = 3 if nested else 2, None
    while fn[i].isdigit():
        name, i = _source_name(fn, i)
        if not nested:
            break
    args = []
    if fn[i] == "I":
        i += 1
        while fn[i] != "E":
            if fn[i] == "L":                # a literal: L <type> <value> E
                end = fn.index("E", i)
                args.append(fn[i + 2:end].replace("n", "-", 1)
                            if fn[i + 2] == "n" else fn[i + 2:end])
                i = end + 1
            elif fn[i].isdigit():
                arg, i = _source_name(fn, i)
                args.append(arg)
            else:
                args.append(_BUILTIN.get(fn[i], fn[i]))
                i += 1
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_summary(log):
    """{kernel: "R registers, S bytes spilled"} from nvcc's -Xptxas=-v."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = _short(line.split("'")[1])
        elif fn and "spill stores" in line:
            spill = line.split(",")[1].split()[0]
        elif fn and "Used" in line and "registers" in line:
            out[fn] = f"{line.split('Used')[1].split()[0]} registers, " \
                      f"{spill} bytes spilled"
            fn = None
    return out


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "LDSM", "LDGSTS", "LDS", "LDS.128",
            "STS", "LDL", "STL", "FFMA")


def sass_ops(name):
    """{kernel: {SASS op: count}} of the built library ``name``, from
    ``cuobjdump -sass``: HGMMA is wgmma, UTMALDG a TMA tensor load, HMMA
    mma.sync, LDSM ldmatrix, LDGSTS cp.async, LDS/STS a shared-memory and
    LDL/STL a local-memory (spill) load and store, FFMA a float32 fused
    multiply-add on the CUDA cores; a predicated instruction counts as its
    op, and a 128-bit shared load as LDS.128 too."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = _short(line.split("Function :")[1].strip())
            out[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn:
            op = line.split("*/", 1)[-1].split()
            if op and op[0].startswith("@"):
                op = op[1:]
            if op and op[0].split(".")[0] in out[fn]:
                out[fn][op[0].split(".")[0]] += 1
                if op[0].split(".")[0] == "LDS" and ".128" in op[0]:
                    out[fn]["LDS.128"] += 1
    return out


# bi_gemm's instances: each tile configuration (BM, BN, TM, TN, slice
# depth, stages, blocks an SM) at each way of staging a and b (kK, kW,
# kAny: 0, 1, 2)
BI_GEMM_TILES = ("64,64,8,4,32,4,3", "64,64,4,4,16,6,2", "32,64,4,4,32,4,4",
                 "32,32,4,4,32,4,4")
BI_GEMM_STAGINGS = ("0,0", "0,1", "1,0", "1,1", "2,2")


def check_bi_sass(gemm, reduce):
    """bi_gemm's instances, each looked up by name: fed by cp.async
    (LDGSTS), multiplying with FFMA from 128-bit shared loads (the kAny
    staging aside, whose copies are 4-byte), no tensor-core instruction
    (HMMA, HGMMA), no spill (LDL, STL); the long-row sum's copies LDGSTS;
    logsumexp's and argmax's tiles too, and read by LDS.128 where the
    copies are 16 bytes; no bi_reduce kernel spills or issues a
    tensor-core instruction."""
    for tile in BI_GEMM_TILES:
        for staging in BI_GEMM_STAGINGS:
            name = f"bi_gemm_kernel<{tile},{staging}>"
            ops = gemm[name]
            assert ops["LDGSTS"] > 0 and ops["FFMA"] > 0, (name, ops)
            assert ops["LDS.128"] > 0, (name, ops)
            assert not any(ops[op] for op in ("HMMA", "HGMMA", "LDL",
                                              "STL")), (name, ops)
    assert len(gemm) == len(BI_GEMM_TILES) * len(BI_GEMM_STAGINGS), gemm
    ops = reduce["sum_long_rows_kernel"]
    assert ops["LDGSTS"] > 0 and not ops["LDL"] and not ops["STL"], ops
    # logsumexp's and argmax's staged tiles: copied by cp.async, walked
    # 16 bytes a load where the copies are 16 bytes (VEC 1)
    for kernel in ("logsumexp_tile_kernel", "argmax_tile_kernel"):
        for rows in (32, 64, 128):
            for vec in (0, 1):
                name = f"{kernel}<{rows},{vec}>"
                ops = reduce[name]
                assert ops["LDGSTS"] > 0 and (ops["LDS.128"] > 0 or not vec), (
                    name, ops)
    for name, ops in reduce.items():
        assert not any(ops[op] for op in ("HMMA", "HGMMA", "LDL", "STL")), (
            name, ops)


def device_us(prof):
    """{kernel name: summed GPU time in us} of a profiler run."""
    return {name: us for name, (us, _) in device_events(prof).items()}


def device_events(prof):
    """{kernel name: (summed GPU time in us, number of events)} of a
    profiler run."""
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, count = out.get(ev.name, (0.0, 0))
            out[ev.name] = (us + ev.time_range.elapsed_us(), count + 1)
    return out


def time_ms(fn, reps):
    """(device ms, call ms) per call of ``fn`` over ``reps`` back-to-back
    calls. Device ms is the GPU time of the kernels it launches (from
    torch.profiler): for each kernel name, its mean time times its
    launches a call (its events over ``reps``, rounded, at least 1), so a
    few events the profiler drops (it does, after a profiled round) bias
    nothing; call ms is the CUDA-event time per call, which the host's
    launch overhead sets whenever the kernels are shorter. The profiler
    now and then hands back no device events for a short run; then the
    profiled calls are made again, at most four more times, and if the
    fifth reading is empty too the CUDA-event time stands in for the
    device time (a ``time_ms_fallback`` line says so): it includes the
    launch overhead, so it can only read slower."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / reps
    for _ in range(5):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device_ms = sum(us / count * max(1, round(count / reps))
                        for us, count in device_events(prof).values()) / 1e3
        if device_ms > 0:
            return device_ms, call_ms
    emit(phase="time_ms_fallback", reps=reps, call_ms=call_ms)
    return call_ms, call_ms


def roofline_ms(flops, nbytes, rate):
    """(least ms, what bounds it): the bytes at the memory rate or the
    operations at ``rate``, whichever takes longer."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def peak_of(dtype):
    """The peak rate of a product's inputs' type: float32 on the CUDA
    cores, bf16 on the tensor cores."""
    return F32_FLOPS if dtype == torch.float32 else BF16_FLOPS


def bound(n, m, dtype):
    """(least ms, what bounds it, bytes moved) of (N, M) x (N,) -> (M,)
    from K1's ``cost``: each input read once and the output written once
    at the memory rate, or 2*N*M flops at the f32 rate."""
    flops, nbytes = weighted_aggregate_cost(n, m, dtype)
    return (*roofline_ms(flops, nbytes, F32_FLOPS), nbytes)


def check_aggregate(n, m, dtype, label, assume_normalized=True,
                    misaligned=False, reps=200):
    """Kernel vs plain on the card at one shape; returns the numbers."""
    g = torch.Generator(device="cuda").manual_seed(n * 100_003 + m)
    # misaligned: the base pointer one element past the vector alignment
    x = torch.randn(n * m + misaligned, device="cuda", generator=g)
    x = x.to(dtype)[int(misaligned):].view(n, m)
    w = torch.rand(n, device="cuda", generator=g) + 1e-3
    if assume_normalized:
        w = w / w.sum()
    kw = dict(assume_normalized=assume_normalized)
    got = weighted_aggregate(x, w, **kw)
    want = weighted_aggregate_ref(x, w, **kw)
    torch.cuda.synchronize()
    assert got.shape == (m,) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    tol = (1e-6 * x.float().abs().max().item() if dtype == torch.float32
           else 1e-2)
    assert err <= tol, (label, n, m, dtype, err, tol)
    kernel_ms, kernel_call_ms = time_ms(
        lambda: weighted_aggregate(x, w, **kw), reps)
    plain_ms, plain_call_ms = time_ms(
        lambda: weighted_aggregate_ref(x, w, **kw), max(reps // 10, 5))
    wl = w.to(dtype)
    library_ms, library_call_ms = time_ms(lambda: wl @ x, reps)
    b_ms, b_by, nbytes = bound(n, m, dtype)
    row = dict(phase="kernel_check", kernel="weighted_aggregate",
               case=label, n=n, m=m, dtype=str(dtype).split(".")[-1],
               max_abs_err=err, tol=tol, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_us=b_ms * 1e3, bound_by=b_by,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


def robust_bound(n, m, trim, mode, dtype):
    """(least ms, what bounds it, bytes moved) of the robust reduce of the
    first n rows of (N, M) -> (M,) from K2's ``cost``: the n real rows read
    once and the output written once at the memory rate, or the
    comparisons and adds at the 32-bit instruction rate."""
    ops, nbytes = robust_aggregate_cost(n, m, trim, mode, dtype)
    return (*roofline_ms(ops, nbytes, INSTR_PER_S), nbytes)


def robust_specials(x, n, g):
    """Special values in the first n rows of x (rows, M), in place: the
    values rounded to integers (ties, and -0 from small negatives), then in
    column c a share (c % 8) * 3% of NaN with the sign bit set, quiet NaN,
    +inf and -inf (more NaN than the trim in some columns, fewer in
    others), and columns 128-191 all -0."""
    rows, m = x.shape
    real = (x[:n].float() * 2).round()
    u = torch.rand(n, m, device="cuda", generator=g)
    rate = (torch.arange(m, device="cuda") % 8) * 0.03
    # bits 0xFFC00000, 0x7FC00000, +inf, -inf
    values = torch.tensor([-0x400000, 0x7FC00000, 0x7F800000, -0x800000],
                          dtype=torch.int32, device="cuda").view(
                              torch.float32)
    for lo, hi, v in zip((0.0, 0.5, 0.7, 0.85), (0.5, 0.7, 0.85, 1.0),
                         values):
        real[(u >= rate * lo) & (u < rate * hi)] = v
    real[:, 128:192] = -0.0
    x[:n] = real.to(x.dtype)


def robust_garbage(x, n):
    """Rows n.. of x hold NaN of both signs, +-3e38 and +inf, in place:
    values the kernel must never read."""
    junk = torch.tensor([float("nan"), -float("nan"), 3e38, -3e38,
                         float("inf")], device="cuda")
    x[n:] = junk[torch.arange(x[n:].numel(), device="cuda") % 5].view(
        x[n:].shape).to(x.dtype)


def check_robust(rows, n, m, mode, dtype, label, reps=200, nan=False,
                 special=False, garbage=False):
    """K2 against its plain version on the card at one shape, bit for bit
    (NaN where it is NaN, equal values elsewhere: -0 and +0 are equal,
    since equal values have no stated order), and against the kernel's
    algorithm in plain PyTorch (``robust_aggregate_network``) to the bit,
    the sign of a zero included; rows >= n hold values the kernel must
    ignore. ``nan`` puts NaN in the first 64 columns past the rank window
    (the result is NaN there) and one NaN in the next 64 (trimmed or below
    the median); ``special`` puts in the values of ``robust_specials``,
    ``garbage`` those of ``robust_garbage``. Returns the numbers."""
    g = torch.Generator(device="cuda").manual_seed(rows * 7919 + n * 31 + m)
    x = torch.randn(rows, m, device="cuda", generator=g).to(dtype)
    if nan:
        x[:n // 2 + 1, :64] = float("nan")
        x[0, 64:128] = float("nan")
    if special:
        robust_specials(x, n, g)
    if garbage:
        robust_garbage(x, n)
    trim = TrimmedMean(0.2).n_trim(n) if mode == "trimmed_mean" else 0
    kw = dict(trim=trim, mode=mode)
    got = robust_aggregate(x, n, **kw)
    want = robust_aggregate_ref(x, n, **kw)
    net = robust_aggregate_network(x, n, **kw)
    torch.cuda.synchronize()
    assert got.shape == (m,) and got.dtype == dtype
    is_nan = got.isnan()
    assert torch.equal(is_nan, want.isnan()), (label, rows, n, m, mode)
    assert torch.equal(is_nan, net.isnan()), (label, rows, n, m, mode)
    if not special:
        assert bool(is_nan[:64].all()) == nan and not bool(is_nan[64:].any())
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got[~is_nan], want[~is_nan]) and torch.equal(
        got[~is_nan].view(bits), net[~is_nan].view(bits)), (
        label, rows, n, m, mode, dtype)
    finite = got.isfinite()
    err = (got.float() - want.float())[finite].abs().max().item() \
        if bool(finite.any()) else 0.0
    kernel_ms, kernel_call_ms = time_ms(
        lambda: robust_aggregate(x, n, **kw), reps)
    plain_ms, plain_call_ms = time_ms(
        lambda: robust_aggregate_ref(x, n, **kw), max(reps // 10, 3))
    real = x[:n]
    if mode == "median":
        library = "torch.quantile(midpoint)"
        # torch.quantile takes at most 2**24 elements
        lib_fn = (None if real.numel() > 1 << 24 or dtype != torch.float32
                  else lambda: torch.quantile(real, 0.5, dim=0,
                                              interpolation="midpoint"))
    else:
        library = "torch.sort (sort only)"
        lib_fn = lambda: torch.sort(real, dim=0)
    library_ms = library_call_ms = None
    if lib_fn is not None:
        library_ms, library_call_ms = time_ms(lib_fn, max(reps // 4, 3))
    b_ms, b_by, nbytes = robust_bound(n, m, trim, mode, dtype)
    row = dict(phase="kernel_check", kernel="robust_aggregate", case=label,
               rows=rows, n=n, trim=trim, m=m, mode=mode,
               dtype=str(dtype).split(".")[-1], max_abs_err=err,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library=library,
               library_ms=library_ms, bound_ms=b_ms, bound_us=b_ms * 1e3,
               bound_by=b_by,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


def robust_cases():
    """Every ``check_robust`` call of phase 3, as (rows, n, m, mode, dtype,
    label, options): the main path's rows in both modes and types, n = N,
    n = 1, N = 128, NaN uploads, odd and even n, ragged M, one
    bandwidth-sized case; the kernel's size-class boundaries (n = 8/9,
    16/17, 32/33, 64/65, 127/128), each with n = N in the trimmed mean and
    with 3 rows more (at most 128) in the median; and the special values
    with garbage in the unread rows."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for mode in ("trimmed_mean", "median"):
        cases += [(48, 44, M_MLP, mode, f32, "main path rows", {}),
                  (8, 8, M_MLP, mode, f32, "n = N", {}),
                  (8, 1, M_MLP, mode, f32, "n = 1", {}),
                  (48, 44, M_MLP, mode, bf16, "bf16", {}),
                  (128, 128, M_MLP, mode, f32, "N = 128", {}),
                  (48, 44, M_MLP, mode, f32, "NaN uploads",
                   dict(reps=20, nan=True)),
                  (48, 44, M_MLP, mode, f32, "special values, garbage rows",
                   dict(reps=20, special=True, garbage=True))]
    cases += [(16, 13, M_MLP, "median", f32, "odd n", {}),
              (16, 12, M_MLP, "median", f32, "even n", {}),
              (16, 11, 4097, "trimmed_mean", f32, "ragged M", {}),
              (16, 11, M_MLP + 1, "median", f32, "ragged M", {}),
              (16, 11, 4097, "median", bf16, "bf16 ragged M", {}),
              (64, 60, 1 << 22, "trimmed_mean", f32, "bandwidth",
               dict(reps=5))]
    for n in (8, 9, 16, 17, 32, 33, 64, 65, 127, 128):
        cases += [(n, n, M_MLP, "trimmed_mean", f32, "class boundary, n = N",
                   dict(reps=20)),
                  (min(n + 3, 128), n, M_MLP, "median", f32,
                   "class boundary", dict(reps=20))]
    return cases


# K3's shapes of phase 3: lm_tiny's training heads (8 windows a client row,
# a bucket's rows padded to 1, 2, 4, 8, 16 or 24) and its evaluation (16
# client rows x 400 windows), at (B, 4, 32, 32, 16) causal; tests/
# test_kernels.py's five shapes, a ragged S and a window without causal
# (b, h, s, t, d, causal, window, label; in both types); grouped KV heads
# and an unmasked S > T (label, b, h, hkv, s, t, d, causal, window)
K3_LM_BATCHES = (8, 32, 64, 128, 192, 6400)
K3_SHAPES = ((2, 4, 256, 256, 64, True, None, "causal"),
             (1, 2, 128, 256, 64, True, None, "right-aligned S < T"),
             (2, 2, 256, 256, 128, True, 64, "window 64, D 128"),
             (1, 1, 256, 256, 64, False, None, "bidirectional"),
             (1, 2, 512, 512, 64, True, None, "S = 512"),
             (3, 2, 37, 37, 16, True, None, "ragged S = 37"),
             (2, 2, 100, 130, 32, False, 17, "window, not causal"))
K3_GQA = ("GQA 12/4", 2, 12, 4, 100, 130, 64, True, None)
K3_UNMASKED = ("unmasked S > T, ragged", 2, 4, 2, 100, 37, 32, False, None)
# every B the LM path launches K3 at (lm_k3_shapes: the training buckets,
# the evaluation and the held-out evaluation's), (B, 4, 32, 32, 16) causal
K3_LM_LAUNCHED = (8, 32, 48, 64, 192, 384, 400, 576, 768, 1152, 6400)
# the float32 route's instances: (D, threads a row, warps a block)
K3_F32_INSTANCES = [(16, 4, w) for w in (1, 2, 4)] + [
    (16, 2, w) for w in (1, 2)] + [(32, 8, w) for w in (1, 2, 4)] + [
    (d, 16, w) for d in (64, 128) for w in (1, 2, 4)]


def flash_bound(b, h, s, t, d, causal, window, dtype, hkv=None):
    """(least ms, what bounds it, bytes moved) of attention: q read and o
    written once (H heads), k and v read once (their Hkv heads) at the
    memory rate, or 4·D flops for every (query head, key) pair inside the
    causal/window band at the peak rate of the inputs' type, whichever
    takes longer (K3's ``cost``)."""
    flops, nbytes = k3.cost(b, h, s, t, d, causal, window, dtype, hkv)
    return (*roofline_ms(flops, nbytes, peak_of(dtype)), nbytes)


def check_flash(b, h, s, t, d, causal, window, dtype, label, reps=100,
                hkv=None):
    """K3 against its plain version on the card at one shape (``hkv`` KV
    heads, H by default), within the tolerances of tests/test_kernels.py
    (|err| <= tol + tol·|plain|); returns the numbers. The library
    yardstick is PyTorch's scaled_dot_product_attention with the same mask
    and the same KV heads (``enable_gqa``)."""
    hkv = hkv or h
    g = torch.Generator(device="cuda").manual_seed(b * 7919 + s * 31 + d)
    q, k, v = (torch.randn(b, n_h, n, d, device="cuda", generator=g).to(
        dtype) for n_h, n in ((h, s), (hkv, t), (hkv, t)))
    kw = dict(causal=causal, window=window)
    got = k3.flash_attention(q, k, v, **kw)
    want = k3.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert bool((diff <= tol + tol * want.float().abs()).all()), (
        label, b, h, s, t, d, causal, window, dtype, err)
    kernel_ms, kernel_call_ms = time_ms(
        lambda: k3.flash_attention(q, k, v, **kw), reps)
    plain_ms, plain_call_ms = time_ms(
        lambda: k3.flash_attention_ref(q, k, v, **kw), max(reps // 5, 5))
    sdpa = functools.partial(
        torch.nn.functional.scaled_dot_product_attention, q, k, v,
        enable_gqa=hkv != h)
    if causal and s == t and window is None:
        lib = lambda: sdpa(is_causal=True)
    elif causal or window is not None:
        mask = k3.band_mask(s, t, causal, window, "cuda")
        lib = lambda: sdpa(attn_mask=mask)
    else:
        lib = sdpa
    library_ms, library_call_ms = time_ms(lib, reps)
    b_ms, b_by, nbytes = flash_bound(b, h, s, t, d, causal, window, dtype,
                                     hkv)
    row = dict(phase="kernel_check", kernel="flash_attention", case=label,
               b=b, h=h, hkv=hkv, s=s, t=t, d=d, causal=causal,
               window=window,
               dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library="scaled_dot_product_attention",
               library_ms=library_ms, bound_ms=b_ms, bound_us=b_ms * 1e3,
               bound_by=b_by,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               attained_tflops=4.0 * d * b * h * k3.band_pairs(
                   s, t, causal, window) / (kernel_ms * 1e-3) / 1e12,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


def check_flash_grad(b, h, s, d, hkv=None, dtype=torch.float32):
    """The gradient through K3's autograd Function (kernel forward, plain
    version's VJP) against the plain version's own, on the card, within
    1e-5 in float32 and ``GRAD_TOL``·max|plain| in bf16; with ``hkv`` < H,
    dk and dv of the Hkv KV heads. In bf16 (the training shape) also the
    backward's device ms (the plain VJP, recomputed)."""
    hkv = hkv or h
    g = torch.Generator(device="cuda").manual_seed(b + s + d)
    qkv = [torch.randn(b, n_h, s, d, device="cuda", generator=g).to(dtype)
           for n_h in (h, hkv, hkv)]
    cot = torch.randn(b, h, s, d, device="cuda", generator=g).to(dtype)
    outs = {}
    for name, fn in (("kernel", k3.flash_attention),
                     ("plain", k3.flash_attention_ref)):
        leaves = [x.clone().requires_grad_(True) for x in qkv]
        outs[name] = torch.autograd.grad(fn(*leaves), leaves, cot)
    err = max((a - b_).abs().max().item()
              for a, b_ in zip(outs["kernel"], outs["plain"]))
    rel = max(_rel_err(a, b_) for a, b_ in zip(outs["kernel"],
                                               outs["plain"]))
    assert [x.shape for x in outs["kernel"]] == [x.shape for x in qkv]
    row = dict(phase="kernel_grad_check", kernel="flash_attention", b=b,
               h=h, hkv=hkv, s=s, d=d, dtype=str(dtype).split(".")[-1],
               max_abs_err=err, max_rel_err=rel)
    del outs
    if dtype == torch.float32:
        emit(**row)
        assert err <= 1e-5, err
        return row
    leaves = [x.clone().requires_grad_(True) for x in qkv]
    out = k3.flash_attention(*leaves)
    row["backward_ms"], row["backward_call_ms"] = time_ms(
        lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True), 5)
    emit(**row)
    assert rel <= GRAD_TOL[dtype], row
    return row


def decode_bound(b, h, hkv, length, d, dtype):
    """(least ms, what bounds it, bytes moved) of flash decode: q read and
    o written once, the ``length`` valid positions of K and V read once,
    at the memory rate; or 4·D flops a (query head, key) at the peak rate
    of the inputs' type, whichever takes longer (K4's ``cost``)."""
    flops, nbytes = k4.cost(b, h, hkv, length, d, dtype)
    return (*roofline_ms(flops, nbytes, peak_of(dtype)), nbytes)


def check_decode(label, b, h, hkv, cap, d, length, dtype, lo=0, reps=100):
    """K4 against its plain version on the card: q (b, h, d) over the
    positions [lo, lo + length) of a (b, cap, hkv, d) cache, passed as a
    view; within the tolerances of tests/test_kernels.py (|err| <= tol +
    tol·|plain|). The library yardstick is PyTorch's
    scaled_dot_product_attention over the same view with a boolean mask
    and its own GQA. Returns the numbers."""
    g = torch.Generator(device="cuda").manual_seed(b * 7919 + cap + length)
    q = torch.randn(b, h, d, device="cuda", generator=g).to(dtype)
    kc, vc = (torch.randn(b, cap, hkv, d, device="cuda", generator=g)
              .to(dtype) for _ in range(2))
    k, v = kc[:, lo:lo + length], vc[:, lo:lo + length]
    got = k4.decode_attention(q, k, v, length)
    want = k4.decode_attention_ref(q, k, v, length)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert bool((diff <= tol + tol * want.float().abs()).all()), (
        label, b, h, hkv, cap, d, length, lo, dtype, err)
    kernel_ms, kernel_call_ms = time_ms(
        lambda: k4.decode_attention(q, k, v, length), reps)
    plain_ms, plain_call_ms = time_ms(
        lambda: k4.decode_attention_ref(q, k, v, length), max(reps // 5, 5))
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = torch.ones(1, 1, 1, length, dtype=torch.bool, device="cuda")
    library_ms, library_call_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True), reps)
    b_ms, b_by, nbytes = decode_bound(b, h, hkv, length, d, dtype)
    row = dict(phase="kernel_check", kernel="decode_attention", case=label,
               b=b, h=h, hkv=hkv, cache=cap, d=d, length=length, lo=lo,
               dtype=str(dtype).split(".")[-1],
               route=k4.route(dtype, h // hkv), max_abs_err=err, tol=tol,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library="scaled_dot_product_attention(bool mask, gqa)",
               library_ms=library_ms, bound_ms=b_ms, bound_us=b_ms * 1e3,
               bound_by=b_by,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


def ssd_bound(b, length, h, p, n, g, q, dtype):
    """(least ms, what bounds it, bytes moved, flops) of the SSD scan: x,
    B, C and dt read once, y and the final state written once, at the
    memory rate; or the flops at the peak rate of the inputs' type,
    whichever takes longer. Per (b, h, chunk) the flops are counted once:
    Q·N·Q for the causal C·Bᵀ scores, Q·P·Q for their product with x·dt
    and 4·Q·N·P for the inter-chunk term and the state update. In bf16
    every product can run on the tensor cores (989 TFLOP/s): a float32
    operand split into a bf16 hi/lo pair doubles the tensor-core work but
    not the function's flops; in float32 they run on the CUDA cores (67
    TFLOP/s). K6's ``cost``, the same for either compute dtype."""
    flops, nbytes = k6.cost(b, length, h, p, n, g, q, dtype)
    return (*roofline_ms(flops, nbytes, peak_of(dtype)), nbytes, flops)


def check_ssd(label, b, length, h, p, n, g, chunk, dtype, reps=20,
              init=False):
    """K6 against its plain version (the sequential recurrence) on the
    card, y and the final state, within 5e-4 + 5e-4·|plain|
    (tests/test_kernels.py's tolerance) in float32; a bfloat16 y within
    2e-2 + 2e-2·|plain| (both round float32 results to 8 bits), its final
    state within 5e-4 + 5e-4·|plain| still. ``init`` starts from a random
    initial state. No single PyTorch call computes an SSD scan, so there
    is no library yardstick. Returns the numbers."""
    gen = torch.Generator(device="cuda").manual_seed(b * 7919 + length + n)
    x = torch.randn(b, length, h, p, device="cuda", generator=gen).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, length, h, device="cuda", generator=gen))
    A = -torch.exp(0.2 * torch.randn(h, device="cuda", generator=gen))
    Bm, Cm = (torch.randn(b, length, g, n, device="cuda", generator=gen)
              .to(dtype) for _ in range(2))
    s0 = (torch.randn(b, h, n, p, device="cuda", generator=gen) if init
          else None)
    y, state = k6.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0)
    y_ref, s_ref = k6.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                   initial_state=s0)
    torch.cuda.synchronize()
    assert y.shape == x.shape and y.dtype == dtype
    tol = 5e-4 if dtype == torch.float32 else 2e-2
    dy = (y.float() - y_ref.float()).abs()
    ds = (state - s_ref).abs()
    assert bool((dy <= tol + tol * y_ref.float().abs()).all()), (
        label, dy.max().item())
    assert bool((ds <= 5e-4 + 5e-4 * s_ref.abs()).all()), (
        label, ds.max().item())
    kernel_ms, kernel_call_ms = time_ms(
        lambda: k6.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                            initial_state=s0), reps)
    plain_ms, plain_call_ms = time_ms(
        lambda: k6.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                initial_state=s0), 2)
    q = min(chunk, length)
    b_ms, b_by, nbytes, flops = ssd_bound(b, length, h, p, n, g, q, dtype)
    row = dict(phase="kernel_check", kernel="ssd_scan", case=label, b=b,
               l=length, h=h, p=p, n=n, g=g, chunk=q, init=init,
               dtype=str(dtype).split(".")[-1],
               route=k6.route(dtype, p, n, q),
               max_abs_err=max(dy.max().item(), ds.max().item()),
               y_err=dy.max().item(), state_err=ds.max().item(), tol=tol,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library=None,
               library_ms=None, bound_ms=b_ms, bound_us=b_ms * 1e3,
               bound_by=b_by,
               attained_tflops=flops / (kernel_ms * 1e-3) / 1e12,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms)
    emit(**row)
    return row


def moe_bound(e, c, k, n, dtype):
    """(least ms, what bounds it, bytes moved) of the grouped product (E,
    C, K) x (E, K, N): x and w read once and the output written once at
    the memory rate, or 2·E·C·K·N flops at the peak rate of the inputs'
    type (bf16 tensor cores, f32 CUDA cores), whichever takes longer (K5's
    ``cost``)."""
    flops, nbytes = k5.cost(e, c, k, n, dtype)
    return (*roofline_ms(flops, nbytes, peak_of(dtype)), nbytes)


def check_moe(label, e, c, k, n, dtype, reps=50):
    """K5 against its plain version (the float32 einsum, rounded once) on
    the card, within tests/test_kernels.py's tolerances (|err| <= tol +
    tol·|plain|, 1e-4 f32, 2e-1 bf16). In bf16 also the largest difference
    in ulps of the plain value, over all elements and over those at least
    1% of max|plain|, and the share of elements more than one ulp off:
    both sum in float32 and round once, so one ulp is expected where the
    sum is not a near-cancellation (there the float32 sums' own difference
    is many ulps of a tiny result). The library yardstick is
    ``torch.bmm`` at the same shape. Returns the numbers."""
    g = torch.Generator(device="cuda").manual_seed(e * 7919 + c + k + n)
    x = torch.randn(e, c, k, device="cuda", generator=g).to(dtype)
    w = torch.randn(e, k, n, device="cuda", generator=g).to(dtype)
    got = k5.moe_gemm(x, w)
    want = k5.moe_gemm_ref(x, w)
    torch.cuda.synchronize()
    assert got.shape == (e, c, n) and got.dtype == dtype
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    tol = 1e-4 if dtype == torch.float32 else 2e-1
    assert bool((diff <= tol + tol * want.float().abs()).all()), (
        label, e, c, k, n, dtype, err)
    ulps = {}
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp_min(2.0 ** -126))) - 7)
        in_ulps = diff / ulp
        big = want.float().abs() >= 0.01 * want.float().abs().max()
        ulps = dict(max_ulps=in_ulps.max().item(),
                    max_ulps_above_1pct=in_ulps[big].max().item(),
                    share_over_1_ulp=(in_ulps > 1).float().mean().item())
    kernel_ms, kernel_call_ms = time_ms(lambda: k5.moe_gemm(x, w), reps)
    plain_ms, plain_call_ms = time_ms(lambda: k5.moe_gemm_ref(x, w),
                                      max(reps // 5, 2))
    library_ms, library_call_ms = time_ms(lambda: torch.bmm(x, w), reps)
    b_ms, b_by, nbytes = moe_bound(e, c, k, n, dtype)
    row = dict(phase="kernel_check", kernel="moe_gemm", case=label, e=e,
               c=c, k=k, n=n, dtype=str(dtype).split(".")[-1],
               max_abs_err=err, tol=tol, **ulps, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library="torch.bmm", library_ms=library_ms,
               bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by,
               attained_tflops=2.0 * e * c * k * n / (kernel_ms * 1e-3)
               / 1e12,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


# K5's decode route: its kernels' slot-tile counts (CT tiles of 8 slots)
K5_DECODE_TILES = (1, 2, 4, 8, 16)
# the archs whose decode step K5 is held on, at full width
K5_DECODE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")
K5_BF16_TOL = 2e-1


def empty_experts(x):
    """(E,) bool: the experts whose x block is all +-0 (bits & 0x7FFF ==
    0), as the dispatch leaves an expert no token was routed to; K5's
    decode route writes them +0 and never reads their weights."""
    return ((x.view(torch.int16) & 0x7FFF) == 0).flatten(1).all(1)


def occupied_bound(x, w):
    """(least ms, bytes) of K5 at a decode: x and the output once at the
    memory rate, and the weights of the occupied experts only (what the
    data needs: an empty expert's weights are never read)."""
    e, c, k = x.shape
    n = w.shape[2]
    occupied = e - int(empty_experts(x).sum())
    nbytes = (e * c * k + occupied * k * n + e * c * n) * x.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def moe_decode_calls(arch, seed=0):
    """One MoE layer of ``arch`` at full width on a decode step's 8 tokens
    through the port's own router, top-k and sort-based dispatch
    (``models/moe._dispatch``), the router and experts drawn on the card
    from a seed (σ 1/√fan-in) and the hidden states unit normal, bf16:
    ([(product, x, w)] for the gate, up and down products as K5 received
    them, and the routes)."""
    cfg = registry.get(arch)
    m, d = cfg.moe, cfg.d_model
    E, f = m.n_routed, m.d_ff_expert
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, fan_in):
        return torch.randn(*shape, device="cuda", generator=g,
                           dtype=torch.bfloat16).mul_(fan_in ** -0.5)

    p = {"router": torch.randn(d, E, device="cuda", generator=g) / d ** 0.5,
         "wg": draw(E, d, f, fan_in=d), "wu": draw(E, d, f, fan_in=d),
         "wd": draw(E, f, d, fan_in=f)}
    x3 = torch.randn(1, SERVE_BATCH, d, device="cuda", generator=g,
                     dtype=torch.bfloat16)
    calls, real = [], tmoe.moe_gemm

    def recording(x, w):
        calls.append((x, w))
        return real(x, w)

    tmoe.moe_gemm = recording
    try:
        with torch.no_grad():
            tmoe._dispatch(cfg, p, x3, False)
    finally:
        tmoe.moe_gemm = real
    torch.cuda.synchronize()
    return ([(name, *call) for name, call in zip(("gate", "up", "down"),
                                                  calls)],
            SERVE_BATCH * m.top_k)


def k5_holds(out, want, empty, tol=K5_BF16_TOL):
    """(the empty experts' rows bit-equal to ``want``'s, the rest within
    tol + tol·|want|, max|Δ| there)."""
    bits = torch.equal(out[empty].view(torch.int16),
                       want[empty].view(torch.int16))
    diff = (out[~empty].float() - want[~empty].float()).abs()
    close = bool((diff <= tol + tol * want[~empty].float().abs()).all())
    return bits, close, diff.max().item() if diff.numel() else 0.0


def check_moe_decode(arch, product, x, w, routes, reps=50):
    """K5 on the x that a decode step's dispatch gave it
    (``moe_decode_calls``): the empty experts' rows bit-equal to the plain
    version's and +0, every other row within the bf16 tolerance of
    ``check_moe``; the negative control (``_k5_control``, the experts
    rolled by one) must fail the same test. Timed beside the plain
    version and ``torch.bmm`` (which read every expert), with both bounds:
    every expert's bytes (K5's ``cost``) and the occupied experts'."""
    e, c, k = x.shape
    n = w.shape[2]
    got = k5.moe_gemm(x, w)
    want = k5.moe_gemm_ref(x, w)
    torch.cuda.synchronize()
    empty = empty_experts(x)
    bits, close, err = k5_holds(got, want, empty)
    assert bits and bool((got[empty].view(torch.int16) == 0).all()), (
        arch, product)
    assert close, (arch, product, err)
    c_bits, c_close, _ = k5_holds(_k5_control(x, w), want, empty)
    assert not (c_bits and c_close), (arch, product, "control accepted")
    kernel_ms, kernel_call_ms = time_ms(lambda: k5.moe_gemm(x, w), reps)
    plain_ms, _ = time_ms(lambda: k5.moe_gemm_ref(x, w), max(reps // 10, 2))
    library_ms, _ = time_ms(lambda: torch.bmm(x, w), reps)
    all_ms, by, _ = moe_bound(e, c, k, n, x.dtype)
    occ_ms, occ_bytes = occupied_bound(x, w)
    row = dict(phase="kernel_check", kernel="moe_gemm",
               case=f"{arch} decode {product}, a decode step's routing",
               e=e, c=c, k=k, n=n, dtype="bfloat16", routes=routes,
               occupied_experts=e - int(empty.sum()),
               empty_experts=int(empty.sum()), max_abs_err=err,
               tol=K5_BF16_TOL, empty_rows_bits_equal=True,
               empty_rows_plus_zero=True, control_rejected=True,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library="torch.bmm",
               library_ms=library_ms, bound_ms=all_ms, bound_by=by,
               bound_occupied_ms=occ_ms, occupied_bytes=occ_bytes,
               of_occupied_bound=kernel_ms / occ_ms,
               of_library=kernel_ms / library_ms,
               kernel_call_ms=kernel_call_ms)
    emit(**row)
    return row


def check_p31(x, w):
    """ROADMAP P31 on the card: an empty expert whose weights hold an inf.
    The plain version gives NaN across that column of its rows (0·inf),
    the kernel +0 (it never reads those weights); the combine never reads
    an empty expert's rows. w is restored."""
    empty = empty_experts(x)
    e0 = int(empty.nonzero()[0])
    old = w[e0, 0, 0].clone()
    w[e0, 0, 0] = float("inf")
    try:
        got, want = k5.moe_gemm(x, w), k5.moe_gemm_ref(x, w)
        torch.cuda.synchronize()
        kernel_zero = bool((got[e0].view(torch.int16) == 0).all())
        plain_nan = int(torch.isnan(want[e0]).sum())
    finally:
        w[e0, 0, 0] = old
    emit(phase="kernel_check", kernel="moe_gemm", case="P31: an empty "
         "expert with an inf weight", expert=e0, kernel_rows_plus_zero=
         kernel_zero, plain_nan_elements=plain_nan, slots=x.shape[1])
    assert kernel_zero and plain_nan == x.shape[1], (kernel_zero, plain_nan)


def moe_decode_checks():
    """``check_moe_decode`` at qwen2-moe-a2.7b's and deepseek-v3-671b's
    decode (gate and down; up shares gate's x and shape), then P31 on
    qwen2-moe's gate. Returns the rows."""
    rows = []
    for arch in K5_DECODE_ARCHS:
        calls, routes = moe_decode_calls(arch)
        for product, x, w in calls:
            if product != "up":
                rows.append(check_moe_decode(
                    arch, product, x, w, routes,
                    reps=20 if x.shape[0] > 128 else 50))
        if arch == "qwen2-moe-a2.7b":
            check_p31(*calls[0][1:])
        del calls
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------- #
# The task plane's batch-invariant kernels (bi_gemm, bi_reduce)
# ---------------------------------------------------------------------- #
# against torch's own order (cuBLAS, torch's reductions), of max|want|
BI_RTOL = 1e-5


def _randn(*shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, device="cuda", generator=g)


def bits_equal(a, b):
    """Equal bit for bit (a -0 is not a +0; NaNs by their bits)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def misaligned(x):
    """x's values at a base 4 bytes past a 16-byte boundary."""
    off = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    off[1:].copy_(x.reshape(-1))
    return off[1:].view(x.shape)


def check_bi_gemm(label, batch, m, k, n, shared=False, timed=True,
                  twin=False, reps=20):
    """bi_gemm against its plain version (torch.matmul) at one shape, a
    shared by the whole batch with ``shared``: within ``BI_RTOL``, its
    matrix 0 equal bit for bit to a batch of 1's, equal to the product with
    a or b stored transposed (the backward's strided operands, staged
    another way) and with a misaligned (4-byte copies), unchanged by zeros
    appended to K (columns of a, rows of b), and with ``twin`` equal bit
    for bit to its order in plain PyTorch (``bi_gemm_chain_ref``). Returns
    the numbers (the times only when ``timed``)."""
    a = _randn(1 if shared else batch, m, k, seed=m * 7 + k)
    b = _randn(batch, k, n, seed=n * 13 + k + batch)
    got = kbg.bi_gemm(a, b)
    want = kbg.bi_gemm_ref(a, b)
    one = kbg.bi_gemm(a[:1], b[:1])
    strided = kbg.bi_gemm(a.mT.contiguous().mT, b)
    strided_b = kbg.bi_gemm(a, b.mT.contiguous().mT)
    unaligned = kbg.bi_gemm(misaligned(a), b)
    padded = kbg.bi_gemm(torch.cat([a, a.new_zeros(a.shape[0], m, 5)], 2),
                         torch.cat([b, b.new_zeros(batch, 5, n)], 1))
    torch.cuda.synchronize()
    assert got.shape == (batch, m, n), (label, got.shape)
    err = (got - want).abs().max().item()
    tol = BI_RTOL * want.abs().max().item()
    assert err <= tol, (label, err, tol)
    assert bits_equal(got[:1], one), label
    for other in (strided, strided_b, unaligned, padded):
        assert bits_equal(got, other), label
    if twin:
        assert bits_equal(got, kbg.bi_gemm_chain_ref(a, b)), label
    if not timed:
        emit(phase="kernel_check", kernel="bi_gemm", case=label, batch=batch,
             m=m, k=k, n=n, shared=shared, max_abs_err=err, tol=tol,
             chain_equal=twin or None, zero_k_equal=True)
        return None
    kernel_ms, kernel_call_ms = time_ms(lambda: kbg.bi_gemm(a, b), reps)
    plain_ms, plain_call_ms = time_ms(lambda: kbg.bi_gemm_ref(a, b), reps)
    wide = a.expand(batch, m, k)
    library_ms, library_call_ms = time_ms(lambda: torch.bmm(wide, b), reps)
    flops, nbytes = kbg.cost(batch, a.shape[0], batch, m, n, k)
    b_ms, b_by = roofline_ms(flops, nbytes, F32_FLOPS)
    row = dict(phase="kernel_check", kernel="bi_gemm", case=label,
               batch=batch, m=m, k=k, n=n, shared=shared, max_abs_err=err,
               tol=tol, chain_equal=twin or None, zero_k_equal=True,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
               attained_tflops=flops / (kernel_ms * 1e-3) / 1e12,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


_BI_LIBRARY = {kbr.SUM: lambda x: x.sum(1),
               kbr.LOGSUMEXP: lambda x: torch.logsumexp(x, 1),
               kbr.ARGMAX: lambda x: torch.argmax(x, 1)}


def same_bits(a, b):
    """Equal bit for bit, NaN exactly where NaN (its payload aside)."""
    nan = torch.isnan(a)
    return a.shape == b.shape and torch.equal(nan, torch.isnan(b)) and \
        bits_equal(a[~nan], b[~nan])


def bi_reduce_input(r, m, d, band=False):
    """check_bi_reduce's x (R, M, D) on the card, from a seed; with
    ``band`` the causal band of an attention's scores: rows in groups of
    M queries over M keys, key j of query i past the band (j > i) set to
    the kernels' -1e30, as ``bi.invariant_vjp`` masks its scores."""
    x = _randn(r, m, d, seed=r + 31 * m + d)
    if band:
        i = torch.arange(r, device="cuda")[:, None] % m
        x[:, :, 0].masked_fill_(torch.arange(m, device="cuda") > i,
                                k3.NEG_INF)
    return x


def check_bi_reduce(label, r, m, d, mode, timed=True, band=False, reps=50):
    """bi_reduce against its plain version (torch's reduction) at one
    shape: the sums and logsumexp within ``BI_RTOL``, argmax exact; row 0
    equal bit for bit to one row's call and every row to the call on a
    misaligned copy of x (4-byte copies); a sum unchanged by zeros
    appended to every row and equal bit for bit to its order in plain
    PyTorch (``bi_reduce_chain_ref``), a logsumexp equal to its order
    (``bi_logsumexp_chain_ref``, NaNs aside: none here). Returns the
    numbers."""
    x = bi_reduce_input(r, m, d, band)
    got = kbr.bi_reduce(x, mode)
    want = kbr.bi_reduce_ref(x, mode)
    one = kbr.bi_reduce(x[:1], mode)
    torch.cuda.synchronize()
    if mode == kbr.ARGMAX:
        err, tol = float((got != want).sum().item()), 0.0
    else:
        err = (got - want).abs().max().item()
        tol = BI_RTOL * max(want.abs().max().item(), 1.0)
    assert err <= tol, (label, err, tol)
    assert bits_equal(got[:1], one), label
    assert bits_equal(kbr.bi_reduce(misaligned(x), mode), got), label
    if mode == kbr.SUM:
        padded = torch.cat([x, x.new_zeros(r, 8, d)], 1)
        assert bits_equal(kbr.bi_reduce(padded), got), label
        assert bits_equal(kbr.bi_reduce_chain_ref(x), got), label
    elif mode == kbr.LOGSUMEXP:
        assert same_bits(kbr.bi_logsumexp_chain_ref(x), got), label
    chain = mode != kbr.ARGMAX or None
    if not timed:
        emit(phase="kernel_check", kernel="bi_reduce", case=label,
             mode=kbr.MODES[mode], r=r, m=m, d=d, band=band,
             max_abs_err=err, tol=tol, chain_equal=chain)
        return None
    kernel_ms, kernel_call_ms = time_ms(lambda: kbr.bi_reduce(x, mode),
                                        reps)
    plain_ms, plain_call_ms = time_ms(lambda: kbr.bi_reduce_ref(x, mode),
                                      reps)
    library = _BI_LIBRARY[mode]
    library_ms, library_call_ms = time_ms(lambda: library(x), reps)
    flops, nbytes = kbr.cost(r, m, d, mode)
    b_ms, b_by = roofline_ms(flops, nbytes, F32_FLOPS)
    row = dict(phase="kernel_check", kernel="bi_reduce", case=label,
               mode=kbr.MODES[mode], r=r, m=m, d=d, band=band,
               max_abs_err=err, tol=tol, chain_equal=chain,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=b_ms, bound_by=b_by,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


# the widths of the edge rows' cases: M = 1 and short rows (walked in
# device memory), the paths' 10, 32 and 64, 33 (a tile of 4-byte copies),
# and 500, past the longest row a tile stages
EDGE_MS = (1, 2, 7, 10, 32, 33, 64, 500)
EDGE_R = 300            # rows a case: the edges, then random rows


def edge_rows(m, seed):
    """(``EDGE_R``, M) float32 rows from a seed: the edges — all -1e30, a
    causal band (the first half finite, then -1e30), a tie of the maximum,
    signed zeros, a +inf, all -inf, -inf among finite values, a NaN, two
    NaNs after a larger value, each whose width allows it — then random
    rows at two scales; on the card."""
    rng = np.random.default_rng(seed)
    rows = [np.full(m, -1e30), np.where(np.arange(m) <= m // 2,
                                        rng.standard_normal(m), -1e30),
            np.where(np.arange(m) % 2, -0.0, 0.0), np.full(m, -np.inf)]
    one = rng.standard_normal(m)
    one[m // 2] = np.inf
    rows.append(one)
    if m > 1:
        tie = rng.standard_normal(m)
        tie[[0, m - 1]] = tie.max() + 1
        lo = rng.standard_normal(m)
        lo[::2] = -np.inf
        rows += [tie, lo]
    nan = rng.standard_normal(m)
    nan[m // 2] = np.nan
    rows.append(nan)
    if m > 2:
        two = rng.standard_normal(m)
        two[0], two[1], two[-1] = 100.0, np.nan, np.nan
        rows.append(two)
    rest = rng.standard_normal((EDGE_R - len(rows), m)) * np.where(
        np.arange(EDGE_R - len(rows)) % 2, 30.0, 1.0)[:, None]
    x = np.concatenate([np.stack(rows), rest]).astype(np.float32)
    return torch.from_numpy(x).to("cuda")[:, :, None]


def check_bi_reduce_edges():
    """logsumexp and argmax on ``edge_rows`` at every width of
    ``EDGE_MS``, aligned and on a misaligned base: the logsumexp equal
    bit for bit to ``bi_logsumexp_chain_ref`` on the card (NaN where it
    is NaN; whether the NaNs' payloads agree too is printed), within
    ``BI_RTOL`` · max(1, |torch.logsumexp|) of ``torch.logsumexp`` row by
    row where the row's maximum is finite (``max_rel_err``), and equal
    to torch's +-inf where it is +-inf (the kernel subtracts +0 there, as
    ``jax.nn.logsumexp`` does); the argmax equal to ``torch.argmax``; the
    misaligned call equal bit for bit to the aligned one."""
    for m in EDGE_MS:
        x = edge_rows(m, seed=m)
        lse = kbr.bi_reduce(x, kbr.LOGSUMEXP)
        arg = kbr.bi_reduce(x, kbr.ARGMAX)
        twin = kbr.bi_logsumexp_chain_ref(x)
        plain = torch.logsumexp(x, 1)
        torch.cuda.synchronize()
        assert same_bits(lse, twin), m
        assert bits_equal(kbr.bi_reduce(misaligned(x), kbr.LOGSUMEXP),
                          lse), m
        assert torch.equal(kbr.bi_reduce(misaligned(x), kbr.ARGMAX), arg), m
        assert torch.equal(arg, torch.argmax(x, 1)), m
        mx = torch.gather(x[:, :, 0], 1, arg)
        nan = torch.isnan(mx)
        inf = torch.isinf(mx)
        fin = ~nan & ~inf
        # row by row: the all -1e30 rows would set a tolerance of 1e25
        gap = (lse[fin] - plain[fin]).abs() / plain[fin].abs().clamp_min(1.0)
        err, tol = gap.max().item(), BI_RTOL
        assert err <= tol, (m, err, tol)
        assert torch.isnan(lse[nan]).all(), m
        assert torch.isinf(plain[inf]).all(), m
        assert torch.equal(lse[inf], plain[inf]), m
        assert torch.equal(lse[inf], mx[inf]), m
        emit(phase="kernel_check", kernel="bi_reduce", case="edge rows",
             mode="logsumexp, argmax", r=EDGE_R, m=m, d=1,
             max_rel_err=err, tol=tol, chain_equal=True,
             nan_rows=int(nan.sum()), infinite_max_rows=int(inf.sum()),
             nan_payloads_equal=bits_equal(lse, twin), argmax_exact=True,
             misaligned_equal=True)


def infinite_max_inputs(dev):
    """From a seed, on ``dev``: the NLL's logits (5, 10) and labels, rows
    with a +inf off and at the label, a row of -inf and -inf among finite
    values; an attention's q, k, v, g (1, 2, 4, 8) whose scores hold
    +-inf (head 0: key 2 has +inf in dim 0, and the queries' dim 0 has
    both signs) and a row of -inf (head 1: every key has +inf in dim 0,
    query 1's dim 0 is negative)."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 10)).astype(np.float32)
    logits[1, 3] = logits[3, 4] = np.inf
    logits[2] = -np.inf
    logits[4, ::2] = -np.inf
    labels = np.array([0, 1, 2, 4, 1])
    rng = np.random.default_rng(1)
    q, k, v, g = (rng.standard_normal((1, 2, 4, 8)).astype(np.float32)
                  for _ in range(4))
    k[0, 0, 2, 0] = np.inf
    q[0, 0, :, 0] = [1.0, -1.0, 2.0, 0.5]
    k[0, 1, :, 0] = np.inf
    q[0, 1, :, 0] = [1.0, -1.0, 1.0, 1.0]
    return [torch.from_numpy(a).to(dev)
            for a in (logits, labels, q, k, v, g)]


def check_infinite_max_backwards():
    """The NLL (forward and backward) and ``bi.attention``'s backward
    (``bi.invariant_vjp``) on rows whose maximum is +-inf
    (``infinite_max_inputs``), on the card's route (``bi_reduce``'s
    logsumexp, ``bi_gemm``) against the same calls on the CPU: NaN
    exactly where the CPU's is NaN, +-inf where it is, the rest within
    ``BI_RTOL`` · max(1, |cpu|). On the CPU the NLL's equal
    ``jax.grad`` of the reference's loss, NaN where it is NaN, and so do
    attention's dq, dk and dv (tests/test_torch_batch_invariant.py). Then
    the P30 repair on the card: ``invariant_vjp`` against its formula
    before the repair (``vjp_before_p30``) on these inputs and on the same
    inputs without the infinities: every element that the repaired
    function gives finite is bit-equal to the old formula's, dq and dk
    are bit-equal throughout, and the finite inputs' every element."""
    def run(dev):
        logits, labels, q, k, v, g = infinite_max_inputs(dev)
        logits.requires_grad_(True)
        with bi.route():
            nll = bi.nll(logits, labels)
            nll.sum().backward()
            grads = bi.invariant_vjp(q, k, v, g, False, None, 8 ** -0.5)
        return {"nll": nll.detach(), "dlogits": logits.grad,
                **dict(zip(("dq", "dk", "dv"), grads))}

    card, cpu = run("cuda"), run("cpu")
    torch.cuda.synchronize()
    nans, err = {}, 0.0
    for name, want in cpu.items():
        got = card[name].cpu()
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), name
        inf = torch.isinf(want)
        assert torch.equal(got[inf], want[inf]), name
        fin = ~nan & ~inf
        gap = ((got[fin] - want[fin]).abs() / want[fin].abs().clamp_min(
            1.0)).max().item() if fin.any() else 0.0
        assert gap <= BI_RTOL, (name, gap)
        nans[name] = [int(nan.sum()), want.numel()]
        err = max(err, gap)
    emit(phase="kernel_check", kernel="bi_reduce",
         case="infinite maximum backwards", nan_of={k: v for k, v in
                                                    nans.items()},
         nll=[float(x) for x in card["nll"].cpu()],
         nan_where_cpu_nan=True, max_rel_err=err, tol=BI_RTOL)
    assert nans["dv"] == [64, 64], nans["dv"]       # P30: as jax's softmax

    old_vjp = vjp_before_p30()
    _, _, q, k, v, g = infinite_max_inputs("cuda")
    finite = [torch.nan_to_num(t, posinf=3.0, neginf=-3.0)
              for t in (q, k, v, g)]
    moved = {}
    for label, args in (("infinite", (q, k, v, g)), ("finite", finite)):
        with bi.route():
            new = bi.invariant_vjp(*args, False, None, 8 ** -0.5)
            old = old_vjp(*args, False, None, 8 ** -0.5)
        for name, a, b in zip(("dq", "dk", "dv"), new, old):
            fin = torch.isfinite(a)
            assert bits_equal(a[fin], b[fin]), (label, name)
            if name != "dv":    # NaN where it was, and nowhere else
                assert torch.equal(torch.isfinite(b), fin), (label, name)
            if label == "finite":
                assert bool(fin.all()), (label, name)
            moved[f"{label} {name}"] = int((~fin & torch.isfinite(b)).sum())
    emit(phase="kernel_check", kernel="bi_reduce", case="P30 repair: "
         "attention backward against the formula before it",
         finite_elements_bits_equal=True, finite_inputs_bits_equal=True,
         now_nan_before_finite=moved)


def vjp_before_p30():
    """``bi.invariant_vjp`` as it was before P30's repair: its source
    without the ``+ (lse - lse)`` that makes p NaN across a row whose
    logsumexp is +inf, compiled in the module's namespace."""
    import inspect
    import textwrap
    src = textwrap.dedent(inspect.getsource(bi.invariant_vjp))
    repaired = "p = torch.exp(sc - lse) + (lse - lse)"
    assert src.count(repaired) == 1, "the repair moved"
    space = dict(vars(bi))
    exec(compile(src.replace(repaired, "p = torch.exp(sc - lse)"),
                 bi.__file__, "exec"), space)
    return space["invariant_vjp"]


# the main paths' shapes: the §V MLP's training (a bucket of 50 clients,
# 50 samples of 784) and evaluation (50 models over the shared 10,000
# test images); lm_tiny's training (a bucket of 24 clients, 8 windows of
# 32 tokens: d 64, d_ff 128, the 32 KV columns, a client's 8 x 4 heads of
# 32 x 32 x 16 in attention) and evaluation (16 models over 400 windows)
BI_GEMM_CASES = (       # (label, batch, M, K, N, a shared, timed, twin)
    ("§V train x @ w1", 50, 50, 784, 64, False, True, True),
    ("§V train dW1 = xT g", 50, 784, 50, 64, False, True, True),
    ("§V train h @ w2", 50, 50, 64, 10, False, False, True),
    ("§V eval x @ w1, x shared", 50, 10_000, 784, 64, True, True, False),
    ("lm_tiny x @ w_ff", 24, 256, 64, 128, False, True, True),
    ("lm_tiny x @ w_kv", 24, 256, 64, 32, False, False, True),
    ("lm_tiny dW_ff = xT g", 24, 64, 256, 128, False, True, True),
    ("lm_tiny attention q kT", 24 * 32, 32, 16, 32, False, True, True),
    ("lm_tiny eval x @ w_ff", 16, 400 * 32, 64, 128, False, True, False),
    ("ragged", 3, 37, 29, 71, False, False, True),
    ("ragged K 48, N 10", 5, 33, 48, 10, False, False, True))
# (label, R, M, D, mode, timed, band): lm_tiny's attention backward takes
# a logsumexp of each query's 32 scores, a client's 8 windows x 4 heads x
# 32 queries, the causal band's keys at -1e30
BI_REDUCE_CASES = (
    ("§V masked loss sums", 50, 50, 1, kbr.SUM, True, False),
    ("§V bias gradient", 50, 50, 64, kbr.SUM, True, False),
    ("§V eval accuracy sums", 56, 10_000, 1, kbr.SUM, True, False),
    ("lm_tiny masked loss sums", 24, 8 * 31, 1, kbr.SUM, False, False),
    ("lm_tiny norm-scale gradient", 24, 256, 64, kbr.SUM, True, False),
    ("lm_tiny rms_norm mean", 24 * 256, 64, 1, kbr.SUM, True, False),
    ("§V logsumexp", 50 * 50, 10, 1, kbr.LOGSUMEXP, False, False),
    ("lm_tiny logsumexp", 24 * 8 * 31, 64, 1, kbr.LOGSUMEXP, True, False),
    ("lm_tiny attention backward logsumexp", 24 * 8 * 4 * 32, 32, 1,
     kbr.LOGSUMEXP, True, True),
    ("§V eval argmax", 50 * 10_000, 10, 1, kbr.ARGMAX, False, False),
    ("lm_tiny eval argmax", 16 * 400 * 31, 64, 1, kbr.ARGMAX, True, False),
    ("ragged", 7, 33, 5, kbr.SUM, False, False))


def reset_launches():
    for fn in LAUNCH_COUNTERS.values():
        fn.launches = 0


def reset_bi():
    """The batch-invariant kernels' counts to 0 (``reset_launches`` leaves
    them, so a count can span phases that reset K1–K6's)."""
    for fn in BI_COUNTERS.values():
        fn.launches = 0


def read_bi():
    return {k: fn.launches for k, fn in BI_COUNTERS.items()}


def read_launches():
    return {k: fn.launches for k, fn in LAUNCH_COUNTERS.items()}


@contextlib.contextmanager
def bi_reduce_modes():
    """Within the block, ``bi_reduce``'s launches by mode (a Counter of
    "sum", "logsumexp", "argmax"): the wrapper's launch, ``kbr._kernel``,
    wrapped here, adding what the package's count adds."""
    modes, real = collections.Counter(), kbr._kernel

    def counted(x, mode):
        before = kbr.bi_reduce.launches
        out = real(x, mode)
        modes[kbr.MODES[mode]] += kbr.bi_reduce.launches - before
        return out

    kbr._kernel = counted
    try:
        yield modes
    finally:
        kbr._kernel = real


def only(**counts):
    """Launch counts of every kernel: those given, 0 for the rest."""
    return {k: counts.get(k, 0) for k in LAUNCH_COUNTERS}


def round_phases(server, t):
    """Round ``t`` split into its phases (host clock, the GPU synchronised
    after each). The detector's validation eval runs inside the cohort
    engine; it is timed there and reported apart from training."""
    phases = {}
    inner = server._eval_validation

    def timed_validation(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)       # numpy: the GPU work is done
        if out is not None:
            phases["validation_eval_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    server._eval_validation = timed_validation
    t0 = time.perf_counter()
    values, sched, sel, forced = server._schedule_round(t)
    phases["schedule_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    uploads, weights, acc_local, acc_test, acc_val = server._train_cohort(
        sel, t)
    torch.cuda.synchronize()
    phases["train_and_eval_uploads_ms"] = (
        (time.perf_counter() - t0) * 1e3 - phases.get("validation_eval_ms",
                                                      0.0))
    t0 = time.perf_counter()
    server._aggregate_uploads(sel, uploads, weights)
    torch.cuda.synchronize()
    phases["aggregate_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    g_acc, g_loss, src_acc, atk_succ = server._global_metrics()
    phases["global_eval_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    server._finalize_round(t, values, sched, sel, forced, acc_local,
                           acc_test, g_acc, src_acc, atk_succ, acc_val,
                           g_loss)
    phases["finalize_ms"] = (time.perf_counter() - t0) * 1e3
    del server._eval_validation
    return phases


def profile_round(server, t):
    """One round under torch.profiler: wall, device busy time, idle share,
    the device time of K1, K2 and K3 (and K3's share of the busy time),
    the top kernels by name."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_round(t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = device_us(prof)
    busy_us = sum(by_kernel.values())
    flash_us = sum(v for k, v in by_kernel.items()
                   if "flash_f32_kernel" in k or "flash_bf16_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return dict(round=t, wall_us=wall_us, device_busy_us=busy_us,
                device_idle_share=1.0 - busy_us / wall_us,
                n_device_events=sum(1 for ev in prof.events()
                                    if ev.device_type
                                    == torch.autograd.DeviceType.CUDA),
                agg_kernel_us=sum(v for k, v in by_kernel.items()
                                  if "agg_kernel" in k),
                robust_kernel_us=sum(v for k, v in by_kernel.items()
                                     if "robust_kernel" in k),
                flash_kernel_us=flash_us,
                flash_kernel_share=flash_us / busy_us,
                top_kernels_us=[[k[:80], v] for k, v in top])


# what route_host_split times: models/batch_invariant.py's entry points
# (each makes a Function or calls a kernel directly), its Functions'
# forward and backward, and the two kernels' wrappers
ROUTE_ENTRIES = ("_product", "expand", "sum_trailing", "nll", "embed",
                 "attention", "argmax", "count", "bi_gemm", "bi_reduce")
ROUTE_FUNCTIONS = ("_Affine", "_Expand", "_SumTrailing", "_NLL", "_Embed",
                   "_Attention")


def route_host_split(server, t):
    """Round ``t`` with the task plane's route timed on the host: for each
    of ``ROUTE_ENTRIES`` and each Function's forward and backward, its
    calls, its host ms with what it calls (inclusive) and without what
    it calls of these (self), on whichever thread runs it; the round's
    wall beside (no timer synchronises: host ms is the time the host took
    to issue the work). An entry's self ms is its Python and its
    ``Function.apply``; a wrapper's self ms its dispatcher call, its
    allocation and its ctypes launch."""
    stats = collections.defaultdict(lambda: [0, 0.0, 0.0])
    local = threading.local()

    def timed(name, fn):
        def inner(*a, **kw):
            stack = local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                child = stack.pop()
                if stack:
                    stack[-1] += dt
                row = stats[name]
                row[0] += 1
                row[1] += dt
                row[2] += dt - child
        return inner

    real = {n: getattr(bi, n) for n in ROUTE_ENTRIES}
    methods = {(c, m): getattr(bi, c).__dict__[m] for c in ROUTE_FUNCTIONS
               for m in ("forward", "backward")}
    for n, fn in real.items():
        setattr(bi, n, timed(n, fn))
    for (c, m), sm in methods.items():
        setattr(getattr(bi, c), m,
                staticmethod(timed(f"{c}.{m}", sm.__func__)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.run_round(t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for n, fn in real.items():
            setattr(bi, n, fn)
        for (c, m), sm in methods.items():
            setattr(getattr(bi, c), m, sm)
    rows = {n: dict(calls=c, ms=ms * 1e3, self_ms=own * 1e3)
            for n, (c, ms, own) in sorted(stats.items(),
                                          key=lambda kv: -kv[1][2])}
    wrappers = sum(rows[n]["self_ms"] for n in ("bi_gemm", "bi_reduce")
                   if n in rows)
    return dict(round=t, wall_ms=wall_ms,
                route_self_ms=sum(r["self_ms"] for r in rows.values()),
                wrapper_self_ms=wrappers, by_name=rows)


class TimedServer(FeelServer):
    """A FeelServer that records each round's wall time (ending in a GPU
    synchronise), each round's kernel launches, and itself, so a path
    driven through ``run_experiment`` can still be read round by round."""
    made = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.round_ms = []
        self.round_launches = []
        TimedServer.made.append(self)

    def run_round(self, t):
        before = read_launches()
        t0 = time.perf_counter()
        log = super().run_round(t)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.round_ms.append((time.perf_counter() - t0) * 1e3)
        self.round_launches.append({k: v - before[k] for k, v in
                                    read_launches().items()})
        return log


def experiment(**kw):
    """``simulation.run_experiment(**kw)`` -> (result dict, its server)."""
    real, simulation.FeelServer = simulation.FeelServer, TimedServer
    try:
        out = simulation.run_experiment(**kw)
    finally:
        simulation.FeelServer = real
    return out, TimedServer.made[-1]


def defended_run(label, **kw):
    """One defended §V-scale run through run_experiment on the GPU with
    every launch count set to 0 just before and read just after."""
    reset_launches()
    out, server = experiment(
        cfg=FeelConfig(n_ues=50, n_malicious=5), n_train=50_000,
        n_test=10_000, policy="dqs", engine="vectorized", control="host",
        device="cuda", rounds=3, seed=0, **kw)
    launches = read_launches()
    for t, log in enumerate(server.logs):
        emit(phase="defended_path", run=label, round=t,
             wall_ms=server.round_ms[t], acc=log.global_acc,
             n_selected=int(log.selected.size),
             n_malicious_selected=int(log.n_malicious_selected),
             n_rejected=log.n_rejected, n_flagged=log.n_flagged,
             det_precision=log.det_precision, det_recall=log.det_recall,
             rep_gap=log.rep_gap, agg_rows=pad_count(int(log.selected.size)))
    emit(phase="defended_path_launches", run=label, launches=launches,
         scenario=out["scenario"], defense=out["defense"])
    assert launches == only(robust_aggregate=3), (label, launches)
    assert all(np.isfinite(out["acc"])), out["acc"]
    return out, server


def lm_run(policy, shapes=None):
    """The LM path through run_experiment on the GPU (examples/
    federated_llm.py's regime) with every launch count set to 0 just
    before and read just after. ``shapes`` (a Counter) records the q shape
    of every K3 launch."""
    real = k3._kernel

    def recording(q, *args):
        shapes[tuple(q.shape)] += 1
        return real(q, *args)

    if shapes is not None:
        k3._kernel = recording
    reset_launches()
    reset_bi()
    try:
        with bi_reduce_modes() as modes:
            out, server = experiment(
                cfg=FeelConfig(**LM_CFG), scenario=COLLAPSE,
                task="lm_tiny", n_train=2000, n_test=400, policy=policy,
                engine="vectorized", control="host", device="cuda",
                rounds=3, seed=0)
    finally:
        k3._kernel = real
    launches = read_launches()
    for t, log in enumerate(server.logs):
        emit(phase="lm_path", policy=policy, round=t,
             wall_ms=server.round_ms[t], loss=log.global_loss,
             acc=log.global_acc, n_selected=int(log.selected.size),
             n_malicious_selected=int(log.n_malicious_selected),
             attack_success=log.attack_success,
             launches=server.round_launches[t],
             selected=log.selected.tolist())
    bi_lm = read_bi()
    emit(phase="lm_path_launches", policy=policy, launches=launches,
         bi_reduce_by_mode=dict(modes), **bi_lm)
    assert all(n > 0 for n in bi_lm.values()), bi_lm
    assert sum(modes.values()) == bi_lm["bi_reduce"], (modes, bi_lm)
    assert all(modes[k] > 0 for k in kbr.MODES.values()), modes
    assert all(np.isfinite(out["loss"])) and all(np.isfinite(out["acc"]))
    return out, server


def lm_phases():
    """The LM path on the GPU: the DQS run (K3 launched in every round, K1
    once a round), random scheduling beside it, one round split into
    phases and one profiled, K3 at the shape the run launched it at most,
    and a K = 8 run on the GPU and the CPU. Returns (K3's launches in the
    DQS run, K3's numbers at that shape)."""
    shapes = collections.Counter()
    lm_dqs, server_lm = lm_run("dqs", shapes)
    for t, got in enumerate(server_lm.round_launches):
        assert got == only(flash_attention=got["flash_attention"],
                           weighted_aggregate=1) \
            and got["flash_attention"] > 0, (t, got)
    k3_launches = read_launches()["flash_attention"]
    emit(phase="lm_k3_shapes", launches_by_shape=sorted(
        ([list(k), n] for k, n in shapes.items()), key=lambda x: -x[1]))
    lm_random, _ = lm_run("random")
    emit(phase="lm_dqs_vs_random", dqs_loss=lm_dqs["loss"],
         random_loss=lm_random["loss"], dqs_acc=lm_dqs["acc"],
         random_acc=lm_random["acc"],
         dqs_malicious_selected=lm_dqs["malicious_selected"],
         random_malicious_selected=lm_random["malicious_selected"])
    emit(phase="round_phases", run="lm", round=3,
         **round_phases(server_lm, 3))
    row = profile_round(server_lm, 4)
    emit(phase="profile_round", run="lm", **row)
    emit(phase="route_host_split", run="lm", **route_host_split(server_lm, 5))
    # every attention forward of the round is K3's: a renamed kernel fails
    assert row["flash_kernel_us"] > 0, row
    (b, h, s_, d), _ = shapes.most_common(1)[0]
    k3_row = check_flash(b, h, s_, s_, d, True, None, torch.float32,
                         "LM path's most launched")

    # the LM path on the GPU and on the CPU, K = 8
    lm_small = {dev: experiment(
        cfg=FeelConfig(n_ues=8, n_malicious=2), scenario="token_flip_1to5",
        task="lm_tiny", n_train=960, n_test=240, rounds=2,
        device=dev)[1].logs for dev in ("cuda", "cpu")}
    for a, b_ in zip(lm_small["cuda"], lm_small["cpu"]):
        assert np.array_equal(a.selected, b_.selected), (a.selected,
                                                         b_.selected)
        assert abs(a.global_loss - b_.global_loss) <= 1e-3, (
            a.global_loss, b_.global_loss)
        assert abs(a.global_acc - b_.global_acc) <= 1e-3, (a.global_acc,
                                                           b_.global_acc)
        emit(phase="cuda_vs_cpu", run="lm_tiny token_flip_1to5",
             round=a.round, loss_cuda=a.global_loss, loss_cpu=b_.global_loss,
             acc_cuda=a.global_acc, acc_cpu=b_.global_acc,
             selected=a.selected.tolist())

    return k3_launches, k3_row


# ---------------------------------------------------------------------- #
# The batched control plane and the multi-run sweep
# ---------------------------------------------------------------------- #
CTRL_K = 50             # the §V cell's UEs
CTRL_ULPS = 4           # the "device" layout's floats against "hybrid"
# Eq. 1's reputations live in [0, 1] and come out of a subtraction whose
# terms (the old reputation, the update) can be far larger than the
# result, so their gap is held to CTRL_ULPS ulp of 1.0, not of the result
REP_TOL = CTRL_ULPS * float(np.spacing(1.0))


def control_instance(seed, r, k, deadline=None):
    """R runs x K UEs of random control state on the card (every policy in
    turn, tests/test_torch_batched_control.py's generator) and one round of
    draws: (state, gains, rand_rank, (w_rep, w_div))."""
    rng = np.random.default_rng(seed)
    cfg = FeelConfig(n_ues=k, **({} if deadline is None
                                 else {"deadline_s": deadline}))
    wms = [WirelessModel(cfg, np.random.default_rng(seed * 100 + i))
           for i in range(r)]
    sizes = (rng.integers(1, 31, (r, k)) * 50).astype(float)
    cpu = rng.uniform(cfg.cpu_hz_min, cfg.cpu_hz_max, (r, k))
    names = list(POLICY_IDS)
    state = ctl.ControlState(
        policy_id=np.array([i % len(names) for i in range(r)], np.int32),
        sizes=sizes, divs=rng.uniform(0, 0.9, (r, k)),
        r_min=np.stack([wms[i].min_rate(wms[i].train_time(sizes[i], cpu[i]))
                        for i in range(r)]),
        reputations=rng.uniform(0, 1, (r, k)),
        ages=rng.integers(1, 6, (r, k)).astype(float), cfg=cfg,
        device=torch.device("cuda"))
    gains = np.stack([wm.draw_channels().gains for wm in wms])
    rand_rank = np.stack([np.argsort(rng.permutation(k)) for _ in range(r)])
    return state, gains, rand_rank, (rng.uniform(0.2, 0.8, r),
                                     rng.uniform(0.2, 0.8, r))


def ulp_gap(a, b):
    """The largest |a - b| in ulps of the larger magnitude (0 where equal)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    gap = np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.where(a == b, 0.0, gap), initial=0.0))


def check_layouts(label, got, want):
    """The "device" layout against "hybrid": integers exact, floats within
    CTRL_ULPS ulp."""
    gaps = {}
    for name, a, b in zip(("x", "alpha", "costs", "values", "forced"),
                          got, want):
        if name in ("alpha", "values"):
            gaps[name] = ulp_gap(a, b)
            assert gaps[name] <= CTRL_ULPS, (label, name, gaps[name])
        else:
            assert np.array_equal(a, b), (label, name)
    return gaps


def with_nan_reputations(state, cells_a_run, seed, crowd=None):
    """A copy of ``state`` whose reputations hold NaN at ``cells_a_run``
    random cells of every run, of both signs and two payloads (the quiet
    NaN and one with low bits set); ``crowd`` = (run, n) also makes n
    cells of that run NaN, so that the NaN keys reach a prefilter's kept
    prefix. A NaN reputation makes the candidate's value and its dqs and
    top_value keys NaN."""
    rng = np.random.default_rng(seed)
    rep = state.reputations.copy()
    r, n = rep.shape
    nans = np.array([np.nan, -np.nan]).view(np.uint64)
    payloads = np.concatenate([nans, nans | np.uint64(0x5A5A)]).view(
        np.float64)
    for i in range(r):
        cols = rng.choice(n, cells_a_run, replace=False)
        rep[i, cols] = payloads[rng.integers(0, 4, cells_a_run)]
    if crowd is not None:
        i, k = crowd
        cols = rng.choice(n, k, replace=False)
        rep[i, cols] = payloads[rng.integers(0, 4, k)]
    return dataclasses.replace(state, reputations=rep)


def card_sort_order():
    """The card's own float64 ``torch.argsort(stable=True)`` against
    numpy's stable argsort, on rows of keys drawn from NaNs of both signs
    and two payloads, +-inf, +-0 and a few numbers, at widths a small and
    a large sort take, and on rows of +-0 ties alone: the rows where the
    raw sort differs are counted (it orders a NaN by its sign bit); the
    argsort of ``scheduler.order_key``, which the "device" layouts sort
    by, must equal numpy's on every row."""
    nans = np.array([np.nan, -np.nan]).view(np.uint64)
    pool = np.concatenate([
        np.concatenate([nans, nans | np.uint64(0x77)]).view(np.float64),
        [np.inf, -np.inf, 0.0, -0.0, 1.5, -1.5, 2.0]])
    for n in (16, 40, 2_048, 100_000):
        rng = np.random.default_rng(n)
        keys = pool[rng.integers(0, len(pool), (6, n))]
        zeros = np.where(rng.random((4, n)) < 0.5, -0.0, 0.0)
        zeros[:, ::5] = 1.0
        rows = {}
        for label, k in (("mixed", keys), ("signed_zeros", zeros)):
            want = np.argsort(k, axis=-1, kind="stable")
            t = torch.from_numpy(k).to("cuda")
            raw = torch.argsort(t, dim=-1, stable=True).cpu().numpy()
            ours = torch.argsort(tsc.order_key(t), dim=-1,
                                 stable=True).cpu().numpy()
            assert np.array_equal(ours, want), (n, label)
            rows[label] = int((raw != want).any(-1).sum())
        emit(phase="card_sort_order", n=n, rows=6, zero_rows=4,
             raw_rows_differing=rows["mixed"],
             signed_zero_rows_differing=rows["signed_zeros"],
             order_key_equals_numpy=True)


def check_nan_layouts(label, got, want):
    """A NaN-key round: selection, alpha, costs and forced equal bit for
    bit; values NaN exactly where NaN, the rest within CTRL_ULPS ulp.
    Returns the values' largest gap in ulps."""
    for name, a, b in zip(("x", "alpha", "costs", "forced"),
                          (got[0], got[1], got[2], got[4]),
                          (want[0], want[1], want[2], want[4])):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), (label,
                                                                    name)
    nan = np.isnan(got[3])
    assert np.array_equal(nan, np.isnan(want[3])), label
    gap = ulp_gap(got[3][~nan], want[3][~nan])
    assert gap <= CTRL_ULPS, (label, gap)
    return gap


def median_ms(fn, reps=15):
    """Median host ms of one call (the call returns host arrays, so it
    ends synchronised)."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def control_layouts():
    """schedule_runs and finalize_runs in both layouts: "device" on the
    card against "hybrid" on the host, on random instances at R = 12 and
    64 runs, K = 50, every policy, and a round where every UE is
    infeasible (integers exact, floats within CTRL_ULPS ulp, reputations
    within REP_TOL); the median ms of a call of each layout; then the
    card's sort order (``card_sort_order``) and two rounds with NaN
    priority keys, "device" equal to "hybrid" (``check_nan_layouts``)."""
    for r in (12, 64):
        gaps = []
        for seed in (0, 1, 2):
            st, gains, rr, om = control_instance(seed, r, CTRL_K)
            gaps.append(check_layouts(
                f"R {r} seed {seed}",
                ctl.schedule_runs(st, gains, rr, *om, kernel="device"),
                ctl.schedule_runs(st, gains, rr, *om, kernel="hybrid")))
        ms = {kern: median_ms(lambda kern=kern: ctl.schedule_runs(
            st, gains, rr, *om, kernel=kern)) for kern in ctl.LAYOUTS}
        # finalize_runs with penalties on every other run
        rng = np.random.default_rng(r)
        n_sel = rng.integers(1, CTRL_K, r)
        sels = [rng.choice(CTRL_K, size=n, replace=False) for n in n_sel]
        acc_l = [rng.uniform(0, 1, n) for n in n_sel]
        acc_t = [rng.uniform(0, 1, n) for n in n_sel]
        pens = [rng.uniform(0, 0.3, n) if i % 2 else None
                for i, n in enumerate(n_sel)]
        after = {}
        for kern in ctl.LAYOUTS:
            s = dataclasses.replace(st, reputations=st.reputations.copy(),
                                    ages=st.ages.copy())
            ctl.finalize_runs(s, sels, acc_l, acc_t, penalties=pens,
                              kernel=kern)
            after[kern] = s
        fin_gap = float(np.max(np.abs(after["device"].reputations
                                      - after["hybrid"].reputations)))
        assert fin_gap <= REP_TOL, fin_gap
        assert np.array_equal(after["device"].ages, after["hybrid"].ages)
        fin_ms = {kern: median_ms(lambda kern=kern: ctl.finalize_runs(
            dataclasses.replace(st), sels, acc_l, acc_t, penalties=pens,
            kernel=kern)) for kern in ctl.LAYOUTS}
        emit(phase="control_layouts", runs=r, ues=CTRL_K,
             schedule_ms=ms, finalize_ms=fin_ms,
             max_ulps={k: max(g[k] for g in gaps) for k in gaps[0]},
             finalize_max_abs_gap=fin_gap)
    st, gains, rr, om = control_instance(3, 12, CTRL_K, deadline=1e-6)
    dev = ctl.schedule_runs(st, gains, rr, *om, kernel="device")
    check_layouts("infeasible", dev,
                  ctl.schedule_runs(st, gains, rr, *om, kernel="hybrid"))
    x, alpha, costs, values, forced = dev
    top = st.policy_id == POLICY_IDS["top_value"]
    assert np.all(costs == CTRL_K + 1) and np.all(forced == ~top), forced
    emit(phase="control_layouts", runs=12, ues=CTRL_K, all_infeasible=True,
         forced=int(forced.sum()))
    # NaN priority keys: NaN reputations of both signs and two payloads in
    # every run (dqs and top_value keys NaN), and a round where every UE
    # is infeasible (the forced rewrite picks the first NaN value)
    card_sort_order()
    nan_cells = 0
    for label, deadline in (("NaN keys", None), ("NaN keys infeasible",
                                                 1e-6)):
        st, gains, rr, om = control_instance(4, 12, CTRL_K,
                                             deadline=deadline)
        st = with_nan_reputations(st, 6, seed=4)
        dev = ctl.schedule_runs(st, gains, rr, *om, kernel="device")
        gap = check_nan_layouts(label, dev, ctl.schedule_runs(
            st, gains, rr, *om, kernel="hybrid"))
        nan_cells = int(np.isnan(st.reputations).sum())
        emit(phase="control_layouts", runs=12, ues=CTRL_K, nan_keys=True,
             case=label, nan_reputations=nan_cells,
             nan_selected=int((dev[0] & np.isnan(dev[3])).sum()),
             forced=int(dev[4].sum()), device_equals_hybrid=True,
             bit_equal=["x", "alpha", "costs", "forced"],
             values_max_ulps=gap)


def sweep_run(**kw):
    """``simulation.run_sweep(**kw)`` with each round timed (ending in a
    GPU synchronise) and its launches read by name. Returns (result, the
    sweep's runs, per-round rows); the row of round ``profile_at`` comes
    from a run under torch.profiler tracing the device alone (a sweep
    round issues ~26,000 device events, and tracing the host's ops too
    took the §V sweep's round on an H100 from 0.85 s to 12.5 s): its
    wall, device busy time and idle share, its wall no timing of the
    round."""
    profile_at = kw.pop("profile_at", None)
    real = simulation._sweep_round_stacked
    seen, rounds = [], []

    def timed(runs, t, sweep_ctrl=None):
        if not seen:
            seen.extend(runs)
        cuda = runs[0].server.device.type == "cuda"
        before = read_launches()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = None
        if t == profile_at:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                real(runs, t, sweep_ctrl)
                torch.cuda.synchronize()
        else:
            real(runs, t, sweep_ctrl)
            if cuda:
                torch.cuda.synchronize()
        row = dict(round=t, wall_ms=(time.perf_counter() - t0) * 1e3,
                   launches={k: v - before[k]
                             for k, v in read_launches().items()},
                   profiled=prof is not None)
        if prof is not None:
            busy_us = sum(device_us(prof).values())
            row.update(device_busy_ms=busy_us / 1e3,
                       device_idle_share=1.0 - busy_us / 1e3
                       / row["wall_ms"],
                       n_device_events=sum(
                           1 for ev in prof.events() if ev.device_type
                           == torch.autograd.DeviceType.CUDA))
        rounds.append(row)

    simulation._sweep_round_stacked = timed
    try:
        res = simulation.run_sweep(**kw)
    finally:
        simulation._sweep_round_stacked = real
    return res, seen, rounds


def hold_against_sequential(label, run, **kw):
    """One sweep run against its own sequential run_experiment on the card
    (host control plane): the same selections in every round, and the
    accuracies and global losses bit for bit (the task plane is
    batch-invariant on the card). Returns the sequential run's round
    ms."""
    out, server = experiment(
        policy=run.policy, seed=run.seed, scenario=run.scenario,
        defense=run.defense, task=run.task, control="host", device="cuda",
        **kw)
    assert len(server.logs) == len(run.server.logs), label
    for a, b in zip(run.server.logs, server.logs):
        assert np.array_equal(a.selected, b.selected), (label, a.round)
    sweep_acc = [l.global_acc for l in run.server.logs]
    sweep_loss = [l.global_loss for l in run.server.logs]
    emit(phase="sweep_vs_sequential", run=label, policy=run.policy,
         seed=run.seed, defense=run.defense.name, sweep_acc=sweep_acc,
         sequential_acc=out["acc"], sweep_loss=sweep_loss,
         sequential_loss=out["loss"], sequential_round_ms=server.round_ms,
         selected=[l.selected.tolist() for l in server.logs])
    assert np.array_equal(sweep_acc, out["acc"]), (label, sweep_acc,
                                                   out["acc"])
    assert np.array_equal(sweep_loss, out["loss"], equal_nan=True), (
        label, sweep_loss, out["loss"])
    return server.round_ms


def sweep_phases():
    """The batched control plane's layouts, then run_sweep on the card:
    the §V cell (12 runs, K1 twelve times a round), a defended sweep (K2
    on every defended run's aggregation), an lm_tiny sweep (K3) and a
    small sweep on the GPU and the CPU. Returns the launches of each."""
    t_phase = time.perf_counter()
    control_layouts()
    emit(phase="control_layouts_seconds",
         seconds=time.perf_counter() - t_phase)

    # the paper's Fig. 3 setting, as examples/poisoning_study.py runs it:
    # four policies x three seeds under the (6, 2) label flip, K = 50,
    # the 5 MB update under which the knapsack binds
    t_phase = time.perf_counter()
    v_cfg = FeelConfig(model_size_bits=5e6 * 8)
    v_kw = dict(cfg=v_cfg, n_train=50_000, n_test=10_000, rounds=3)
    policies = ["dqs", "random", "best_channel", "max_count"]
    reset_launches()
    res, runs, rounds = sweep_run(
        policies=policies, seeds=(0, 1, 2), scenarios=[atk.label_flip(6, 2)],
        device="cuda", profile_at=2, **v_kw)
    launches = {"sweep": read_launches()}
    for row in rounds:
        emit(phase="sweep", **row)
        assert row["launches"] == only(weighted_aggregate=12), row
    assert launches["sweep"] == only(weighted_aggregate=36), launches
    assert len(res.runs) == 12 and all(
        np.isfinite(r["acc"]).all() for r in res.runs)
    seq_ms = [hold_against_sequential(
        f"sweep {r.policy}", r, cfg=v_cfg, n_train=50_000, n_test=10_000,
        rounds=3) for r in runs if r.seed == 0]
    emit(phase="sweep_summary", runs=len(res.runs),
         round_ms=[row["wall_ms"] for row in rounds],
         sequential_seed0_round_ms=np.sum(seq_ms, axis=0).tolist(),
         dqs_acc=res.mean_curve("acc", policy="dqs").tolist(),
         random_acc=res.mean_curve("acc", policy="random").tolist(),
         dqs_malicious_selected=res.mean_curve(
             "malicious_selected", policy="dqs").tolist(),
         seconds=time.perf_counter() - t_phase)

    # defended: sign flip under none / trimmed mean + validation / median
    t_phase = time.perf_counter()
    d_kw = dict(cfg=FeelConfig(), n_train=12_000, n_test=2_000, rounds=2)
    reset_launches()
    res_d, runs_d, rounds_d = sweep_run(
        policies=["dqs", "random"], seeds=(0, 1), scenarios=["sign_flip"],
        defenses=["none", "trimmed_mean+validation", "median"],
        device="cuda", **d_kw)
    launches["sweep_defended"] = read_launches()
    for row in rounds_d:
        emit(phase="sweep_defended", **row)
        assert row["launches"] == only(weighted_aggregate=4,
                                       robust_aggregate=8), row
    assert launches["sweep_defended"] == only(
        weighted_aggregate=8, robust_aggregate=16), launches
    for r in runs_d:
        if ((r.policy, r.seed, r.defense.name)
                in (("dqs", 0, "trimmed_mean+validation"),
                    ("random", 1, "median"))):
            hold_against_sequential(f"sweep_defended {r.defense.name}", r,
                                    **d_kw)
    emit(phase="sweep_defended_summary", runs=len(res_d.runs),
         n_flagged=[sum(r["n_flagged"]) for r in res_d.runs],
         n_rejected=[sum(r["n_rejected"]) for r in res_d.runs],
         seconds=time.perf_counter() - t_phase)

    # lm_tiny: every attention forward of the sweep through K3
    t_phase = time.perf_counter()
    reset_launches()
    lm_kw = dict(cfg=FeelConfig(n_ues=8, n_malicious=2), n_train=960,
                 n_test=240, rounds=2)
    res_lm, runs_lm, rounds_lm = sweep_run(
        policies=["dqs", "random"], seeds=(0,), tasks=["lm_tiny"],
        scenarios=["token_flip_1to5"], device="cuda", **lm_kw)
    launches["sweep_lm"] = read_launches()
    for row in rounds_lm:
        emit(phase="sweep_lm", **row)
        got = row["launches"]
        assert got == only(weighted_aggregate=2,
                           flash_attention=got["flash_attention"]) \
            and got["flash_attention"] > 0, row
    assert all(np.isfinite(r["loss"]).all() for r in res_lm.runs)
    for r in runs_lm:
        hold_against_sequential(f"sweep_lm {r.policy}", r, **lm_kw)
    emit(phase="sweep_lm_summary", loss=[r["loss"] for r in res_lm.runs],
         seconds=time.perf_counter() - t_phase)

    # the same small sweep on the GPU and on the CPU
    t_phase = time.perf_counter()
    small = {dev: sweep_run(policies=["dqs", "random"], seeds=(0, 1),
                            cfg=FeelConfig(n_ues=10, n_malicious=2),
                            n_train=3000, n_test=500, rounds=2, device=dev)
             for dev in ("cuda", "cpu")}
    for a, b in zip(small["cuda"][1], small["cpu"][1]):
        for la, lb in zip(a.server.logs, b.server.logs):
            assert np.array_equal(la.selected, lb.selected), (a.policy,
                                                              la.round)
            assert abs(la.global_acc - lb.global_acc) <= 1e-4, (
                la.global_acc, lb.global_acc)
        emit(phase="sweep_cuda_vs_cpu", policy=a.policy, seed=a.seed,
             acc_cuda=[l.global_acc for l in a.server.logs],
             acc_cpu=[l.global_acc for l in b.server.logs],
             selected=[l.selected.tolist() for l in a.server.logs])
    emit(phase="sweep_cuda_vs_cpu_seconds",
         seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------- #
# The population plane and the async plane
# ---------------------------------------------------------------------- #
# the timed rounds a size: two, one of each order on the mesh, for the
# script's time limit (the host layouts take seconds a round at 10^6)
POP_K, POP_RUNS, POP_ROUNDS = 64, 5, 2
POP_NS = (10_000, 100_000, 1_000_000)
POP_PATHS = ("exact_device", "prefilter_device", "prefilter_hybrid",
             "exact_hybrid")


def population_instance(n):
    """benchmarks/bench_round.py's population instance (its population
    worker): R = 5 runs cycling the five policies, K = 64, N candidates,
    ages 1, the state on the card; and its per-round draw of every run's
    gains and random-policy ranks. Returns (state, omega, draw)."""
    cfg = FeelConfig(n_ues=POP_K, n_malicious=max(POP_K // 10, 1),
                     population=n)
    rng = np.random.default_rng(0)
    wm = WirelessModel(cfg, np.random.default_rng(1))
    r = POP_RUNS
    sizes = (rng.integers(1, 31, (r, n)) * 50).astype(float)
    cpu = rng.uniform(cfg.cpu_hz_min, cfg.cpu_hz_max, (r, n))
    state = ctl.ControlState(
        policy_id=np.array([i % len(POLICY_IDS) for i in range(r)],
                           np.int32),
        sizes=sizes, divs=rng.uniform(0.0, 0.9, (r, n)),
        r_min=np.stack([wm.min_rate(wm.train_time(sizes[i], cpu[i]))
                        for i in range(r)]),
        reputations=rng.uniform(0.0, 1.0, (r, n)),
        ages=np.ones((r, n)), cfg=cfg, device=torch.device("cuda"))
    omega = (np.full(r, cfg.omega_rep), np.full(r, cfg.omega_div))

    def draw(t):
        g = np.stack([wm.rng.exponential(1.0, n)
                      * wm.distances ** (-cfg.pathloss_exp)
                      for _ in range(r)])
        rr = np.stack([np.argsort(np.random.default_rng((t, i))
                                  .permutation(n)) for i in range(r)])
        return g, rr

    return state, omega, draw


class WalkSteps:
    """Counts the budget walk's steps: a ``pack_scan`` call (the scheduler's,
    imported by name into the control plane and the prefilter) ends after
    the most takes of a row + 1 steps."""
    MODULES = (tsc, ctl, tpop)

    def __init__(self):
        self.steps = []

    def __enter__(self):
        real = self._real = tsc.pack_scan

        def counted(c, k):
            take = real(c, k)
            self.steps.append(int(take.sum(-1).max()) + 1)
            return take

        for mod in self.MODULES:
            mod.pack_scan = counted
        return self

    def __exit__(self, *exc):
        for mod in self.MODULES:
            mod.pack_scan = self._real


def population_round(state, g, rr, omega, m=None):
    """One round of every path: (outputs by path, ms by path, info by
    prefilter layout, walk steps by path)."""
    outs, ms, info, steps = {}, {}, {}, {}
    for path in POP_PATHS:
        kern = path.split("_")[1]
        with WalkSteps() as ws:
            t0 = time.perf_counter()
            if path.startswith("exact"):
                out = ctl.schedule_runs(state, g, rr, *omega, kernel=kern)
            else:
                *out, info[kern] = tpop.prefilter_schedule_runs(
                    state, g, rr, *omega, m=m, kernel=kern)
            ms[path] = (time.perf_counter() - t0) * 1e3
        outs[path], steps[path] = out, ws.steps
    return outs, ms, info, steps


def n_step_walk(c_sorted, k):
    """The budget walk ``scheduler.pack_scan`` replaced: the remaining
    budget carried through every sorted position, N steps of 4 launches
    (tests/test_torch_population.py keeps it as its oracle)."""
    budget = torch.full(c_sorted.shape[:-1], k, dtype=c_sorted.dtype,
                        device=c_sorted.device)
    takes = []
    for c in c_sorted.unbind(-1):
        take = (c <= k) & (c <= budget)
        budget = budget - torch.where(take, c, 0)
        takes.append(take)
    return torch.stack(takes, -1)


def walk_ab():
    """The budget walk on the card, the N-step walk against
    ``pack_scan``, in turns (N-step, pack_scan, pack_scan, N-step): Eq. 9
    costs of ``control_layouts``' instances (K = 50, R = 12 and 64) and of
    the population grid at N = 10^4 (R = 5, K = 64), in a random visit
    order; the same take mask, the median ms of a call of each."""
    cases = []
    for r in (12, 64):
        st, gains, _, _ = control_instance(0, r, CTRL_K)
        cases.append((f"K {CTRL_K}, R {r}", CTRL_K, st.r_min, gains))
    state, _, draw = population_instance(POP_NS[0])
    cases.append((f"K {POP_K}, R {POP_RUNS}, N {POP_NS[0]}", POP_K,
                  state.r_min, draw(0)[0]))
    for label, k, r_min, gains in cases:
        cfg = FeelConfig(n_ues=k)
        dev = torch.device("cuda")
        costs = cost_bisect(
            torch.as_tensor(gains, device=dev),
            torch.as_tensor(r_min, device=dev), k, cfg.bandwidth_hz,
            cfg.p_watt, cfg.n0_watt_hz)
        order = torch.argsort(torch.rand(
            costs.shape, generator=torch.Generator(dev).manual_seed(0),
            device=dev), dim=-1)
        c = costs.gather(-1, order)
        assert torch.equal(tsc.pack_scan(c, k), n_step_walk(c, k)), label
        reps = 3 if c.shape[-1] > 1000 else 15
        ms = {"n_step": [], "pack_scan": []}
        for name in ("n_step", "pack_scan", "pack_scan", "n_step"):
            fn = n_step_walk if name == "n_step" else tsc.pack_scan
            ms[name].append(median_ms(
                lambda fn=fn: (fn(c, k), torch.cuda.synchronize()), reps))
        emit(phase="walk_ab", case=label, width=int(c.shape[-1]),
             most_takes=int(tsc.pack_scan(c, k).sum(-1).max()),
             ms={name: v for name, v in ms.items()})


def check_population_round(label, outs, info):
    """The prefilter on the card against the exact schedule on the card
    (every output bit for bit) and against both layouts on the host
    (integers exact, floats within CTRL_ULPS ulp); the two prefilter
    layouts escalate the same number of rows."""
    got = outs["prefilter_device"]
    for name, a, b in zip(("x", "alpha", "costs", "values", "forced"),
                          got, outs["exact_device"]):
        assert np.array_equal(a, b), (label, name)
    gaps = {path: check_layouts(f"{label} {path}", got, outs[path])
            for path in ("prefilter_hybrid", "exact_hybrid")}
    assert info["device"] == info["hybrid"], (label, info)
    return gaps


def population_control():
    """Phase (a): the budget walk old and new (``walk_ab``), then the
    prefilter at the reference bench's grid (R = 5,
    K = 64, N = 10^4, 10^5, 10^6), held round by round against the exact
    schedule on the card and both layouts on the host; ms a round of each
    path, M, the escalations, the walk's steps, the state's bytes and the
    peak device memory; a round with NaN keys (``population_nan_keys``);
    then one round at N = 10^6 forced to escalate (M = min_selected)."""
    walk_ab()
    for n in POP_NS:
        state, omega, draw = population_instance(n)
        torch.cuda.reset_peak_memory_stats()
        g, rr = draw(0)                  # warm-up round, checked
        outs, _, info, _ = population_round(state, g, rr, omega)
        check_population_round(f"N {n} warm-up", outs, info)
        rows = []
        for t in range(POP_ROUNDS):
            g, rr = draw(t + 1)
            outs, ms, info, steps = population_round(state, g, rr, omega)
            gaps = check_population_round(f"N {n} round {t}", outs, info)
            rows.append(ms)
            emit(phase="population_round", n=n, round=t, ms=ms,
                 m=info["device"]["m"],
                 n_escalated=info["device"]["n_escalated"],
                 walk_steps=steps, max_ulps=gaps,
                 forced=int(outs["exact_device"][4].sum()),
                 n_selected=outs["exact_device"][0].sum(-1).tolist())
        emit(phase="population_control", n=n, runs=POP_RUNS, ues=POP_K,
             ms_a_round={p: float(np.mean([r[p] for r in rows]))
                         for p in POP_PATHS},
             state_bytes=tpop.PopulationState.from_control(state).nbytes(),
             peak_device_bytes=torch.cuda.max_memory_allocated())
    # where a round on the card goes at N = 10^6: each "device" path once
    # more, the device traced alone
    for kern, fn in (("exact_device", lambda: ctl.schedule_runs(
            state, g, rr, *omega, kernel="device")),
                     ("prefilter_device", lambda: tpop.prefilter_schedule_runs(
                         state, g, rr, *omega, kernel="device"))):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = device_events(prof)
        busy_us = sum(us for us, _ in events.values())
        copy_us = sum(us for name, (us, _) in events.items()
                      if name.startswith("Memcpy"))
        top = sorted(events.items(), key=lambda kv: -kv[1][0])[:6]
        emit(phase="population_profile", n=POP_NS[-1], path=kern,
             wall_us=wall_us, device_busy_us=busy_us, memcpy_us=copy_us,
             device_idle_share=1.0 - busy_us / wall_us,
             n_device_events=sum(c for _, c in events.values()),
             top_us=[[name[:60], us, c] for name, (us, c) in top])
    population_nan_keys()
    # N = 10^6 at M = min_selected: the certificate fails, the rows
    # escalate to the exact schedule on the card
    m = state.cfg.min_selected
    outs, ms, info, steps = population_round(state, g, rr, omega, m=m)
    check_population_round("forced escalation", outs, info)
    assert info["device"]["n_escalated"] > 0, info
    emit(phase="population_forced_escalation", n=POP_NS[-1], m=m, ms=ms,
         n_escalated=info["device"]["n_escalated"], walk_steps=steps)


def population_nan_keys():
    """One round at N = 10^4 with NaN reputations of both signs and two
    payloads (20 cells a run, and all but 300 of the dqs run's, so that
    its NaN keys fill the kept prefix past its 300 numbers): the
    prefilter on the card equal to the exact schedule on the card bit for
    bit (NaN values by their bits), and the "device" layouts equal to
    the "hybrid" ones (``check_nan_layouts``), the same escalations."""
    n = POP_NS[0]
    state, omega, draw = population_instance(n)
    state = with_nan_reputations(state, 20, seed=5, crowd=(0, n - 300))
    g, rr = draw(0)
    outs, ms, info, _ = population_round(state, g, rr, omega)
    got, exact = outs["prefilter_device"], outs["exact_device"]
    for name, a, b in zip(("x", "alpha", "costs", "values", "forced"),
                          got, exact):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    gaps = {"prefilter": check_nan_layouts(
        "population NaN keys prefilter", got, outs["prefilter_hybrid"]),
        "exact": check_nan_layouts("population NaN keys exact", exact,
                                   outs["exact_hybrid"])}
    assert info["device"] == info["hybrid"], info
    m = info["device"]["m"]
    assert 300 < m          # the dqs run's NaN keys reach the prefix
    emit(phase="population_control", n=n, runs=POP_RUNS, ues=POP_K,
         nan_keys=True, nan_reputations=int(np.isnan(
             state.reputations).sum()), m=m,
         n_escalated=info["device"]["n_escalated"],
         nan_selected=int((exact[0] & np.isnan(exact[3])).sum()),
         device_equals_hybrid=True, prefilter_equals_exact=True,
         bit_equal=["x", "alpha", "costs", "forced"],
         values_max_ulps=gaps, ms=ms)


def curves_equal(a, b, fields):
    """NaN-aware equality of result curves."""
    return {f: bool(np.array_equal(np.asarray(a[f], float),
                                   np.asarray(b[f], float), equal_nan=True))
            for f in fields}


V_KW = dict(n_train=50_000, n_test=10_000, rounds=3, device="cuda")
CURVES = ("acc", "loss", "source_acc", "attack_success",
          "malicious_selected", "objective", "rep_gap")


def population_end_to_end():
    """Phase (b): the population cut through run_experiment and run_sweep
    at the §V scale, K1 once a round a run."""
    # N = 500 candidates, DQS on the card's prefilter, against the same
    # run on the host control plane
    runs = {}
    for control in ("batched", "host"):
        reset_launches()
        out, server = experiment(policy="dqs", seed=0, population=500,
                                 control=control, **V_KW)
        runs[control] = (out, server, read_launches())
    (out, server, launches), (_, host, _) = runs["batched"], runs["host"]
    assert launches == only(weighted_aggregate=3), launches
    for a, b in zip(server.logs, host.logs):
        assert np.array_equal(a.selected, b.selected), a.round
    assert np.isfinite(out["acc"]).all(), out["acc"]
    emit(phase="population_run", population=500, round_ms=server.round_ms,
         host_round_ms=host.round_ms, acc=out["acc"],
         n_selected=[int(l.selected.size) for l in server.logs],
         malicious_selected=out["malicious_selected"], launches=launches)
    # N == K is the paper's regime, curve for curve
    legacy = {p: simulation.run_experiment(policy="dqs", seed=0,
                                           population=p, **V_KW)
              for p in (50, None)}
    same = curves_equal(legacy[50], legacy[None], CURVES)
    assert all(same.values()), same
    emit(phase="population_equal_k", equal=same)
    # the sweep: four policies at seed 0 over N = 500, each run against its
    # sequential run
    reset_launches()
    res, sweep, rounds = sweep_run(
        policies=["dqs", "random", "best_channel", "max_count"], seeds=(0,),
        population=500, cfg=FeelConfig(), n_train=50_000, n_test=10_000,
        rounds=3, device="cuda")
    for row in rounds:
        emit(phase="population_sweep", **row)
        assert row["launches"] == only(weighted_aggregate=4), row
    for r in sweep:
        hold_against_sequential(f"population sweep {r.policy}", r,
                                population=500, cfg=FeelConfig(),
                                n_train=50_000, n_test=10_000, rounds=3)


class TimedEngine(AsyncFeelEngine):
    """An AsyncFeelEngine that records each aggregation's wall time since
    the previous one (ending in a GPU synchronise) and its launches, and
    itself."""
    made = []

    def __init__(self, server):
        super().__init__(server)
        self.agg_ms, self.agg_launches = [], []
        self._t0, self._before = time.perf_counter(), read_launches()
        TimedEngine.made.append(self)

    def _aggregate(self, trigger):
        log = super()._aggregate(trigger)
        torch.cuda.synchronize()
        now, launches = time.perf_counter(), read_launches()
        self.agg_ms.append((now - self._t0) * 1e3)
        self.agg_launches.append({k: v - self._before[k]
                                  for k, v in launches.items()})
        self._t0, self._before = now, launches
        return log


@contextlib.contextmanager
def timed_engine():
    real, simulation.AsyncFeelEngine = (simulation.AsyncFeelEngine,
                                        TimedEngine)
    try:
        yield
    finally:
        simulation.AsyncFeelEngine = real


def async_run(label, cfg, expect, **kw):
    """One async run through run_experiment on the card, every launch count
    set to 0 just before and read just after; each aggregation must launch
    ``expect``. Returns (result, engine)."""
    reset_launches()
    with timed_engine():
        out = simulation.run_experiment(cfg=cfg, device="cuda", **kw)
    eng = TimedEngine.made[-1]
    launches = read_launches()
    for row in eng.agg_launches:
        assert row == expect, (label, row)
    emit(phase="async_run", run=label, agg_ms=eng.agg_ms,
         launches=launches, acc=out["acc"], sim_time=out["sim_time"],
         trigger=out["trigger"], n_uploads=out["n_uploads"],
         mean_age=out["mean_age"])
    return out, eng


ZERO_LATENCY = dict(mode="async", async_buffer=None, async_deadline=None,
                    async_latency_scale=0.0)
PARITY = ("acc", "loss", "rep_gap", "objective", "malicious_selected")


def async_phases():
    """Phase (c): the async plane at the §V scale. Returns the CLI run's
    result and wall ms (the untraced twin of the obs phase's CLI run)."""
    k1 = only(weighted_aggregate=1)
    # zero-latency wave triggers reproduce the sync runs, both planes
    for control in ("batched", "host"):
        sync = simulation.run_experiment(policy="dqs", seed=0,
                                         control=control, **V_KW)
        kw = {k: v for k, v in V_KW.items() if k != "device"}
        azero, _ = async_run(f"zero latency, {control}",
                             FeelConfig(**ZERO_LATENCY), k1, policy="dqs",
                             seed=0, control=control, **kw)
        same = curves_equal(sync, azero, PARITY)
        assert all(same.values()), (control, same)
        assert azero["trigger"] == ["wave"] * 3, azero["trigger"]
        emit(phase="async_zero_latency_parity", control=control, equal=same)
    # the CLI's documented run
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with timed_engine(), contextlib.redirect_stdout(buf):
        rc = serve.main(["--rounds", "8", "--buffer", "4", "--scenario",
                         "stale_rider_2", "--defense", "validation",
                         "--json"])
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert rc == 0, rc
    res, eng = json.loads(buf.getvalue()), TimedEngine.made[-1]
    assert read_launches() == only(weighted_aggregate=8), read_launches()
    assert len(res["acc"]) == 8 and np.isfinite(res["acc"]).all()
    emit(phase="async_cli", argv="--rounds 8 --buffer 4 --scenario "
         "stale_rider_2 --defense validation", sim_time=res["sim_time"],
         trigger=res["trigger"], n_uploads=res["n_uploads"],
         mean_age=res["mean_age"], acc=res["acc"], agg_ms=eng.agg_ms,
         wall_ms=wall_ms)
    # a deadline shorter than the wave's spread of latencies
    out, _ = async_run("deadline 30 s",
                       FeelConfig(mode="async", async_deadline=30.0), k1,
                       scenario="flip_6to2", n_train=50_000, n_test=10_000,
                       rounds=3)
    assert "deadline" in out["trigger"], out["trigger"]
    # a robust aggregator: K2 once an aggregation, K1 never
    async_run("trimmed_mean", FeelConfig(mode="async"),
              only(robust_aggregate=1), scenario="sign_flip",
              defense="trimmed_mean", n_train=50_000, n_test=10_000,
              rounds=3)
    # lm_tiny at zero latency: K3 every aggregation, equal to its sync twin
    lm_kw = dict(task="lm_tiny", scenario="token_flip_1to5", n_train=960,
                 n_test=240, rounds=2, seed=0)
    lm_cfg = dict(n_ues=8, n_malicious=2)
    reset_launches()
    sync = simulation.run_experiment(cfg=FeelConfig(**lm_cfg),
                                     device="cuda", **lm_kw)
    reset_launches()
    with timed_engine():
        azero = simulation.run_experiment(
            cfg=FeelConfig(**lm_cfg, **ZERO_LATENCY), device="cuda",
            **lm_kw)
    eng = TimedEngine.made[-1]
    for row in eng.agg_launches:
        assert (row["weighted_aggregate"] == 1 and row["flash_attention"] > 0
                and row == only(weighted_aggregate=1,
                                flash_attention=row["flash_attention"])), row
    same = curves_equal(sync, azero, PARITY)
    assert all(same.values()), same
    emit(phase="async_lm_zero_latency", equal=same, loss=azero["loss"],
         agg_launches=eng.agg_launches, agg_ms=eng.agg_ms)
    # the same small async run on the GPU and on the CPU
    small_cfg = FeelConfig(n_ues=10, n_malicious=2, mode="async",
                           async_buffer=3)
    small = {dev: experiment(cfg=small_cfg, scenario="flip_6to2",
                             n_train=3000, n_test=500, rounds=3, device=dev)
             for dev in ("cuda", "cpu")}
    (a, sa), (b, sb) = small["cuda"], small["cpu"]
    for la, lb in zip(sa.logs, sb.logs):
        assert np.array_equal(la.selected, lb.selected), la.round
    for f in ("trigger", "n_uploads", "mean_age", "sim_time"):
        assert a[f] == b[f], (f, a[f], b[f])
    assert np.allclose(a["acc"], b["acc"], rtol=0, atol=1e-2), (a["acc"],
                                                                b["acc"])
    emit(phase="async_cuda_vs_cpu", acc_cuda=a["acc"], acc_cpu=b["acc"],
         trigger=a["trigger"], mean_age=a["mean_age"],
         selected=[l.selected.tolist() for l in sa.logs])
    return res, wall_ms


def population_async_phases():
    """The population plane (a, b) and the async plane (c), each timed.
    The servers and engines these phases record are let go at the end, so
    that the serving phases' peak memory counts no FEEL run's tensors.
    Returns what ``async_phases`` returns."""
    n_servers = len(TimedServer.made)
    for name, fn in (("population_control", population_control),
                     ("population_end_to_end", population_end_to_end),
                     ("async", async_phases)):
        t0 = time.perf_counter()
        out = fn()
        emit(phase=f"{name}_seconds", seconds=time.perf_counter() - t0)
    release_runs(n_servers)
    return out


def release_runs(n_servers):
    """Let go of the servers recorded since ``n_servers`` and every engine,
    and of their tensors on the card."""
    del TimedServer.made[n_servers:]
    TimedEngine.made.clear()
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# The observability plane
# ---------------------------------------------------------------------- #
OBS_DIR = build.BUILD_DIR.parent / "obs_traces"


def traced_main_path(traced, rounds=2):
    """The §V main path (``quickstart``: K = 50, 50,000/10,000, DQS, host
    control) with the tracer on or off: ``rounds`` rounds under
    ``profile_fn`` with every launch count set to 0 just before and read
    just after. Returns a namespace: the server, the launches, the profile
    row, the params after the rounds and the next round's index."""
    server = quickstart(50, 5, 50_000, 10_000, "cuda")
    trace.configure(enabled=traced)
    try:
        reset_launches()
        _, prof = profile_fn(lambda: [server.run_round(t)
                                      for t in range(rounds)])
        launches = read_launches()
        params = {k: v.clone() for k, v in server.params.items()}
    finally:
        trace.configure(enabled=False)
    return types.SimpleNamespace(server=server, launches=launches,
                                 prof=prof, params=params, next_round=rounds)


def rounds_in_turns(off, on, turns=2):
    """Round walls of the untraced and the traced server, one round at a
    time in turns (off, on, on, off, ...), each ending in a synchronise
    (the order of two runs moves a wall more than tracing does), and the
    traced rounds' spans and JSONL trace: (walls off, walls on, spans,
    path)."""
    walls = {False: [], True: []}
    trace.configure(enabled=False)
    try:
        for traced in (False, True, True, False) * turns:
            run = on if traced else off
            trace.configure(enabled=traced, reset=False)
            t0 = time.perf_counter()
            run.server.run_round(run.next_round)
            torch.cuda.synchronize()
            walls[traced].append((time.perf_counter() - t0) * 1e3)
            run.next_round += 1
        trace.configure(enabled=False, reset=False)
        spans = list(trace.tracer().spans)
        path = trace.flush_jsonl(str(OBS_DIR / "main_path.jsonl"))
    finally:
        trace.configure(enabled=False)
    return walls[False], walls[True], spans, path


def span_cost_us(n=20_000):
    """Host µs of one enabled span with two attributes, the mean of n."""
    trace.configure(enabled=True)
    try:
        t0 = time.perf_counter()
        for i in range(n):
            with trace.span("probe") as sp:
                sp.set(t=i, n=2)
        return (time.perf_counter() - t0) / n * 1e6
    finally:
        trace.configure(enabled=False)


def check_nesting(spans):
    """Span dicts from ``load_jsonl`` nest: each child's parent was kept,
    one level up, and its interval holds the child's."""
    by_sid = {s["sid"]: s for s in spans}
    for s in spans:
        assert s["t1"] >= s["t0"], s
        if s["parent"] == -1:
            assert s["depth"] == 0, s
            continue
        p = by_sid[s["parent"]]
        assert p["depth"] == s["depth"] - 1, (p, s)
        assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"], (p, s)


def obs_phases(out_a, server_a, cli_untraced):
    """The observability plane on the card, each traced run beside its
    untraced twin: the §V main path (equal selections, bit-equal params,
    K1 twice in 2 rounds, the same host waits under the profiler; its
    phase summary and the schedule and train phases on the H100's
    roofline), defended run (a) (its defense spans, K2 three times, the
    untraced run's selections) and the serve CLI's documented run with
    ``--trace`` (the untraced run's result, both clocks on every span of
    the event loop, well-formed nesting, the report CLI exits 0)."""
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    n_servers = len(TimedServer.made)
    off, on = traced_main_path(False), traced_main_path(True)
    untraced_ms, traced_ms, spans, path = rounds_in_turns(off, on)
    for a, b in zip(off.server.logs, on.server.logs, strict=True):
        assert np.array_equal(a.selected, b.selected), a.round
        assert a.global_acc == b.global_acc, (a.round, a.global_acc,
                                              b.global_acc)
    for snap_off, snap_on in ((off.params, on.params),
                              (off.server.params, on.server.params)):
        for k in snap_off:
            assert torch.equal(snap_off[k], snap_on[k]), k
    assert off.launches == on.launches == only(weighted_aggregate=2), (
        off.launches, on.launches)
    assert off.prof["host_waits"] == on.prof["host_waits"], (
        off.prof["host_waits"], on.prof["host_waits"])
    per_span_us = span_cost_us()
    spans_a_round = len(spans) / len(traced_ms)
    emit(phase="obs_main_path", rounds=2, spans=len(spans),
         host_waits=on.prof["host_waits"],
         profiled_wall_us_untraced=off.prof["wall_us"],
         profiled_wall_us_traced=on.prof["wall_us"],
         device_busy_us_untraced=off.prof["device_busy_us"],
         device_busy_us_traced=on.prof["device_busy_us"],
         round_ms_in_turns_untraced=untraced_ms,
         round_ms_in_turns_traced=traced_ms,
         median_round_ms_untraced=float(np.median(untraced_ms)),
         median_round_ms_traced=float(np.median(traced_ms)),
         span_cost_us=per_span_us, spans_a_round=spans_a_round,
         span_ms_a_round=spans_a_round * per_span_us / 1e3,
         launches=on.launches)
    emit(phase="obs_phase_summary", **trace.phase_summary(spans))
    rep = obs_report.summarize(path)
    assert {"schedule", "train"} <= set(rep["roofline"]), rep["roofline"]
    emit(phase="obs_roofline", **{k: rep["roofline"][k]
                                  for k in ("schedule", "train")})

    # defended run (a), traced
    trace.configure(enabled=True)
    try:
        out, server = defended_run("a, traced", scenario="sign_flip",
                                   defense="trimmed_mean+validation")
        names = collections.Counter(s.name for s in trace.tracer().spans)
        snap = trace.tracer().metrics.snapshot()
    finally:
        trace.configure(enabled=False)
    for name in ("defense.aggregate", "defense.detect", "eval.validation"):
        assert names[name] == 3, (name, names)
    assert snap["gauges"]["launches.robust_aggregate"]["value"] == 3.0, snap
    for a, b in zip(server_a.logs, server.logs):
        assert np.array_equal(a.selected, b.selected), a.round
    emit(phase="obs_defended", run="a", spans=dict(names),
         round_ms_untraced=server_a.round_ms[:3],
         round_ms_traced=server.round_ms, acc_untraced=out_a["acc"],
         acc_traced=out["acc"])

    # the serve CLI's documented run, traced, and its report
    path = OBS_DIR / "serve.jsonl"
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with timed_engine(), contextlib.redirect_stdout(buf):
            rc = serve.main(["--rounds", "8", "--buffer", "4", "--scenario",
                             "stale_rider_2", "--defense", "validation",
                             "--trace", str(path), "--json"])
    finally:
        trace.configure(enabled=False)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert rc == 0, rc
    assert read_launches() == only(weighted_aggregate=8), read_launches()
    res, (res_untraced, wall_ms_untraced) = json.loads(buf.getvalue()), \
        cli_untraced
    # as JSON text, so that the NaN curves (MNIST has no loss) compare
    assert json.dumps(res) == json.dumps(res_untraced), (res, res_untraced)
    meta, spans, metrics = trace.load_jsonl(str(path))
    assert meta["gpu"] == torch.cuda.get_device_name(0), meta
    check_nesting(spans)
    for s in spans:
        if s["name"] != "experiment":
            assert s["sim_t0"] <= s["sim_t1"], s
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                             / "src")})
    assert rep.returncode == 0, rep.stderr[-2000:]
    emit(phase="obs_serve_cli", spans=len(spans), wall_ms_untraced=
         wall_ms_untraced, wall_ms_traced=wall_ms,
         agg_ms_traced=TimedEngine.made[-1].agg_ms,
         sim_time=res["sim_time"], report=[
             line for line in rep.stdout.splitlines()
             if line.startswith(("phase,", "async.", "roofline,"))])
    release_runs(n_servers)


# ---------------------------------------------------------------------- #
# Serving the decoder-only zoo
# ---------------------------------------------------------------------- #
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
N_COMPARED = 8          # decode steps whose greedy tokens are compared
# check 1: max|Δ logit| over max|plain logit|, and a near tie in bf16 ulps
# of the top logit; the sound runs read at most 0.032 and 4 ulps, the
# negative controls at least 0.70 and 107 ulps (PERF.md; H100 80GB HBM3,
# 700 W)
LOGIT_TOL = 0.06
TIE_ULPS = 8
# check 1 of the MoE path: every MoE layer's output with K5 against the
# same layer with K5's plain version on the same input, max|Δ| over
# max|plain|; the sound calls read at most 0.0108, the negative control's
# at least 0.967 (PERF.md; H100 80GB HBM3, 700 W)
MOE_LAYER_TOL = 0.05


def prompts(cfg, b, s, seed=0):
    """b prompts of s tokens on the card: consecutive windows of the port's
    token stream (``data/tokens.make_stream``) over the config's
    vocabulary."""
    stream = make_stream(b * s, cfg.vocab_size, seed=seed)
    return torch.from_numpy(stream.astype(np.int64).reshape(b, s)).cuda()


def _k4_control(q, k, v, n):
    """K4's plain version with the wrong GQA grouping: query head h reads
    KV head h % Hkv instead of h // G."""
    g = q.shape[1] // k.shape[2]
    return k4.decode_attention_ref(q, k.repeat(1, 1, g, 1),
                                   v.repeat(1, 1, g, 1), n)


def _k6_control(x, dt, A, B_, C_, q, s0, cdt=None):
    """K6's plain version with the inter-chunk term dropped: every chunk
    starts from the initial state instead of the one carried from the
    chunk before."""
    ys, state = [], s0
    for c in range(0, x.shape[1], q):
        sl = slice(c, c + q)
        y, state = k6.ssd_scan_ref(x[:, sl], dt[:, sl], A, B_[:, sl],
                                   C_[:, sl], chunk=q, initial_state=s0)
        ys.append(y)
    return torch.cat(ys, 1), state


def _k5_control(x, w):
    """K5's plain version with the experts' weights rolled by one along E:
    expert e's slots meet expert e - 1's weights."""
    return k5.moe_gemm_ref(x, w.roll(1, 0))


@contextlib.contextmanager
def plain_route(module, control=False):
    """Within the block, the wrapper of ``module`` (K3, K4, K5 or K6) runs
    its plain version on CUDA tensors, for check 1 of the serving phases;
    with ``control``, a deliberately wrong one (K3's causal at every call,
    ``_k4_control``, ``_k5_control``, ``_k6_control``), the negative
    control that check 1 must reject. Nothing else in the script or the
    port routes a CUDA tensor so."""
    real = module._kernel
    if module is k3:
        module._kernel = lambda q, k, v, causal, window, scale: (
            k3.flash_attention_ref(q, k, v, causal=causal or control,
                                   window=window, scale=scale))
    elif module is k4:
        module._kernel = _k4_control if control else (
            lambda q, k, v, n: k4.decode_attention_ref(q, k, v, n))
    elif module is k5:
        module._kernel = _k5_control if control else k5.moe_gemm_ref
    else:
        module._kernel = _k6_control if control else (
            lambda x, dt, A, B_, C_, q, s0, cdt: k6._plain(
                x, dt, A, B_, C_, q, s0, cdt))
    try:
        yield
    finally:
        module._kernel = real


def profile_fn(fn, keep_prof=False, settle_s=0.0):
    """``fn()`` once under torch.profiler: (its result, wall us, device
    busy us, K5's device us, idle share, device events, top kernels by
    device time, and
    with ``keep_prof`` the profile itself under "prof"). With
    ``settle_s`` the profiler runs that long, after one marker-free
    kernel, before ``fn`` starts and the wall clock with it: kernels
    launched just after the profiler starts have been seen to go
    unrecorded."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        if settle_s:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            time.sleep(settle_s)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = device_us(prof)
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # host calls that wait for the card (a synchronise, a blocking copy, a
    # tensor read into a Python number); the closing synchronise above and
    # the profiler's own are two of them
    waits = collections.Counter(
        ev.name for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CPU
        and ("Synchronize" in ev.name or ev.name in (
            "cudaMemcpy", "aten::item", "aten::_local_scalar_dense")))
    row = dict(wall_us=wall_us, device_busy_us=busy_us,
               moe_gemm_us=sum(us for name, us in by_kernel.items()
                               if "moe_gemm" in name),
               host_waits=dict(waits),
               device_idle_share=1.0 - busy_us / wall_us,
               n_device_events=sum(
                   1 for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
               top_kernels_us=[[k[:80], v] for k, v in top])
    if keep_prof:
        row["prof"] = prof
    return out, row


def greedy_decode(decode, params, cache, first, n, profile_at=None):
    """n greedy decode steps from ``cache`` starting with token ``first``
    (B, 1): (the tokens fed (B, n), the logits (n, B, V), each step's ms —
    host clock ending in a synchronise — the profile of step
    ``profile_at``, whose time is left out of the list, and the cache)."""
    tok, fed, logits_all, step_ms, prof = first, [], [], [], None
    for i in range(n):
        fed.append(tok)
        if i == profile_at:
            (logits, cache), prof = profile_fn(
                lambda: decode(params, cache, tok))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, tok)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        logits_all.append(logits)
        tok = logits.argmax(-1)[:, None]
    return torch.cat(fed, 1), torch.stack(logits_all), step_ms, prof, cache


def forced_decode(decode, params, cache, fed):
    """Decode the tokens ``fed`` (B, n) one step each: the logits (n, B,
    V)."""
    out = []
    for i in range(fed.shape[1]):
        logits, cache = decode(params, cache, fed[:, i:i + 1])
        out.append(logits)
    return torch.stack(out)


def logit_gap(label, got, want, phase="plain_check", tol=LOGIT_TOL):
    """The logits (n, B, V) of a run against the plain run's: max|Δ|, as
    a share of max|plain| too, and the root-mean-square Δ over that of the
    plain logits; and the greedy tokens of the first ``N_COMPARED`` steps,
    where a differing token is a near tie if the plain run's token is
    within ``TIE_ULPS`` bf16 ulps of the run's top logit. Emits the row
    and returns it."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    diff = got - want
    err = diff.abs().max().item()
    tk, tp = got.argmax(-1)[:N_COMPARED], want.argmax(-1)[:N_COMPARED]
    top = got[:N_COMPARED].max(-1).values
    at_plain = got[:N_COMPARED].gather(-1, tp[..., None])[..., 0]
    ulp = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
    gap_ulps = (top - at_plain) / ulp
    differ = tk != tp
    tie = gap_ulps <= TIE_ULPS
    row = dict(phase=phase, run=label, max_abs_err=err,
               rel_max_err=err / scale,
               rel_rms_err=(diff.norm() / want.norm()).item(),
               max_abs_logit=scale, tol=tol * scale,
               tokens_compared=tk.numel(),
               tokens_equal=int((~differ).sum()),
               near_ties=int((differ & tie).sum()),
               tokens_differ_outside_tie=int((differ & ~tie).sum()),
               max_gap_ulps_of_differing=gap_ulps[differ].max().item()
               if bool(differ.any()) else 0.0)
    emit(**row)
    return row


def check1_passes(row):
    """Check 1 of a serving phase: max|Δ| <= ``LOGIT_TOL``·max|plain| and
    no greedy token differs outside a near tie."""
    return (row["max_abs_err"] <= row["tol"]
            and row["tokens_differ_outside_tie"] == 0)


def compare_logits(label, got, want, tol=LOGIT_TOL):
    """Check 1 on the kernel run's logits against the plain run's.

    The kernel and its plain version agree within their own tolerances
    (phase 3), but each rounds its bf16 output in other places, and 40–48
    bf16 layers carry that into every logit. ``LOGIT_TOL`` lies between
    the sound runs' reading and that of the negative control
    (``plain_route(control=True)``), which the serving phases run beside
    check 1 and which check 1 must reject; PERF.md keeps both readings."""
    row = logit_gap(label, got, want, tol=tol)
    assert check1_passes(row), row
    return row


def expected_launches(cfg, steps):
    """The kernel launches of a prefill and ``steps`` decode steps of
    ``cfg``: K3 at every attention layer's prefill (the leading dense
    layers' too; an encoder-decoder's encoder layers and each decoder
    layer's cross-attention besides), K6 at every SSM layer's, K4 at every
    attention layer a step (an encoder-decoder's twice: self and cross),
    K5 three times (gate, up, down) at every MoE layer of the prefill and
    of every step. MLA is plain PyTorch, as in the reference: no K3 or
    K4."""
    pattern, nb = cfg.block_pattern(), cfg.n_blocks
    n_attn = (0 if cfg.mla is not None else
              nb * sum(k["mixer"] == "attn" for k in pattern)
              + cfg.first_dense_layers)
    n_ssm = nb * sum(k["mixer"] == "ssm" for k in pattern)
    n_moe = nb * sum(k["mlp"] == "moe" for k in pattern)
    n_k3, n_k4 = n_attn, n_attn
    if cfg.is_encoder_decoder:
        n_k3, n_k4 = cfg.encoder_layers + 2 * n_attn, 2 * n_attn
    return only(flash_attention=n_k3, ssd_scan=n_ssm,
                decode_attention=n_k4 * steps,
                moe_gemm=3 * n_moe * (1 + steps))


def source_frames(cfg, b, s_src, seed=0):
    """An encoder-decoder's source: b x s_src frame embeddings (the
    reference's frontend stub), float32 on the card from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(b, s_src, cfg.d_model, device="cuda", generator=gen)


SERVE_INIT_S = {}          # arch -> the serving run's init seconds


def serve_phase(arch, cfg=None):
    """The serving main path of ``arch`` (``cfg``, by default the
    registry's, at full width): weights drawn on the card (seed 0), 8
    prompts of 2,048 tokens (an encoder-decoder's after 2,048 source
    frames, ``source_frames``) through ``api.prefill`` (target 2,080) and
    32 greedy ``api.decode_step`` calls, every launch count set to 0 just
    before and read just after; one decode step profiled; then check 1,
    the same run with a kernel's plain version (K4's, K6's, for a MoE K5's:
    ``moe_check1``, for an encoder-decoder K3's and K4's:
    ``encdec_check1``), and its negative control. Returns the main run's
    launches."""
    cfg = cfg or registry.get(arch)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    target = SERVE_PROMPT + SERVE_NEW
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(cfg, 0)
    torch.cuda.synchronize()
    init_s = SERVE_INIT_S[arch] = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    tok = prompts(cfg, SERVE_BATCH, SERVE_PROMPT)
    batch = {"tokens": tok}
    if cfg.is_encoder_decoder:
        batch["src"] = source_frames(
            cfg, SERVE_BATCH, api._default_src_len(cfg, SERVE_PROMPT))
    with torch.inference_mode():
        prefill(params, batch, target)              # warm-up, not counted
        # not counted either: one prefill under the profiler, for the
        # device's busy share and the prefill's time by kernel
        out, prefill_prof = profile_fn(
            lambda: prefill(params, batch, target))
        del out
        emit(phase="serve_prefill_profile", arch=arch, **prefill_prof)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, target)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        at_prefill = read_launches()
        cache0 = ({k: v.clone() if torch.is_tensor(v) else v
                   for k, v in cache.items()}
                  if cfg.family == "dense" else None)
        first = logits.argmax(-1)[:, None]
        fed, step_logits, step_ms, prof, cache = greedy_decode(
            decode, params, cache, first, SERVE_NEW,
            profile_at=SERVE_NEW // 2)
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        assert logits.shape == (SERVE_BATCH, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        assert bool(torch.isfinite(step_logits).all())
        assert cache["index"] == target
        del cache
        steady = sorted(step_ms[1:])
        decode_ms = steady[len(steady) // 2]
        emit(phase="serve", arch=arch, n_layers=cfg.n_layers,
             first_dense_layers=cfg.first_dense_layers,
             encoder_layers=cfg.encoder_layers,
             src_frames=batch["src"].shape[1] if "src" in batch else 0,
             dtype=cfg.dtype, n_params=n_params, init_s=init_s,
             batch=SERVE_BATCH, prompt=SERVE_PROMPT, new_tokens=SERVE_NEW,
             prefill_ms=prefill_ms,
             prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT
             / (prefill_ms / 1e3),
             decode_ms_per_step_median=decode_ms,
             decode_ms_first=step_ms[0], decode_ms_max=max(step_ms[1:]),
             decode_tokens_per_s=SERVE_BATCH * len(step_ms)
             / (sum(step_ms) / 1e3),
             peak_memory_gb=peak_gb, launches_at_prefill=at_prefill,
             launches=launches,
             greedy_tokens_row0=torch.cat([fed[0], step_logits[-1].argmax(
                 -1)[:1]]).tolist())
        emit(phase="serve_profile", arch=arch, step=SERVE_NEW // 2, **prof)
        assert at_prefill == expected_launches(cfg, 0), at_prefill
        assert launches == expected_launches(cfg, SERVE_NEW), launches

        if cfg.moe is not None or cfg.is_encoder_decoder:
            check1 = moe_check1 if cfg.moe is not None else encdec_check1
            check1(arch, cfg, prefill, decode, params, batch, target, logits,
                   fed, step_logits)
            del params
            torch.cuda.empty_cache()
            return launches
        # check 1: the same decode (and, for the SSM, the prefill) with the
        # mixer kernel's plain version; then its negative control, the
        # first N_COMPARED steps with a wrong plain version, which check 1
        # must reject
        module = k6 if cfg.family == "ssm" else k4
        with plain_route(module):
            if cfg.family == "ssm":
                logits_p, cache0 = prefill(params, batch, target)
                compare_logits(arch + " prefill", logits[None],
                               logits_p[None])
            cache_c = {k: v.clone() if torch.is_tensor(v) else v
                       for k, v in cache0.items()}
            plain_logits = forced_decode(decode, params, cache0, fed)
        compare_logits(arch + " decode", step_logits, plain_logits)
        del cache0
        with plain_route(module, control=True):
            if cfg.family == "ssm":
                del cache_c
                _, cache_c = prefill(params, batch, target)
            control_logits = forced_decode(decode, params, cache_c,
                                           fed[:, :N_COMPARED])
        control = logit_gap(arch + " decode, negative control",
                            control_logits, plain_logits[:N_COMPARED],
                            phase="control_check")
        assert not check1_passes(control), control
    del params, cache_c
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def moe_layers(check=False):
    """Within the block, every MoE layer call appends to the list it
    yields its tokens' top-k expert sets (ascending expert ids, (T, K); the
    router's softmax and top-k computed again on the layer's input) and,
    with ``check``, the layer's output computed twice more on the same
    input — with K5's plain version and with the negative control
    (``_k5_control``) — as max|Δ| over max|plain| of the layer's own
    output and the control's. The layer's own output is returned, so the
    run goes on as it would. For check 1 of the MoE path only, never
    timed."""
    rows = []
    real = blocks.moe_apply

    def recording(cfg, p, x, with_aux=True):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"], dim=-1)
        row = dict(routes=torch.topk(probs, cfg.moe.top_k, dim=-1)
                   .indices.sort(-1).values)
        y, aux = real(cfg, p, x, with_aux=with_aux)
        if check:
            outs = []
            for control in (False, True):
                with plain_route(k5, control=control):
                    outs.append(real(cfg, p, x, with_aux=False)[0].float())
            scale = outs[0].abs().max()
            row.update(gap=(y.float() - outs[0]).abs().max() / scale,
                       control_gap=(outs[1] - outs[0]).abs().max() / scale)
        rows.append(row)
        return y, aux

    blocks.moe_apply = recording
    try:
        yield rows
    finally:
        blocks.moe_apply = real


def moe_check1(arch, cfg, prefill, decode, params, batch, target, logits,
               fed, step_logits):
    """Check 1 of the MoE path.

    The kernel run is repeated with every MoE layer checked on its own
    input (``moe_layers(check=True)``): at prefill and at every decode
    step, the layer with K5 against the layer with K5's plain version, max
    |Δ| within ``MOE_LAYER_TOL`` of max|plain| at every call, and the
    negative control, K5's plain version with the experts rolled by one,
    rejected at every call. The repeated run's logits must be the main
    run's bit for bit (the dispatch and its combine have a fixed order);
    its routes give the share of routes dropped at prefill.

    Then the whole run with K5's plain version, end to end: its logit gap
    and the (layer, token) expert sets that differ from the kernel run's
    are reported, not held to a tolerance. A near tie of the router, moved
    by one bf16 ulp upstream, sends a token to another expert; with the
    reference's draw (σ = 1/√E experts, ROADMAP R4) that moves the token's
    state far, attention spreads it, and the sound end-to-end gap reads as
    large as that of the rolled-experts control (PERF.md), so only the
    layer-wise check decides."""
    E, K = cfg.moe.n_routed, cfg.moe.top_k
    with moe_layers(check=True) as kernel_rows:
        logits_k, cache_k = prefill(params, batch, target)
        n_pre = len(kernel_rows)
        rerun = forced_decode(decode, params, cache_k, fed)
    del cache_k
    rerun_gap = max((logits_k - logits).abs().max().item(),
                    (rerun - step_logits).abs().max().item())
    T = SERVE_BATCH * SERVE_PROMPT
    C = tmoe.capacity(T, cfg)
    dropped = [int((torch.bincount(r["routes"].reshape(-1), minlength=E)
                    - C).clamp_min(0).sum()) for r in kernel_rows[:n_pre]]
    emit(phase="moe_prefill_drops", arch=arch, tokens=T, top_k=K,
         capacity=C, slots=E * C, routes=T * K,
         dropped_share=sum(dropped) / (n_pre * T * K),
         dropped_share_by_layer=[d / (T * K) for d in dropped])
    gaps = [r["gap"].item() for r in kernel_rows]
    controls = [r["control_gap"].item() for r in kernel_rows]
    layer = dict(phase="moe_layer_check", arch=arch, calls=len(gaps),
                 prefill_calls=n_pre, tol=MOE_LAYER_TOL,
                 max_gap_prefill=max(gaps[:n_pre]),
                 max_gap_decode=max(gaps[n_pre:]),
                 min_control_gap_prefill=min(controls[:n_pre]),
                 min_control_gap_decode=min(controls[n_pre:]),
                 max_control_gap=max(controls),
                 kernel_rerun_max_abs_diff=rerun_gap)
    emit(**layer)
    assert rerun_gap == 0.0, rerun_gap
    assert max(gaps) <= MOE_LAYER_TOL, layer
    assert min(controls) > MOE_LAYER_TOL, layer

    with plain_route(k5), moe_layers() as plain_rows:
        logits_p, cache_p = prefill(params, batch, target)
        plain_logits = forced_decode(decode, params, cache_p, fed)
    del cache_p
    differ = [int((a["routes"] != b["routes"]).any(-1).sum())
              for a, b in zip(kernel_rows, plain_rows)]
    emit(phase="moe_route_check", arch=arch, prefill_sets=n_pre * T,
         prefill_sets_differ=sum(differ[:n_pre]),
         decode_sets=(len(differ) - n_pre) * SERVE_BATCH,
         decode_sets_differ=sum(differ[n_pre:]),
         prefill_sets_differ_by_layer=differ[:n_pre])
    logit_gap(arch + " prefill, end to end", logits[None], logits_p[None],
              phase="plain_check_end_to_end")
    logit_gap(arch + " decode, end to end", step_logits, plain_logits,
              phase="plain_check_end_to_end")


def encdec_check1(arch, cfg, prefill, decode, params, batch, target,
                  logits, fed, step_logits):
    """Check 1 of the encoder-decoder: the same run — prefill, then the
    fed tokens — with K3's and K4's plain versions; the prefill's and the
    decode steps' logits within ``LOGIT_TOL``·max|plain|. Then the negative
    control, K3's plain version causal at every call (the encoder's and
    the cross-attention masked as the decoder's is), which check 1 must
    reject on the first ``N_COMPARED`` decode steps."""
    with plain_route(k3), plain_route(k4):
        logits_p, cache_p = prefill(params, batch, target)
        plain_logits = forced_decode(decode, params, cache_p, fed)
    del cache_p
    compare_logits(arch + " prefill", logits[None], logits_p[None])
    compare_logits(arch + " decode", step_logits, plain_logits)
    with plain_route(k3, control=True), plain_route(k4):
        _, cache_c = prefill(params, batch, target)
        control_logits = forced_decode(decode, params, cache_c,
                                       fed[:, :N_COMPARED])
    del cache_c
    control = logit_gap(arch + " decode, negative control", control_logits,
                        plain_logits[:N_COMPARED], phase="control_check")
    assert not check1_passes(control), control


def consistency_phase(arch, **kw):
    """Check 2: full width in float32 at 2 layers (or the layers ``kw``
    sets) — prefill of 24 tokens plus 8 decode steps reproduce the full
    forward's logits (``lm_forward``, an encoder-decoder's
    ``encdec_forward`` after 24 source frames) within 1e-3·max|logit| +
    1e-3 (tests/test_decode_consistency.py's property, on the card), so
    that no route is dropped a MoE at capacity factor 8.0, as that test
    sets it, or E/top_k where that is larger: the least at which an
    expert's slots (C = cf·T·top_k/E) hold all T tokens, which a random
    router may send to one expert (qwen2-moe's 60 experts top-4: 15;
    DeepSeek's 256 top-8: 32, where at 8.0 one expert drew 19 of the full
    forward's 64 tokens against 16 slots, and decode, which keeps every
    route, then disagreed with it). The most tokens any expert drew in
    the full forward are reported beside its capacity."""
    cfg = dataclasses.replace(registry.get(arch),
                              **{"n_layers": 2, "dtype": "float32", **kw})
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=max(
                8.0, cfg.moe.n_routed / cfg.moe.top_k)))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init(cfg, 1)
    tok = prompts(cfg, 2, 32, seed=1)
    batch = {"tokens": tok[:, :24]}
    with torch.inference_mode():
        if cfg.is_encoder_decoder:
            batch["src"] = source_frames(cfg, 2, 24, seed=1)
            full = ted.encdec_forward(cfg, params, batch["src"], tok)[0]
        else:
            with moe_layers() as rows:
                full = tf.lm_forward(cfg, params, tok,
                                     window=cfg.sliding_window)
        loads = {}
        if cfg.moe is not None:
            loads = dict(capacity=tmoe.capacity(tok.numel(), cfg),
                         max_expert_load=max(int(torch.bincount(
                             r["routes"].reshape(-1)).max()) for r in rows))
        logits, cache = api.prefill(cfg, params, batch, target_len=32)
        errs = [(logits - full[:, 23]).abs().max().item()]
        for t in range(24, 32):
            logits, cache = api.decode_step(cfg, params, cache,
                                            tok[:, t:t + 1])
            errs.append((logits - full[:, t]).abs().max().item())
    tol = 1e-3 * full.abs().max().item() + 1e-3
    emit(phase="prefill_decode_vs_forward", arch=arch,
         n_layers=cfg.n_layers, first_dense_layers=cfg.first_dense_layers,
         encoder_layers=cfg.encoder_layers, dtype="float32",
         n_params=sum(v.numel() for v in params.values()),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         capacity_factor=cfg.moe.capacity_factor if cfg.moe else None,
         **loads, max_abs_err=max(errs), tol=tol, errs=errs)
    assert max(errs) <= tol, (arch, errs, tol)
    del params, cache, full
    torch.cuda.empty_cache()


ZOO_CUDA_VS_CPU = [("starcoder2-15b", "ring", False),
                   ("qwen2.5-32b", "greedy", False),
                   ("mamba2-370m", "greedy", False),
                   ("qwen2-moe-a2.7b", "greedy", False),
                   ("qwen2-moe-a2.7b", "greedy", True),
                   ("moonshot-v1-16b-a3b", "greedy", False),
                   ("jamba-1.5-large-398b", "greedy", False)]


def zoo_cuda_vs_cpu(runs=ZOO_CUDA_VS_CPU):
    """Reduced float32 configs on the GPU and the CPU from the same
    weights: starcoder2 decoding 48 tokens from scratch through its ring
    cache (window 16); greedy generation (8 prompt tokens, 7 new; 32 prompt
    tokens, one chunk, where there are SSM layers; an encoder-decoder's
    after 12 source frames) of qwen2.5, mamba2, qwen2-moe (also
    ``optimized``: group-local dispatch in 2 groups at prefill), moonshot
    and the Jamba hybrid, or of ``runs``. The same tokens, logits within
    1e-4; every greedy GPU run launches what ``expected_launches`` says
    (the Jamba run K3, K4, K5 and K6)."""
    for arch, mode, optimized in runs:
        cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                                  dtype="float32")
        if optimized:
            cfg = registry.optimized(cfg, 2)
        host = api.init(cfg, PRNGKey(0, "cpu"), device="cpu")
        rng = np.random.default_rng(4)
        n_prompt = 32 if cfg.ssm is not None else 8
        toks = rng.integers(0, cfg.vocab_size, (1 if mode == "ring" else 2,
                                                48 if mode == "ring"
                                                else n_prompt))
        src = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
        out = {}
        for dev in ("cuda", "cpu"):
            params = {k: v.to(dev) for k, v in host.items()}
            tt = torch.from_numpy(toks).to(dev)
            batch = {"tokens": tt}
            if cfg.is_encoder_decoder:
                batch["src"] = torch.from_numpy(src).to(dev)
            decode = steps.make_decode_step(cfg)
            reset_launches()
            with torch.inference_mode():
                if mode == "ring":
                    cache = api.cache_init(cfg, 1, 48, device=dev)
                    assert "slot_pos" in cache
                    logits = forced_decode(decode, params, cache, tt)
                    tokens = logits.argmax(-1)
                else:
                    first, cache = api.prefill(cfg, params, batch,
                                               target_len=n_prompt + 8)
                    fed, logits, _, _, _ = greedy_decode(
                        decode, params, cache, first.argmax(-1)[:, None], 7)
                    tokens = torch.cat([fed, logits[-1].argmax(-1)[:, None]],
                                       1)
            launches = read_launches()
            out[dev] = (tokens.cpu(), logits.float().cpu(), launches)
        err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
        label = f"{arch} reduced {mode}" + (", optimized" if optimized
                                            else "")
        emit(phase="cuda_vs_cpu", run=label, tokens=out["cuda"][0].tolist(),
             max_abs_logit_err=err, launches=out["cuda"][2])
        assert torch.equal(out["cuda"][0], out["cpu"][0]), (arch, out)
        assert err <= 1e-4, (arch, err)
        assert out["cpu"][2] == only(), out["cpu"][2]
        if mode == "greedy":
            assert out["cuda"][2] == expected_launches(cfg, 7), (
                label, out["cuda"][2])


def zoo_phases():
    """The serving path of the zoo: starcoder2-15b (dense, K3 at prefill,
    K4 at every decode step) and mamba2-370m (SSM, K6 at every prefill)
    at full width with checks 1 and 2, then qwen2-moe-a2.7b (K3, K4 and
    K5 at prefill and every decode step) likewise, then GPU against CPU.
    Returns the main-path launches of K4, K5 and K6 in their serving
    runs."""
    dense = serve_phase("starcoder2-15b")
    consistency_phase("starcoder2-15b")
    ssm = serve_phase("mamba2-370m")
    consistency_phase("mamba2-370m")
    moe = serve_phase("qwen2-moe-a2.7b")
    consistency_phase("qwen2-moe-a2.7b")
    zoo_cuda_vs_cpu()
    return (dense["decode_attention"], moe["moe_gemm"], ssm["ssd_scan"])


def zoo_rest_phases():
    """The rest of the zoo at full width (phase 14): DeepSeek-V3 cut to its
    3 leading dense layers and 1 MoE layer (MLA in plain PyTorch, K5 3
    times a prefill and 3 a step), check 1 layer by layer, check 2 at 1
    dense + 1 MoE layer in float32; Seamless-M4T's encoder-decoder, all 12
    + 12 layers (K3 36 times a prefill, K4 24 a step), check 1 with K3's
    and K4's plain versions, check 2 at all 24 layers in float32; then
    both reduced on the GPU and the CPU. Returns each serving run's
    launches."""
    deepseek = dataclasses.replace(registry.get("deepseek-v3-671b"),
                                   n_layers=4)
    out = {"deepseek-v3-671b": serve_phase("deepseek-v3-671b", deepseek)}
    consistency_phase("deepseek-v3-671b", first_dense_layers=1)
    out["seamless-m4t-medium"] = serve_phase("seamless-m4t-medium")
    consistency_phase("seamless-m4t-medium", n_layers=12)
    zoo_cuda_vs_cpu([("deepseek-v3-671b", "greedy", False),
                     ("seamless-m4t-medium", "greedy", False)])
    return out


# ---------------------------------------------------------------------- #
# Training the zoo (phase 16)
# ---------------------------------------------------------------------- #
# train_4k's sequence of 4,096 at batch 2 (8,192 tokens a step), the batch
# cut from 256 to fit one card; 5 timed steps, then one profiled
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 5
# a gradient against its plain version: max|Δ| over max|plain|. In bf16
# both round float32 sums once, and one bf16 ulp is 2^-8 to 2^-7 of a
# value; float32 gradients (K6's dt and A) sum in other orders
GRAD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
# kernel names (substrings) of each ported kernel in a profile
KERNEL_NAMES = {"flash_attention": ("flash_f32_kernel", "flash_bf16_kernel"),
                "moe_gemm": ("moe_gemm_decode_kernel",
                             "moe_gemm_decode_tma_kernel",
                             "moe_gemm_wgmma_kernel", "moe_gemm_f32_kernel"),
                "ssd_scan": ("ssd_kernel", "ssd_state_kernel",
                             "ssd_pass_kernel", "ssd_chunk_scan_kernel")}


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


K5_BACKWARD = k5._MoeGemm.backward


def _k5_wrong_backward(ctx, dy):
    """The negative control of K5's gradient check: the right dw laid out
    transposed (its (K, N) block read as (N, K), reshaped back)."""
    dx, dw = K5_BACKWARD(ctx, dy)
    return dx, dw.transpose(1, 2).reshape(dw.shape)


def check_moe_grad(label, e, c, k, n, dtype=torch.bfloat16, reps=10,
                   control=False):
    """K5's autograd Function on the card (dx = dy·wᵀ and dw = xᵀ·dy, two
    more K5 launches) against autograd through its plain version, within
    ``GRAD_TOL``·max|plain|; with ``control`` a deliberately wrong backward
    (``_k5_wrong_backward``) that the check must reject. Times the two
    backward launches at these shapes beside the plain version's backward
    and ``torch.bmm`` for the same two products, with their bound (inputs
    x, w, dy read once, dx and dw written once; 4·E·C·K·N flops)."""
    g = torch.Generator(device="cuda").manual_seed(e * 131 + c + k + n)
    x = torch.randn(e, c, k, device="cuda", generator=g).to(dtype)
    w = torch.randn(e, k, n, device="cuda", generator=g).to(dtype)
    dy = torch.randn(e, c, n, device="cuda", generator=g).to(dtype)
    grads = {}
    for name, fn in (("kernel", k5.moe_gemm), ("plain", k5.moe_gemm_ref)):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if control and name == "kernel":
            k5._MoeGemm.backward = staticmethod(_k5_wrong_backward)
        try:
            grads[name] = torch.autograd.grad(fn(xs, ws), (xs, ws), dy)
        finally:
            k5._MoeGemm.backward = K5_BACKWARD
    errs = [_rel_err(a, b) for a, b in zip(grads["kernel"], grads["plain"])]
    tol = GRAD_TOL[dtype]
    row = dict(phase="kernel_grad_check", kernel="moe_gemm", case=label,
               e=e, c=c, k=k, n=n, dtype=str(dtype).split(".")[-1],
               control=control, dx_err=errs[0], dw_err=errs[1], tol=tol)
    if control:
        emit(**row)
        assert errs[1] > tol, row
        return row
    assert max(errs) <= tol, row
    wt, xt = w.transpose(1, 2).contiguous(), x.transpose(1, 2).contiguous()
    ms, call_ms = time_ms(lambda: (k5.moe_gemm(dy, wt), k5.moe_gemm(xt, dy)),
                          reps)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = k5.moe_gemm_ref(xs, ws)
    plain_ms, _ = time_ms(lambda: torch.autograd.grad(
        y, (xs, ws), dy, retain_graph=True), 2)
    library_ms, _ = time_ms(lambda: (torch.bmm(dy, w.transpose(1, 2)),
                                     torch.bmm(x.transpose(1, 2), dy)), reps)
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * e * c * k + 2 * e * k * n + e * c * n) * size
    flops = 4.0 * e * c * k * n
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    row.update(backward_ms=ms, backward_call_ms=call_ms,
               plain_backward_ms=plain_ms, library="torch.bmm x 2",
               library_ms=library_ms,
               bound_ms=max(by_bytes, by_ops) * 1e3,
               bound_by="bytes" if by_bytes >= by_ops else "operations",
               attained_tflops=flops / (ms * 1e-3) / 1e12)
    emit(**row)
    return row


def check_ssd_grad(label, b, length, h, p, n, g, chunk,
                   dtype=torch.bfloat16, reps=5):
    """K6's autograd Function on the card (K6 forward; backward the VJP of
    the chunked form, recomputed) against autograd through the plain
    version, the sequential recurrence: the gradients of x, dt, A, B and C
    within ``GRAD_TOL`` of their dtype (·max|plain|). Times the Function's
    backward and the plain version's forward and backward, with the
    backward's bound (x, dt, B, C and dy read once, their gradients and
    A's written once; twice the forward's flops, ``ssd_bound``)."""
    gen = torch.Generator(device="cuda").manual_seed(b * 7919 + length + n)
    x = torch.randn(b, length, h, p, device="cuda", generator=gen).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, length, h, device="cuda", generator=gen))
    A = -torch.exp(0.2 * torch.randn(h, device="cuda", generator=gen))
    Bm, Cm = (torch.randn(b, length, g, n, device="cuda", generator=gen)
              .to(dtype) for _ in range(2))
    dy = torch.randn(b, length, h, p, device="cuda", generator=gen).to(dtype)
    grads, outs = {}, {}
    for name, fn in (("kernel", k6.ssd_scan), ("plain", k6.ssd_scan_ref)):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = fn(*ins, chunk=chunk)
        grads[name] = torch.autograd.grad(y, ins, dy)
        torch.cuda.synchronize()
        outs[name] = ((time.perf_counter() - t0) * 1e3, ins, y)
    errs = {nm: _rel_err(a, b_) for nm, a, b_ in zip(
        ("x", "dt", "A", "B", "C"), grads["kernel"], grads["plain"])}
    tols = {nm: GRAD_TOL[t.dtype] for nm, t in zip(
        ("x", "dt", "A", "B", "C"), (x, dt, A, Bm, Cm))}
    row = dict(phase="kernel_grad_check", kernel="ssd_scan", case=label,
               b=b, l=length, h=h, p=p, n=n, g=g, chunk=chunk,
               dtype=str(dtype).split(".")[-1], errs=errs, tols=tols,
               plain_fwd_bwd_wall_ms=outs["plain"][0],
               kernel_fwd_bwd_wall_ms=outs["kernel"][0])
    assert all(errs[nm] <= tols[nm] for nm in errs), row
    del grads, outs
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    y, _ = k6.ssd_scan(*ins, chunk=chunk)
    ms, call_ms = time_ms(lambda: torch.autograd.grad(
        y, ins, dy, retain_graph=True), reps)
    _, _, nbytes, flops = ssd_bound(b, length, h, p, n, g, min(chunk, length),
                                    dtype)
    nbytes += b * length * h * p * x.element_size() + h * 4
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 2 * flops / peak
    row.update(backward_ms=ms, backward_call_ms=call_ms, library=None,
               library_ms=None, bound_ms=max(by_bytes, by_ops) * 1e3,
               bound_by="bytes" if by_bytes >= by_ops else "operations")
    emit(**row)
    return row


TRAIN_MARKER = "repro_train_marker/"


class TrainProbe:
    """What a train step does, by phase, read without changing it: the
    launch counts when the loss returns (the forward), the launches made
    inside K5's backward, and — when ``markers`` — at each phase boundary
    a ``record_function`` range named ``TRAIN_MARKER`` and the marker's
    index around two one-thread ``torch.cuda._sleep(1)`` kernels
    (``spin_kernel``, the device's witness of the marker), with the
    boundaries' labels in order, so that a profile's device timeline
    splits into the forward, the backward (block recomputes and the rest),
    K5's backward launches, the plain VJPs of K3 and K6, and the
    optimizer (``split_profile``). Installed by ``train_probes``."""

    def __init__(self):
        self.markers, self.labels = False, []
        self.forward, self.k5_backward = None, 0

    def reset(self, markers=False):
        self.markers, self.labels = markers, []
        self.forward, self.k5_backward = None, 0

    def mark(self, label):
        self.labels.append(label)
        if self.markers:
            with torch.profiler.record_function(
                    f"{TRAIN_MARKER}{len(self.labels) - 1}"):
                torch.cuda._sleep(1)
                torch.cuda._sleep(1)


@contextlib.contextmanager
def train_probes():
    """Within the block ``api.loss``, the backwards of K3's, K5's and K6's
    autograd Functions and the optimizer ``steps.make_optimizer`` builds
    report to the yielded ``TrainProbe`` (build the train step inside the
    block)."""
    probe = TrainProbe()
    real_loss, real_make = api.loss, steps.make_optimizer
    backs = {cls: cls.backward for cls in (k3._FlashAttention,
                                           k5._MoeGemm, k6._SsdScan)}
    labels = {k3._FlashAttention: "k3_vjp", k5._MoeGemm: "k5_backward",
              k6._SsdScan: "k6_vjp"}

    def loss(*a, **kw):
        probe.mark("forward")
        out = real_loss(*a, **kw)
        probe.forward = read_launches()
        probe.mark("backward")
        return out

    def wrap(cls):
        real = backs[cls]

        def backward(ctx, *g):
            probe.mark(labels[cls])
            before = k5.moe_gemm.launches
            out = real(ctx, *g)
            if cls is k5._MoeGemm:
                probe.k5_backward += k5.moe_gemm.launches - before
            probe.mark("backward")
            return out
        return staticmethod(backward)

    def make_optimizer(tcfg):
        opt = real_make(tcfg)

        def update(*a):
            probe.mark("optimizer")
            out = opt.update(*a)
            probe.mark("end")
            return out
        return dataclasses.replace(opt, update=update)

    api.loss, steps.make_optimizer = loss, make_optimizer
    for cls in backs:
        cls.backward = wrap(cls)
    try:
        yield probe
    finally:
        api.loss, steps.make_optimizer = real_loss, real_make
        for cls, real in backs.items():
            cls.backward = real


def _launch_name(name):
    """A CUDA runtime or driver call that enqueues device work
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)."""
    return name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                            "cuMemcpy", "cudaMemset", "cuMemset"))


def split_profile(prof, labels):
    """A profiled train step's device time by phase. Each device event
    (kernel, copy, set) is placed by its launch: the host runtime call of
    the same correlation id (``FunctionEvent.id``), in the phase of the
    last ``TrainProbe`` marker range that opened before that call; a
    device event whose launch call the profile lacks takes the phase of
    the device event before it on the timeline (one stream). Nothing
    counts the spin kernels: they only witness, per marker, that the
    device saw it (a marker whose spins are missing is named in the
    record). Returns (({segment label: {"all": us, kernel: us}} summed
    over the segments of that label, or None when a marker's range is
    missing from the profile), the record: markers found on the host,
    spin events, the markers missing spins, device events placed by their
    launch and by their neighbour, and launches whose device event is
    missing, by phase)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = list(prof.events())
    opened = {}                 # marker index: its host range
    launched = {}               # correlation id: the launch's host start
    for ev in evs:
        if ev.device_type != cpu:
            continue
        if ev.name.startswith(TRAIN_MARKER):
            opened[int(ev.name[len(TRAIN_MARKER):])] = ev.time_range
        elif _launch_name(ev.name):
            launched[ev.id] = ev.time_range.start
    dev = sorted((ev for ev in evs if ev.device_type == cuda
                  and not getattr(ev, "is_user_annotation", False)
                  and not ev.name.startswith(TRAIN_MARKER)),
                 key=lambda ev: ev.time_range.start)
    spin = ["spin_kernel" in ev.name for ev in dev]
    witnessed = collections.Counter()
    for ev, s in zip(dev, spin):
        at = launched.get(ev.id)
        for i, rng in opened.items():
            if s and at is not None and rng.start <= at <= rng.end:
                witnessed[i] += 1
    record = dict(labels=len(labels), markers_on_host=len(opened),
                  spin_events=sum(spin), device_events=len(dev),
                  markers_missing_spins=[
                      [i, labels[i], witnessed[i]]
                      for i in range(len(labels)) if witnessed[i] < 2])
    if sorted(opened) != list(range(len(labels))):
        return None, record
    starts = [opened[i].start for i in range(len(labels))]
    assert starts == sorted(starts), starts
    out = collections.defaultdict(lambda: collections.defaultdict(float))
    label, by_launch, by_neighbour = "before", 0, 0
    for ev, s in zip(dev, spin):
        at = launched.get(ev.id)
        if at is not None:
            i = bisect.bisect_right(starts, at) - 1
            label = labels[i] if i >= 0 else "before"
            by_launch += 1
        else:
            by_neighbour += 1
        if s:
            continue
        us = ev.time_range.elapsed_us()
        out[label]["all"] += us
        for kernel, names in KERNEL_NAMES.items():
            if any(nm in ev.name for nm in names):
                out[label][kernel] += us
    # launches whose device event the profile lacks, by phase
    seen = {ev.id for ev in dev}
    lost = collections.Counter(
        labels[i] if i >= 0 else "before" for i in (
            bisect.bisect_right(starts, at) - 1
            for cid, at in launched.items() if cid not in seen))
    record.update(placed_by_launch=by_launch,
                  placed_by_neighbour=by_neighbour,
                  launches_without_device_event=dict(lost))
    return {k: dict(v) for k, v in out.items()}, record


def train_cell(label, cfg, tcfg, expect):
    """``TRAIN_STEPS`` steps of ``cfg`` through ``steps.make_train_step``
    on ``data.tokens.batches`` (``TRAIN_BATCH`` x ``TRAIN_SEQ``), every
    launch count set to 0 just before each step and read just after (K3,
    K5, K6 forward, remat recompute and K5 backward counted apart and held
    to ``expect``), the step's wall ms, loss and grad norm; the peak
    memory; then one more step profiled (``profile_fn``) and split by
    phase (``split_profile``; profiled again, at most twice, when a
    marker's range is missing; a step that still cannot be split fails
    the cell). Returns the summary row."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = steps.init_state(cfg, tcfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in state[0].values())
    stream = make_stream(max(200_000, 2 * TRAIN_BATCH * TRAIN_SEQ),
                         cfg.vocab_size, seed=0)
    it = batches(stream, TRAIN_BATCH, TRAIN_SEQ, np.random.default_rng(0))
    rows = []
    with train_probes() as probe:
        train_step = steps.make_train_step(cfg, tcfg)
        for i in range(TRAIN_STEPS):
            tokens = torch.from_numpy(next(it)["tokens"]).to("cuda",
                                                             torch.int64)
            probe.reset()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *state, m = train_step(*state, {"tokens": tokens})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            total = read_launches()
            fwd = probe.forward
            launches = {k: dict(forward=fwd[k], recompute=total[k] - fwd[k]
                                - (probe.k5_backward if k == "moe_gemm"
                                   else 0),
                                backward=probe.k5_backward
                                if k == "moe_gemm" else 0)
                        for k in ("flash_attention", "moe_gemm", "ssd_scan")}
            row = dict(phase="train_step", cell=label, step=i + 1, ms=ms,
                       loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       launches=launches)
            emit(**row)
            rows.append(row)
            assert launches == expect, (label, launches, expect)
            assert total == only(**{k: sum(v.values())
                                    for k, v in expect.items()}), total
        # one more step under the profiler, split at its markers (the
        # profiler settles first: the first marker went unrecorded
        # without it); a step whose marker ranges do not all come back is
        # profiled again, at most twice more, and then the cell fails
        for attempt in range(3):
            tokens = torch.from_numpy(next(it)["tokens"]).to("cuda",
                                                             torch.int64)
            probe.reset(markers=True)
            torch.cuda.synchronize()
            (*state, m), prof_row = profile_fn(
                lambda: train_step(*state, {"tokens": tokens}),
                keep_prof=True, settle_s=0.05)
            prof = prof_row.pop("prof")
            split, record = split_profile(prof, probe.labels)
            emit(phase="train_profile_markers", cell=label, attempt=attempt,
                 split=split is not None, **record)
            if split is not None:
                break
    assert split is not None, (label, "the profiled step cannot be split",
                               record)
    wall_us = prof_row["wall_us"]

    def seg(lbl, key="all"):
        return split.get(lbl, {}).get(key, 0.0)
    fwd_k = sum(seg("forward", k) for k in KERNEL_NAMES)
    rec_k = sum(seg("backward", k) for k in KERNEL_NAMES)
    shares = {name: us / wall_us for name, us in (
        ("kernels_forward", fwd_k), ("kernels_remat_recompute", rec_k),
        ("k5_backward_launches", seg("k5_backward", "moe_gemm")),
        ("k5_backward_all", seg("k5_backward")),
        ("k3_plain_vjp", seg("k3_vjp")),
        ("k6_plain_vjp", seg("k6_vjp")),
        ("optimizer", seg("optimizer")),
        ("forward_all", seg("forward")),
        ("backward_rest", seg("backward")))}
    shares["idle"] = prof_row["device_idle_share"]
    losses = [r["loss"] for r in rows]
    step_ms = float(np.median([r["ms"] for r in rows[1:]]))
    kernel_us = {kernel: sum(us for name, us in device_us(prof).items()
                             if any(nm in name for nm in names))
                 for kernel, names in KERNEL_NAMES.items()}
    out = dict(phase="train_cell", cell=label, arch=cfg.name,
               n_layers=cfg.n_layers, params=n_params,
               dtype=cfg.dtype, optimizer=tcfg.optimizer, remat=tcfg.remat,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, init_s=init_s,
               step_ms_median_2_to_5=step_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, profiled_loss=float(m["loss"]),
               launches_a_step=rows[-1]["launches"],
               profile={k: v for k, v in prof_row.items()},
               kernel_us=kernel_us, split_us=split, shares=shares)
    del prof
    emit(**out)
    assert all(np.isfinite(losses + [out["profiled_loss"]])), out
    assert losses[-1] < losses[0], losses
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def remat_check():
    """A remat step against a no-remat step of ``qwen2-moe-a2.7b`` at full
    width and 1 layer (bf16, AdamW), from the same weights and batch:
    every MoE route of the first forward, of the remat recompute and of
    the no-remat forward equal, the losses equal (the same forward on the
    card, ``REMAT_LOSS_TOL`` relative) and the grad norms within
    ``REMAT_GNORM_TOL`` relative (the backwards' bf16 sums in other
    orders)."""
    cfg = dataclasses.replace(registry.get("qwen2-moe-a2.7b"), n_layers=1)
    stream = make_stream(max(200_000, 2 * TRAIN_BATCH * TRAIN_SEQ),
                         cfg.vocab_size, seed=0)
    tokens = torch.from_numpy(next(batches(
        stream, TRAIN_BATCH, TRAIN_SEQ, np.random.default_rng(0)))["tokens"])
    out = {}
    real = blocks.moe_apply
    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        tcfg = TrainConfig(optimizer="adamw", remat=remat)
        state = steps.init_state(cfg, tcfg, 0, device="cuda")
        routes = []

        def recording(cfg_, p, x, with_aux=True):
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ p["router"], dim=-1)
            routes.append(torch.topk(probs, cfg_.moe.top_k, dim=-1)
                          .indices.sort(-1).values)
            return real(cfg_, p, x, with_aux=with_aux)
        blocks.moe_apply = recording
        try:
            *_, m = steps.make_train_step(cfg, tcfg)(
                *state, {"tokens": tokens.to("cuda", torch.int64)})
        finally:
            blocks.moe_apply = real
        out[remat] = (float(m["loss"]), float(m["grad_norm"]), routes)
        del state, m
    (l0, g0, r0), (l1, g1, r1) = out[False], out[True]
    row = dict(phase="remat_check", arch=cfg.name, n_layers=1,
               loss_no_remat=l0, loss_remat=l1, grad_norm_no_remat=g0,
               grad_norm_remat=g1, route_calls=[len(r0), len(r1)],
               routes_equal=len(r0) == 1 and len(r1) == 2 and all(
                   torch.equal(r0[0], r) for r in r1),
               loss_tol=REMAT_LOSS_TOL, grad_norm_tol=REMAT_GNORM_TOL)
    emit(**row)
    assert row["routes_equal"], row
    assert abs(l1 - l0) <= REMAT_LOSS_TOL * abs(l0), row
    assert abs(g1 - g0) <= REMAT_GNORM_TOL * abs(g0), row
    gc.collect()
    torch.cuda.empty_cache()


REMAT_LOSS_TOL = 1e-6
REMAT_GNORM_TOL = 1e-3
TRAIN_CUDA_VS_CPU_TOL = 1e-4


def train_cuda_vs_cpu():
    """One train step of each of the ten archs reduced to float32, remat on
    and off, on the GPU and on the CPU from the same weights and batch:
    the loss and the grad norm within ``TRAIN_CUDA_VS_CPU_TOL`` relative."""
    for arch in registry.list_archs():
        cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                                  dtype="float32")
        rng = np.random.default_rng(5)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
        src = torch.from_numpy(rng.standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32))
        for remat in (False, True):
            tcfg = TrainConfig(optimizer=("adafactor"
                                          if arch in ADAFACTOR_ARCHS
                                          else "adamw"), lr=5e-3,
                               remat=remat)
            host = steps.init_state(cfg, tcfg, 1, device="cpu")
            got = {}
            for dev in ("cuda", "cpu"):
                state = ({k: v.to(dev) for k, v in host[0].items()},
                         {k: v.to(dev) for k, v in host[1].items()},
                         host[2].to(dev))
                batch = {"tokens": toks.to(dev)}
                if cfg.is_encoder_decoder:
                    batch["src"] = src.to(dev)
                *_, m = steps.make_train_step(cfg, tcfg)(*state, batch)
                got[dev] = (float(m["loss"]), float(m["grad_norm"]))
            errs = [abs(a - b) / abs(b) for a, b in zip(got["cuda"],
                                                        got["cpu"])]
            emit(phase="train_cuda_vs_cpu", arch=arch, remat=remat,
                 loss_cuda=got["cuda"][0], loss_cpu=got["cpu"][0],
                 grad_norm_cuda=got["cuda"][1], grad_norm_cpu=got["cpu"][1],
                 rel_errs=errs)
            assert max(errs) <= TRAIN_CUDA_VS_CPU_TOL, (arch, remat, got)


TRAIN_RESUME_TOL = 1e-4


def train_cli_phase():
    """``python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --smoke
    --steps 4 --batch 2 --ckpt DIR --ckpt-every 2`` through its ``main``
    (train_4k's sequence of 4,096: at its batch of 256 the plain VJP of K3
    would hold 68.7 GB of float32 logits), then again from its step-2
    checkpoint: the state restored from the step-4 checkpoint bit-equal to
    the run's own, the resumed run's losses and final parameters within
    ``TRAIN_RESUME_TOL`` relative of the uninterrupted run's."""
    ck = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--batch", "2",
            "--ckpt", str(ck), "--ckpt-every", "2"]
    reset_launches()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        full = train_cli.main(argv + ["--steps", "4"])
    launches = read_launches()
    state, meta = restore(str(ck), full["state"])
    bit_equal = all(torch.equal(a[k], b[k]) for a, b in zip(
        state[:2], full["state"][:2]) for k in a) and torch.equal(
        state[2], full["state"][2])
    (ck / "00000004").rename(ck.parent / "train_ckpt_step4")
    with contextlib.redirect_stdout(printed):
        resumed = train_cli.main(argv + ["--steps", "2"])
    losses = [float(m["loss"]) for m in full["metrics"]]
    again = [float(m["loss"]) for m in resumed["metrics"]]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(again, losses[2:]))
    param_err = max(_rel_err(resumed["state"][0][k], full["state"][0][k])
                    for k in full["state"][0])
    row = dict(phase="train_cli", argv=" ".join(argv), meta=meta,
               restored_bit_equal=bit_equal, losses=losses,
               resumed_losses=again, resumed_loss_rel_err=loss_err,
               resumed_param_rel_err=param_err, tol=TRAIN_RESUME_TOL,
               launches=launches, seconds=time.perf_counter() - t0,
               printed=printed.getvalue().splitlines())
    emit(**row)
    assert bit_equal and meta == {"step": 4}, row
    assert int(resumed["state"][2]) == 4, row
    assert loss_err <= TRAIN_RESUME_TOL and param_err <= TRAIN_RESUME_TOL, row
    assert launches["moe_gemm"] > 0 and launches["flash_attention"] > 0, row
    shutil.rmtree(ck.parent / "train_ckpt_step4", ignore_errors=True)
    shutil.rmtree(ck, ignore_errors=True)


def train_phases():
    """Phase 16, training the zoo: (a) the gradients of K5, K6 and K3
    through their autograd Functions against their plain versions at the
    training shapes, and the wrong-backward control; (b) ``qwen2-moe-a2.7b``
    at full width cut to 4 layers, (c) ``mamba2-370m`` uncut, each 5 steps
    and a profiled one (``train_cell``); (e) the remat check and the ten
    reduced archs on the GPU against the CPU; (f) the training CLI with a
    checkpoint resume. Returns the K5 and K6 backward rows and each cell's
    row."""
    bf16 = torch.bfloat16
    qwen = registry.get("qwen2-moe-a2.7b")
    c_train = tmoe.capacity(TRAIN_BATCH * TRAIN_SEQ, qwen)
    e, d, f = qwen.moe.n_routed, qwen.d_model, qwen.moe.d_ff_expert
    k5_rows = [check_moe_grad("qwen2-moe train gate/up", e, c_train, d, f),
               check_moe_grad("qwen2-moe train down", e, c_train, f, d)]
    check_moe_grad("ragged capacity", e, 37, d, f, reps=3)
    check_moe_grad("ragged, float32", 3, 37, 100, 70, torch.float32, reps=3)
    check_moe_grad("wrong backward (dw transposed)", e, c_train, d, f,
                   control=True)
    k6_row = check_ssd_grad("mamba2-370m train", TRAIN_BATCH, TRAIN_SEQ, 32,
                            64, 128, 1, 256)
    check_flash_grad(TRAIN_BATCH, 16, TRAIN_SEQ, 128, dtype=bf16)

    n_moe = 4
    cells = {}
    cells["qwen2-moe-a2.7b"] = train_cell(
        "qwen2-moe-a2.7b, 4 layers", dataclasses.replace(qwen,
                                                         n_layers=n_moe),
        TrainConfig(optimizer="adamw", remat=True),
        dict(flash_attention=dict(forward=n_moe, recompute=n_moe,
                                  backward=0),
             moe_gemm=dict(forward=3 * n_moe, recompute=3 * n_moe,
                           backward=6 * n_moe),
             ssd_scan=dict(forward=0, recompute=0, backward=0)))
    mamba = registry.get("mamba2-370m")
    cells["mamba2-370m"] = train_cell(
        "mamba2-370m", mamba, TrainConfig(optimizer="adamw", remat=True),
        dict(flash_attention=dict(forward=0, recompute=0, backward=0),
             moe_gemm=dict(forward=0, recompute=0, backward=0),
             ssd_scan=dict(forward=mamba.n_layers, recompute=mamba.n_layers,
                           backward=0)))
    remat_check()
    train_cuda_vs_cpu()
    train_cli_phase()
    return k5_rows, k6_row, cells


# ---------------------------------------------------------------------------
# 17. the step-cost plane: the dry run and the hillclimb, the dry
# run's counts against the card, K6's bf16-compute route
# ---------------------------------------------------------------------------
COST_DIR = build.BUILD_DIR.parent / "step_cost"
HILLCLIMB = ("mamba2-370m", "train_4k",
             "baseline,chunk128,ssd_bf16,remat_off,bf16_opt,baseline")
BYTES_TOL = 0.01        # the card's bytes against the trace's
PEAK_TOL = 0.15         # max_memory_allocated against the traced peak
BF16_COMPUTE_TOL = 2e-2  # the bf16 route against its plain version, ·max
K4_HOST_CALLS = 200


# (d)'s loop: each variant's record, both baselines kept (the CLI's --out
# keeps one record a variant, the last)
_HILLCLIMB = """import json, sys
from repro_torch.launch import hillclimb
arch, shape, variants, out = sys.argv[1:]
recs = []
for v in variants.split(","):
    recs.append(hillclimb.run_variant(arch, shape, v))
    hillclimb.print_rec(recs[-1])
json.dump(recs, open(out, "w"))
"""


def start_cli(name, *argv):
    """``python <argv> <file>`` (the dry run's CLI, or the hillclimb's
    loop) in a subprocess that sees no device (a trace needs none) and
    takes one thread, writing its records to ``<file>``; started now,
    collected by ``finish_cli``, killed at exit if still running."""
    COST_DIR.mkdir(parents=True, exist_ok=True)
    out = COST_DIR / f"{name}.json"
    out.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                           / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    # its output to a file: a pipe nobody reads until the end would stop
    # a chatty job once the pipe's buffer fills
    log = open(COST_DIR / f"{name}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, *argv, str(out)], stdout=log,
        stderr=subprocess.STDOUT, text=True, env=env,
        cwd=Path(__file__).resolve().parent)
    atexit.register(_stop, proc)
    return dict(proc=proc, out=out, log=log, t0=time.perf_counter())


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def finish_cli(job):
    """(its records, its output, its seconds, the seconds waited for it
    here)."""
    t0 = time.perf_counter()
    job["proc"].wait()
    waited = time.perf_counter() - t0
    job["log"].close()
    log = Path(job["log"].name).read_text()
    assert job["proc"].returncode == 0, log[-4000:]
    return (json.loads(job["out"].read_text()), log,
            time.perf_counter() - job["t0"], waited)


def dryrun_phase(job):
    """(a) ``python -m repro_torch.launch.dryrun --all``: 40 records, no
    error, skipped exactly where ``supports_shape`` refuses; each record's
    numbers printed."""
    recs, _, seconds, waited = finish_cli(job)
    archs = registry.list_archs()
    assert len(recs) == len(archs) * len(SHAPES), len(recs)
    errors = [r for r in recs if r["status"] == "error"]
    assert not errors, errors
    refused = {(a, s) for a in archs for s in SHAPES
               if not api.supports_shape(registry.get(a), SHAPES[s])[0]}
    assert {(r["arch"], r["shape"]) for r in recs
            if r["status"] == "skipped"} == refused
    for r in recs:
        if r["status"] != "ok":
            emit(phase="dryrun", arch=r["arch"], shape=r["shape"],
                 status=r["status"], reason=r["reason"])
            continue
        emit(phase="dryrun", arch=r["arch"], shape=r["shape"],
             status="ok", optimizer=r.get("optimizer"),
             flops=r["flops_per_chip"], bytes=r["hbm_bytes_per_chip"],
             peak_gb=r["memory"]["peak_bytes"] / 1e9,
             argument_gb=r["memory"]["argument_bytes"] / 1e9,
             compute_s=r["compute_s"], memory_s=r["memory_s"],
             collective_s=r["collective_s"], dominant=r["dominant"],
             useful_flops_ratio=r["useful_flops_ratio"],
             trace_s=r["lower_s"])
    emit(phase="dryrun_seconds", records=len(recs), seconds=seconds,
         waited_s=waited, skipped=sorted(refused))
    return recs


def serving_trace(arch):
    """The dry run's count of ``arch`` at full width under this script's
    serving traffic, on ``meta``: the prefill of 8 x 2,048 tokens into a
    cache of 2,080 positions, and a decode step at the cache's last
    position. Touches no device."""
    cfg = registry.get(arch)
    params = api.init(cfg, 0, device="meta")
    target = SERVE_PROMPT + SERVE_NEW
    batch = dryrun.step_inputs(cfg, InputShape(
        "serve", SERVE_PROMPT, SERVE_BATCH, "prefill"), "meta")
    pre = dryrun.count_step(
        lambda p, b: api.prefill(cfg, p, b, target_len=target),
        (params, batch))
    cache = api.cache_init(cfg, SERVE_BATCH, target, device="meta")
    cache["index"] = target - 1
    dec = dryrun.count_step(steps.make_decode_step(cfg), (
        params, cache, torch.empty((SERVE_BATCH, 1), dtype=torch.int32,
                                   device="meta")))
    row = dict(phase="serving_trace", arch=arch,
               params_gb=pre.argument_bytes / 1e9,
               prefill_peak_gb=pre.peak_bytes / 1e9,
               decode_peak_gb=dec.peak_bytes / 1e9,
               prefill_flops=pre.flops, decode_flops=dec.flops,
               card_gb=torch.cuda.get_device_properties(0).total_memory
               / 1e9)
    row["fits"] = max(row["prefill_peak_gb"],
                      row["decode_peak_gb"]) < row["card_gb"]
    emit(**row)
    return row


def free_card():
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def against_card(label, cfg, shape, optimizer="adamw"):
    """(b) One step traced on ``meta``, then the same step on the card
    under the same counter: FLOPs equal (every operator), bytes within
    ``BYTES_TOL`` (the operators that differ named), the card's
    ``max_memory_allocated`` over the step within ``PEAK_TOL`` of the
    traced peak; then the step timed three times uncounted, no faster than
    its roofline floor max(compute_s, memory_s)."""
    meta = dryrun.count_step(*dryrun.step_args(cfg, shape, optimizer, True,
                                               "meta"))
    free_card()
    base = torch.cuda.memory_allocated()
    fn, args = dryrun.step_args(cfg, shape, optimizer, True, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card = dryrun.count_step(fn, args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    del fn, args
    free_card()
    ops = set(meta.op_bytes) | set(card.op_bytes)
    flop_diff = {op: (meta.op_flops.get(op), card.op_flops.get(op))
                 for op in set(meta.op_flops) | set(card.op_flops)
                 if meta.op_flops.get(op) != card.op_flops.get(op)}
    byte_diff = {op: (meta.op_bytes[op], card.op_bytes[op]) for op in ops
                 if meta.op_bytes[op] != card.op_bytes[op]}
    terms = rl.roofline_terms(meta.flops, meta.bytes, {})
    floor_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    step_ms = float(np.median(walls))
    quadratic = sum(meta.op_bytes[op] for op in
                    ("aten.select_backward", "aten.add"))
    row = dict(phase="dryrun_vs_card", cell=label, kind=shape.kind,
               batch=shape.global_batch, seq=shape.seq_len,
               flops_meta=meta.flops, flops_card=card.flops,
               bytes_meta=meta.bytes, bytes_card=card.bytes,
               peak_gb_meta=meta.peak_bytes / 1e9, peak_gb_card=peak / 1e9,
               peak_gap=(peak - meta.peak_bytes) / peak,
               argument_gb=meta.argument_bytes / 1e9,
               flop_diff=flop_diff, byte_diff=byte_diff,
               top_bytes=meta.op_bytes.most_common(6),
               select_backward_and_add_share=quadratic / meta.bytes,
               compute_ms=terms["compute_s"] * 1e3,
               memory_ms=terms["memory_s"] * 1e3, floor_ms=floor_ms,
               step_ms=step_ms, step_walls_ms=walls,
               step_over_floor=step_ms / floor_ms)
    emit(**row)
    assert not flop_diff and meta.flops == card.flops, row
    assert abs(card.bytes - meta.bytes) <= BYTES_TOL * meta.bytes, row
    assert abs(row["peak_gap"]) <= PEAK_TOL, row
    assert step_ms >= floor_ms, row
    return row


def _ssd_inputs_bf16(b, length, h, p, n, g, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, length, h, p, device="cuda", generator=gen).to(
        torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.randn(b, length, h, device="cuda", generator=gen))
    A = -torch.exp(0.2 * torch.randn(h, device="cuda", generator=gen))
    Bm, Cm = (torch.randn(b, length, g, n, device="cuda", generator=gen)
              .to(torch.bfloat16) for _ in range(2))
    return x, dt, A, Bm, Cm


def check_ssd_bf16(label, b, length, h=32, p=64, n=128, g=1, chunk=256,
                   reps=20):
    """(c) K6's bf16-compute route (``tensor_cores_bf16``: every operand of
    an mma one bf16) against its plain version, ``ssd_chunked`` at bf16
    compute on the card: y and the final state within
    ``BF16_COMPUTE_TOL``·max|plain|; timed beside the hi/lo route (the
    float32-compute route at the same inputs) in turns; the bound from
    K6's ``cost``; the route's kernels' HMMA count."""
    x, dt, A, Bm, Cm = _ssd_inputs_bf16(b, length, h, p, n, g,
                                        b * 7919 + length)
    rep = h // g
    bf16 = dict(chunk=chunk, compute_dtype="bfloat16")
    y, state = k6.ssd_scan(x, dt, A, Bm, Cm, **bf16)
    y_plain, s_plain = k6.ssd_chunked(
        x, dt, A, Bm.repeat_interleave(rep, 2), Cm.repeat_interleave(rep, 2),
        chunk, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert k6.route(x.dtype, p, n, min(chunk, length),
                    compute_dtype=torch.bfloat16) == "tensor_cores_bf16"
    y_rel, s_rel = _rel_err(y, y_plain), _rel_err(state, s_plain)
    turns = {"bf16": [], "hilo": []}
    for route in ("bf16", "hilo", "hilo", "bf16"):
        kw = bf16 if route == "bf16" else dict(chunk=chunk)
        turns[route].append(time_ms(
            lambda: k6.ssd_scan(x, dt, A, Bm, Cm, **kw), reps))
    plain_ms, plain_call_ms = time_ms(lambda: k6.ssd_chunked(
        x, dt, A, Bm.repeat_interleave(rep, 2), Cm.repeat_interleave(rep, 2),
        chunk, compute_dtype=torch.bfloat16), 3)
    q = min(chunk, length)
    flops, nbytes = k6.cost(b, length, h, p, n, g, q, torch.bfloat16)
    b_ms, b_by = roofline_ms(flops, nbytes, BF16_FLOPS)
    hmma = {name: ops["HMMA"] for name, ops in sass_ops("ssd_scan").items()
            if name in (f"ssd_state_kernel<{p},0>",
                        f"ssd_chunk_scan_kernel<{p},0>")}
    assert len(hmma) == 2 and all(hmma.values()), hmma
    kernel_ms = float(np.mean([t[0] for t in turns["bf16"]]))
    row = dict(phase="kernel_check", kernel="ssd_scan",
               case=label + ", bf16 compute", route="tensor_cores_bf16",
               b=b, l=length, h=h, p=p, n=n, g=g, chunk=q,
               max_abs_err=(y.float() - y_plain.float()).abs().max().item(),
               y_rel_err=y_rel, state_rel_err=s_rel, tol=BF16_COMPUTE_TOL,
               kernel_ms=kernel_ms,
               kernel_ms_turns=[t[0] for t in turns["bf16"]],
               hilo_ms=float(np.mean([t[0] for t in turns["hilo"]])),
               hilo_ms_turns=[t[0] for t in turns["hilo"]],
               kernel_call_ms=turns["bf16"][0][1], plain_ms=plain_ms,
               plain_call_ms=plain_call_ms, library=None, library_ms=None,
               bound_ms=b_ms, bound_by=b_by, hmma=hmma,
               attained_tflops=flops / (kernel_ms * 1e-3) / 1e12)
    emit(**row)
    assert y_rel <= BF16_COMPUTE_TOL and s_rel <= BF16_COMPUTE_TOL, row
    return row


def check_ssd_bf16_grad(b, length, h=32, p=64, n=128, g=1, chunk=256):
    """(c) The gradient through K6's Function at bf16 compute (the route's
    forward, the VJP of the bf16 chunked form) against autograd through
    the plain bf16 chunked form, every input within ``GRAD_TOL`` (bf16)."""
    x, dt, A, Bm, Cm = _ssd_inputs_bf16(b, length, h, p, n, g, 17)
    dy = torch.randn_like(x)
    rep = h // g
    grads = {}
    for name in ("kernel", "plain"):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        if name == "kernel":
            y, _ = k6.ssd_scan(*ins, chunk=chunk, compute_dtype="bfloat16")
        else:
            y, _ = k6.ssd_chunked(ins[0], ins[1], ins[2],
                                  ins[3].repeat_interleave(rep, 2),
                                  ins[4].repeat_interleave(rep, 2), chunk,
                                  compute_dtype=torch.bfloat16)
        grads[name] = torch.autograd.grad(y, ins, dy)
    errs = {nm: _rel_err(a, b_) for nm, a, b_ in zip(
        ("x", "dt", "A", "B", "C"), grads["kernel"], grads["plain"])}
    row = dict(phase="kernel_grad_check", kernel="ssd_scan",
               case="mamba2-370m train, bf16 compute", b=b, l=length,
               errs=errs, tol=GRAD_TOL[torch.bfloat16])
    emit(**row)
    assert all(e <= GRAD_TOL[torch.bfloat16] for e in errs.values()), row
    return row


def mamba2_bf16_prefill():
    """(c) ``mamba2-370m`` (48 layers, bf16) prefilling 8 x 2,048 tokens
    with ``ssm.compute_dtype="bfloat16"`` against the same weights at
    float32 compute: logits within ``LOGIT_TOL``·max|logit|; both
    prefills timed in turns; K6 launched once a layer through the new
    route (the launch count of the kernels line's row)."""
    cfg = registry.get("mamba2-370m")
    cfg16 = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, compute_dtype="bfloat16"))
    params = api.init(cfg, 0, device="cuda")
    batch = {"tokens": prompts(cfg, SERVE_BATCH, SERVE_PROMPT)}

    def prefill(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = api.prefill(c, params, batch)
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t0) * 1e3
    prefill(cfg)
    prefill(cfg16)
    ms = {"float32": [], "bfloat16": []}
    for name, c in (("float32", cfg), ("bfloat16", cfg16),
                    ("bfloat16", cfg16), ("float32", cfg)):
        ms[name].append(prefill(c)[1])
    reset_launches()
    logits16, _ = prefill(cfg16)
    launches = read_launches()
    logits32, _ = prefill(cfg)
    gap = _rel_err(logits16, logits32)
    row = dict(phase="ssd_bf16_prefill", arch=cfg.name, batch=SERVE_BATCH,
               prompt=SERVE_PROMPT, launches=launches, logit_gap=gap,
               tol=LOGIT_TOL, prefill_ms_float32=ms["float32"],
               prefill_ms_bfloat16=ms["bfloat16"])
    emit(**row)
    assert launches == only(ssd_scan=cfg.n_layers), launches
    assert gap <= LOGIT_TOL, row
    del params
    free_card()
    return launches["ssd_scan"]


def k3_backward_yardstick(reps=5):
    """K3's backward at the training shape (2, 16, 4,096, 128) causal bf16:
    the plain VJP the Function runs, timed beside the one PyTorch call
    that computes the same gradient (SDPA's forward and backward), with the
    bound from K3's ``backward_cost``."""
    b, h, s, d = TRAIN_BATCH, 16, TRAIN_SEQ, 128
    g = torch.Generator(device="cuda").manual_seed(24)
    qkv = [torch.randn(b, h, s, d, device="cuda", generator=g).to(
        torch.bfloat16).requires_grad_(True) for _ in range(3)]
    cot = torch.randn(b, h, s, d, device="cuda", generator=g).to(
        torch.bfloat16)
    out = k3.flash_attention(*qkv)
    plain_ms, plain_call_ms = time_ms(lambda: torch.autograd.grad(
        out, qkv, cot, retain_graph=True), reps)
    del out

    def sdpa():
        o = torch.nn.functional.scaled_dot_product_attention(
            *qkv, is_causal=True)
        return torch.autograd.grad(o, qkv, cot)
    library_ms, library_call_ms = time_ms(sdpa, reps)
    b_ms, b_by = roofline_ms(*k3.backward_cost(b, h, s, s, d, True, None,
                                               torch.bfloat16), BF16_FLOPS)
    row = dict(phase="k3_backward", b=b, h=h, s=s, d=d,
               backward_ms=plain_ms, backward_call_ms=plain_call_ms,
               library="scaled_dot_product_attention forward + backward",
               library_ms=library_ms, library_call_ms=library_call_ms,
               bound_ms=b_ms, bound_by=b_by)
    emit(**row)
    del qkv
    free_card()
    return row


def k4_host_cost(turns=3):
    """One K4 call's host time at starcoder2-15b's decode shape, three
    ways in turns: before the op layer (``_check`` and the launch, as the
    wrapper was), through the ``torch.library`` operator (the wrapper now)
    and through a ``torch.library.custom_op`` wrapping the same launch
    (the higher layer, not taken). Each reading: ``K4_HOST_CALLS`` calls
    back to back, host seconds before the synchronise over the calls."""
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(SERVE_BATCH, 48, 128, device="cuda", generator=g).to(
        torch.bfloat16)
    kc, vc = (torch.randn(SERVE_BATCH, SERVE_PROMPT + SERVE_NEW, 4, 128,
                          device="cuda", generator=g).to(torch.bfloat16)
              for _ in range(2))
    n = SERVE_PROMPT + 16
    k, v = kc[:, :n], vc[:, :n]

    @torch.library.custom_op("chip_smoke::decode_attention", mutates_args=())
    def custom(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length: int) -> torch.Tensor:
        return k4._kernel(q, k, v, length)
    custom.register_fake(lambda q, k, v, length: q.new_empty(q.shape))

    ways = {"before": lambda: (k4._check(q, k, v, n),
                               k4._kernel(q, k, v, n)),
            "op": lambda: k4.decode_attention(q, k, v, n),
            "custom_op": lambda: custom(q, k, v, n)}
    us = {name: [] for name in ways}
    for fn in ways.values():
        fn()
    for _ in range(turns):
        for name in (*ways, *reversed(ways)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(K4_HOST_CALLS):
                ways[name]()
            us[name].append((time.perf_counter() - t0) / K4_HOST_CALLS
                            * 1e6)
            torch.cuda.synchronize()
    med = {name: float(np.median(v_)) for name, v_ in us.items()}
    row = dict(phase="k4_host_cost", calls=K4_HOST_CALLS, host_us=us,
               median_us=med, op_adds_us=med["op"] - med["before"],
               custom_op_adds_us=med["custom_op"] - med["before"])
    emit(**row)
    return row


BI_HOST_CALLS = 200


def bi_host_cost(turns=3):
    """The host µs of one call of the task plane's kernels at the §V
    training shapes (x @ w1: 50 x 50 x 784 x 64; the bias gradient's sum:
    50 x 50 x 64), layer by layer in turns: torch's own op (the parent's
    call), the ctypes launch alone, ``_kernel`` (the output's allocation,
    the device guard and stream, the launch), the ``torch.library``
    operator, the wrapper (its checks, then the operator) and the route's
    entry with a Function (``bi._product`` / ``bi.sum_trailing`` on an
    input that needs a gradient: ``Function.apply``, the forward, the
    wrapper). Each reading: ``BI_HOST_CALLS`` calls back to back, host
    seconds before the synchronise over the calls."""
    a, b = _randn(50, 50, 784, seed=1), _randn(50, 784, 64, seed=2)
    x = _randn(50, 50, 64, seed=3)
    ag, xg = a.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = torch.empty(50, 50, 64, device="cuda")
    red = torch.empty(50, 64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gemm = kbg._launcher()
    reduce_ = kbr._launchers()[kbr.SUM]
    ways = {
        "gemm": {
            "torch": lambda: torch.bmm(a, b),
            "launch": lambda: gemm(a.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), 50, 50, 64, 784,
                                   *a.stride(), *b.stride(), stream),
            "kernel": lambda: kbg._kernel(a, b),
            "op": lambda: kbg._op(a, b),
            "wrapper": lambda: kbg.bi_gemm(a, b),
            "function": lambda: bi._product(ag, b)},
        "reduce": {
            "torch": lambda: x.sum(1),
            "launch": lambda: reduce_(x.data_ptr(), red.data_ptr(), 50, 50,
                                      64, stream),
            "kernel": lambda: kbr._kernel(x, kbr.SUM),
            "op": lambda: kbr._op(x, kbr.SUM),
            "wrapper": lambda: kbr.bi_reduce(x),
            "function": lambda: bi.sum_trailing(xg.reshape(50, -1, 1), 1)}}
    rows = {}
    for kind, fns in ways.items():
        us = {name: [] for name in fns}
        for fn in fns.values():
            fn()
        for _ in range(turns):
            for name in (*fns, *reversed(fns)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(BI_HOST_CALLS):
                    fns[name]()
                us[name].append((time.perf_counter() - t0) / BI_HOST_CALLS
                                * 1e6)
                torch.cuda.synchronize()
        rows[kind] = dict(host_us=us, median_us={
            name: float(np.median(v_)) for name, v_ in us.items()})
    emit(phase="bi_host_cost", calls=BI_HOST_CALLS, **rows)
    return rows


def step_cost_phases(dry_job, climb_job):
    """Phase 17: (a) the full dry run (started after the build) and the
    serving trace of moonshot-v1-16b-a3b; (b) the dry run against the card
    at three cells; (c) K6's bf16-compute route, its gradient and
    mamba2's bf16-compute prefill; (d) the hillclimb (started after the
    build); K3's backward beside SDPA's, K4's host cost. Returns (K6's
    bf16-compute row, its launches on the bf16-compute prefill)."""
    bf16 = torch.bfloat16
    qwen = registry.get("qwen2-moe-a2.7b")
    train = InputShape("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    against_card("qwen2-moe-a2.7b, 4 layers",
                 dataclasses.replace(qwen, n_layers=4), train)
    against_card("mamba2-370m", registry.get("mamba2-370m"), train)
    against_card("starcoder2-15b prefill", registry.get("starcoder2-15b"),
                 InputShape("prefill_2k", SERVE_PROMPT, SERVE_BATCH,
                            "prefill"))
    k6_row = check_ssd_bf16("mamba2-370m prefill", SERVE_BATCH, SERVE_PROMPT)
    check_ssd_bf16("mamba2-370m train", TRAIN_BATCH, TRAIN_SEQ)
    check_ssd_bf16_grad(TRAIN_BATCH, TRAIN_SEQ)
    launches = mamba2_bf16_prefill()
    k3_backward_yardstick()
    k4_host_cost()
    serving_trace("moonshot-v1-16b-a3b")
    recs, _, seconds, waited = finish_cli(climb_job)
    assert [r["variant"] for r in recs] == HILLCLIMB[2].split(","), recs
    assert all(r["status"] == "ok" for r in recs), recs
    first, last = (dict(r) for r in (recs[0], recs[-1]))
    first.pop("lower_s"), last.pop("lower_s")
    for r in recs:
        emit(phase="hillclimb", arch=r["arch"], shape=r["shape"],
             variant=r["variant"], flops=r["flops_per_chip"],
             bytes=r["hbm_bytes_per_chip"],
             peak_gb=r["memory"]["peak_bytes"] / 1e9,
             compute_s=r["compute_s"], memory_s=r["memory_s"],
             dominant=r["dominant"],
             useful_flops_ratio=r["useful_flops_ratio"])
    emit(phase="hillclimb_seconds", seconds=seconds, waited_s=waited)
    assert first == last, (first, last)
    dryrun_phase(dry_job)
    return k6_row, launches


# ---------------------------------------------------------------------------
# The contract checker (phase 18)
# ---------------------------------------------------------------------------
CHECK_REPORT = (Path(__file__).resolve().parent / "chiprun_out"
                / "check_report_torch.json")


def contracts_cli():
    """(a) ``python -m repro_torch.check --strict --device cuda --json``:
    every checker, its trace pass on the card; exit 0, ``contracts:
    clean``."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "--strict", "--device",
         "cuda", "--json", "--out", str(CHECK_REPORT)],
        capture_output=True, text=True, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    assert "contracts: clean" in proc.stdout.splitlines(), proc.stdout
    report = json.loads(CHECK_REPORT.read_text())
    emit(phase="contracts_cli", seconds=seconds, ok=report["ok"],
         per_checker=report["per_checker"], gpu=report["meta"].get("gpu"),
         dead=report["inventory"]["n_dead"],
         modules=report["inventory"]["n_modules"])
    assert report["ok"] and report["meta"]["gpu"], report["meta"]


def contracts_trace():
    """(b) the trace entries on the card, K1 and K2 launched through their
    operators; the negative control, one ``.double()`` in a data-plane
    function, reported."""
    from repro_torch.check import trace as check_trace
    from repro_torch.federated.cohort import broadcast_params
    reset_launches()
    report = check_trace.trace_report("cuda")
    launches = read_launches()
    for e in report:
        emit(phase="contracts_trace", name=e["name"], kind=e["kind"],
             outputs=e["outputs"], ops=e["ops"],
             violations=[v.format() for v in e["violations"]])
    emit(phase="contracts_trace_launches", launches=launches)
    by = {e["name"]: e for e in report}
    for name in ("aggregation.fedavg_stacked", "kernels.weighted_aggregate"):
        assert "repro_torch.weighted_aggregate" in by[name]["ops"], by[name]
    for mode in ("trimmed_mean", "median"):
        e = by[f"kernels.robust_aggregate[{mode}]"]
        assert "repro_torch.robust_aggregate" in e["ops"], e
    for e in report:
        assert e["violations"] == [], e
        want = "torch.float32" if e["kind"] == "f32" else "float64"
        assert e["outputs"] and set(e["outputs"]) == {want}, e
    # the trace ran the kernels: K1 in fedavg_stacked and its own entry,
    # K2 in its two
    assert launches == only(weighted_aggregate=2, robust_aggregate=2), (
        launches)
    from repro_torch.federated.task import TASKS
    g = TASKS["mnist_mlp"].init_params(PRNGKey(0, "cuda"), "cuda")
    st = broadcast_params(g, 2)
    st = {k: (v.double() if k == "w1" else v) for k, v in st.items()}
    vs = check_trace.assert_no_f64(
        "negative control: ModelAttack.apply_stacked, w1 in float64",
        lambda: atk.ModelAttack(scale=-1.0).apply_stacked(
            st, g, np.array([True, False])))
    emit(phase="contracts_negative_control",
         violations=[v.format() for v in vs])
    assert vs and all(v.rule == "trace-f64" for v in vs), vs


def host_sync_inputs(k2_rows, k2_n):
    """One call of each of K1-K6's public wrappers at a main-path shape of
    phase 3, its inputs made on the card beforehand (a copy from the host
    is itself a sync)."""
    g = torch.Generator(device="cuda").manual_seed(18)
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(*shape, dtype=f32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    cap, length = SERVE_PROMPT + SERVE_NEW, SERVE_PROMPT + SERVE_NEW // 2
    k1 = (rnd(32, M_MLP), rnd(32).abs())
    k2 = rnd(k2_rows, M_MLP)
    lm = [rnd(64, 4, 32, 16) for _ in range(3)]
    sc = (rnd(SERVE_BATCH, 48, SERVE_PROMPT, 128, dtype=bf16),
          rnd(SERVE_BATCH, 4, SERVE_PROMPT, 128, dtype=bf16),
          rnd(SERVE_BATCH, 4, SERVE_PROMPT, 128, dtype=bf16))
    dec = (rnd(SERVE_BATCH, 48, 128, dtype=bf16),
           rnd(SERVE_BATCH, cap, 4, 128, dtype=bf16),
           rnd(SERVE_BATCH, cap, 4, 128, dtype=bf16))
    moe = (rnd(60, 8, 2048, dtype=bf16), rnd(60, 2048, 1408, dtype=bf16))
    b, n = SERVE_BATCH, SERVE_PROMPT
    ssd = (rnd(b, n, 32, 64, dtype=bf16), rnd(b, n, 32).abs() * 0.1,
           -rnd(32).abs(), rnd(b, n, 1, 128, dtype=bf16),
           rnd(b, n, 1, 128, dtype=bf16))
    trim = TrimmedMean(0.2).n_trim(k2_n)
    return [
        ("K1 weighted_aggregate (32, M_MLP) f32",
         lambda: weighted_aggregate(*k1)),
        (f"K2 robust_aggregate run (a) ({k2_rows}, M_MLP), n {k2_n}",
         lambda: robust_aggregate(k2, k2_n, trim=trim)),
        ("K3 flash_attention lm_tiny f32",
         lambda: k3.flash_attention(*lm)),
        ("K3 flash_attention starcoder2-15b prefill bf16",
         lambda: k3.flash_attention(*sc)),
        ("K4 decode_attention starcoder2-15b decode",
         lambda: k4.decode_attention(*dec, length)),
        ("K5 moe_gemm qwen2-moe-a2.7b decode gate/up",
         lambda: k5.moe_gemm(*moe)),
        ("K6 ssd_scan mamba2-370m prefill",
         lambda: k6.ssd_scan(*ssd, chunk=256)),
    ] + host_sync_backwards(rnd)


def host_sync_backwards(rnd):
    """One forward and backward each of K3, K5 and K6 through their
    autograd Functions (a list like ``host_sync_inputs``'), the inputs and
    cotangents made on the card beforehand: K3 at lm_tiny's f32 shape
    (its plain VJP), K5 at qwen2-moe-a2.7b's decode gate/up (two more K5
    launches), K6 at mamba2-370m's heads over 512 positions (the chunked
    VJP)."""
    bf16 = torch.bfloat16

    def leaf(*shape, dtype=torch.float32, scale=1.0):
        return (rnd(*shape, dtype=dtype) * scale).detach().requires_grad_()

    qkv = [leaf(64, 4, 32, 16) for _ in range(3)]
    g3 = rnd(64, 4, 32, 16)
    moe = (leaf(60, 8, 2048, dtype=bf16),
           leaf(60, 2048, 1408, dtype=bf16, scale=0.02))
    g5 = rnd(60, 8, 1408, dtype=bf16)
    b, n = 1, 512
    ssd = (leaf(b, n, 32, 64, dtype=bf16), (rnd(b, n, 32).abs() * 0.1)
           .requires_grad_(), (-rnd(32).abs()).requires_grad_(),
           leaf(b, n, 1, 128, dtype=bf16), leaf(b, n, 1, 128, dtype=bf16))
    g6 = rnd(b, n, 32, 64, dtype=bf16)

    def grads(out, ins, g):
        return torch.autograd.grad(out, ins, g)

    return [
        ("K3 flash_attention lm_tiny f32, forward and backward",
         lambda: grads(k3.flash_attention(*qkv), qkv, g3)),
        ("K5 moe_gemm qwen2-moe-a2.7b decode gate/up, forward and backward",
         lambda: grads(k5.moe_gemm(*moe), moe, g5)),
        ("K6 ssd_scan mamba2-370m heads over 512 positions, forward and "
         "backward",
         lambda: grads(k6.ssd_scan(*ssd, chunk=256)[0], ssd, g6)),
    ]


def host_sync_routed_steps():
    """One routed masked SGD step each of the §V MLP (a bucket of 50
    clients of 50 samples) and lm_tiny (24 clients of 8 windows), as the
    vectorized engine runs it: inside the task plane's route, so every
    product and sum is ``bi_gemm`` or ``bi_reduce``, forward and backward
    (a list like ``host_sync_inputs``'). The params and batches are made on
    the card beforehand, and each step runs once here unarmed (the route's
    count tensors and K3's mask are cached at a first call). Returns the
    calls and the two kernels' launches of one run of all of them."""
    g = np.random.default_rng(28)
    mlp_p = tmlp.mlp_init(PRNGKey(0, "cuda"), device="cuda")
    lm_p = tf.lm_init(PRNGKey(1, "cuda"), LM_TINY, device="cuda")

    def stack(params, n):
        return {k: v.expand((n,) + v.shape).clone() for k, v in
                params.items()}

    mlp_b = {"x": torch.as_tensor(g.random((50, 50, 784), dtype=np.float32)),
             "y": torch.as_tensor(g.integers(0, 10, (50, 50))),
             "m": torch.ones(50, 50)}
    lm_b = {"tokens": torch.as_tensor(g.integers(0, 64, (24, 8, 32))),
            "m": torch.ones(24, 8)}
    mlp_b = {k: v.cuda() for k, v in mlp_b.items()}
    lm_b = {k: v.cuda() for k, v in lm_b.items()}
    mlp_s, lm_s = stack(mlp_p, 50), stack(lm_p, 24)

    def mlp_step():
        with bi.route():
            return tf.sgd_step(mlp_s, lambda p: tmlp.mlp_loss_masked(
                p, mlp_b), 0.1)["w1"]

    def lm_step():
        with bi.route():
            return tf.sgd_step(lm_s, lambda p: tf.lm_loss_masked(
                LM_TINY, p, lm_b), 0.3)["embed"]

    calls = [("the §V MLP's routed masked SGD step (50 clients)", mlp_step),
             ("lm_tiny's routed masked SGD step (24 clients)", lm_step)]
    torch.cuda.synchronize()
    reset_launches()
    reset_bi()
    for _, call in calls:
        call()
    torch.cuda.synchronize()
    return calls, read_bi(), read_launches()


def contracts_host_sync(k2_rows, k2_n):
    """(c) each of K1-K6's public wrappers once, then a forward and
    backward of each of K3, K5 and K6, then one routed masked SGD step of
    the §V MLP and one of lm_tiny (``bi_gemm``, ``bi_reduce``, the route's
    Functions, forward and backward), under
    ``torch.cuda.set_sync_debug_mode("error")``: none may synchronise
    with the host; the control, ``.item()``, must raise."""
    calls = host_sync_inputs(k2_rows, k2_n)
    routed, bi_want, routed_launches = host_sync_routed_steps()
    calls += routed
    torch.cuda.synchronize()
    reset_launches()
    reset_bi()
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for label, call in calls:
            outs.append(call())
        x = outs[0]
        try:
            x.sum().item()
        except RuntimeError as e:
            control = str(e).splitlines()[0]
        else:
            raise AssertionError(".item() under sync debug mode 'error' "
                                 "did not raise: the mode was not armed")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches, bi_got = read_launches(), read_bi()
    for (label, _), out in zip(calls, outs):
        y = out[0] if isinstance(out, tuple) else out
        emit(phase="contracts_host_sync", call=label, shape=list(y.shape),
             finite=bool(torch.isfinite(y).all()))
        assert torch.isfinite(y).all(), label
    emit(phase="contracts_host_sync_launches", launches=launches,
         control=control, **bi_got)
    # lm_tiny's step launches K3 once a layer (its forward; the backward is
    # the route's invariant VJP on bi_gemm and bi_reduce)
    assert routed_launches == only(flash_attention=LM_TINY.n_layers), (
        routed_launches)
    assert launches == only(weighted_aggregate=1, robust_aggregate=1,
                            flash_attention=3 + LM_TINY.n_layers,
                            decode_attention=1, moe_gemm=4,
                            ssd_scan=2), launches
    # the routed steps' every product and sum: the two kernels, as many
    # launches as the same steps made unarmed
    assert bi_got == bi_want and all(n > 0 for n in bi_got.values()), (
        bi_got, bi_want)


def contracts_phases(k2_rows, k2_n):
    """Phase 18: (a) the checker's CLI with its trace on the card, (b) the
    trace in process with the operators it ran and its negative control,
    (c) K1-K6 under the sync debug mode; returns its seconds."""
    t0 = time.perf_counter()
    contracts_cli()
    contracts_trace()
    contracts_host_sync(k2_rows, k2_n)
    return time.perf_counter() - t0


# 19. the sharded plane: the paper's §V cohort on one rank
COHORT = dict(n_clients=50, samples=256, lr=0.1, local_steps=5, seed=19)


def cohort_inputs(server, device):
    """(params, batch, weights, select) of the §V cohort on ``device``:
    50 clients of 256 synthetic MNIST samples drawn from the seed, the
    quickstart clients' D_k as the weights, the DQS selection x_k of its
    first round as the mask, and MLP params drawn from the seed."""
    n, b = COHORT["n_clients"], COHORT["samples"]
    data, _ = generate(n * b, 1, seed=COHORT["seed"])
    batch = {"x": torch.from_numpy(data.x.reshape(n, b, -1)).to(device),
             "y": torch.from_numpy(data.y.reshape(n, b).astype(np.int64))
             .to(device)}
    weights = torch.tensor([float(c.size) for c in server.clients],
                           device=device)
    select = torch.zeros(n, device=device)
    select[torch.as_tensor(server.logs[0].selected, device=device)] = 1.0
    params = tmlp.mlp_init(PRNGKey(COHORT["seed"], device), device=device)
    return params, batch, weights, select


def cohort_oracle(params, batch, weights, select):
    """Check 1's plain version: each client's local SGD one at a time
    through ``torch.autograd.grad``, then ``weighted_aggregate_ref`` over
    the masked weights divided by max(sum w·s, 1e-9)."""
    lr, steps = COHORT["lr"], COHORT["local_steps"]
    locs = []
    for i in range(weights.shape[0]):
        p = dict(params)
        for _ in range(steps):
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            loss = tmlp.mlp_loss(leaves, {"x": batch["x"][i],
                                          "y": batch["y"][i]})
            gr = torch.autograd.grad(loss, list(leaves.values()))
            p = {k: (v.detach().float() - lr * g.float()).to(v.dtype)
                 for (k, v), g in zip(leaves.items(), gr)}
        locs.append(p)
    flat = flatten_stacked({k: torch.stack([q[k] for q in locs])
                            for k in params})
    w = (weights * select).float()
    agg = weighted_aggregate_ref(flat, w, assume_normalized=True)
    return unflatten(agg / torch.clamp_min(w.sum(), 1e-9), params)


def leaf_gap(got, want):
    """The largest |got - want| over the leaves, and whether every leaf is
    within 2e-5 abs/rel (the reference test's tolerance)."""
    gap = max(float((got[k] - want[k]).abs().max()) for k in want)
    close = all(torch.allclose(got[k], want[k], atol=2e-5, rtol=2e-5)
                for k in want)
    return gap, close


def cohort_checks(mesh, cpu_mesh, server, smi):
    """Phase 19's step, checks and times on an existing process group;
    returns K1's launches in the driven step."""
    lr, steps = COHORT["lr"], COHORT["local_steps"]
    step = make_cohort_step(mesh, tmlp.mlp_loss, lr, steps)
    args = cohort_inputs(server, "cuda")
    params, batch, weights, select = args
    # the first call starts NCCL's communicator: not counted
    step(*args)
    torch.cuda.synchronize()
    reset_launches()
    out = step(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    emit(phase="cohort_step_launches", launches=launches, gpu=smi,
         n_clients=COHORT["n_clients"],
         n_selected=int(select.sum().item()), m=M_MLP)
    assert launches == only(weighted_aggregate=1), launches
    assert all(torch.isfinite(v).all() for v in out.values())

    # (1) against the plain version; (8) its control, the mask dropped
    want = cohort_oracle(*args)
    gap, close = leaf_gap(out, want)
    wrong_gap, wrong_close = leaf_gap(out, cohort_oracle(
        params, batch, weights, torch.ones_like(select)))
    emit(phase="cohort_check", check="plain version", max_abs_err=gap,
         tol="2e-5 abs/rel", control="mask dropped",
         control_max_abs_err=wrong_gap)
    assert close, gap
    assert not wrong_close, ("the control passed", wrong_gap)

    # (2) an unselected client's batch as finite garbage
    j = int(torch.nonzero(select == 0)[0].item())
    junk = {"x": batch["x"].clone(), "y": batch["y"].clone()}
    junk["x"][j] = 5.0 * junk["x"][j].flip(0) + 2.0
    junk["y"][j] = (junk["y"][j] + 3) % 10
    out2 = step(params, junk, weights, select)
    equal = all(torch.equal(out2[k], out[k]) for k in out)
    emit(phase="cohort_check", check="unselected client's garbage",
         client=j, bit_equal=equal)
    assert equal

    # (3) the same step on the CPU (gloo)
    cpu_args = (*({k: v.cpu() for k, v in t.items()}
                  for t in (params, batch)), weights.cpu(), select.cpu())
    out_cpu = make_cohort_step(cpu_mesh, tmlp.mlp_loss, lr, steps)(*cpu_args)
    cpu_gap = max(float((out[k].cpu() - out_cpu[k]).abs().max())
                  for k in out)
    emit(phase="cohort_check", check="cuda vs cpu", max_abs_diff=cpu_gap,
         tol=1e-4)
    assert cpu_gap <= 1e-4, cpu_gap

    # (4) bf16 aggregation
    out_bf = make_cohort_step(mesh, tmlp.mlp_loss, lr, steps,
                              agg_dtype=torch.bfloat16)(*args)
    bf_gap = {k: float((out_bf[k] - out[k]).abs().max()) for k in out}
    bf_tol = {k: 1e-2 * float(out[k].abs().max()) for k in out}
    emit(phase="cohort_check", check="agg_dtype bfloat16", gap=bf_gap,
         tol=bf_tol)
    assert all(bf_gap[k] <= bf_tol[k] for k in out), (bf_gap, bf_tol)

    # (5) K1 once a step call
    reset_launches()
    for _ in range(3):
        step(*args)
    torch.cuda.synchronize()
    per_call = read_launches()
    emit(phase="cohort_check", check="K1 a call", launches_3_calls=per_call)
    assert per_call == only(weighted_aggregate=3), per_call

    # (6) no host sync: the inputs are on the card already
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out6 = step(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    gap6, close6 = leaf_gap(out6, out)
    emit(phase="cohort_check", check="sync debug mode error", raised=False,
         max_abs_diff=gap6)
    assert close6, gap6

    # (7) the meta trace against the step on the card
    meta_batch, meta_w, meta_s = cohort_input_specs(
        mesh, COHORT["n_clients"], {
            "x": ((COHORT["samples"], 784), torch.float32),
            "y": ((COHORT["samples"],), torch.int64)})
    meta = dryrun.count_step(step, (
        tmlp.mlp_init(PRNGKey(0, "meta"), device="meta"), meta_batch, meta_w,
        meta_s))
    card = dryrun.count_step(step, args)
    counts = {k: dict(flops=c.flops, bytes=c.bytes,
                      collectives=rl.collective_bytes(c.op_collective_bytes))
              for k, c in (("meta", meta), ("card", card))}
    emit(phase="cohort_check", check="meta trace vs card", **counts)
    assert counts["meta"] == counts["card"], counts
    assert counts["card"]["collectives"]["all-reduce"] == (M_MLP + 1) * 4

    # (d) the times
    def timed_step():
        step(*args)
        torch.cuda.synchronize()
    step_ms = median_ms(timed_step)
    _, prof = profile_fn(lambda: step(*args), keep_prof=True)
    nccl = {name: us for name, us in device_us(prof.pop("prof")).items()
            if "nccl" in name.lower()}
    emit(phase="cohort_step", gpu=smi, step_ms_median_15=step_ms,
         allreduce_device_us=sum(nccl.values()), nccl_kernels=nccl,
         device_busy_us=prof["device_busy_us"], wall_us=prof["wall_us"],
         device_idle_share=prof["device_idle_share"],
         top_kernels_us=prof["top_kernels_us"])
    k1 = check_aggregate(COHORT["n_clients"], M_MLP, torch.float32,
                         "cohort step rows (50, M_MLP)")
    emit(phase="cohort_k1", gpu=smi, kernel_ms=k1["kernel_ms"],
         bound_ms=k1["bound_ms"], cublas_gemv_ms=k1["library_ms"],
         plain_ms=k1["plain_ms"])
    return launches["weighted_aggregate"]


def sharded_phases(server, smi, then=None):
    """Phase 19: an NCCL process group of one rank in process, the host
    mesh on the card, the cohort step and its checks; then ``then(mesh)``
    (phase 20) on the same group, which is destroyed whatever happens.
    Returns K1's launches in the driven step, the phase's seconds, and
    ``then``'s result and seconds."""
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        cpu_mesh = make_host_mesh(device_type="cpu")
        backend = type(mesh.get_group("data")._get_backend(
            torch.device("cuda"))).__name__
        emit(phase="sharded_mesh", mesh=str(mesh), cpu_mesh=str(cpu_mesh),
             cuda_backend=backend, gpu=smi,
             nccl_version=str(torch.cuda.nccl.version()))
        assert isinstance(mesh, DeviceMesh) and mesh.device_type == "cuda"
        assert mesh.mesh_dim_names == ("data", "model"), mesh
        assert tuple(mesh.shape) == (1, 1), mesh
        assert backend == "ProcessGroupNCCL", backend
        k1 = cohort_checks(mesh, cpu_mesh, server, smi)
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        after = then(mesh) if then is not None else None
    finally:
        dist.destroy_process_group()
    return k1, seconds, after, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# 20. the sharded zoo: the zoo's steps on DTensors on the (1, 1) mesh over
# phase 19's group, and the dry run on the production meshes
# ---------------------------------------------------------------------------
SHARDED_CELLS = (("qwen2-moe-a2.7b", "train_4k"),
                 ("mamba2-370m", "train_4k"),
                 ("starcoder2-15b", "prefill_32k"),
                 ("qwen2-moe-a2.7b", "decode_32k"))
SHARDED_STEPS = 3
SHARDED_LOSS_TOL = 1e-3    # relative, should the losses not be bit-equal
SHARDED_DECODE = 8         # decode steps after the prefill


def start_sharded_dryruns():
    """(c), started after the build: ``python -m repro_torch.launch.dryrun
    --arch A --shape S --mesh both`` for each of ``SHARDED_CELLS``, one
    subprocess a cell (no device, one thread), collected in phase 20."""
    return {cell: start_cli(f"dryrun_sharded_{i}", "-m",
                            "repro_torch.launch.dryrun", "--arch", cell[0],
                            "--shape", cell[1], "--mesh", "both", "--out")
            for i, cell in enumerate(SHARDED_CELLS)}


@contextlib.contextmanager
def timed_train_steps(rows):
    """``launch/train.py``'s train step with each call timed (the card
    synchronised on both sides) and its launches counted (every count set
    to 0 just before, read just after), a row a call in ``rows``."""
    real = train_cli.make_train_step

    def make(cfg, tcfg):
        step = real(cfg, tcfg)

        def timed(*args):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            rows.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                             launches=read_launches()))
            return out
        return timed
    train_cli.make_train_step = make
    try:
        yield
    finally:
        train_cli.make_train_step = real


def sharded_train_cell(label, cfg, arch, expect, smi):
    """(a) one cell: ``launch/train.py``'s ``main`` in process, 3 steps at
    2 x 4,096 tokens (AdamW, remat), on one device and then with
    ``--host-mesh`` (phase 19's group: a (1, 1) mesh, the state
    ``DTensor``s) from the same seed and batches: the losses bit-equal
    (else within ``SHARDED_LOSS_TOL``), each step's launches those of the
    plain step (``expect``: every K3, K5 or K6 call launched its kernel,
    none reached a plain version), the median ms of steps 2 and 3 beside
    the plain step's."""
    argv = ["--arch", arch, "--steps", str(SHARDED_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    runs = {}
    for mode, extra in (("plain", []), ("mesh", ["--host-mesh"])):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows, printed = [], io.StringIO()
        with timed_train_steps(rows), contextlib.redirect_stdout(printed):
            r = train_cli.main(argv + extra, cfg=cfg)
        runs[mode] = dict(
            losses=[float(dtensor.full({"l": m["loss"]})["l"])
                    for m in r["metrics"]],
            ms=[row["ms"] for row in rows],
            launches=[row["launches"] for row in rows],
            median_ms=float(np.median([row["ms"] for row in rows[1:]])),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            first_line=printed.getvalue().splitlines()[0],
            dtensor_leaves=sum(dtensor.is_dtensor(v)
                               for v in r["state"][0].values()))
        del r
    plain, mesh = runs["plain"], runs["mesh"]
    bit_equal = mesh["losses"] == plain["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(mesh["losses"],
                                                   plain["losses"]))
    row = dict(phase="sharded_train", cell=label, gpu=smi, plain=plain,
               mesh=mesh, losses_bit_equal=bit_equal, loss_rel_err=rel,
               dtensor_host_ms=mesh["median_ms"] - plain["median_ms"])
    emit(**row)
    assert mesh["first_line"].startswith("mesh {'data': 1, 'model': 1}"), row
    assert mesh["dtensor_leaves"] == len(api.init(cfg, 0, device="meta")), row
    assert plain["dtensor_leaves"] == 0, row
    assert bit_equal or rel <= SHARDED_LOSS_TOL, row
    for launches in plain["launches"] + mesh["launches"]:
        assert launches == only(**expect), (label, launches, expect)
    assert all(np.isfinite(mesh["losses"])), row
    gc.collect()
    torch.cuda.empty_cache()
    return row


def sharded_serving(mesh, smi):
    """(b) ``qwen2-moe-a2.7b`` at full width cut to 4 layers (bf16): one
    prefill of 8 prompts of 2,048 and ``SHARDED_DECODE`` decode steps fed
    the plain run's greedy tokens, plain and with the params and caches
    ``DTensor``s (params by ``param_specs``, the prompts by
    ``batch_specs``, the prefill's cache placed again by the decode
    shape's ``batch_specs``, the reference's activation specs): every
    logit bit-equal, K3, K4 and K5 launched as often (prefill K3 4, K5 12;
    a step K4 4, K5 12)."""
    from repro_torch.sharding import specs as sp
    cfg = dataclasses.replace(registry.get("qwen2-moe-a2.7b"), n_layers=4)
    params = api.init(cfg, 0, device="cuda")
    tokens = prompts(cfg, SERVE_BATCH, SERVE_PROMPT)
    target = SERVE_PROMPT + SHARDED_DECODE
    pre = InputShape("prefill", SERVE_PROMPT, SERVE_BATCH, "prefill")
    dec = InputShape("decode", target, SERVE_BATCH, "decode")
    expect_pre = only(flash_attention=4, moe_gemm=12)
    expect_dec = only(decode_attention=4, moe_gemm=12)

    def run(P, B, place_cache, specs_pre, specs_dec, fed=None):
        out, fed_out, launches = [], [], []
        reset_launches()
        with dtensor.sharded(), activation_specs(specs_pre):
            logits, cache = api.prefill(cfg, P, {"tokens": B},
                                        target_len=target)
        launches.append(read_launches())
        cache = place_cache(cache)
        out.append(dtensor.full({"l": logits})["l"])
        for i in range(SHARDED_DECODE):
            tok = (out[-1].argmax(-1)[:, None] if fed is None else fed[i])
            fed_out.append(tok)
            reset_launches()
            with dtensor.sharded(), activation_specs(specs_dec):
                logits, cache = api.decode_step(cfg, P, cache,
                                                place_token(tok))
            launches.append(read_launches())
            out.append(dtensor.full({"l": logits})["l"])
        return out, fed_out, launches

    place_token = (lambda t: t)
    t0 = time.perf_counter()
    want, fed, plain_launches = run(params, tokens, lambda c: c, {}, {})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    bspecs = sp.batch_specs(cfg, dec, mesh)
    P = dtensor.place(params, sp.param_specs(cfg, params, mesh), mesh)
    B = dtensor.place({"tokens": tokens}, sp.batch_specs(cfg, pre, mesh),
                      mesh)["tokens"]
    place_token = (lambda t: dtensor.place({"token": t}, bspecs,
                                           mesh)["token"])
    t0 = time.perf_counter()
    got, _, mesh_launches = run(
        P, B, lambda c: {k: v.redistribute(mesh, sp.named(
            mesh, bspecs["cache"][k])) if dtensor.is_dtensor(v) else v
            for k, v in c.items()},
        dryrun.act_specs(mesh, "prefill"),
        dryrun.act_specs(mesh, "decode", dryrun.batch_shardable(dec, mesh)),
        fed=fed)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
    row = dict(phase="sharded_serving", arch=cfg.name, n_layers=4,
               prompts=SERVE_BATCH, prompt_len=SERVE_PROMPT,
               decode_steps=SHARDED_DECODE, logits_bit_equal=equal,
               max_abs_diff=max(float((g.float() - w.float()).abs().max())
                                for g, w in zip(got, want)),
               plain_launches=plain_launches, mesh_launches=mesh_launches,
               plain_s=plain_s, mesh_s=mesh_s, gpu=smi)
    emit(**row)
    assert all(equal), row
    for launches in (plain_launches, mesh_launches):
        assert launches[0] == expect_pre, (launches[0], expect_pre)
        assert all(x == expect_dec for x in launches[1:]), launches
    del params, P, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return row


def sharded_dryrun_phase(jobs):
    """(c) each cell's two records, 16x16 and 2x16x16 (each a
    ``dryrun_sharded`` line): ``ok``; collectives moved; FLOPs a chip
    times the chips at least the one-device trace's (phase 17's record:
    sharding only adds work); a chip's peak below the one-device peak;
    2x16x16's FLOPs a chip at most 16x16's."""
    one = {(r["arch"], r["shape"]): r for r in json.loads(
        (COST_DIR / "dryrun.json").read_text())}
    waited = 0.0
    for (arch, shape), job in jobs.items():
        recs, _, seconds, w = finish_cli(job)
        waited += w
        by_mesh = {r["mesh"]: r for r in recs}
        base = one[(arch, shape)]
        for name, chips in (("16x16", 256), ("2x16x16", 512)):
            r = by_mesh[name]
            emit(phase="dryrun_sharded", arch=arch, shape=shape, mesh=name,
                 status=r["status"], error=r.get("error"),
                 flops_per_chip=r.get("flops_per_chip"),
                 hbm_bytes_per_chip=r.get("hbm_bytes_per_chip"),
                 collectives=r.get("collectives"),
                 peak_gb=r.get("memory", {}).get("peak_bytes", 0) / 1e9,
                 compute_s=r.get("compute_s"), memory_s=r.get("memory_s"),
                 collective_s=r.get("collective_s"),
                 dominant=r.get("dominant"),
                 useful_flops_ratio=r.get("useful_flops_ratio"),
                 one_device_flops=base["flops_per_chip"],
                 one_device_peak_gb=base["memory"]["peak_bytes"] / 1e9,
                 trace_s=r.get("lower_s"), job_s=seconds)
            assert r["status"] == "ok", r
            assert sum(r["collectives"].values()) > 0, r
            assert r["flops_per_chip"] * chips >= base["flops_per_chip"], r
            assert (r["memory"]["peak_bytes"]
                    < base["memory"]["peak_bytes"]), (r, base)
        assert (by_mesh["2x16x16"]["flops_per_chip"]
                <= by_mesh["16x16"]["flops_per_chip"]), by_mesh
    return waited


def zoo_sharded_phases(mesh, jobs, smi):
    """Phase 20, on phase 19's one-rank group: (a) training on the (1, 1)
    mesh, (b) serving on it, (c) the dry run on the production meshes.
    Returns the launches of (a) and (b) by kernel."""
    qwen = dataclasses.replace(registry.get("qwen2-moe-a2.7b"), n_layers=4)
    mamba = registry.get("mamba2-370m")
    n = qwen.n_layers
    cells = [sharded_train_cell("qwen2-moe-a2.7b, 4 layers", qwen,
                                "qwen2-moe-a2.7b",
                                dict(flash_attention=2 * n,
                                     moe_gemm=12 * n), smi),
             sharded_train_cell("mamba2-370m", mamba, "mamba2-370m",
                                dict(ssd_scan=2 * mamba.n_layers), smi)]
    serving = sharded_serving(mesh, smi)
    waited = sharded_dryrun_phase(jobs)
    launches = collections.Counter()
    for cell in cells:
        for x in cell["mesh"]["launches"]:
            launches.update(x)
    for x in serving["mesh_launches"]:
        launches.update(x)
    emit(phase="sharded_zoo_steps", gpu=smi, cells={
        c["cell"]: dict(plain_ms=c["plain"]["median_ms"],
                        mesh_ms=c["mesh"]["median_ms"],
                        dtensor_host_ms=c["dtensor_host_ms"],
                        losses_bit_equal=c["losses_bit_equal"])
        for c in cells}, dryrun_waited_s=waited)
    return dict(launches)


# ---------------------------------------------------------------------------
# 21. the last slice: the population prefilter on a mesh (on phase 19's
# group) and the example drivers' torch twins on the card
# ---------------------------------------------------------------------------
EXAMPLES = Path(__file__).resolve().parent / "examples"
DRIVER_ROUNDS = 2          # the drivers' functions: seed 0, 2 rounds


def mesh_round(state, g, rr, omega, mesh, mesh_first, m=None):
    """One round through the mesh-less "device" prefilter and the mesh
    one, in the given order: (outputs, info, ms) by path."""
    outs, info, ms = {}, {}, {}
    for path in (("mesh", "device") if mesh_first else ("device", "mesh")):
        t0 = time.perf_counter()
        *outs[path], info[path] = tpop.prefilter_schedule_runs(
            state, g, rr, *omega, m=m, kernel="device",
            mesh=mesh if path == "mesh" else None)
        ms[path] = (time.perf_counter() - t0) * 1e3
    return outs, info, ms


def check_mesh_round(label, state, g, rr, omega, outs, info):
    """The mesh path bit for bit against the mesh-less one (every output
    and ``info``), its selections, costs and ``forced`` against the exact
    "device" schedule."""
    for name, a, b in zip(("x", "alpha", "costs", "values", "forced"),
                          outs["mesh"], outs["device"]):
        assert a.dtype == b.dtype and np.array_equal(a, b), (label, name)
    assert info["mesh"] == info["device"], (label, info)
    exact = ctl.schedule_runs(state, g, rr, *omega, kernel="device")
    for i in (0, 2, 4):
        assert np.array_equal(outs["mesh"][i], exact[i]), (label, i)


def population_mesh_phase(smi):
    """Phase 21 (a), on phase 19's group: the prefilter on
    ``population_mesh()`` at phase 10's grid, in turns with the mesh-less
    "device" prefilter, then one forced escalation; returns the phase's
    seconds."""
    t0 = time.perf_counter()
    mesh = tpop.population_mesh()
    assert isinstance(mesh, DeviceMesh) and mesh.device_type == "cuda"
    assert mesh.mesh_dim_names == ("data", "model"), mesh
    assert tuple(mesh.shape) == (1, 1), mesh
    reset_launches()
    for n in POP_NS:
        state, omega, draw = population_instance(n)
        rows = []
        for t in range(POP_ROUNDS + 1):       # round 0: the warm-up
            g, rr = draw(t)
            outs, info, ms = mesh_round(state, g, rr, omega, mesh,
                                        mesh_first=t % 2 == 1)
            check_mesh_round(f"N {n} round {t}", state, g, rr, omega, outs,
                             info)
            if t:
                rows.append(ms)
        counter = dryrun.count_step(
            lambda: tpop.prefilter_schedule_runs(
                state, g, rr, *omega, kernel="device", mesh=mesh), ())
        emit(phase="population_mesh", n=n, runs=POP_RUNS, ues=POP_K,
             m=info["mesh"]["m"], n_escalated=info["mesh"]["n_escalated"],
             ms_a_round={p: float(np.mean([r[p] for r in rows]))
                         for p in ("device", "mesh")},
             ms_rounds=rows,
             collective_bytes=rl.collective_bytes(
                 counter.op_collective_bytes),
             state_bytes=tpop.PopulationState.from_control(state).nbytes(),
             gpu=smi)
    m = state.cfg.min_selected
    outs, info, ms = mesh_round(state, g, rr, omega, mesh, True, m=m)
    check_mesh_round("forced escalation", state, g, rr, omega, outs, info)
    assert info["mesh"]["n_escalated"] > 0, info
    emit(phase="population_mesh_forced_escalation", n=POP_NS[-1], m=m,
         ms=ms, n_escalated=info["mesh"]["n_escalated"], gpu=smi)
    launches = read_launches()
    assert launches == only(), launches
    seconds = time.perf_counter() - t0
    emit(phase="population_mesh_seconds", seconds=seconds, gpu=smi)
    return seconds


def example_twin(name):
    """``examples/<name>_torch.py`` as a module (the examples are not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def batched_product_gap(smi):
    """ROADMAP P24 on the card: float32 products at ``lm_tiny``'s shapes
    (8 windows of 32 tokens: the forward's x @ w into d_ff 128 and into
    the 32 KV columns, the weight gradients' x^T @ dy) alone (``mm``) and
    as element 0 of a ``bmm`` of n copies; the largest gap for each n,
    with torch's default BLAS library (cuBLAS) and with cuBLASLt; and the
    same for the task plane's ``bi_gemm`` (at the §V MLP's shapes too),
    which must read 0 at every n."""
    shapes = {"ff": (256, 64, 128), "kv": (256, 64, 32),
              "wgrad_ff": (64, 256, 128), "wgrad_down": (128, 256, 64)}
    mlp_shapes = {"mlp_w1": (50, 784, 64), "mlp_w2": (50, 64, 10),
                  "mlp_wgrad_w1": (784, 50, 64)}
    default = torch.backends.cuda.preferred_blas_library()
    gaps = {}
    # the task plane's product on the card: matrix 0 of a bi_gemm of n
    # against a bi_gemm of 1, at lm_tiny's and the §V MLP's shapes
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (m, k, n) in {**shapes, **mlp_shapes}.items():
        x = torch.randn(50, m, k, device="cuda", generator=g)
        w = torch.randn(50, k, n, device="cuda", generator=g)
        one = kbg.bi_gemm(x[:1], w[:1])[0]
        gaps.setdefault("bi_gemm", {})[name] = {
            b: float((kbg.bi_gemm(x[:b], w[:b])[0] - one).abs().max())
            for b in (1, 2, 8, 50)}
    assert not any(v for row in gaps["bi_gemm"].values()
                   for v in row.values()), gaps["bi_gemm"]
    try:
        for lib in ("cublas", "cublaslt"):
            torch.backends.cuda.preferred_blas_library(lib)
            g = torch.Generator(device="cuda").manual_seed(0)
            for name, (m, k, n) in shapes.items():
                x = torch.randn(m, k, device="cuda", generator=g)
                w = torch.randn(k, n, device="cuda", generator=g)
                one = x @ w
                gaps.setdefault(lib, {})[name] = {
                    b: float((torch.bmm(x.expand(b, -1, -1).contiguous(),
                                        w.expand(b, -1, -1).contiguous())[0]
                              - one).abs().max())
                    for b in (1, 2, 8, 50)}
    finally:
        torch.backends.cuda.preferred_blas_library(default)
    emit(phase="batched_product_gap", shapes=shapes, gaps=gaps, gpu=smi)


class _SliceRecorder(TorchDispatchMode):
    """Every operator's outputs, client 0's slice of each (the first 1/N
    of its leading axis, None where that axis is not a multiple of N)."""

    def __init__(self, n):
        super().__init__()
        self.n, self.ops = n, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((str(func.overloadpacket), [
            t[:t.shape[0] // self.n].detach().clone()
            if t.shape[0] % self.n == 0 else None
            for t in tree_leaves(out)
            if isinstance(t, torch.Tensor) and t.dim() > 0]))
        return out


def _first_slice_gap(ref_ops, ops):
    """(the first operator whose client-0 slice differs, with its largest
    gap, or None; the differing operators' names), over the same
    operator sequence."""
    assert [o for o, _ in ref_ops] == [o for o, _ in ops]
    first, names = None, set()
    for i, ((name, a), (_, b)) in enumerate(zip(ref_ops, ops)):
        for x, y in zip(a, b):
            if x is None or y is None or x.shape != y.shape \
                    or torch.equal(x, y):
                continue
            if first is None:
                first = dict(index=i, op=name, max_abs=float(
                    (x.double() - y.double()).abs().max()
                    if x.is_floating_point() else -1))
            names.add(name)
            break
    return first, sorted(names)


def invariance_probe(smi):
    """Which operators of one masked SGD step of the vectorized engine
    make client 0's slice differ between a stack of 1 and stacks of 8 and
    50, for the §V MLP (50 samples) and lm_tiny (8 windows of 32), with
    the task plane's batch-invariant route off (the plain ops, as before
    it) and on (none may, none may be one of ``bi.TORCH_SUMS``, and the
    recorder must see every ``bi_gemm`` launch of the step, the backward's
    on autograd's device thread too); and the loop oracle's unstacked
    step against the stack of 1's params (equal on the route)."""
    for model in ("mlp", "lm"):
        key = PRNGKey(0, "cuda")
        if model == "mlp":
            params, lr = tmlp.mlp_init(key, device="cuda"), 0.1
        else:
            params, lr = tf.lm_init(key, LM_TINY, device="cuda"), 0.3
        batches = {}
        for n in (1, 8, 50):
            g = np.random.default_rng(n)
            if model == "mlp":
                b = {"x": torch.as_tensor(g.random((n, 50, 784),
                                                   dtype=np.float32)),
                     "y": torch.as_tensor(g.integers(0, 10, (n, 50))),
                     "m": torch.ones(n, 50)}
            else:
                b = {"tokens": torch.as_tensor(g.integers(0, 64,
                                                          (n, 8, 32))),
                     "m": torch.ones(n, 8)}
            batches[n] = {k: v.cuda() for k, v in b.items()}
            for k in b:               # client 0's rows in every stack
                batches[n][k][0] = batches[1][k][0]

        def loss(b):
            if model == "mlp":
                return lambda p: tmlp.mlp_loss_masked(p, b)
            return lambda p: tf.lm_loss_masked(LM_TINY, p, b)

        def step(n, routed, record=True):
            rec = _SliceRecorder(n)
            stack = {k: v.expand((n,) + v.shape).clone()
                     for k, v in params.items()}
            before = kbg.bi_gemm.launches
            with (bi.route() if routed else contextlib.nullcontext()), \
                    (rec if record else contextlib.nullcontext()):
                out = tf.sgd_step(stack, loss(batches[n]), lr)
            if record and routed:
                # no torch product or reduction, the backward's included
                # (it runs on autograd's device thread): every bi_gemm
                # launch of the step was recorded
                names = {o for o, _ in rec.ops}
                seen = sum(o == "repro_torch.bi_gemm" for o, _ in rec.ops)
                assert not names & bi.TORCH_SUMS, names & bi.TORCH_SUMS
                assert seen == kbg.bi_gemm.launches - before > 0, (
                    seen, kbg.bi_gemm.launches - before)
            return rec.ops, {k: v[0] for k, v in out.items()}
        step(1, True, record=False)             # the caches, made once
        for routed in (False, True):
            ref_ops, ref_p = step(1, routed)
            row = dict(phase="invariance_probe", model=model,
                       routed=routed, n_ops=len(ref_ops),
                       torch_sums=sorted({o for o, _ in ref_ops}
                                         & bi.TORCH_SUMS), gpu=smi)
            for n in (8, 50):
                ops, p = step(n, routed)
                first, names = _first_slice_gap(ref_ops, ops)
                row[f"n{n}"] = dict(first=first, differing_ops=names,
                                    params_equal=all(torch.equal(
                                        p[k], ref_p[k]) for k in p))
                if routed:
                    assert first is None and row[f"n{n}"]["params_equal"], \
                        row
            b1 = batches[1]
            rec = _SliceRecorder(1)
            with (bi.route() if routed else contextlib.nullcontext()), rec:
                if model == "mlp":
                    one = tf.sgd_step(params, lambda p: tmlp.mlp_loss(
                        p, {"x": b1["x"][0], "y": b1["y"][0]}), lr)
                else:
                    one = tf.sgd_step(params, lambda p: tf.lm_loss(
                        LM_TINY, p, {"tokens": b1["tokens"][0]}), lr)
            row["loop_equal"] = all(torch.equal(one[k], ref_p[k])
                                    for k in one)
            row["loop_torch_sums"] = sorted({o for o, _ in rec.ops}
                                            & bi.TORCH_SUMS)
            assert row["loop_equal"] or not routed, row
            assert not row["loop_torch_sums"] or not routed, row
            emit(**row)


def counted(label, fn, smi):
    """``fn()`` with every launch count set to 0 just before and read just
    after; (its result, the launches), a ``driver`` line emitted."""
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    emit(phase="driver", driver=label, seconds=seconds, launches=launches,
         gpu=smi)
    return out, launches


def driver_phases(smi):
    """Phase 21 (b): the example drivers' torch twins on the card, in a
    temporary working directory; returns the launches by kernel."""
    t0 = time.perf_counter()
    total = collections.Counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            qs = example_twin("quickstart")
            logs, got = counted("quickstart_torch.main",
                                lambda: qs.main(["--device", "cuda"]), smi)
            assert got == only(weighted_aggregate=qs.ROUNDS), got
            accs = [log.global_acc for log in logs]
            assert len(accs) == qs.ROUNDS and all(np.isfinite(accs)), accs
            assert accs[-1] > accs[0], accs
            total.update(got)
            rounds, qs.ROUNDS = qs.ROUNDS, DRIVER_ROUNDS
            try:
                cpu = qs.main(["--device", "cpu"])
            finally:
                qs.ROUNDS = rounds
            for a, b in zip(logs, cpu):
                assert np.array_equal(a.selected, b.selected), (
                    a.round, a.selected, b.selected)
            emit(phase="driver_quickstart", accs=accs,
                 selected=[int(log.selected.size) for log in logs],
                 cpu_accs=[log.global_acc for log in cpu])

            ps = example_twin("poisoning_study")
            kw = dict(ps.FAST_KW, rounds=DRIVER_ROUNDS)
            out, got = counted("poisoning_study_torch.curve", lambda: ps.curve(
                "dqs", ps._flip((6, 2)), (0.5, 0.5),
                FeelConfig(model_size_bits=5e6 * 8), (0,), device="cuda",
                **kw), smi)
            assert got["weighted_aggregate"] > 0 and got == only(
                weighted_aggregate=got["weighted_aggregate"]), got
            assert np.isfinite(out["acc"]).all(), out
            total.update(got)
            emit(phase="driver_poisoning_study", **out)

            rb = example_twin("robustness_extensions")
            kw = dict(rb.FAST_KW, rounds=DRIVER_ROUNDS)
            cells, got = counted("robustness_extensions_torch.matrix",
                                 lambda: rb.matrix(
                                     (0,), FeelConfig(
                                         model_size_bits=5e6 * 8),
                                     device="cuda", **kw), smi)
            assert got["weighted_aggregate"] > 0, got
            assert got["robust_aggregate"] > 0, got
            assert len(cells) == 36 and all(
                np.isfinite(c["acc"]).all() for c in cells.values())
            total.update(got)
            emit(phase="driver_robustness", cells=len(cells),
                 feature_noise_rep_gap=[
                     cells["feature_noise_dqs"]["rep_gap"],
                     cells["feature_noise_dqs_defended"]["rep_gap"]])

            fl = example_twin("federated_llm")
            batched_product_gap(smi)
            invariance_probe(smi)
            for label, fn in (
                    ("dqs_vs_random", lambda: fl.dqs_vs_random(
                        [0], DRIVER_ROUNDS, "cuda")),
                    ("loop_parity", lambda: fl.loop_parity(
                        DRIVER_ROUNDS, "cuda")),
                    ("flash_leg", lambda: fl.flash_leg(1, "cuda"))):
                out, got = counted(f"federated_llm_torch.{label}", fn, smi)
                if label == "loop_parity":
                    # the reference's check, on the card too
                    assert out["bit_exact"], out
                assert got["flash_attention"] > 0, (label, got)
                assert got["weighted_aggregate"] > 0, (label, got)
                total.update(got)
                emit(phase="driver_federated_llm", leg=label, result=out)
        finally:
            os.chdir(cwd)
    emit(phase="drivers_seconds", seconds=time.perf_counter() - t0,
         launches=dict(total), gpu=smi)
    return dict(total)


# ---------------------------------------------------------------------- #
# 22. the model init: the reference's threefry draw on the card
# ---------------------------------------------------------------------- #
INIT_SEEDS = (0, 1, 2**31 - 1)
INIT_ULP = 2               # the float bound the CPU tests hold jax to
# the init-spread offsets run here: 0, the leg itself (each offset takes
# ~37 s of the script's time limit; the script takes any offsets)
SPREAD_OFFSETS = (0,)
_ULP_VIEW = {torch.float32: (torch.int32, 0x7FFFFFFF),
             torch.bfloat16: (torch.int16, 0x7FFF)}


def draw_gap(a, b):
    """(elements not bit-equal, the largest gap) between two draws of one
    shape and dtype on any devices: integers by value, floats in units in
    the last place of their dtype."""
    a, b = a.cpu(), b.cpu()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if a.is_floating_point():
        view, mag = _ULP_VIEW[a.dtype]
        a, b = (t.contiguous().view(view).long() for t in (a, b))
        a, b = (torch.where(t < 0, -(t & mag), t) for t in (a, b))
    d = (a - b).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def tree_gap(a, b):
    """``draw_gap`` summed over two param dicts' leaves: (elements not
    bit-equal, the largest gap)."""
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    gaps = [draw_gap(a[k], b[k]) for k in a]
    return sum(n for n, _ in gaps), max((g for _, g in gaps), default=0)


def generator_draw(params):
    """The draw the port made before it drew the reference's weights: a
    float32 uniform from a ``torch.Generator`` on the card through the
    inverse CDF, scaled and cast, for every leaf of two or more dims of
    ``params``' shapes (the init's baseline seconds; nothing kept)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    lo, hi = math.erf(-3 / math.sqrt(2)), math.erf(3 / math.sqrt(2))
    for v in params.values():
        if v.dim() >= 2:
            u = torch.empty(v.shape, dtype=torch.float32,
                            device="cuda").uniform_(lo, hi, generator=gen)
            u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0).mul_(0.02)
            u.to(v.dtype)
            del u


def seconds(fn):
    """(``fn()``, its seconds with the card synchronised on both ends)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def init_phases(smi):
    """Phase 22: (a) keys, splits, bits (across the flat index 2^32 too),
    uniforms and a truncated normal drawn on the card against the same
    draws on the CPU; (b) the MLP's, ``lm_tiny``'s and reduced
    ``deepseek-v3-671b``'s initial params likewise; (c) the card's init
    seconds for the MLP and ``lm_tiny`` beside the generator draw they
    replace, and ``starcoder2-15b``'s at full width (22.0 B parameters,
    the largest init this script builds; its serving run's, phase 12)
    beside the generator draw over the same leaves; (d) ``federated_llm_torch.py --fast``'s
    leg 1 through the init-spread script's ``margin`` at offsets
    ``SPREAD_OFFSETS`` (0 is the leg itself), every launch count set to 0
    just before each and read just after. Returns the launches."""
    # (a) the draws, card against CPU
    for seed in INIT_SEEDS:
        kc, kh = PRNGKey(seed, "cuda"), PRNGKey(seed, "cpu")
        far = (2**32 - 3, 2**32 + 3)
        row = {
            "key": draw_gap(kc, kh),
            "split": draw_gap(rnd.split(kc, 8), rnd.split(kh, 8)),
            "nested_split": draw_gap(rnd.split(rnd.split(kc, 5)[3], 4),
                                     rnd.split(rnd.split(kh, 5)[3], 4)),
            "bits": draw_gap(rnd.bits(kc, (1001,)), rnd.bits(kh, (1001,))),
            "bits_past_2^32": draw_gap(rnd._bits_i32(kc, *far),
                                       rnd._bits_i32(kh, *far)),
            "uniform": draw_gap(rnd.uniform(kc, (4096,), -2.0, 3.0),
                                rnd.uniform(kh, (4096,), -2.0, 3.0)),
            "truncated_normal": draw_gap(
                rnd.truncated_normal(kc, -3.0, 3.0, (1024, 1024)),
                rnd.truncated_normal(kh, -3.0, 3.0, (1024, 1024)))}
        emit(phase="init_draws", seed=seed, **row)
        assert all(n == 0 for k, (n, _) in row.items()
                   if k not in ("uniform", "truncated_normal")), row
        assert max(g for _, g in row.values()) <= INIT_ULP, row

    # (b) the initial params, card against CPU
    deepseek = registry.reduced(registry.get("deepseek-v3-671b"))
    trees = {
        "mlp_seed_0": lambda dev: tmlp.mlp_init(PRNGKey(0, dev), device=dev),
        "mlp_seed_1": lambda dev: tmlp.mlp_init(PRNGKey(1, dev), device=dev),
        "lm_tiny": lambda dev: tf.lm_init(PRNGKey(0, dev), LM_TINY),
        "deepseek-v3-671b reduced, bf16": lambda dev: api.init(
            deepseek, 0, device=dev),
        "deepseek-v3-671b reduced, f32": lambda dev: api.init(
            dataclasses.replace(deepseek, dtype="float32"), 0, device=dev)}
    for name, init in trees.items():
        off, gap = tree_gap(init("cuda"), init("cpu"))
        emit(phase="init_trees", tree=name, not_bit_equal=off, max_ulp=gap)
        assert gap <= INIT_ULP, (name, off, gap)

    # (c) the card's init seconds beside the generator draw, in turns
    for name, init in (
            ("mnist_mlp", lambda: tmlp.mlp_init(PRNGKey(0, "cuda"),
                                                device="cuda")),
            ("lm_tiny", lambda: tf.lm_init(PRNGKey(0, "cuda"), LM_TINY))):
        new, old = [], []
        for _ in range(5):
            params, s = seconds(init)
            new.append(s)
            old.append(seconds(lambda: generator_draw(params))[1])
        emit(phase="init_seconds", model=name, n_params=sum(
            v.numel() for v in params.values()), threefry_s=float(
                np.median(new)), generator_s=float(np.median(old)), runs=5,
             gpu=smi)
    gc.collect()
    torch.cuda.empty_cache()
    meta = api.init(registry.get("starcoder2-15b"), 0, device="meta")
    emit(phase="init_seconds", model="starcoder2-15b", n_params=sum(
        v.numel() for v in meta.values()),
         threefry_s=SERVE_INIT_S["starcoder2-15b"],
         generator_s=seconds(lambda: generator_draw(meta))[1], runs=1,
         gpu=smi)

    # (d) the --fast leg 1 and the init-spread offsets from the new init
    spread = example_twin("federated_llm_init_spread")
    total = collections.Counter()
    for off in SPREAD_OFFSETS:
        (margin, end), got = counted(
            f"init_spread.margin({off})", lambda: spread.margin(off, "cuda"),
            smi)
        assert got["flash_attention"] > 0 and got["weighted_aggregate"] > 0, (
            off, got)
        assert np.isfinite(margin), (off, margin)
        total.update(got)
        emit(phase="init_margin", offset=off, margin=margin, end_loss=end,
             fast_leg_passes=bool(margin >= 0.0) if off == 0 else None,
             gpu=smi)
    return dict(total)


def quickstart(n_ues, n_malicious, n_train, n_test, device, seed=0):
    cfg = FeelConfig(n_ues=n_ues, n_malicious=n_malicious)
    train, test = generate(n_train, n_test, seed=seed)
    rng = np.random.default_rng(seed)
    mal = pick_malicious(cfg.n_ues, cfg.n_malicious, rng)
    clients = partition(train, cfg.n_ues, rng, mal,
                        LabelFlipAttack(*EASY_PAIR))
    return FeelServer(cfg, clients, test, rng, policy="dqs",
                      engine="vectorized", control="host", device=device)


# ---------------------------------------------------------------------- #
# --rounds-against DIR: two trees' rounds in turns
# ---------------------------------------------------------------------- #
# one turn: a tree's rounds in a process of its own (argv: its src/ dir),
# built from that tree's sources, through run_experiment on the card:
# "v_vectorized" / "v_loop" the §V cell (K = 50, 50,000/10,000, the (6, 2)
# flip, DQS, host control) on each engine, "lm_vectorized" / "lm_loop"
# lm_tiny in examples/federated_llm.py's regime (K = 20, 6 malicious,
# token_flip_1to5, 2,000/400 windows, DQS); 4 rounds vectorized, 3 loop.
# Prints one JSON line: each run's round ms (host clock ending in a
# synchronise) and curves
_ROUND_TURN = """import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from repro_torch.configs.base import FeelConfig
from repro_torch.federated import simulation
from repro_torch.kernels import build
build.build([k for k in build.KERNELS if k in (
    "weighted_aggregate", "flash_attention", "bi_gemm", "bi_reduce")])
made = []

class Timed(simulation.FeelServer):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.round_ms = []
        made.append(self)

    def run_round(self, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log = super().run_round(t)
        torch.cuda.synchronize()
        self.round_ms.append((time.perf_counter() - t0) * 1e3)
        return log

simulation.FeelServer = Timed
runs = {}
for name, engine, rounds in (("v_vectorized", "vectorized", 4),
                             ("v_loop", "loop", 3),
                             ("lm_vectorized", "vectorized", 4),
                             ("lm_loop", "loop", 3)):
    if name.startswith("lm"):
        kw = dict(task="lm_tiny", n_train=2_000, n_test=400,
                  scenario="token_flip_1to5", cfg=FeelConfig(
                      n_ues=20, n_malicious=6, deadline_s=60.0,
                      model_size_bits=82240 * 32.0, bandwidth_hz=1e5))
    else:
        kw = dict(task="mnist_mlp", n_train=50_000, n_test=10_000,
                  scenario="flip_6to2", cfg=FeelConfig(n_ues=50,
                                                       n_malicious=5))
    res = simulation.run_experiment(policy="dqs", seed=0, control="host",
                                    device="cuda", engine=engine,
                                    rounds=rounds, **kw)
    runs[name] = dict(
        round_ms=made[-1].round_ms, acc=[float(x) for x in res["acc"]],
        loss=[float(x) for x in np.asarray(res["loss"], float)],
        malicious_selected=[int(x) for x in res["malicious_selected"]])
print(json.dumps({"src": sys.argv[1], "runs": runs}))
"""


def rounds_against(other: Path, smi: str) -> dict:
    """The §V and lm_tiny rounds of ``other``'s tree (``other/src``, e.g. a
    ``git archive`` of the parent) and of this one in turns (other, this,
    this, other), a process a turn; each turn's line, then the median
    round ms of rounds 2 on by tree and run, whether the two trees'
    curves agree bit for bit, and whether each tree's loop engine gave
    its vectorized engine's curves."""
    here = Path(__file__).resolve().parent
    trees = {"against": str(other.resolve() / "src"),
             "this": str(here / "src")}
    rows = []
    for label in ("against", "this", "this", "against"):
        line = subprocess.run(
            [sys.executable, "-c", _ROUND_TURN, trees[label]],
            capture_output=True, text=True, check=True,
            cwd=here).stdout.strip().splitlines()[-1]
        rows.append(dict(json.loads(line), tree=label))
        emit(phase="round_turn", gpu=smi, **rows[-1])
    names = list(rows[0]["runs"])
    median = {n: {label: float(np.median([
        ms for r in rows if r["tree"] == label
        for ms in r["runs"][n]["round_ms"][1:]])) for label in trees}
        for n in names}
    fields = ("acc", "loss", "malicious_selected")
    same = {n: all(np.array_equal(rows[0]["runs"][n][k],
                                  rows[1]["runs"][n][k], equal_nan=True)
                   for k in fields) for n in names}
    engines = {r["tree"]: {task: all(np.array_equal(
        r["runs"][f"{task}_vectorized"][k][:3], r["runs"][f"{task}_loop"][k],
        equal_nan=True) for k in fields) for task in ("v", "lm")}
        for r in rows[:2]}
    out = dict(median_round_ms=median, curves_equal=same,
               loop_equals_vectorized=engines)
    emit(phase="rounds_against", gpu=smi, **out)
    return out


# ---------------------------------------------------------------------- #
# --kernels-against DIR: two trees' batch-invariant kernels and K5 in turns
# ---------------------------------------------------------------------- #
AGAINST_DIR = build.BUILD_DIR.parent / "kernels_against"


def _against_kernels(other: Path):
    """DIR's ``bi_gemm.cu``, ``bi_reduce.cu``, ``moe_gemm.cu`` and
    ``flash_attention.cu`` built (one nvcc each, in parallel, with this
    tree's flags) and loaded: their C launchers ``bi_gemm_f32``,
    ``bi_sum_f32``, ``bi_logsumexp_f32``, ``bi_argmax_f32``,
    ``moe_gemm_bf16``, ``flash_attention_f32`` and
    ``flash_attention_bf16``, whose interfaces this tree keeps; the
    reductions by mode, K3's by dtype."""
    AGAINST_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("bi_gemm", "bi_reduce", "moe_gemm", "flash_attention"):
        src = other / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(AGAINST_DIR / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {other}'s {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(AGAINST_DIR / f"{name}.so"))
    gemm = libs["bi_gemm"].bi_gemm_f32
    gemm.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                     + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    gemm.restype = ctypes.c_int
    reduce = {kbr.SUM: libs["bi_reduce"].bi_sum_f32,
              kbr.LOGSUMEXP: libs["bi_reduce"].bi_logsumexp_f32,
              kbr.ARGMAX: libs["bi_reduce"].bi_argmax_f32}
    for mode, fn in reduce.items():
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * (
            3 if mode == kbr.SUM else 2) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    moe = libs["moe_gemm"].moe_gemm_bf16
    moe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    moe.restype = ctypes.c_int
    flash = {torch.float32: libs["flash_attention"].flash_attention_f32,
             torch.bfloat16: libs["flash_attention"].flash_attention_bf16}
    for fn in flash.values():
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return gemm, reduce, moe, flash


def _k3_with(fns, q, k, v, causal, window):
    """``flash_attention(q, k, v)`` through another tree's launchers
    ``fns`` (by dtype), at the default scale."""
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    assert fns[q.dtype](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, h, k.shape[1], s, k.shape[2], d,
                        int(causal), window or 0, d ** -0.5,
                        torch.cuda.current_stream().cuda_stream) == 0
    return out


def k3_edge_inputs(b, h, hkv, s, t, d, kind, seed):
    """q, k, v (float32, unit normal from ``seed``) made into an edge case:
    "underflow" logits 30x wider, so that most exps underflow to 0 (and
    rows' alphas with them); "inf logits" q at 1e18 and one q element
    +inf, so that logits overflow to +-inf and NaN; "nonfinite v" +inf,
    NaN and -inf in V at keys past the causal edge of earlier rows, or
    inside and outside a window (a masked key adds 0·v, NaN); "misaligned"
    every operand 4 bytes past a 16-byte boundary (the kernel's 4-byte
    copies)."""
    q, k, v = (_randn(b, n_h, n, d, seed=seed + i) for i, (n_h, n) in
               enumerate(((h, s), (hkv, t), (hkv, t))))
    if kind == "underflow":
        q, k = q * 30, k * 30
    elif kind == "inf logits":
        q = q * 1e18
        q[:, :, s // 2, 0] = float("inf")
    elif kind == "nonfinite v":
        v[:, :, t - 1, 0] = float("inf")
        v[:, :, t // 2, 1] = float("nan")
        v[:, :, t // 3, 2] = -float("inf")
    elif kind == "misaligned":
        q, k, v = misaligned(q), misaligned(k), misaligned(v)
    return q, k, v


def k3_against(old, smi):
    """K3's float32 route of ``other``'s tree (its launchers ``old``) and of
    this one: equal bit for bit (int32 views) at every float32 shape of
    phase 3 and every B the LM path launches, and on the edge inputs
    (``k3_edge_inputs``) at the LM's training and evaluation shapes, a
    window with and without ``causal``, a long causal head, a ragged S and
    grouped KV heads; one bf16 shape (the route this tree leaves alone)
    too. Then each tree's kernel and SDPA in turns (``median_turns``) at
    each of those float32 shapes, with the bound (``flash_bound``)."""
    f32 = torch.float32
    cases = [(f"lm_tiny B = {b}", b, 4, 4, 32, 32, 16, True, None)
             for b in sorted({*K3_LM_BATCHES, *K3_LM_LAUNCHED})]
    cases += [(label, b, h, h, s_, t_, d, causal, window)
              for b, h, s_, t_, d, causal, window, label in K3_SHAPES]
    cases += [K3_GQA, K3_UNMASKED]
    edges = [c for c in cases if c[0] in (
        "lm_tiny B = 8", "lm_tiny B = 6400", "window 64, D 128",
        "window, not causal", "causal", "ragged S = 37", "GQA 12/4")]
    elements = n_edges = 0
    for i, (label, b, h, hkv, s_, t_, d, causal, window) in enumerate(cases):
        q, k, v = k3_edge_inputs(b, h, hkv, s_, t_, d, "normal", seed=3 * i)
        assert bits_equal(_k3_with(old, q, k, v, causal, window),
                          k3.flash_attention(q, k, v, causal=causal,
                                             window=window)), label
        elements += q.numel()
    for i, (label, b, h, hkv, s_, t_, d, causal, window) in enumerate(edges):
        for kind in ("underflow", "inf logits", "nonfinite v", "misaligned"):
            q, k, v = k3_edge_inputs(b, h, hkv, s_, t_, d, kind,
                                     seed=100 + 3 * i)
            new = k3.flash_attention(q, k, v, causal=causal, window=window)
            assert bits_equal(_k3_with(old, q, k, v, causal, window),
                              new), (label, kind)
            elements += q.numel()
            n_edges += 1
    q, k, v = (_randn(2, 4, 256, 64, seed=i).to(torch.bfloat16)
               for i in range(3))
    assert bits_equal(_k3_with(old, q, k, v, True, None),
                      k3.flash_attention(q, k, v)), "bf16"
    emit(phase="k3_bits_against", gpu=smi, f32_shapes=len(cases),
         edge_cases=n_edges, f32_elements=elements,
         bf16_shape=[2, 4, 4, 256, 256, 64], bits_equal=True)
    rows = []
    for label, b, h, hkv, s_, t_, d, causal, window in cases:
        q, k, v = (_randn(b, n_h, n, d, seed=j) for j, (n_h, n) in
                   enumerate(((h, s_), (hkv, t_), (hkv, t_))))
        sdpa = functools.partial(
            torch.nn.functional.scaled_dot_product_attention, q, k, v,
            enable_gqa=hkv != h)
        if causal and s_ == t_ and window is None:
            lib = functools.partial(sdpa, is_causal=True)
        elif causal or window is not None:
            lib = functools.partial(sdpa, attn_mask=k3.band_mask(
                s_, t_, causal, window, "cuda"))
        else:
            lib = sdpa
        ms = median_turns({
            "against": lambda q=q, k=k, v=v, c=causal, w=window: _k3_with(
                old, q, k, v, c, w),
            "this": lambda q=q, k=k, v=v, c=causal, w=window:
                k3.flash_attention(q, k, v, causal=c, window=w),
            "library": lib}, 20 if b * s_ * d > 1_000_000 else 100)
        rows.append(dict(
            kernel="flash_attention", case=label, dtype="float32",
            shape=[b, h, hkv, s_, t_, d], causal=causal, window=window,
            library_call="scaled_dot_product_attention", bound_ms=flash_bound(
                b, h, s_, t_, d, causal, window, f32, hkv)[0], **ms))
    for row in rows:
        emit(phase="kernel_turns", gpu=smi, bits_equal=True,
             speedup=row["against"] / row["this"],
             of_library=row["this"] / row["library"],
             of_bound=row["bound_ms"] / row["this"], **row)
    return rows


def _gemm_with(fn, a, b):
    """``bi_gemm(a, b)`` through another tree's launcher ``fn``."""
    batch = max(a.shape[0], b.shape[0])
    out = torch.empty((batch, a.shape[1], b.shape[2]), device="cuda")
    sa, sb = list(a.stride()), list(b.stride())
    sa[0] = 0 if a.shape[0] == 1 else sa[0]
    sb[0] = 0 if b.shape[0] == 1 else sb[0]
    assert fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, a.shape[1],
              b.shape[2], a.shape[2], *sa, *sb,
              torch.cuda.current_stream().cuda_stream) == 0
    return out


def _reduce_with(fns, x, mode=kbr.SUM):
    """``bi_reduce(x, mode)`` through another tree's launchers ``fns``."""
    out = torch.empty((x.shape[0], x.shape[2]), device="cuda",
                      dtype=torch.int64 if mode == kbr.ARGMAX else x.dtype)
    sizes = x.shape if mode == kbr.SUM else x.shape[:2]
    assert fns[mode](x.data_ptr(), out.data_ptr(), *sizes,
                     torch.cuda.current_stream().cuda_stream) == 0
    return out


def median_turns(fns, reps, rounds=2):
    """{label: device ms}: each of ``fns`` timed by ``time_ms`` in the
    order given and then reversed, ``rounds`` times; the median."""
    got = {k: [] for k in fns}
    for _ in range(rounds):
        for k in list(fns) + list(fns)[::-1]:
            got[k].append(time_ms(fns[k], reps)[0])
    return {k: float(np.median(v)) for k, v in got.items()}


def _lse_against(old_reduce, x):
    """The logsumexp of ``x`` by ``other``'s kernel and by this one: equal
    bit for bit (int32 views) on every row but those whose maximum is
    +-inf, where this tree reads torch's +-inf (the rule of ``jax.nn.
    logsumexp``) and a tree without that rule reads NaN; returns (the
    rows that differ, the rows whose maximum is +-inf)."""
    old = _reduce_with(old_reduce, x, kbr.LOGSUMEXP)
    new = kbr.bi_reduce(x, kbr.LOGSUMEXP)
    inf = torch.isinf(torch.gather(x[:, :, 0], 1,
                                   kbr.bi_reduce(x, kbr.ARGMAX)))[:, 0]
    differ = (old.view(torch.int32) != new.view(torch.int32))[:, 0]
    assert not (differ & ~inf).any().item(), "a finite or NaN row moved"
    assert torch.equal(new[inf], torch.logsumexp(x[inf], 1))
    return int(differ.sum()), int(inf.sum())


def _k5_with(fn, x, w):
    """``moe_gemm(x, w)`` in bf16 through another tree's launcher ``fn``."""
    e, c, k = x.shape
    out = torch.empty((e, c, w.shape[2]), dtype=x.dtype, device=x.device)
    assert fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, k,
              w.shape[2], torch.cuda.current_stream().cuda_stream) == 0
    return out


@contextlib.contextmanager
def k5_launcher(fn):
    """Within the block, K5's wrapper launches ``fn`` (another tree's bf16
    C launcher, the same interface) for bf16 tensors, counted as its own."""
    real = k5._launchers
    fns = {**real(), torch.bfloat16: fn}
    k5._launchers = lambda: fns
    try:
        yield
    finally:
        k5._launchers = real


def k5_against(old, smi):
    """K5 of ``other``'s tree (its bf16 launcher ``old``) and of this one
    at the decode products of ``K5_DECODE_ARCHS`` (gate and down), on a
    decode step's dispatch (``moe_decode_calls``) and with every expert
    occupied (unit normal x), and at qwen2-moe-a2.7b's prefill gate/up
    (the wgmma route): each tree's output against the plain version
    (within ``K5_BF16_TOL``; this tree's empty experts' rows bit-equal
    too), then both trees' kernels and ``torch.bmm`` in turns
    (``median_turns``), with both bounds."""
    rows = []
    for arch in K5_DECODE_ARCHS:
        calls, _ = moe_decode_calls(arch)
        for product, x, w in calls:
            if product == "up":
                continue
            g = torch.Generator(device="cuda").manual_seed(x.shape[2])
            dense = torch.randn(x.shape, device="cuda", generator=g,
                                dtype=x.dtype)
            for kind, xx in (("a decode step's routing", x),
                             ("every expert occupied", dense)):
                want = k5.moe_gemm_ref(xx, w)
                empty = empty_experts(xx)
                bits, close, err = k5_holds(k5.moe_gemm(xx, w), want, empty)
                assert bits and close, (arch, product, kind, err)
                close_old = k5_holds(_k5_with(old, xx, w), want, empty)[1]
                assert close_old, (arch, product, kind, "against")
                ms = median_turns({
                    "against": lambda xx=xx, w=w: _k5_with(old, xx, w),
                    "this": lambda xx=xx, w=w: k5.moe_gemm(xx, w),
                    "library": lambda xx=xx, w=w: torch.bmm(xx, w)},
                    10 if xx.shape[0] > 128 else 50)
                occ_ms, _ = occupied_bound(xx, w)
                rows.append(dict(
                    kernel="moe_gemm", case=f"{arch} decode {product}, {kind}",
                    shape=[*xx.shape, w.shape[2]],
                    occupied_experts=xx.shape[0] - int(empty.sum()),
                    bound_ms=moe_bound(*xx.shape, w.shape[2], xx.dtype)[0],
                    bound_occupied_ms=occ_ms, **ms,
                    of_occupied_bound=ms["this"] / occ_ms))
            del dense
        del calls
        gc.collect()
        torch.cuda.empty_cache()
    cfg = registry.get("qwen2-moe-a2.7b")
    e, d, f = cfg.moe.n_routed, cfg.d_model, cfg.moe.d_ff_expert
    c = tmoe.capacity(SERVE_BATCH * SERVE_PROMPT, cfg)
    x, w = (_randn(*shape, seed=seed).to(torch.bfloat16)
            for shape, seed in (((e, c, d), 1), ((e, d, f), 2)))
    assert k5_holds(_k5_with(old, x, w), k5.moe_gemm(x, w),
                    torch.zeros(e, dtype=torch.bool, device="cuda"))[1]
    ms = median_turns({"against": lambda: _k5_with(old, x, w),
                       "this": lambda: k5.moe_gemm(x, w),
                       "library": lambda: torch.bmm(x, w)}, 10)
    rows.append(dict(kernel="moe_gemm", case="qwen2-moe-a2.7b prefill "
                     "gate/up (the wgmma route)", shape=[e, c, d, f],
                     bound_ms=moe_bound(e, c, d, f, torch.bfloat16)[0], **ms))
    for row in rows:
        emit(phase="kernel_turns", gpu=smi, speedup=row["against"]
             / row["this"], of_library=row["this"] / row["library"], **row)
    return rows


def decode_steps_against(old, smi, steps_a_turn=8):
    """qwen2-moe-a2.7b (24 layers) and deepseek-v3-671b (cut to 4 layers,
    as phase 14) served at full width as ``serve_phase`` serves them
    (weights from seed 0, 8 prompts of 2,048 tokens), then decoded with
    ``other``'s K5 (its bf16 launcher ``old``) and this tree's in turns
    (one untimed step each, then against, this, this, against),
    ``steps_a_turn`` greedy steps a turn on the host clock, each ending in
    a synchronise, and one more under the profiler: each tree's median
    step ms and tokens/s over its turns, and its profiled steps' device
    idle share and K5 device us a step."""
    out = {}
    for arch, cfg in (("qwen2-moe-a2.7b", registry.get("qwen2-moe-a2.7b")),
                      ("deepseek-v3-671b", dataclasses.replace(
                          registry.get("deepseek-v3-671b"), n_layers=4))):
        prefill = steps.make_prefill_step(cfg)
        decode = steps.make_decode_step(cfg)
        turns = ("against", "this", "this", "against")
        target = SERVE_PROMPT + 2 + len(turns) * (steps_a_turn + 1)
        gc.collect()
        torch.cuda.empty_cache()
        params = api.init(cfg, 0)
        batch = {"tokens": prompts(cfg, SERVE_BATCH, SERVE_PROMPT)}
        got = {t: dict(step_ms=[], idle=[], busy_us=[], k5_us=[])
               for t in ("against", "this")}
        with torch.inference_mode():
            logits, cache = prefill(params, batch, target)
            tok = logits.argmax(-1)[:, None]
            for i, tree in enumerate(("against", "this") + turns):
                timed = i >= 2                  # the first two warm up
                with (k5_launcher(old) if tree == "against"
                      else contextlib.nullcontext()):
                    n = steps_a_turn + 1 if timed else 1
                    _, lg, step_ms, prof, cache = greedy_decode(
                        decode, params, cache, tok, n,
                        profile_at=n - 1 if timed else None)
                tok = lg[-1].argmax(-1)[:, None]
                if timed:
                    got[tree]["step_ms"] += step_ms
                    got[tree]["idle"].append(prof["device_idle_share"])
                    got[tree]["busy_us"].append(prof["device_busy_us"])
                    got[tree]["k5_us"].append(prof["moe_gemm_us"])
        del params, cache, logits
        row = {tree: dict(step_ms_median=float(np.median(v["step_ms"])),
                          tokens_per_s=SERVE_BATCH * len(v["step_ms"])
                          / (sum(v["step_ms"]) / 1e3),
                          device_idle_share=float(np.mean(v["idle"])),
                          device_busy_us=float(np.mean(v["busy_us"])),
                          k5_device_us_a_step=float(np.mean(v["k5_us"])),
                          steps=len(v["step_ms"]))
               for tree, v in got.items()}
        emit(phase="decode_turns", arch=arch, n_layers=cfg.n_layers,
             gpu=smi, batch=SERVE_BATCH, prompt=SERVE_PROMPT, **row)
        out[arch] = row
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kernels_against(other: Path, smi: str) -> list:
    """``bi_gemm`` and ``bi_reduce`` (its sums, logsumexp and argmax) of
    ``other``'s tree (``other/src``, e.g. a ``git archive`` of the
    parent) and of this one: equal bit for bit (int32 views) at every
    shape of ``BI_GEMM_CASES`` and ``BI_REDUCE_CASES``, the main path's
    evaluation product and argmax, and, for logsumexp and argmax,
    ``edge_rows`` at every width of ``EDGE_MS``, aligned and misaligned,
    but for the logsumexp's rows whose maximum is +-inf, which this tree
    reads as torch's +-inf (``_lse_against``: the rows that differ are
    counted, and a tree without that rule differs on each of them);
    then at the timed shapes and the main path's evaluation each tree's
    kernel and the library's call (cuBLAS ``bmm``, torch's ``sum``,
    ``logsumexp``, ``argmax``) in turns (against, this, library, library,
    this, against, twice; the median device ms of four). Then K3's
    float32 route (``k3_against``), K5 the same way at the MoE decode and
    prefill (``k5_against``) and the MoE decode steps with each tree's K5
    in turns (``decode_steps_against``)."""
    old_gemm, old_reduce, old_moe, old_flash = _against_kernels(other)
    build.build(["bi_gemm", "bi_reduce", "moe_gemm", "flash_attention"])
    rows = []
    gemm_cases = [c[:6] for c in BI_GEMM_CASES if c[6]] + [
        ("main path eval", 48, 10_000, 784, 64, True)]
    for label, batch, m, k, n, shared in gemm_cases:
        a = _randn(1 if shared else batch, m, k, seed=m * 7 + k)
        b = _randn(batch, k, n, seed=n * 13 + k + batch)
        assert bits_equal(_gemm_with(old_gemm, a, b), kbg.bi_gemm(a, b)), label
        wide = a.expand(batch, m, k)
        ms = median_turns({
            "against": lambda a=a, b=b: _gemm_with(old_gemm, a, b),
            "this": lambda a=a, b=b: kbg.bi_gemm(a, b),
            "library": lambda wide=wide, b=b: torch.bmm(wide, b)},
            10 if m * k > 1_000_000 else 50)
        rows.append(dict(kernel="bi_gemm", case=label, shape=[batch, m, k, n],
                         **ms))
    edges = differ = infinite = 0
    for m in EDGE_MS:
        x = edge_rows(m, seed=m)
        for xx in (x, misaligned(x)):
            assert bits_equal(_reduce_with(old_reduce, xx, kbr.ARGMAX),
                              kbr.bi_reduce(xx, kbr.ARGMAX)), m
            d, i = _lse_against(old_reduce, xx)
            assert d in (0, i), (m, d, i)   # the other tree has the rule
            differ, infinite, edges = differ + d, infinite + i, edges + 2
    emit(phase="kernel_edges_against", gpu=smi, cases=edges,
         widths=list(EDGE_MS), rows=EDGE_R, argmax_bits_equal=True,
         logsumexp_rows=EDGE_R * edges // 2, rows_differing=differ,
         infinite_max_rows=infinite, against_reads_nan_there=differ > 0,
         only_infinite_max_rows_differ=True)
    reduce_cases = list(BI_REDUCE_CASES) + [
        ("main path eval argmax", 48 * 10_000, 10, 1, kbr.ARGMAX, True,
         False)]
    for label, r, m, d, mode, timed, band in reduce_cases:
        x = bi_reduce_input(r, m, d, band)
        if mode == kbr.LOGSUMEXP:
            assert _lse_against(old_reduce, x) == (0, 0), label
        else:
            assert bits_equal(_reduce_with(old_reduce, x, mode),
                              kbr.bi_reduce(x, mode)), label
        if not timed:
            emit(phase="kernel_turns", gpu=smi, kernel="bi_reduce",
                 case=label, mode=kbr.MODES[mode], shape=[r, m, d],
                 bits_equal=True, timed=False)
            continue
        library = _BI_LIBRARY[mode]
        ms = median_turns({
            "against": lambda x=x, mode=mode: _reduce_with(old_reduce, x,
                                                           mode),
            "this": lambda x=x, mode=mode: kbr.bi_reduce(x, mode),
            "library": lambda x=x, library=library: library(x)}, 100)
        rows.append(dict(kernel="bi_reduce", case=label,
                         mode=kbr.MODES[mode], shape=[r, m, d], **ms))
    for row in rows:
        emit(phase="kernel_turns", gpu=smi, bits_equal=True,
             speedup=row["against"] / row["this"],
             of_library=row["this"] / row["library"], **row)
    rows += k3_against(old_flash, smi)
    rows += k5_against(old_moe, smi)
    decode_steps_against(old_moe, smi)
    return rows


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs on the GPU")
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    emit(phase="device", gpu=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=platform.python_version())

    # 2. build every kernel from source
    assert set(KERNELS) == set(build.KERNELS), (KERNELS, build.KERNELS)
    t0 = time.perf_counter()
    logs = build.build()
    emit(phase="build", seconds=time.perf_counter() - t0,
         built=sorted(logs), ptxas={k: ptxas_summary(v)
                                    for k, v in logs.items()})
    # what the bf16 routes were compiled to: K3 on mma.sync (HMMA, fed by
    # ldmatrix), K5's prefill route on wgmma (HGMMA) fed by TMA tensor loads
    # (UTMALDG), K4's tensor-core route on mma.sync fed by cp.async
    # (LDGSTS), K6's chunk states and chunk scan on mma.sync
    sass = {name: sass_ops(name) for name in (
        "flash_attention", "moe_gemm", "decode_attention", "ssd_scan",
        "robust_aggregate", "bi_gemm", "bi_reduce")}
    emit(phase="sass", **sass)
    check_bi_sass(sass["bi_gemm"], sass["bi_reduce"])
    # K2 sorts each column in registers: no instance up to 64 rows may
    # touch shared or local memory; each instance's registers and spills
    k2_ptxas = ptxas_summary(logs.get("robust_aggregate", ""))
    k2 = {}
    for c in SIZE_CLASSES:
        name = f"robust_kernel<{c}>"
        ops = sass["robust_aggregate"][name]
        k2[name] = dict(ptxas=k2_ptxas.get(name), **{
            op: ops[op] for op in ("LDS", "STS", "LDL", "STL")})
        if c <= 64:
            assert not any(ops[op] for op in ("LDS", "STS", "LDL", "STL")), (
                name, ops)
    emit(phase="k2_instances", **k2)
    # every expected kernel must be found by name, so a renamed one fails
    for d in k3.HEAD_DIMS:
        ops = sass["flash_attention"][f"flash_bf16_kernel<{d}>"]
        assert ops["HMMA"] > 0, (d, ops)
    # K3's float32 route on the CUDA cores: FFMA from 128-bit shared loads
    # fed by cp.async, no tensor-core instruction; at most one value
    # spilled once (ptxas spills 8 bytes at D = 32 with 2 or 4 warps)
    assert {n for n in sass["flash_attention"] if n.startswith(
        "flash_f32_kernel<")} == {f"flash_f32_kernel<{d},{kt},{w}>"
                                  for d, kt, w in K3_F32_INSTANCES}
    for d, kt, w in K3_F32_INSTANCES:
        ops = sass["flash_attention"][f"flash_f32_kernel<{d},{kt},{w}>"]
        assert ops["FFMA"] > 0 and ops["LDS.128"] > 0 and ops["LDGSTS"] > 0, (
            d, kt, w, ops)
        assert not ops["HMMA"] and not ops["HGMMA"], (d, kt, w, ops)
        assert ops["LDL"] <= 1 and ops["STL"] <= 1, (d, kt, w, ops)
    ops = sass["moe_gemm"]["moe_gemm_wgmma_kernel"]
    assert ops["HGMMA"] > 0 and ops["UTMALDG"] > 0, ops
    # K5's decode route, every slot-tile count: HMMA fed by TMA (UTMALDG) or
    # by cp.async (LDGSTS), read by ldmatrix (LDSM), no spill
    for ct in K5_DECODE_TILES:
        for kernel, feed in (("moe_gemm_decode_tma_kernel", "UTMALDG"),
                             ("moe_gemm_decode_kernel", "LDGSTS")):
            ops = sass["moe_gemm"][f"{kernel}<{ct}>"]
            assert ops["HMMA"] > 0 and ops[feed] > 0 and ops["LDSM"] > 0, (
                kernel, ct, ops)
            assert not ops["LDL"] and not ops["STL"], (kernel, ct, ops)
    for d in k4.HEAD_DIMS:
        ops = sass["decode_attention"][f"decode_mma_kernel<{d}>"]
        assert ops["HMMA"] > 0 and ops["LDGSTS"] > 0, (d, ops)
    # both routes of each: hi/lo pairs (kSplit 1) and bf16 compute (0)
    for p in k6.MMA_HEAD_DIMS:
        for kernel in ("ssd_state_kernel", "ssd_chunk_scan_kernel"):
            for split in (1, 0):
                ops = sass["ssd_scan"][f"{kernel}<{p},{split}>"]
                assert ops["HMMA"] > 0, (kernel, p, split, ops)

    # 17 (a, d), started now: the full dry run and the hillclimb trace on
    # meta tensors in subprocesses on the host's other cores, collected by
    # phase 17
    dry_job = start_cli("dryrun", "-m", "repro_torch.launch.dryrun", "--all",
                        "--force", "--out")
    climb_job = start_cli("hillclimb", "-c", _HILLCLIMB, *HILLCLIMB)
    # 20 (c), started now too: the dry run on the production meshes
    sharded_jobs = start_sharded_dryruns()

    # 3. kernels against their plain versions
    for n in (8, 32, 56):
        check_aggregate(n, M_MLP, torch.float32, "main")
    check_aggregate(1, 1, torch.float32, "ragged", assume_normalized=False)
    check_aggregate(7, 4097, torch.float32, "ragged",
                    assume_normalized=False)
    check_aggregate(5, M_MLP + 1, torch.float32, "ragged odd M")
    check_aggregate(32, M_MLP, torch.float32, "misaligned",
                    misaligned=True)
    check_aggregate(32, M_MLP, torch.bfloat16, "bf16")
    check_aggregate(16, 1 << 16, torch.bfloat16, "bf16 wide")
    check_aggregate(7, 4097, torch.bfloat16, "bf16 ragged",
                    assume_normalized=False)
    check_aggregate(64, 1 << 22, torch.float32, "bandwidth", reps=20)

    for rows, n, m, mode, dtype, label, opts in robust_cases():
        check_robust(rows, n, m, mode, dtype, label, **opts)

    f32, bf16 = torch.float32, torch.bfloat16

    # lm_tiny's training shapes (8 windows a client row, a bucket's rows
    # padded to 1, 2, 4, 8, 16 or 24) and its evaluation shape (16 client
    # rows x 400 windows); then tests/test_kernels.py's five shapes in
    # both types, a ragged S and a window without causal
    for b in K3_LM_BATCHES:
        check_flash(b, 4, 32, 32, 16, True, None, f32,
                    "lm_tiny eval" if b == 6400 else "lm_tiny train")
    for dt in (f32, bf16):
        for b, h, s_, t_, d, causal, window, label in K3_SHAPES:
            check_flash(b, h, s_, t_, d, causal, window, dt, label, reps=50)
    # the bf16 tensor-core route at every head dim, a ragged S and T (S =
    # 100 right-aligned in T = 130), windowed and not, with grouped KV
    # heads; then f32 with grouped KV heads
    for d in k3.HEAD_DIMS:
        for causal, window in ((True, None), (True, 48), (False, 17)):
            check_flash(2, 6, 100, 130, d, causal, window, bf16,
                        "ragged T, GQA 6/2", reps=20, hkv=2)
    label, b, h, hkv, s_, t_, d, causal, window = K3_GQA
    check_flash(b, h, s_, t_, d, causal, window, f32, label, reps=20,
                hkv=hkv)
    check_flash_grad(128, 4, 32, 16)
    check_flash_grad(4, 12, 64, 32, hkv=4)
    # K3 at starcoder2-15b's prefill shape (48 query heads over its 4 KV
    # heads, read in place) and at qwen2-moe-a2.7b's (16 heads, no GQA)
    check_flash(SERVE_BATCH, 48, SERVE_PROMPT, SERVE_PROMPT, 128, True, None,
                bf16, "starcoder2-15b prefill", reps=5, hkv=4)
    check_flash(SERVE_BATCH, 16, SERVE_PROMPT, SERVE_PROMPT, 128, True, None,
                bf16, "qwen2-moe-a2.7b prefill", reps=5)
    # seamless-m4t-medium's prefill (16 heads of 64): the decoder's causal
    # self-attention, the encoder's bidirectional one and the
    # cross-attention (2,048 frames); then the cross-attention of a target
    # longer than its source, unmasked S > T (the negative shift feeds no
    # mask), at the serving width and ragged in both types
    check_flash(SERVE_BATCH, 16, SERVE_PROMPT, SERVE_PROMPT, 64, True, None,
                bf16, "seamless-m4t-medium decoder prefill", reps=5)
    check_flash(SERVE_BATCH, 16, SERVE_PROMPT, SERVE_PROMPT, 64, False, None,
                bf16, "seamless-m4t-medium encoder / cross prefill", reps=5)
    check_flash(SERVE_BATCH, 16, SERVE_PROMPT, SERVE_PROMPT // 2, 64, False,
                None, bf16, "unmasked S > T (2,048 over 1,024)", reps=5)
    label, b, h, hkv, s_, t_, d, causal, window = K3_UNMASKED
    for dt in (f32, bf16):
        check_flash(b, h, s_, t_, d, causal, window, dt, label, reps=20,
                    hkv=hkv)

    # K4: tests/test_kernels.py's three shapes in both types; the GQA
    # serving shape of starcoder2-15b (48 query, 4 KV heads, D 128, bf16,
    # a cache of 2,080) and qwen2-moe-a2.7b's (16 query and KV heads: one
    # query head a block, and B·Hkv, which sets the split count, 4x
    # starcoder2's) at the first, a middle and the last length; a window's
    # view in the middle of a linear cache; a ring's prefix
    for dt in (f32, bf16):
        for b, h, t_, d, length in ((2, 4, 512, 64, 300),
                                    (1, 8, 1024, 128, 1024),
                                    (4, 2, 256, 64, 1)):
            check_decode("tests/test_kernels.py", b, h, h, t_, d, length, dt)
    cap = SERVE_PROMPT + SERVE_NEW
    for length in (1, 2048, cap):
        check_decode("starcoder2-15b serving", SERVE_BATCH, 48, 4, cap, 128,
                     length, bf16)
        check_decode("qwen2-moe-a2.7b serving", SERVE_BATCH, 16, 16, cap,
                     128, length, bf16)
    check_decode("window 1,024 view of a linear cache", SERVE_BATCH, 48, 4,
                 cap, 128, 1024, bf16, lo=1024)
    # seamless-m4t-medium's decode (16 / 16 heads of 64): the
    # cross-attention over all 2,048 frames, the self-attention at the
    # serving path's median length
    check_decode("seamless-m4t-medium cross", SERVE_BATCH, 16, 16,
                 SERVE_PROMPT, 64, SERVE_PROMPT, bf16)
    check_decode("seamless-m4t-medium self, median length", SERVE_BATCH, 16,
                 16, cap, 64, SERVE_PROMPT + SERVE_NEW // 2, bf16)
    check_decode("ring prefix (1,001 of 4,096 slots)", SERVE_BATCH, 48, 4,
                 4096, 128, 1001, bf16)
    # the tensor-core route at every group size of the zoo (qwen2-moe and
    # moonshot 1, qwen2.5 5, yi 7, chameleon and Jamba 8, starcoder2 12) and
    # every head dim, at a ragged length (237 of 300 slots: a split's last
    # 16-key step cut short)
    for d in k4.HEAD_DIMS:
        for g in (1, 5, 7, 8, 12):
            row = check_decode(f"G {g}, D {d}, ragged", 3, 2 * g, 2, 300,
                               d, 237, bf16, reps=20)
            assert row["route"] == "tensor_cores", row

    # K6: tests/test_kernels.py's three shapes (grouped B/C included);
    # mamba2-370m's prefill shape in bf16
    for b, length, h, p, n, g, chunk in ((2, 256, 4, 32, 16, 4, 64),
                                         (1, 128, 2, 64, 32, 1, 128),
                                         (1, 64, 8, 16, 8, 8, 16)):
        check_ssd("tests/test_kernels.py", b, length, h, p, n, g, chunk, f32)
    summary_k6 = check_ssd("mamba2-370m prefill", SERVE_BATCH, SERVE_PROMPT,
                           32, 64, 128, 1, 256, bf16, reps=10)
    # the tensor-core route: mamba2's shape from an initial state (the
    # decode cache's prefill continued), Jamba's grouping (8 B/C groups over
    # 64 heads, L cut to 1,024), chunks of 64 and 128; and a bf16 shape it
    # does not take (N 8: the CUDA-core kernel)
    check_ssd("mamba2-370m prefill, initial state", SERVE_BATCH,
              SERVE_PROMPT, 32, 64, 128, 1, 256, bf16, reps=10, init=True)
    check_ssd("Jamba grouping", 2, 1024, 64, 64, 128, 8, 256, bf16, reps=10)
    check_ssd("chunk 64", 2, 512, 8, 64, 128, 1, 64, bf16, reps=10)
    check_ssd("chunk 128, initial state", 2, 512, 8, 32, 64, 2, 128, bf16,
              reps=10, init=True)
    row = check_ssd("N 8 (the CUDA-core route)", 1, 128, 4, 32, 8, 1, 64,
                    bf16, reps=10)
    assert row["route"] == "cuda_cores", row
    assert summary_k6["route"] == "tensor_cores", summary_k6

    # K5: tests/test_kernels.py's three shapes in both types; ragged shapes
    # (qwen2-moe's prefill capacity C = 1,368 at small E; K and N off the
    # tiles); bf16 on either side of the launcher's C threshold (128: the
    # wgmma route at and above it, mma.sync below), N a multiple of its
    # 256-wide tile and not; qwen2-moe-a2.7b's serving shapes
    # (60 experts, d 2,048, f 1,408): the gate/up and down products at
    # prefill (C 1,368 for 8 x 2,048 tokens) and at a decode step (C 8)
    for dt in (f32, bf16):
        for e, c, k, n in ((4, 128, 256, 128), (8, 64, 128, 384),
                           (2, 256, 512, 256)):
            check_moe("tests/test_kernels.py", e, c, k, n, dt)
        for e, c, k, n in ((3, 1368, 200, 136), (2, 37, 100, 70),
                           (5, 8, 33, 65), (1, 1, 7, 1)):
            check_moe("ragged", e, c, k, n, dt)
    for c in (127, 128, 129):
        for n in (384, 512):
            check_moe("C threshold", 4, c, 264, n, bf16)
    e, d, f = 60, 2048, 1408
    c_pre = tmoe.capacity(SERVE_BATCH * SERVE_PROMPT,
                          registry.get("qwen2-moe-a2.7b"))
    check_moe("qwen2-moe prefill gate/up", e, c_pre, d, f, bf16, reps=10)
    check_moe("qwen2-moe prefill down", e, c_pre, f, d, bf16, reps=10)
    summary_k5 = check_moe("qwen2-moe decode gate/up", e, 8, d, f, bf16)
    check_moe("qwen2-moe decode down", e, 8, f, d, bf16)
    # deepseek-v3-671b's (256 experts, d 7,168, f 2,048): gate/up and down at
    # prefill (C 640 for 8 x 2,048 tokens), gate/up at a decode step (C 8)
    e, d, f = 256, 7168, 2048
    c_pre = tmoe.capacity(SERVE_BATCH * SERVE_PROMPT,
                          registry.get("deepseek-v3-671b"))
    check_moe("deepseek-v3 prefill gate/up", e, c_pre, d, f, bf16, reps=10)
    check_moe("deepseek-v3 prefill down", e, c_pre, f, d, bf16, reps=10)
    check_moe("deepseek-v3 decode gate/up", e, 8, d, f, bf16, reps=20)
    check_moe("deepseek-v3 decode down", e, 8, f, d, bf16, reps=20)
    # both decodes again on the x a decode step's dispatch gives K5 (the
    # experts no token was routed to all zero), with P31
    moe_decode_checks()

    # the task plane's batch-invariant kernels at the main paths' shapes
    for case in BI_GEMM_CASES:
        check_bi_gemm(*case)
    for case in BI_REDUCE_CASES:
        check_bi_reduce(*case)
    check_bi_reduce_edges()
    check_infinite_max_backwards()

    # 4. the undefended main path at the paper's §V scale
    reset_launches()
    reset_bi()
    server = quickstart(50, 5, 50_000, 10_000, "cuda")
    emit(phase="main_path_init",
         w1_sum=float(server.params["w1"].double().sum()),
         w1_head=server.params["w1"][0, :4].tolist())
    rounds = []
    with bi_reduce_modes() as modes:
        for t in range(3):
            t0 = time.perf_counter()
            log = server.run_round(t)
            torch.cuda.synchronize()
            rounds.append(dict(
                round=t, acc=log.global_acc,
                n_selected=int(log.selected.size),
                n_malicious_selected=int(log.n_malicious_selected),
                agg_rows=pad_count(int(log.selected.size)),
                wall_ms=(time.perf_counter() - t0) * 1e3,
                selected=log.selected.tolist()))
            emit(phase="main_path", **rounds[-1])
    launches = read_launches()
    bi_main = read_bi()
    emit(phase="main_path_launches", launches=launches,
         bi_reduce_by_mode=dict(modes), **bi_main)
    assert launches == only(weighted_aggregate=3), launches
    # every product and sum of the task plane went through the two
    # kernels, the reductions in each of their three modes
    assert all(n > 0 for n in bi_main.values()), bi_main
    assert sum(modes.values()) == bi_main["bi_reduce"], (modes, bi_main)
    assert all(modes[k] > 0 for k in kbr.MODES.values()), modes
    launches.update(bi_main)
    accs = [r["acc"] for r in rounds]
    assert all(np.isfinite(accs)), accs
    assert accs[2] > accs[0], accs

    # not counted: one round split into its phases, then one round under
    # the profiler for the device's busy share and kernel time by name
    emit(phase="round_phases", run="main", round=3,
         **round_phases(server, 3))
    emit(phase="profile_round", run="main", **profile_round(server, 4))
    emit(phase="route_host_split", run="main", gpu=smi,
         **route_host_split(server, 5))

    # the kernel at the main path's aggregation shape, for the summary
    n_main = max(r["agg_rows"] for r in rounds)
    summary = {"weighted_aggregate": check_aggregate(
        n_main, M_MLP, torch.float32, "main path rows")}
    # the batch-invariant kernels at the main path's largest calls: the
    # evaluation's product (its models over the shared test images) and
    # argmax (each model's 10,000 rows of 10 logits)
    summary["bi_gemm"] = check_bi_gemm("main path eval", n_main, 10_000,
                                       784, 64, shared=True)
    summary["bi_reduce"] = check_bi_reduce(
        "main path eval argmax", n_main * 10_000, 10, 1, kbr.ARGMAX)
    # what a routed call costs the host, layer by layer
    bi_host_cost()

    # 5. the defended path at the same scale, through run_experiment
    out_a, server_a = defended_run(
        "a", scenario="sign_flip", defense="trimmed_mean+validation")
    launches["robust_aggregate"] = read_launches()["robust_aggregate"]
    emit(phase="round_phases", run="a", round=3,
         **round_phases(server_a, 3))
    emit(phase="profile_round", run="a", **profile_round(server_a, 4))
    n_a = max(int(log.selected.size) for log in server_a.logs[:3])
    summary["robust_aggregate"] = check_robust(
        pad_count(n_a), n_a, M_MLP, "trimmed_mean", f32, "run (a) rows")
    defended_run("b", scenario="noise_0.8", defense="median")

    # 6. K1's defended routes
    for defense in ("norm_clip", "krum", "validation"):
        reset_launches()
        out, _ = experiment(
            cfg=FeelConfig(n_ues=10, n_malicious=2), n_train=3000,
            n_test=500, scenario="sign_flip", defense=defense, rounds=2,
            device="cuda")
        got = read_launches()
        emit(phase="k1_defended_route", defense=defense, launches=got,
             acc=out["acc"], n_clipped=out["n_clipped"],
             n_rejected=out["n_rejected"], n_flagged=out["n_flagged"])
        assert got == only(weighted_aggregate=2), (defense, got)
    # the loop engine stacks its uploads on the card and aggregates there
    for defense in ("trimmed_mean", "median"):
        reset_launches()
        out, _ = experiment(
            cfg=FeelConfig(n_ues=10, n_malicious=2), n_train=3000,
            n_test=500, scenario="sign_flip", defense=defense,
            engine="loop", rounds=2, device="cuda")
        got = read_launches()
        emit(phase="loop_defended_route", defense=defense, launches=got,
             acc=out["acc"], n_rejected=out["n_rejected"])
        assert got == only(robust_aggregate=2), (defense, got)
        assert all(np.isfinite(out["acc"])), out["acc"]

    # 7. small runs on the GPU and on the CPU
    small = {dev: quickstart(10, 2, 3000, 500, dev).run(2)
             for dev in ("cuda", "cpu")}
    for a, b in zip(small["cuda"], small["cpu"]):
        assert np.array_equal(a.selected, b.selected), (a.selected,
                                                        b.selected)
        assert abs(a.global_acc - b.global_acc) <= 1e-2, (a.global_acc,
                                                         b.global_acc)
        emit(phase="cuda_vs_cpu", run="undefended", round=a.round,
             acc_cuda=a.global_acc, acc_cpu=b.global_acc,
             selected=a.selected.tolist())
    defended = {dev: experiment(
        cfg=FeelConfig(n_ues=10, n_malicious=2), n_train=3000, n_test=500,
        scenario="sign_flip", defense="trimmed_mean+validation", rounds=2,
        device=dev)[1].logs for dev in ("cuda", "cpu")}
    for a, b in zip(defended["cuda"], defended["cpu"]):
        assert np.array_equal(a.selected, b.selected), (a.selected,
                                                        b.selected)
        assert (a.n_rejected, a.n_flagged) == (b.n_rejected, b.n_flagged)
        assert abs(a.global_acc - b.global_acc) <= 1e-2, (a.global_acc,
                                                         b.global_acc)
        emit(phase="cuda_vs_cpu", run="trimmed_mean+validation",
             round=a.round, acc_cuda=a.global_acc, acc_cpu=b.global_acc,
             n_rejected=a.n_rejected, n_flagged=a.n_flagged,
             selected=a.selected.tolist())

    # 8. the LM path
    launches["flash_attention"], summary["flash_attention"] = lm_phases()

    # 9. the batched control plane and the multi-run sweep
    emit(phase="sweep_launches", **sweep_phases())

    # 10. the population plane and the async plane
    cli_untraced = population_async_phases()

    # 11. the observability plane
    t0 = time.perf_counter()
    obs_phases(out_a, server_a, cli_untraced)
    emit(phase="obs_seconds", seconds=time.perf_counter() - t0)

    # 12./13. serving the decoder-only zoo, experts included; from here to
    # phase 17 nothing enters the task plane, and its kernels stay idle
    reset_bi()
    (launches["decode_attention"], launches["moe_gemm"],
     launches["ssd_scan"]) = zoo_phases()
    # K4 at the serving path's median cache length (2,049 to 2,080 valid
    # positions over the 32 steps)
    summary["decode_attention"] = check_decode(
        "starcoder2-15b decode, median length", SERVE_BATCH, 48, 4,
        SERVE_PROMPT + SERVE_NEW, 128, SERVE_PROMPT + SERVE_NEW // 2,
        torch.bfloat16)
    summary["ssd_scan"] = summary_k6
    summary["moe_gemm"] = summary_k5

    # 14. the rest of the zoo: DeepSeek-V3 and Seamless-M4T
    t0 = time.perf_counter()
    rest = zoo_rest_phases()
    emit(phase="zoo_rest_seconds", seconds=time.perf_counter() - t0,
         launches=rest)

    # 16. training the zoo
    t0 = time.perf_counter()
    k5_train, k6_train, cells = train_phases()
    emit(phase="train_seconds", seconds=time.perf_counter() - t0,
         k5_backward_ms=[r["backward_ms"] for r in k5_train],
         k6_backward_ms=k6_train["backward_ms"],
         cells={k: dict(step_ms=v["step_ms_median_2_to_5"],
                        tokens_per_s=v["tokens_per_s"],
                        peak_gb=v["peak_gb"], shares=v["shares"])
                for k, v in cells.items()})

    # 17. the step-cost plane
    t0 = time.perf_counter()
    summary[BF16_ROUTE], launches[BF16_ROUTE] = step_cost_phases(dry_job,
                                                                 climb_job)
    emit(phase="step_cost_seconds", seconds=time.perf_counter() - t0)
    zoo_bi = read_bi()
    emit(phase="zoo_bi_launches", **zoo_bi)
    assert not any(zoo_bi.values()), zoo_bi

    # 18. the contract checker on the card
    emit(phase="contracts_seconds",
         seconds=contracts_phases(pad_count(n_a), n_a))

    # 19. the sharded plane: the cohort step over NCCL, K1 once a step;
    # 20. the sharded zoo on the same group
    gc.collect()
    torch.cuda.empty_cache()
    # 21 (a). the population prefilter on a mesh, on the same group
    k1_cohort, seconds, (zoo_launches, mesh_s), zoo_s = sharded_phases(
        server, smi, then=lambda mesh: (
            zoo_sharded_phases(mesh, sharded_jobs, smi),
            population_mesh_phase(smi)))
    launches["weighted_aggregate"] += k1_cohort
    emit(phase="sharded_seconds", seconds=seconds)
    for name, n in zoo_launches.items():
        launches[name] += n
    emit(phase="sharded_zoo_seconds", seconds=zoo_s - mesh_s, gpu=smi)

    # 21 (b). the example drivers' torch twins
    t0 = time.perf_counter()
    for name, n in driver_phases(smi).items():
        launches[name] += n
    emit(phase="last_slice_seconds",
         seconds=mesh_s + time.perf_counter() - t0, gpu=smi)

    # 22. the model init: the reference's draw on the card
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for name, n in init_phases(smi).items():
        launches[name] += n
    emit(phase="init_phase_seconds", seconds=time.perf_counter() - t0,
         gpu=smi)

    # 15. summary and result
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [dict(
        name=name, **ROUTES[name], launches=launches[name],
        max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"])
        for name, row in summary.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        import argparse
        ap = argparse.ArgumentParser(description="With no argument, the "
                                     "whole check above.")
        which = ap.add_mutually_exclusive_group(required=True)
        which.add_argument("--rounds-against", type=Path, metavar="DIR",
                           help="time the FEEL rounds of DIR's tree and "
                           "this one in turns, and nothing else")
        which.add_argument("--kernels-against", type=Path, metavar="DIR",
                           help="hold bi_gemm and bi_reduce (sum, "
                           "logsumexp, argmax) and K3's float32 route of "
                           "DIR's tree against this one's, bit for bit, "
                           "and time them in turns; K5 at the MoE decode "
                           "and prefill and the MoE decode steps likewise, "
                           "in turns; and nothing else")
        args = ap.parse_args()
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; this runs on the GPU")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        if args.rounds_against:
            rounds_against(args.rounds_against, smi)
        else:
            kernels_against(args.kernels_against, smi)
    else:
        main()
