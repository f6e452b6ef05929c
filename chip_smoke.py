#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chainermn_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line on stdout:

1. ``device``: the card's name, PyTorch and CUDA versions, and the card's
   name and power limit as ``nvidia-smi`` reports them.
2. ``build``: ``nvcc`` compiles every source under
   ``chainermn_tpu_torch/csrc/`` for sm_90a, all at once (the ptxas
   report of registers, shared memory and spills goes to stderr); then
   ``flash_sass`` and ``conv_sass``: the count of ``HGMMA`` (wgmma),
   ``HMMA`` (mma.sync) and ``UTMALDG`` (TMA loads) in each bf16 flash
   function and each bf16 fused-conv function of ``cuobjdump -sass``, and
   the functions whose wgmmas ptxas serialized (from the library's build
   log), printed before the check that every one of them has wgmma and
   TMA, no mma.sync and no serialized wgmma; and ``decode_sass``: the
   count of ``UBLKCP`` (1-D bulk copies) and ``LDGSTS`` (``cp.async``) in
   each decode-attention function with ptxas's registers, stack frame and
   spill bytes for it, printed before the check that every bf16-cache
   function (K4 and K5) copies asynchronously and spills nothing.
3. ``parity``: each hand-written kernel against its plain PyTorch version
   on the same inputs at the serving model's shapes: fp32 (atol 1e-4:
   sums in another order), bf16 (atol 2e-2: one bf16 rounding of O(1)
   outputs) and int8 pools with grouped-query heads (atol 2e-2), with
   speculative verify chunks (T = 4), idle slots (valid_len = 0) and every
   supported head dim; each case twice, the second time with lengths that
   end exactly on, just before and just past the launch's split
   boundaries, straddle one with a verify chunk's rows, and leave whole
   splits empty; then the fused kernel at the searches' shapes in bf16
   and fp32 (``SEARCH_CASES``: a beam search's 32 rows at one length, a
   speculative draft step's 8 rows of lengths 129-133).
4. ``timing``: device times (CUDA-graph replay, CUDA events) of each
   kernel, its plain version and one PyTorch library call computing the
   same function, at the main path's shapes with the L2 cache cold,
   beside the least time the card could take (the larger of bytes over
   3.35 TB/s and operations over the peak rate of the input type), and
   the kernel wrapper's eager per-call time; then one long-context row
   per decode kernel (``timing`` lines with ``"row": "long"``): the paged
   kernel at 8 slots of ~4096 positions (256 blocks of 16), the fused one
   at batch 8, L = 16384, both bf16 with 12 kv heads and Dh 64.
5. ``serving``: the full-width model of the serving benchmark (12 layers,
   d_model 768, 12 heads, d_ff 3072, vocab 32768, RoPE, seeded random
   weights, bf16 compute) through ``DecodeEngine`` + ``Scheduler.run`` on
   16 requests, with the scheduler's planes on as the JAX benchmark's
   headline arm runs them; then ``serving_turns`` (the same 16 requests
   on one engine, 3 rounds of the full run's scheduler set-up and the
   compare turns', in turns: clean decode-step ms and garbage
   collections per pass), ``obs_overhead`` (a decode-heavy mix, 12 pairs
   of drain-mode passes with the planes off (``CMN_OBS=0``) and on in
   turns: the median of the per-pair ratios of median tick time, the
   planes' cost per decode iteration, and of makespans), ``policy`` (an
   adversarial tenant's burst of twice
   the capacity ahead of an SLO tenant's requests, FIFO and under a 4:1
   weighted-fair ``PolicyPlane``: each tenant's p95), and the same drive
   with 4 kv heads and an int8 cache.  Each engine is warmed first (one
   request of 20 new tokens: the decode step's CUDA-graph capture and
   the capture watch's cost model).  A drive checks that every request
   completes, one capture replayed once per decode iteration, the paged
   kernel run decode iterations x 12 times as the kernel counts its own
   runs on the card (a replay runs it without its wrapper), that count
   equal to the wrappers' eager launches plus replays x the launches the
   capture recorded, all three SLO streams reported, a
   complete timeline per request and its Chrome trace written and
   parsed, the ledger's books exact, no incident, no leaked block, and a
   ``device.decode_step.mfu_pct`` gauge in (0, 100] against the H100's
   989 TFLOP/s.  Prefill is captured too, one graph per ladder geometry
   (32/16/8), all at the warm-up: the drive checks every chunk replayed
   one and no capture made in it.
5b. ``serving_spec``: the serving bench's ``--spec-k 4`` A/B
   (``benchmarks/serving.py:691-790``): the zero-tail distilled draft of
   ``layers // 4`` = 3 blocks lifted into the engine, 16 requests of 16
   tokens and 24 new, drain passes of the plain and the speculative
   engine in turns (4 pairs): acceptance, the tokens/s ratio, one
   ``spec_round`` capture replayed every round, K4's runs on the card =
   rounds x (5 x 3 + 12), ``device.spec_round.*`` gauges published; in
   fp32 the speculative tokens = the plain engine's (in bf16 the
   divergence structure is reported: the verify forward and the
   single-token step round differently).
5a. The serving fleet on the same model, every replica on this one card
   over one copy of the weights, each engine warmed (its decode step
   captured) as it is built: ``router`` (the JAX bench's ``--replicas``
   arm: 2 replicas behind a ``Router``, 32 requests; tokens against one
   engine alone, divergence structure in bf16 and exactly in an fp32
   twin; dispatch ms, steals, occupancy, the fleet trace naming a stolen
   request on both pids, the shared ledger conserved), ``disagg`` (the
   ``--disagg`` arm: a prefill and a decode role over ``LocalComm``
   against a colocated engine; no mixed iteration and one capture on
   the decode role, every request migrated, ``migrate_ms`` and bytes,
   and a migrated block re-read byte for byte in bf16 and int8-GQA),
   ``chaos`` (the ``--chaos`` arm: ``ChaosHarness`` over 3 replicas
   under ``chaos_schedule(seed, 3)``; the terminal invariant, the health
   counters against the schedule) and ``elastic`` (the ``--elastic``
   arm: an ``Autoscaler`` fleet against a static 2-replica one on
   sinusoid-plus-burst arrivals, then a ``RollingDeploy``;
   replica-seconds, flaps, p95s).  Each checks every request terminated
   once, one capture per engine, K4's runs on the card = warm-ups +
   every engine's replays x 12, and (``chaos``, ``elastic``) that the
   card's allocated bytes equal what the engines still in a fleet hold.
6. ``generation``: ``lm_generate`` at batch 8, prompt 128, 64 new tokens.
7. ``agreement``: the engine and ``lm_generate`` on the same requests with
   the model in fp32, so that bf16 near-ties cannot flip tokens.
7a. The rest of decoding, on the decode benchmark's model
   (``benchmarks/decode.py:45-53``: 12 layers, d_model 768, 12 heads,
   d_ff 3072, vocab 32768, learned positions, bf16, fused decode
   attention; batch 8, prompt 128, 64 new tokens): ``beam``
   (``lm_beam_search``, beam 4: K5 on 32 rows, 12 x 63 runs; one step's
   cache reorder under ``torch.profiler``; in fp32 on the same weights
   beam 1 = ``lm_generate`` token for token and beam 4's best score >=
   greedy's summed log-probability from a full forward), ``speculative``
   (the bench's ``--speculative 4 --draft-mode distilled`` arm: the
   target's blocks 2-11 zeroed in ``proj``/``ff2``, its first 2 blocks
   the draft; target forwards, acceptance and tokens/s against
   ``lm_generate`` of the same target, K5 = 2 x (k + 1) x rounds; a
   sampled drive; in fp32 the tokens = the target's greedy ones),
   ``rolling`` (window 1024, RoPE, einsum cache,
   ``lm_generate(rolling=True)`` for 1024 new tokens: every step's cache
   is the 1024-slot ring, no kernel runs; in fp32 the tokens = the full
   cache's over 128 new tokens after a 960-token prompt),
   ``moe_generation`` (``benchmarks/moe.py``'s MoE
   model, E 8, F 1536, top-2, capacity factor 1.25, through
   ``lm_generate`` on the fused path: K5 12 x 63, the dropped share of
   the prefill and of a decode step; in fp32 the decode prefill's logits
   = the full forward's, and at ample capacity single-token steps = the
   full forward, atol 1e-4).
8. ``flash_parity``: the flash-attention kernels (forward, dK/dV, dQ)
   through their autograd Function, ``(o, lse)`` forward and ``(dq, dk,
   dv)`` backward with a nonzero lse cotangent, against their plain
   versions: causal, non-causal, window, packed segments with fully masked
   rows, cross-attention with kv segments, GQA 12->4, MQA, ragged T = 1000,
   head dims 32/64/128, fp32 and bf16; then each kernel alone at the
   training path's shapes.  Each element is held to |err| <= rtol |ref| +
   atol rms(its reference row over the head dim): fp32 rtol 1e-5, atol
   1e-4 (sums in another order); bf16 rtol 2^-7 (each side rounds its
   output to bf16), atol 3e-2 (P and dS rounded to bf16 as tensor-core
   operands); lse |err| <= 1e-5 |ref| + 1e-5.  The line shows each
   reading before any check.
9. ``flash_timing``: as phase 4, for each flash kernel at the training
   path's shapes (batch 8, 12 heads, T 2048, Dh 64, bf16, causal); the
   library yardstick is ``F.scaled_dot_product_attention(is_causal=True)``:
   its forward for the forward kernel, its backward (forward + backward
   minus forward) for the two backward kernels together.
9a. ``flash_crossover``: K1-K3 forward + backward against the eager
   ``"xla"`` path at the LM's widths for T 128-4096, causal and not, at
   the LM step's 16384 tokens (the table ``FLASH_MIN_SEQ`` comes from).
10. ``training``: the LM benchmark's default model (benchmarks/lm.py: batch
   8, seq 2048, 12 layers, d_model 768, 12 heads, d_ff 3072, vocab 32768,
   learned positions, bf16 compute over fp32 params, AdamW 3e-4, remat
   on, a bf16 gradient wire) through the training entry path
   (``create_communicator`` -> ``create_multi_node_optimizer(adamw)`` ->
   ``make_train_step(lm_loss(model))``) on a fixed seeded batch (targets =
   tokens): 2 warm-up and 5 timed steps with ``attention="flash"``, the
   step captured as a CUDA graph (its first call runs eagerly, warms up
   and captures; the rest replay), the same steps eager
   (``capture=False``), then captured with the eager ``attention="xla"``;
   then the ``train_lm`` example for 3 steps.  One more step of each arm
   runs under ``torch.profiler`` (``training_trace``: device time by
   kernel, busy share, and the port's kernels counted in the profile:
   one replay's must be what the capture recorded).
11. ``training_agreement``: a 2-layer fp32 model (d_model 128, 4 heads,
   T 256, packed rows) trained 3 steps with the flash kernels and 3 with
   the plain path from the same weights: losses within rtol 1e-5,
   parameters within atol 1e-4 (fp32 sums in another order, through
   three Adam steps of lr 1e-3); and ``capture_agreement``: the flash
   arm captured against eager, losses within rtol ``CAPTURE_TOL`` and
   parameters within its atol (the same kernels on the same inputs).
11a. ``moe_training``: the MoE model at ``benchmarks/moe.py``'s training
   geometry (batch 8, seq 2048, remat, flash attention,
   ``lm_loss_chunked(chunk_size=8192)``, a bf16 gradient wire; AdamW 3e-4
   where the bench runs adafactor) through the same entry path: 2 warm-up
   and 5 timed steps, K1/K2/K3 24/12/12 per step, finite losses,
   ``moe_aux`` and ``moe_dropped``, captured, then the same steps eager;
   ``moe_training_trace`` traces one more eager step with every kernel
   of the MoE FFNs (forward, remat recompute, and the backward nodes of
   their forward ops) in a group of its own; and a 2-layer fp32 MoE model
   (d_model 128, T 256, vocab 1000, chunk 384: a ragged tail) holds
   ``lm_loss_chunked`` against ``lm_loss``: loss within rtol 1e-5,
   gradients within atol 1e-5, and another one's three steps captured
   against eager (``capture_agreement``).
12. ``conv_parity``: the fused 1x1-conv kernel (K6) against its plain
   version at every (N, Cin, Cout) a ResNet-50 training step gives it
   (batch 256, 224 px) and at ragged shapes, ReLU on and off, bf16 and
   fp32, each output element held to |err| <= rtol |ref| + atol rms(its
   reference row) (``K6_TOL``).  The line shows each reading before any
   check.
13. ``conv_timing``: as phase 4, for K6 at each of those shapes; the
   library yardstick is ``torch.matmul(x, w)`` alone (cuBLAS: the product
   without the epilogue, so it bounds any library route from below); then
   the sums over the 36 launches of one training step.
14. ``resnet``: ResNet-50 data-parallel training at full width (the
   bench's configuration, ``bench.py:1077``, ``:1154-1169``, ``:1226``:
   batch 256 per card, 224 px, 1000 classes, bf16 compute over fp32
   parameters, SGD 0.1 with momentum 0.9, a bf16 gradient wire) through
   ``create_communicator`` -> ``create_multi_node_optimizer(sgd)`` ->
   ``make_train_step(resnet_loss(model), stateful=True)`` on one seeded
   batch, three arms of 2 warm-up and 5 timed steps: ``sync/none`` (the
   headline: sync-BN, cuDNN convolutions, no K6; its loss must fall over
   its first two steps, and it runs on untimed to the bench's 25 steps,
   whose losses must stay finite), ``frozen/pallas`` (K6, 36 launches per
   step) and
   ``frozen/xla`` (its plain twin).  cuDNN
   autotuning (``cudnn.benchmark``) is on; the warm-up steps cover it.
   The frozen arms start their residual branches' last affine scales at
   ``FROZEN_BRANCH_SCALE`` (stored-statistics BN does not normalize, so
   from random weights at unit scales the residual stream grows block by
   block and the loss overflows).  Every arm's step is captured; the
   ``sync/none`` and ``frozen/pallas`` steps run eagerly too.  One more
   step of each arm runs under ``torch.profiler`` (``resnet_trace``; K6
   counted in the profiled replay: 36).
15. ``resnet_agreement``: ``ResNetTiny`` in fp32 (width 16, 32 px, 10
   classes, ``bn="frozen"``) trained 3 SGD steps with ``conv1="pallas"``
   (K6's fp32 instantiation) and 3 with ``conv1="xla"`` from the same
   weights, TF32 off and cuDNN deterministic: losses within rtol 1e-5,
   parameters within atol 1e-4; and ``capture_agreement`` for the
   frozen K6 model and a sync-BN one, captured against eager.
16. ``train_imagenet_example``: the ``train_imagenet`` example at its
   defaults for 3 steps.

The training loop's phases (``mnist_trainer`` with an eager arm
beside the four captured ones and the bare step eager in
``mnist_trainer_host_cost``, ``imagenet_trainer`` with
``imagenet_trainer_eager``, ``lm_eval``) follow phase 16.

17. The rest of the one-card model zoo and the optimizer tiers, each train
   step through the entry path and captured (one ``*_trace`` line per
   captured arm: the profiled replay's kernels must be the capture's
   record): ``seq2seq`` (``TransformerSeq2Seq`` at the NMT bench's
   geometry, ``benchmarks/seq2seq.py:22-33``: batch 64, src/tgt 512,
   d_model 512, 8 heads, d_ff 2048, 6 + 6 layers, vocab 32000, bf16,
   AdamW 3e-4, a bf16 wire, non-pad share 0.87; arms flash captured and
   eager, eager attention captured (an out-of-memory there is that arm's
   recorded result, as the bench records it), packed; K1-K3 18 each per
   step; flash against the plain path at the model's mask shapes, dead
   rows included; greedy and beam decoding of 2 rows for 32 positions,
   18 K1 per forward, and ``beam=1`` = greedy in fp32),
   ``seq2seq_example`` (the twin at its defaults for 20 epochs, LSTM and
   Transformer: BLEU above a floor, one capture per bucket signature and
   the card bytes they hold),
   ``vit`` (ViT-S/16, 224 px, batch 256, SGD 0.1 momentum 0.9, captured
   and eager, K1-K3 12 each; flash against plain at its T = 196; the
   ``train_imagenet --arch vit`` twin under LARS), ``lora`` (rank 16 on the LM bench's geometry against
   full fine-tuning: step ms, optimizer-state bytes, the base frozen) and
   ``large_batch`` (ResNet-50 ``sync/none`` under LARS, LAMB and a
   scheduled SGD, the LM step under Adafactor and a scheduled AdamW,
   against this run's constant-rate SGD and AdamW steps).
18. The rest of the communicator and the model-parallel surface:
   ``collectives_nccl`` (every new collective, its differentiable form
   and the ragged functions on one NCCL rank: identities, error 0),
   ``model_parallel`` (BASELINE.json configuration 4: VGG-11 at its
   published widths, 32x32x3, 10 classes, batch 64, 4 stages on 4 ranks
   x 1 data rank, all sharing this card through the port's launcher over
   the gloo (``naive``) communicator, compute on the card and each wire
   message staged through pinned host memory; 3 SGD-momentum steps held
   against the same network in one process through ``apply_sequential``
   (``MP_TOL``), then each side's step ms and the wire's share of the
   4-rank step), ``model_parallel_example`` (the twin through ``python
   -m chainermn_tpu_torch.launch --nproc 4 -m ...``),
   ``model_parallel_grid`` (2 ranks as a ``data x model`` = 2 x 1 grid:
   NCCL refuses two ranks on one card, naming ``naive``; ``sub``,
   ``split`` and the collectives on card tensors; the differentiable
   broadcast and point-to-point gradients, a ragged all-reduce) and
   ``seq2seq_two_ranks`` (the seq2seq twin data-parallel over 2 ranks:
   its BLEU covers every held-out sentence once).  Each launched job has a
   time limit (``MP_TIMEOUT_S``); a hang fails the run.
19. Pipelines and the 5-way-parallel LM, every rank sharing this card over
   gloo: ``pipeline`` (configuration 4's VGG-11 as in ``model_parallel``
   on ``build_hetero_pipeline`` with 4 GPipe microbatches, and on
   ``to_pipeline`` of the same ``MultiNodeChainList``: 3 SGD-momentum
   steps each held against the one-process network at the CPU test's
   tolerance (``PIPE_TOL``); the per-rank step ms beside
   ``model_parallel``'s and each rank's parameter bytes, its own stage's
   only), ``sequence_parallel`` (4 ranks, the LM bench's attention widths
   (12 heads, Dh 64), bf16, causal, global T 8192: the plain ring, the
   flash ring, zigzag flash, Ulysses flash, the flash ring with compact
   GQA K/V (4 kv heads) and the flash ring on packed rows; output and
   dq/dk/dv against one-process flash attention over the whole sequence
   (``SP_TOL``), and each rank's K1/K2/K3 launches against the
   prediction), ``parallel_lm`` (``ParallelLM`` on 8 ranks, a 1x2x2x2
   ``data x stage x model x seq`` grid, at the LM bench's widths with 2
   stages of one block and 2 experts, T 2048, batch 4, 2 microbatches,
   fp32: the step-0 loss and gradients against ``dense_lm_reference`` in
   one process (``PLM_TOL``), then 3 SGD-momentum steps whose loss falls
   and is equal on every rank, K1-K3 launches per rank per step against
   the prediction) and ``dryrun_multichip`` (the twin of the JAX entry
   through the launcher on 8 ranks, with its ZeRO program: an int8-wire
   step, a bit-exact checkpoint round trip, one more step).
20. Tensor-parallel serving, the ZeRO tier, the convnets and DCGAN:
   ``tp_serving`` (the decode bench's model, ``DECODE``, on 16 requests
   in 4 shared-prefix families: one model rank over NCCL in bf16, the
   engine captured once with its all-reduces and all-gather inside the
   graph, tokens and last-step logits bit-equal to the plain engine's;
   then 2 ranks (and a speculative arm, a 1-layer draft, ``spec_k`` 4)
   and 4 ranks with 4 kv heads, one local kv head each, sharing the card
   over gloo in fp32: greedy tokens equal the one-rank engine's but for a
   near-tie flip at or past generated position 8, equal on every rank,
   K4's runs on the card per rank = steps x 12 (rounds x 17), decode-step
   ms and the wire's share per rank; then ``lm_generate`` of each rank's
   tensor-parallel part: tokens equal to the one-rank model's, K5's runs
   on the card per rank on its ``KH/M`` heads = steps x 12; the parity
   phase holds K4/K5 at these local-head shapes), ``zero`` (``LM`` in
   fp32 with flash and
   remat under ZeRO AdamW on 4 gloo ranks against one process's
   replicated AdamW on the same global batch: losses, parameters,
   K1/K2/K3 per rank per step and in a profiled step, each rank's bytes
   against a quarter of one process's; a one-rank NCCL ZeRO step
   captured against eager, bitwise; the 4 ranks' checkpoint restored at
   2 ranks by ``maybe_load_elastic`` for one more step) and
   ``gan_convnet`` (the channel-parallel convnet and the DCGAN on 2 gloo
   ranks for 3 SGD-momentum steps each, against one process).
21. ``health_guard``: the training-health guard on the LM benchmark's
   step (``LM``, batch 8, flash, remat, AdamW 3e-4, bf16 wire,
   captured): step ms (median of 5 after 2 warm-ups) and peak bytes with
   the health check on and off, K1/K2/K3 24/12/12 in a profiled replay
   with it on; ``nan@grad:3`` and ``spike@loss:5`` (carried by the
   batch's loss weight) skipped with ``step_ok`` 0 and the digest of the
   parameters and the optimizer's state unchanged, the later steps and
   the final state bitwise those of a run that never saw batches 3 and
   5; a checkpoint restored into the captured step's own tensors and the
   replay after it bitwise the one before.  Then 3 gloo ranks sharing the
   card (2 layers): ``flip@param:3`` on rank 1 named by the vote at 4,
   every rank rolled back to known-good step 2 and ending bitwise equal
   to the unfaulted run; a heartbeat detector on each rank's
   ``HostComm``, 3 clean barriers, then ``hang@barrier:4`` on rank 2: the
   others raise ``PeerFailedError`` naming rank 2 and ``barrier``, the
   detection latency in heartbeat intervals.
22. ``preemption``: the same captured LM step under
   ``Trainer(preemption_guard=)`` with a ``MultiNodeCheckpointer``, one
   NCCL rank under ``launch.supervise``: a SIGTERM from a timer thread at
   iteration 3 of 6; the guard votes, the rank saves and exits 75; the
   relaunch resumes and runs to 6; exit codes, the emergency save's bytes
   and seconds, the resume's seconds, K1/K2/K3 24/12/12 in a profiled
   replay after the resume, the final parameters and AdamW state bit for
   bit against this process's unpreempted run, which carries
   ``MetricsReport(device=True)``: the ``device.train_step.*`` gauges
   (MFU against the card's bf16 peak, counting the remat recompute, and
   the roofline gap) beside the model-FLOPs MFU (6·N·T plus the
   attention core); then a ``ShardReplicator`` of that full-size state
   in one process, its snapshot and local spill timed over 2 cadences.
23. ``replication``: 3 gloo ranks sharing the card (the LM cut to 2
   layers, ZeRO AdamW, a ``ShardReplicator`` every 2 iterations, factor
   1) through a ``TrainingChaosHarness`` schedule drawn by
   ``chaos_schedule``: a crash (the crashed rank's spill wiped, its shard
   restored from its successor's replica), a SIGTERM preemption and a
   torn frame, one relaunch each; the final digest against the unfaulted
   run's on every rank, lost steps per failure, the torn frame
   discarded, the replicator's ms per cadence against the step; a
   relaunch at 2 ranks falling back to ``maybe_load_elastic`` with its
   ``replication_fallback`` incident; then ``FleetClock.sync`` and
   ``export_fleet_trace``: offsets and RTTs per rank, the merged trace's
   spans and ``analyze``'s critical path.
24. ``serving_drain``: the disaggregated roles at the serving bench's
   widths (a prefill role, a guarded decode role whose drain
   ``guard.attach_drain`` binds to a peer decode role); a SIGTERM once every request reached the decode
   role: every live slot and queued entry migrates, none is lost, tokens
   equal an undrained run's, exit 75, K4's runs on the card before and
   after the drain.
25. ``perf_sentinel``: ``observability.perf`` over ``result/`` and this
   run's records of this platform (judged apart from the TPU history);
   then ``phase_seconds``, every phase's seconds.

The launch counters are set to 0 just before each drive of the main path
(phases 5, 5a, 5b, 6, 7a, the timed steps of 10, 11a, 14 and 21, each
rank's drive in 19-20, 22's profiled replay and 24's roles) and read just after it; the ``kernels`` line
lists K4's launches in the serving drive, the speculative drive, each
fleet phase and each ``tp_serving`` arm (per rank), K5's in each decode
phase and ``tp_serving``'s generation (per rank), and K1-K3's per step
of each training phase, per rank in the
multi-rank ones (``launches_by_phase``).  A captured train step's replays run its kernels
without their wrappers: its launches are the wrappers' eager ones (the
signature's first step and the capture's warm-ups) plus replays x what
the capture recorded, and a profile of one replay must count the same
(the profiler can lose a replay's kernel records: a profile that counts
fewer is taken again, up to 3 times; one that counts more fails).
The decode-attention kernels also count their own runs on the card
(``ops.decode_attention.kernel_runs``), zeroed and read the same way:
the serving drive replays K4 from a CUDA graph, where its wrapper does
not run, so its ``launches`` in the ``kernels`` line are the card's
count; K5's card count must equal its wrapper's.
Then come the ``kernels`` line,
the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  A
failed check raises and exits non-zero before the last line; without a
CUDA device the script exits 2 at once.

    python3 chip_smoke.py --compare-with DIR

runs none of the above: it times the decode kernels (phase 4 with its
long rows) and the bf16 and int8 serving drives (phase 5's without the
incident manager: an older tree has none), the flash
kernels (phase 9), the LM flash-arm step (phase 10's first arm), the fused
1x1-conv kernel (phase 13) and the ``frozen/pallas`` ResNet step (an arm
of phase 14) of the checkout DIR and of this one in turns, DIR, this,
this, DIR, each in a process of its own, and prints every line with its
tree; ``--compare-phases decode,conv`` (say) times only those.  The
decode phase runs this script's timing code on each tree's own kernels.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

#: the serving benchmark's default model (benchmarks/serving.py).
FULL = dict(vocab=32768, n_layers=12, d_model=768, n_heads=12, d_ff=3072,
            pos_enc="rope", decode_attention="fused")
ENGINE = dict(capacity=8, block_len=16, prefill_chunk=32)

#: H100 SXM data-sheet rates (dense): device memory, and peak operations
#: per second by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
            torch.int8: 1979e12}

#: the LM benchmark's default model (benchmarks/lm.py:39-46).
LM = dict(vocab=32768, n_layers=12, d_model=768, n_heads=12, d_ff=3072,
          max_len=2048)
LM_BATCH = 8

#: each kernel of the port, the TPU kernel it replaces, and its source.
KERNELS = {
    "flash_attention_fwd": "chainermn_tpu/ops/flash_attention.py:191",
    "flash_attention_bwd_dkv": "chainermn_tpu/ops/flash_attention.py:427",
    "flash_attention_bwd_dq": "chainermn_tpu/ops/flash_attention.py:493",
    "paged_decode_attention": "chainermn_tpu/ops/decode_attention.py:196",
    "fused_decode_attention": "chainermn_tpu/ops/decode_attention.py:101",
    "matmul_affine_fwd": "chainermn_tpu/ops/conv_fused.py:42",
}
SOURCES = {k: "chainermn_tpu_torch/csrc/flash_attention.cu"
           for k in list(KERNELS)[:3]}
SOURCES.update({k: "chainermn_tpu_torch/csrc/decode_attention.cu"
                for k in list(KERNELS)[3:5]})
SOURCES["matmul_affine_fwd"] = "chainermn_tpu_torch/csrc/conv_fused.cu"
FLASH = list(KERNELS)[:3]

#: the bench's ResNet-50 configuration (bench.py:1002, :1068, :1154).
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 256, 224, 1000
#: the bench's step count on its fixed batch (5 warm-up + 20 timed).
RESNET_BENCH_STEPS = 25
#: the frozen arms' starting scale of each residual branch's last affine
#: (``ResNet.scale_residual_branches``).
FROZEN_BRANCH_SCALE = 0.1
#: K6 against its plain version, element by element: |err| <= rtol |ref| +
#: atol rms(ref row over Cout).  rtol: each side rounds its fp32 result to
#: the output dtype once (bf16: one ulp is at most 2^-8 of the value);
#: atol: the fp32 sums taken in another order.
#: The sound kernel read at most 7.9e-6 (fp32) and 4.7e-6 (bf16) over these
#: cases on an H100 80GB HBM3 at 700 W; atol sits 12x and 21x above.
K6_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-4)}
K6_RAGGED = [(1000, 24, 40), (37, 8, 16), (77, 20, 13)]


_T0 = time.perf_counter()
#: seconds by phase name: each phase line's ``t_s`` less the previous one's.
PHASE_SECONDS = {}
_LAST_T = [0.0]


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's seconds so far
    (``t_s``), so that phase durations read off consecutive lines (and
    add up in :data:`PHASE_SECONDS`)."""
    if "phase" in obj:
        t = time.perf_counter() - _T0
        obj = {**obj, "t_s": t}
        PHASE_SECONDS[obj["phase"]] = PHASE_SECONDS.get(obj["phase"], 0.0) \
            + t - _LAST_T[0]
        _LAST_T[0] = t
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


# ------------------------------------------------------------------ inputs
def quantize(x):
    """Symmetric absmax int8 over the last axis, as the model writes."""
    scale = torch.clamp_min(x.abs().amax(dim=-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.float().contiguous()


def paged_inputs(g, dev, S, T, H, KH, Dh, BL, MB, valid, dtype, quant,
                 spare=8):
    """Inputs of the paged kernel as the engine lays them out: each slot
    owns distinct shuffled blocks covering its last row's bound, the rest
    of its table parks on block 0."""
    need = [math.ceil(min(max(v + T - 1, 0), MB * BL) / BL) for v in valid]
    NB = 1 + sum(need) + spare
    perm = (torch.randperm(NB - 1, generator=g) + 1).tolist()
    tables = torch.zeros((S, MB), dtype=torch.int32)
    for s, n in enumerate(need):
        tables[s, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    qshape = (S, T, H, Dh) if T > 1 else (S, H, Dh)
    q = torch.randn(qshape, generator=g)
    kp = torch.randn((KH, NB, BL, Dh), generator=g)
    vp = torch.randn((KH, NB, BL, Dh), generator=g)
    ks = vs = None
    if quant:
        kp, ks = quantize(kp)
        vp, vs = quantize(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    to = dict(device=dev)
    return dict(
        q=q.to(dtype=dtype, **to), k=kp.to(**to), v=vp.to(**to),
        tables=tables.to(**to),
        valid=torch.tensor(valid, dtype=torch.int32, **to),
        ks=None if ks is None else ks.to(**to),
        vs=None if vs is None else vs.to(**to),
    )


def fused_inputs(g, dev, B, H, KH, L, Dh, valid, dtype, quant):
    q = torch.randn((B, H, Dh), generator=g)
    kc = torch.randn((B, KH, L, Dh), generator=g)
    vc = torch.randn((B, KH, L, Dh), generator=g)
    ks = vs = None
    if quant:
        kc, ks = quantize(kc)
        vc, vs = quantize(vc)
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
    to = dict(device=dev)
    return dict(
        q=q.to(dtype=dtype, **to), k=kc.to(**to), v=vc.to(**to),
        valid=torch.tensor(valid, dtype=torch.int32, **to),
        ks=None if ks is None else ks.to(**to),
        vs=None if vs is None else vs.to(**to),
    )


def run_paged(ops, a, plain=False):
    fn = ops.paged_decode_attention_reference if plain \
        else ops.paged_decode_attention
    return fn(a["q"], a["k"], a["v"], a["tables"], a["valid"], a["ks"],
              a["vs"])


def run_fused(ops, a, plain=False):
    fn = ops.fused_decode_attention_reference if plain \
        else ops.fused_decode_attention
    return fn(a["q"], a["k"], a["v"], a["valid"], a["ks"], a["vs"])


# ------------------------------------------------------------------ parity
PAGED_CASES = [
    # name, T, KH, Dh, q/kv dtype, int8 pools, atol[, query heads H (12)]
    ("bf16", 1, 12, 64, torch.bfloat16, False, 2e-2),
    ("fp32", 1, 12, 64, torch.float32, False, 1e-4),
    ("bf16_verify4", 4, 12, 64, torch.bfloat16, False, 2e-2),
    ("fp32_gqa_verify4", 4, 4, 64, torch.float32, False, 1e-4),
    ("int8_gqa", 1, 4, 64, torch.bfloat16, True, 2e-2),
    ("int8_gqa_verify4", 4, 4, 64, torch.bfloat16, True, 2e-2),
    ("fp32_dh16", 1, 6, 16, torch.float32, False, 1e-4),
    ("int8_dh16", 2, 6, 16, torch.float32, True, 1e-4),
    ("fp32_dh32", 3, 4, 32, torch.float32, False, 1e-4),
    ("bf16_dh128", 1, 12, 128, torch.bfloat16, False, 2e-2),
    # One model rank's heads of a tensor-parallel engine (tp_serving):
    # 12 heads over 2 ranks (6 local, G = 1), over 4 (3 local), and 4 kv
    # heads over 4 ranks (one local kv head, G = 3); the speculative
    # arm's verify chunk of k + 1 = 5.
    ("tp2_local_bf16", 1, 6, 64, torch.bfloat16, False, 2e-2, 6),
    ("tp2_local_fp32", 1, 6, 64, torch.float32, False, 1e-4, 6),
    ("tp2_local_fp32_verify5", 5, 6, 64, torch.float32, False, 1e-4, 6),
    ("tp4_local_fp32", 1, 3, 64, torch.float32, False, 1e-4, 3),
    ("tp4_kh1_fp32", 1, 1, 64, torch.float32, False, 1e-4, 3),
    ("tp4_kh1_bf16_verify5", 5, 1, 64, torch.bfloat16, False, 2e-2, 3),
]
FUSED_CASES = [
    # name, L, KH, Dh, dtype, int8 cache, atol[, query heads H (12)]
    ("bf16", 192, 12, 64, torch.bfloat16, False, 2e-2),
    ("fp32", 192, 12, 64, torch.float32, False, 1e-4),
    ("int8_gqa", 192, 4, 64, torch.bfloat16, True, 2e-2),
    ("fp32_gqa_long", 4096, 4, 64, torch.float32, False, 1e-4),
    ("bf16_max_len", 16384, 12, 64, torch.bfloat16, False, 2e-2),
    ("fp32_dh16", 100, 6, 16, torch.float32, False, 1e-4),
    ("int8_dh32", 100, 4, 32, torch.float32, True, 1e-4),
    ("bf16_dh128", 300, 12, 128, torch.bfloat16, False, 2e-2),
    ("tp2_local_fp32", 192, 6, 64, torch.float32, False, 1e-4, 6),
    ("tp4_kh1_bf16", 192, 1, 64, torch.bfloat16, False, 2e-2, 3),
]
#: the fused kernel at the shapes the searches give it (12 kv heads, Dh
#: 64): a beam search's batch 8 x beam 4 = 32 rows at one length, and a
#: speculative draft step's 8 rows whose lengths differ row by row in a
#: 197-slot cache (prompt 128 + 64 new + k 4 + 1).
SEARCH_CASES = [
    # name, rows, L, valid lengths
    ("beam32", 32, 192, [191] * 32),
    ("draft_rows", 8, 197, [129, 130, 131, 132, 133, 131, 129, 133]),
]


def split_lengths(per, n_max, T=1):
    """Eight valid lengths against a launch whose splits hold ``per``
    positions of ``n_max``: an idle row; bounds that end exactly on the
    first split boundary, just before it and just past it (for a verify
    chunk of T positions the last row's bound, valid + T - 1); a verify
    chunk's rows straddling the second boundary; a row that leaves every
    split but the first empty; one that leaves the last split empty; and
    a full row."""
    out = [0, per - (T - 1), per - T, per - (T - 1) + 1,
           2 * per - T // 2, max(per // 2, 1), n_max - per - (T - 1),
           n_max - (T - 1)]
    return [min(max(v, 0), n_max - (T - 1)) for v in out]


def phase_parity(ops, dev, seed, mb):
    """Every case against the plain version, at the original lengths and
    at the launch's split boundaries (:func:`split_lengths`); returns the
    largest error of each kernel over its main-path (bf16, 12 kv heads)
    case."""
    g = torch.Generator().manual_seed(seed)
    S = ENGINE["capacity"]
    BL = ENGINE["block_len"]
    sms = ops._sm_count(dev)
    rows, main_err = [], {}
    for name, T, KH, Dh, dt, quant, tol, *heads in PAGED_CASES:
        H = heads[0] if heads else FULL["n_heads"]
        hi = mb * BL - (T - 1)
        elt = 1 if quant else torch.tensor([], dtype=dt).element_size()
        splits, per, _ = ops._plan(mb * BL, S, KH, T * (H // KH), Dh * elt,
                                   sms, block_len=BL)
        for lens, valid in (
                ("", [0, 1, BL - 1, BL, BL + 1, 100, 192, hi][:S]),
                ("_splits", split_lengths(per, mb * BL, T))):
            a = paged_inputs(g, dev, S, T, H, KH, Dh, BL, mb, valid, dt,
                             quant)
            got = run_paged(ops, a)
            want = run_paged(ops, a, plain=True)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rows.append(("paged_decode_attention", name + lens, err, tol,
                         valid, splits))
            check(err <= tol, f"paged kernel case {name}{lens} (valid "
                  f"{valid}): max |err| {err} > {tol}")
            check(torch.isfinite(got.float()).all().item(),
                  f"paged kernel case {name}{lens}: non-finite output")
            if T == 1:
                # Idle slot 0 (valid 0): every row fully masked, exactly 0.
                check(bool((got[0] == 0).all()),
                      f"paged kernel case {name}{lens}: fully masked row "
                      "is not exactly 0 (exp(NEG_INF - NEG_INF) leaked)")
            if name == "bf16":
                main_err["paged_decode_attention"] = max(
                    err, main_err.get("paged_decode_attention", 0.0))
    for name, L, KH, Dh, dt, quant, tol, *heads in FUSED_CASES:
        H = heads[0] if heads else FULL["n_heads"]
        elt = 1 if quant else torch.tensor([], dtype=dt).element_size()
        splits, per, _ = ops._plan(L, S, KH, H // KH, Dh * elt, sms)
        for lens, valid in (("", [0, 1, 31, 32, 33, L // 2 + 1, L - 1,
                                  L][:S]),
                            ("_splits", split_lengths(per, L))):
            a = fused_inputs(g, dev, S, H, KH, L, Dh, valid, dt, quant)
            got = run_fused(ops, a)
            want = run_fused(ops, a, plain=True)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rows.append(("fused_decode_attention", name + lens, err, tol,
                         valid, splits))
            check(err <= tol, f"fused kernel case {name}{lens} (valid "
                  f"{valid}): max |err| {err} > {tol}")
            if name == "bf16":
                main_err["fused_decode_attention"] = max(
                    err, main_err.get("fused_decode_attention", 0.0))
    H = FULL["n_heads"]
    for name, rows_, L, valid in SEARCH_CASES:
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            case = f"{name}_{'bf16' if dt == torch.bfloat16 else 'fp32'}"
            splits, _, _ = ops._plan(L, rows_, H, 1, 64 * (4 if dt ==
                                     torch.float32 else 2), sms)
            a = fused_inputs(g, dev, rows_, H, H, L, 64, valid, dt, False)
            got = run_fused(ops, a)
            want = run_fused(ops, a, plain=True)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rows.append(("fused_decode_attention", case, err, tol, valid,
                         splits))
            check(err <= tol, f"fused kernel case {case} (valid {valid}): "
                  f"max |err| {err} > {tol}")
    emit({"phase": "parity", "cases": [
        {"kernel": k, "case": n, "max_abs_err": e, "atol": t,
         "valid": v, "splits": sp}
        for k, n, e, t, v, sp in rows]})
    return main_err


# ------------------------------------------------------------------ timing
def _warm(fn, args_list):
    # On a side stream, as CUDA-graph capture wants its libraries warmed.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in args_list[:3]:
            fn(a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


def time_ms(fn, args_list, iters):
    """Device ms per call: ``iters`` calls cycling through ``args_list``
    (copies of the inputs, together larger than the L2 cache, so that each
    call finds its inputs cold) captured into one CUDA graph, and the
    graph's replay timed with CUDA events.  The host's cost of issuing the
    calls is not in the number."""
    _warm(fn, args_list)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(fn, args_list, iters):
    """Ms per call issued eagerly, back to back: the device time or the
    host's cost of issuing the call, whichever is longer."""
    _warm(fn, args_list)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(a, min_bytes=128 << 20, cap=64):
    nbytes = sum(t.numel() * t.element_size() for t in a.values()
                 if isinstance(t, torch.Tensor))
    n = min(cap, max(2, math.ceil(min_bytes / max(nbytes, 1))))
    return [a] + [{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                   for k, v in a.items()} for _ in range(n - 1)]


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def paged_bound(a, T):
    """Bytes: the K/V rows (and int8 scales) of the positions the slots'
    last rows can attend, the table entries that reach them, q, valid_len
    and the output.  Operations: 4 * Dh per (query row, attended
    position)."""
    k, q = a["k"], a["q"]
    KH, _, BL, Dh = k.shape
    H = q.shape[-2]
    G = H // KH
    MB = a["tables"].shape[1]
    valid = a["valid"].tolist()
    pos = sum(min(max(v + T - 1, 0), MB * BL) for v in valid)
    row_bytes = Dh * k.element_size() + (4 if a["ks"] is not None else 0)
    nbytes = 2 * KH * pos * row_bytes
    nbytes += 4 * sum(math.ceil(min(max(v + T - 1, 0), MB * BL) / BL)
                      for v in valid)
    nbytes += 2 * q.numel() * q.element_size() + 4 * len(valid)
    ops = sum(4 * Dh * G * KH * min(max(v + t, 0), MB * BL)
              for v in valid for t in range(T))
    return bound(nbytes, ops, k.dtype)


def fused_bound(a):
    """As :func:`paged_bound`; a row with valid_len <= 0 reads its whole
    panel (the uniform mean)."""
    k, q = a["k"], a["q"]
    _, KH, L, Dh = k.shape
    G = q.shape[1] // KH
    pos = [L if v <= 0 else min(v, L) for v in a["valid"].tolist()]
    row_bytes = Dh * k.element_size() + (4 if a["ks"] is not None else 0)
    nbytes = 2 * KH * sum(pos) * row_bytes
    nbytes += 2 * q.numel() * q.element_size() + 4 * len(pos)
    ops = sum(4 * Dh * G * KH * p for p in pos)
    return bound(nbytes, ops, k.dtype)


def phase_timing(ops, dev, seed, mb):
    """The kernels at the main path's shapes and dtypes: the engine's
    decode step (8 slots, bf16 pools, 12 kv heads, Dh 64, block 16, valid
    lengths drawn like the serving phase's requests) and lm_generate's
    step (batch 8, cache 192 = prompt 128 + 64 new)."""
    g = torch.Generator().manual_seed(seed + 1)
    rng = np.random.RandomState(seed + 1)
    S, H, Dh = ENGINE["capacity"], FULL["n_heads"], 64
    BL = ENGINE["block_len"]
    out = {}

    valid = rng.randint(17, 16 + 128 + 64 + 1, size=S).tolist()
    a = paged_inputs(g, dev, S, 1, H, H, Dh, BL, mb, valid,
                     torch.bfloat16, False)
    nblk = math.ceil(max(valid) / BL)
    idx = a["tables"][:, :nblk].long()
    Lg = nblk * BL

    def gathered(pool):
        return pool[:, idx].permute(1, 0, 2, 3, 4) \
            .reshape(S, H, Lg, Dh).contiguous()

    lib = dict(q=a["q"].view(S, H, 1, Dh), k=gathered(a["k"]),
               v=gathered(a["v"]),
               mask=(torch.arange(Lg, device=dev)[None, :]
                     < a["valid"][:, None])[:, None, None, :])
    out["paged_decode_attention"] = timing_row(
        "paged_decode_attention", a, lib, lambda x: run_paged(ops, x),
        lambda x: run_paged(ops, x, plain=True), paged_bound(a, 1),
        dict(S=S, H=H, KH=H, Dh=Dh, block_len=BL, max_blocks=mb,
             valid=valid))

    L = 128 + 64
    valid = rng.randint(129, L + 1, size=S).tolist()
    a = fused_inputs(g, dev, S, H, H, L, Dh, valid, torch.bfloat16, False)
    lib = dict(q=a["q"].view(S, H, 1, Dh), k=a["k"], v=a["v"],
               mask=(torch.arange(L, device=dev)[None, :]
                     < a["valid"][:, None])[:, None, None, :])
    out["fused_decode_attention"] = timing_row(
        "fused_decode_attention", a, lib, lambda x: run_fused(ops, x),
        lambda x: run_fused(ops, x, plain=True), fused_bound(a),
        dict(B=S, H=H, KH=H, L=L, Dh=Dh, valid=valid))

    # The int8-GQA serving arm's step (4 kv heads, int8 pools with fp32
    # scales, its engine's table width).  No one PyTorch call takes int8
    # K/V with scales: the row has no library time.
    _, mb8 = engine_geometry(draw_requests(np.random.RandomState(seed + 10),
                                           6, FULL["vocab"]))
    valid = rng.randint(17, 16 + 128 + 64 + 1, size=S).tolist()
    a = paged_inputs(g, dev, S, 1, H, 4, Dh, BL, mb8, valid,
                     torch.bfloat16, True)
    out["paged_decode_attention_int8_gqa"] = timing_row(
        "paged_decode_attention", a, None, lambda x: run_paged(ops, x),
        lambda x: run_paged(ops, x, plain=True), paged_bound(a, 1),
        dict(S=S, H=H, KH=4, Dh=Dh, block_len=BL, max_blocks=mb8,
             valid=valid, kv_dtype="int8"), row="int8_gqa")
    return out


#: the long-context rows: the paged kernel at 8 slots of ~4096 positions
#: (max_blocks 256 at block 16), the fused one at lm_generate's limit
#: (``MAX_FUSED_LEN``); bf16, 12 kv heads, Dh 64.
LONG_PAGED_BLOCKS, LONG_FUSED_LEN = 256, 16384


def phase_long_timing(ops, dev, seed):
    """One long-context ``timing`` row per decode kernel, valid lengths
    drawn near the row's capacity."""
    g = torch.Generator().manual_seed(seed + 9)
    rng = np.random.RandomState(seed + 9)
    S, H, Dh = ENGINE["capacity"], FULL["n_heads"], 64
    BL, mb = ENGINE["block_len"], LONG_PAGED_BLOCKS
    out = {}
    valid = rng.randint(mb * BL - 192, mb * BL + 1, size=S).tolist()
    a = paged_inputs(g, dev, S, 1, H, H, Dh, BL, mb, valid,
                     torch.bfloat16, False, spare=0)
    idx = a["tables"].long()
    Lg = mb * BL
    lib = dict(q=a["q"].view(S, H, 1, Dh),
               k=a["k"][:, idx].permute(1, 0, 2, 3, 4)
               .reshape(S, H, Lg, Dh).contiguous(),
               v=a["v"][:, idx].permute(1, 0, 2, 3, 4)
               .reshape(S, H, Lg, Dh).contiguous(),
               mask=(torch.arange(Lg, device=dev)[None, :]
                     < a["valid"][:, None])[:, None, None, :])
    out["paged_decode_attention"] = timing_row(
        "paged_decode_attention", a, lib, lambda x: run_paged(ops, x),
        lambda x: run_paged(ops, x, plain=True), paged_bound(a, 1),
        dict(S=S, H=H, KH=H, Dh=Dh, block_len=BL, max_blocks=mb,
             valid=valid), row="long", plain_iters=2, kernel_iters=50)
    del a, lib
    L = LONG_FUSED_LEN
    valid = rng.randint(L - 256, L + 1, size=S).tolist()
    a = fused_inputs(g, dev, S, H, H, L, Dh, valid, torch.bfloat16, False)
    lib = dict(q=a["q"].view(S, H, 1, Dh), k=a["k"], v=a["v"],
               mask=(torch.arange(L, device=dev)[None, :]
                     < a["valid"][:, None])[:, None, None, :])
    out["fused_decode_attention"] = timing_row(
        "fused_decode_attention", a, lib, lambda x: run_fused(ops, x),
        lambda x: run_fused(ops, x, plain=True), fused_bound(a),
        dict(B=S, H=H, KH=H, L=L, Dh=Dh, valid=valid), row="long",
        plain_iters=2, kernel_iters=50)
    del a, lib
    torch.cuda.empty_cache()
    return out


def sdpa(x):
    return F.scaled_dot_product_attention(x["q"], x["k"], x["v"],
                                          attn_mask=x["mask"])


def timing_row(name, a, lib, kernel, plain, bnd, shape, row="main",
               plain_iters=10, kernel_iters=200):
    bound_ms, bound_by = bnd
    copies = copies_for(a)
    # Turns: plain, kernel, library, kernel, plain.
    p1 = time_ms(plain, copies, plain_iters)
    k1 = time_ms(kernel, copies, kernel_iters)
    lib_ms = lib_err = None
    if lib is not None:
        lib_ms = time_ms(sdpa, copies_for(lib), kernel_iters)
    k2 = time_ms(kernel, copies, kernel_iters)
    p2 = time_ms(plain, copies, plain_iters)
    k_eager = eager_ms(kernel, copies, kernel_iters)
    if lib is not None:
        # The yardstick must compute the same function.
        want = plain(a).float().reshape(-1)
        lib_err = (sdpa(lib).float().reshape(-1) - want).abs().max().item()
        check(lib_err <= 2e-2, f"library yardstick disagrees: {lib_err}")
    row = dict(kernel=name, row=row, kernel_ms=min(k1, k2),
               kernel_ms_runs=[k1, k2],
               kernel_eager_ms=k_eager, plain_ms=min(p1, p2),
               plain_ms_runs=[p1, p2], library_ms=lib_ms,
               library_max_abs_err=lib_err, bound_ms=bound_ms,
               bound_by=bound_by, bound_fraction=bound_ms / min(k1, k2),
               shape=shape, copies=len(copies))
    emit({"phase": "timing", **row})
    return row


# ---------------------------------------------------------------- serving
def draw_requests(rng, n, vocab, plen=(16, 128), new=(16, 64)):
    from chainermn_tpu_torch.serving import Request

    plens = rng.randint(plen[0], plen[1] + 1, size=n)
    news = rng.randint(new[0], new[1] + 1, size=n)
    return [Request(id=i, prompt=rng.randint(1, vocab, size=int(p)).tolist(),
                    max_new_tokens=int(m))
            for i, (p, m) in enumerate(zip(plens, news))]


def engine_geometry(reqs):
    """The serving benchmark's sizing: tables cover the longest request
    (padded to a prefill chunk), the pool the 85th-percentile one per
    slot (tail requests may evict)."""
    from chainermn_tpu_torch.serving import blocks_for

    BL, chunk = ENGINE["block_len"], ENGINE["prefill_chunk"]
    lens = np.asarray([len(r.prompt) + r.max_new_tokens for r in reqs])
    longest = int(lens.max()) + chunk
    max_blocks = blocks_for(longest, BL)
    p85 = float(np.percentile(lens, 85))
    num_blocks = 1 + ENGINE["capacity"] * (1 + int(p85) // BL + 1)
    return num_blocks, max_blocks


def warm_engine(eng, seed):
    """Warm ``eng`` before any measured run: one request of 20 new tokens
    (the decode step's capture, the kernel library, cuBLAS and the
    allocator, and, its 19 decode iterations crossing the planes' check
    cadence of 16, the capture watch's one-time cost model), then prompts
    whose last chunks take every other ladder geometry, so that each
    prefill graph is captured here (the scheduler sends full chunks,
    then the smallest geometry covering the tail)."""
    from chainermn_tpu_torch.serving import Request, Scheduler

    Scheduler(eng).run(draw_requests(np.random.RandomState(seed + 99), 1,
                                     FULL["vocab"], new=(20, 20)))
    top = max(eng.prefill_ladder)
    rng = np.random.RandomState(seed + 98)
    Scheduler(eng).run([
        Request(id=i, prompt=rng.randint(1, FULL["vocab"],
                                         size=top + c).tolist(),
                max_new_tokens=2)
        for i, c in enumerate(eng.prefill_ladder)])
    eng.drop_prefix_cache()
    if eng.device.type == "cuda" and hasattr(eng, "_prefill_graphs"):
        check(eng.prefill_compiles == len(eng.prefill_ladder),
              f"warm-up: {eng.prefill_compiles} prefill captures for the "
              f"ladder {eng.prefill_ladder}")


def serving_engine(dev, seed, reqs, **model_kw):
    """The full-width engine sized for ``reqs``, warmed
    (:func:`warm_engine`)."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import DecodeEngine

    num_blocks, max_blocks = engine_geometry(reqs)
    model = TransformerLM(**{**FULL, **model_kw}, device=dev, seed=seed)
    eng = DecodeEngine(model, num_blocks=num_blocks,
                       max_blocks_per_slot=max_blocks, device=dev, **ENGINE)
    warm_engine(eng, seed)
    return eng, num_blocks, max_blocks


def drive_serving(ops, dev, card, seed, label, n_requests, planes=True,
                  **model_kw):
    """The serving drive: ``n_requests`` through ``Scheduler.run`` on a
    warmed full-width engine.  With ``planes`` (the main run) the
    scheduler runs with its planes on, as the JAX serving benchmark's
    headline arm does (SLO monitor, request timeline, memory monitor,
    usage ledger, device feed, and an incident manager over the run's
    registry), and the drive checks what each reports.  ``planes=False``
    is the drive ``--compare-with`` runs in both trees (an older tree
    has no planes): it passes no incident manager and checks no plane,
    but a tree that has planes still builds its defaults on the
    registry (SLO, memory, ledger, device feed, and the timeline under
    ``CMN_OBS``)."""
    from chainermn_tpu_torch.observability import MetricsRegistry
    from chainermn_tpu_torch.serving import Scheduler

    rng = np.random.RandomState(seed)
    reqs = draw_requests(rng, n_requests, FULL["vocab"])
    eng, num_blocks, max_blocks = serving_engine(dev, seed, reqs,
                                                 **model_kw)
    model = eng.model
    reg = MetricsRegistry()
    kw = {}
    if planes:
        from chainermn_tpu_torch.observability.incident import (
            IncidentManager,
        )

        kw["incidents"] = IncidentManager(registry=reg, directory=None)
    sched = Scheduler(eng, registry=reg, **kw)
    # An older tree's engine runs its step eagerly (no graphs), and its
    # kernels count no runs on the card: there the wrappers' counts are
    # every launch.
    captured = bool(getattr(eng, "_graphs", None))
    counted = hasattr(ops, "kernel_runs")
    replays0 = eng.decode_replays if captured else None
    # A tree whose prefill runs eagerly has no prefill graphs.
    prefill_graphs = hasattr(eng, "prefill_replays")
    prefill0 = eng.prefill_replays if prefill_graphs else None
    prefill_caps0 = eng.prefill_compiles
    torch.cuda.synchronize()
    ops.paged_decode_attention.launches = 0
    ops.fused_decode_attention.launches = 0
    if counted:
        ops.zero_kernel_runs(dev)
    gc0 = _gc_collections()
    t0 = time.perf_counter()
    comps = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gc1 = _gc_collections()
    wrapper = {"paged_decode_attention": ops.paged_decode_attention.launches,
               "fused_decode_attention": ops.fused_decode_attention.launches}
    # The kernels' own count of their runs in this drive, replays included.
    launches = ops.kernel_runs(dev) if counted else wrapper

    byid = {c.id: c for c in comps}
    check(sorted(byid) == [r.id for r in reqs],
          f"{label}: not every request completed")
    for r in reqs:
        c = byid[r.id]
        check(c.status == "ok" and len(c.tokens) == r.max_new_tokens,
              f"{label}: request {r.id} ended {c.status} with "
              f"{len(c.tokens)}/{r.max_new_tokens} tokens")
        check(all(0 <= t < FULL["vocab"] for t in c.tokens),
              f"{label}: request {r.id} emitted a token outside the vocab")
    check(eng.decode_compiles == 1,
          f"{label}: decode step saw {eng.decode_compiles} signatures")
    n_layers = FULL["n_layers"]
    check(launches["paged_decode_attention"]
          == sched.decode_iterations * n_layers,
          f"{label}: paged kernel launched "
          f"{launches['paged_decode_attention']} times, expected "
          f"{sched.decode_iterations} decode steps x {n_layers} layers")
    check(launches["fused_decode_attention"] == 0,
          f"{label}: the engine launched the fused kernel")
    replays = None
    if captured:
        replays = eng.decode_replays - replays0
        per_replay = next(iter(eng._graphs.values())).captured
        check(len(eng._graphs) == 1
              and replays == sched.decode_iterations
              and per_replay == {"paged_decode_attention": n_layers,
                                 "fused_decode_attention": 0},
              f"{label}: {len(eng._graphs)} captures, {replays} replays "
              f"for {sched.decode_iterations} decode steps, "
              f"{per_replay} launches captured per replay")
        # Cross-check: the runs the card counted are the wrappers' eager
        # launches plus what each replay ran.
        check(all(launches[k] == wrapper[k] + replays * per_replay[k]
                  for k in launches),
              f"{label}: the card counted {launches} runs; the wrappers "
              f"launched {wrapper} and {replays} replays ran "
              f"{per_replay} each")
    check(captured or not planes,
          f"{label}: the engine did not capture its decode step")
    snap = reg.snapshot()
    clean = snap["serve.decode_ms"]
    prefill = snap["serve.prefill_ms"]
    prefill_replays = None
    if prefill_graphs:
        # Every chunk a replay of a graph the warm-up captured.
        prefill_replays = eng.prefill_replays - prefill0
        check(prefill_replays == prefill["count"]
              and eng.prefill_compiles == prefill_caps0
              == len(eng.prefill_ladder),
              f"{label}: {prefill_replays} prefill replays for "
              f"{prefill['count']} chunks, {eng.prefill_compiles} prefill "
              f"captures (ladder {eng.prefill_ladder})")
    tokens = sum(len(c.tokens) for c in comps)
    row = dict(
        phase="serving", label=label, card=card, requests=len(reqs),
        tokens=tokens,
        wall_s=wall, tokens_per_s=tokens / wall,
        decode_steps=sched.decode_iterations,
        decode_step_ms_mean=sched.decode_ms_total
        / max(sched.decode_iterations, 1),
        clean_decode_step_ms_mean=(clean["sum"] / clean["count"]
                                   if clean["count"] else None),
        clean_decode_step_ms_max=clean["max"],
        clean_decode_steps=clean["count"],
        gc_collections=[b - a for a, b in zip(gc0, gc1)],
        prefill_chunks=prefill["count"],
        prefill_ms_mean=prefill["sum"] / max(prefill["count"], 1),
        evictions=sum(c.evictions for c in comps),
        decode_compiles=eng.decode_compiles,
        captured=captured, replays=replays,
        prefill_compiles=eng.prefill_compiles,
        prefill_replays=prefill_replays,
        prefill_ms_max=prefill["max"],
        num_blocks=num_blocks, max_blocks=max_blocks,
        launches=launches, launches_counted_on="card" if counted
        else "host", wrapper_launches=wrapper,
        kv_dtype=str(model.kv_dtype or model.dtype).replace("torch.", ""),
        n_kv_heads=model.kv_heads,
    )
    if planes:
        row.update(serving_planes(sched, eng, reqs, reg, kw["incidents"],
                                  label))
    eng.drop_prefix_cache()
    check(eng.free_blocks() == num_blocks - 1,
          f"{label}: {num_blocks - 1 - eng.free_blocks()} blocks leaked")
    emit(row)
    return row


def serving_planes(sched, eng, reqs, reg, incidents, label):
    """What the serving planes of one drive report, checked: the three
    SLO streams, a complete timeline per request and its Chrome trace
    written and parsed, the ledger's books exact, no incident on an
    unfaulted run, no leaked block after the drain, and a
    ``device.decode_step.mfu_pct`` gauge in (0, 100]."""
    import os
    import tempfile

    report = sched.slo.last_report
    check(set(report) == {"ttft", "queue_wait", "token"},
          f"{label}: SLO streams reported: {sorted(report)}")
    kinds = {}
    for e in sched.timeline.events():
        if e.req is not None:
            kinds.setdefault(e.req, []).append(e.kind)
    for r in reqs:
        k = kinds.get(r.id, [])
        check(k[:2] == ["submit", "admit"] and "prefill" in k
              and k[-1] == "retire",
              f"{label}: request {r.id}'s timeline is {k}")
    with tempfile.TemporaryDirectory() as d:
        path = sched.export_trace(os.path.join(d, "trace.json"))
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    slices = sum(e["ph"] == "X" for e in trace)
    check(slices >= 3 * len(reqs), f"{label}: {slices} trace slices")
    cons = sched.ledger.verify_conservation(reqs)
    check(cons["holds"], f"{label}: ledger books not exact: {cons}")
    check(incidents.count == 0 and incidents.dropped == 0,
          f"{label}: {incidents.count} incidents on an unfaulted run: "
          f"{[m['id'] for m in incidents.incidents]}")
    leaked = sched.memory.check_drained(eng)
    snap = reg.snapshot()
    check(leaked == 0 and snap["mem.kv.leaked_blocks"]["value"] == 0,
          f"{label}: {leaked} KV blocks leaked")
    mfu = snap.get("device.decode_step.mfu_pct", {}).get("value")
    check(mfu is not None and 0 < mfu <= 100,
          f"{label}: device.decode_step.mfu_pct = {mfu}")
    return dict(
        slo_p95_ms={s: r["p95_ms"] for s, r in report.items()},
        trace_events=len(trace),
        ledger_tokens=sched.ledger.totals["tokens"],
        ledger_block_seconds=sched.ledger.totals["block_us"] / 1e6,
        incidents=incidents.count, leaked_blocks=leaked,
        mfu_pct=mfu,
        tflops=snap["device.decode_step.tflops"]["value"],
        arithmetic_intensity=snap["device.decode_step.ai"]["value"],
        mem_peak_bytes=snap["mem.peak_bytes"]["value"],
    )


def _gc_collections():
    import gc

    return [g["collections"] for g in gc.get_stats()]


def phase_obs_overhead(dev, card, seed, pairs=12):
    """The planes' cost per decode iteration, by the JAX serving
    benchmark's method (drain-mode passes, planes off and on in turns,
    the order swapped every pair, the median of the per-pair ratios) on
    a decode-heavy mix: 16 requests of 8-16 prompt tokens (one prefill
    chunk each) and 96-128 new tokens on one warmed engine, so that
    decode iterations take most of each pass.  "Off" is ``CMN_OBS=0``
    (no registry, no plane); "on" is the shipped default (every plane on
    the process registry).  Each pass is driven tick by tick; its median
    tick is a clean decode iteration (prefill ticks are under a tenth of
    them), so the per-pair ratio of median ticks is the planes' cost per
    decode iteration.  The makespan ratio (the JAX bench's number) is
    reported beside it."""
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.serving import Scheduler

    reqs = draw_requests(np.random.RandomState(seed + 4), 16,
                         FULL["vocab"], plen=(8, 16), new=(96, 128))
    eng, _, _ = serving_engine(dev, seed, reqs)

    def one_pass(on):
        obs.set_enabled(on)
        try:
            eng.drop_prefix_cache()
            sched = Scheduler(eng)
            for r in reqs:
                sched.submit(r)
            ticks = []
            gc0 = _gc_collections()
            t_start = time.perf_counter()
            while sched.pending:
                t0 = time.perf_counter()
                progressed = sched.tick()
                ticks.append(time.perf_counter() - t0)
                check(progressed, "obs A/B: a tick made no progress")
            sched.finish()
            makespan = time.perf_counter() - t_start
            gc1 = _gc_collections()
        finally:
            obs.set_enabled(None)
        check(len(sched.completions) == len(reqs)
              and all(c.status == "ok" for c in sched.completions),
              "obs A/B: a request did not complete")
        return dict(tick_ms=1e3 * float(np.median(ticks)),
                    makespan_s=makespan, ticks=len(ticks),
                    decode_iterations=sched.decode_iterations,
                    gc_collections=[b - a for a, b in zip(gc0, gc1)])

    one_pass(True)  # untimed: the planes' first use
    one_pass(False)
    passes = {False: [], True: []}
    tick_ratios, span_ratios, tick_us = [], [], []
    for rep in range(pairs):
        got = {}
        for on in ((False, True) if rep % 2 == 0 else (True, False)):
            got[on] = one_pass(on)
            passes[on].append(got[on])
        tick_ratios.append(got[True]["tick_ms"] / got[False]["tick_ms"] - 1)
        span_ratios.append(got[True]["makespan_s"]
                           / got[False]["makespan_s"] - 1)
        tick_us.append(1e3 * (got[True]["tick_ms"] - got[False]["tick_ms"]))
    check(eng.decode_compiles == 1,
          f"obs A/B: {eng.decode_compiles} captures")

    def pct(v):
        return [100.0 * float(q) for q in np.percentile(v, [25, 50, 75])]

    row = dict(phase="obs_overhead", card=card, pairs=pairs,
               requests=len(reqs),
               decode_iterations=passes[True][0]["decode_iterations"],
               per_iteration_overhead_pct=pct(tick_ratios)[1],
               per_iteration_quartiles_pct=pct(tick_ratios)[::2],
               per_iteration_overhead_us=float(np.median(tick_us)),
               median_tick_ms={"off": float(np.median(
                   [p["tick_ms"] for p in passes[False]])),
                   "on": float(np.median(
                       [p["tick_ms"] for p in passes[True]]))},
               makespan_overhead_pct=pct(span_ratios)[1],
               makespan_quartiles_pct=pct(span_ratios)[::2],
               tick_ratios=tick_ratios, makespan_ratios=span_ratios,
               passes_off=passes[False], passes_on=passes[True],
               replays=eng.decode_replays)
    emit(row)
    return row


def phase_serving_turns(dev, card, seed, rounds=3):
    """The bf16 drive's two scheduler set-ups in turns on one warmed
    engine: as the full run drives it (an explicit registry and an
    incident manager) and as ``--compare-with`` drives it (the registry
    alone), the order swapped every round.  Each pass reports its clean
    decode-step mean and max and the garbage collections that ran in
    it, so that a gap between the full run's number and the compare
    turns' can be told from the set-up."""
    from chainermn_tpu_torch.observability import MetricsRegistry
    from chainermn_tpu_torch.observability.incident import IncidentManager
    from chainermn_tpu_torch.serving import Scheduler

    reqs = draw_requests(np.random.RandomState(seed), 16, FULL["vocab"])
    eng, _, _ = serving_engine(dev, seed, reqs)

    def one_pass(incidents):
        eng.drop_prefix_cache()
        reg = MetricsRegistry()
        kw = ({"incidents": IncidentManager(registry=reg, directory=None)}
              if incidents else {})
        gc0 = _gc_collections()
        comps = Scheduler(eng, registry=reg, **kw).run(reqs)
        gc1 = _gc_collections()
        check(all(c.status == "ok" for c in comps),
              "serving turns: a request did not complete")
        clean = reg.snapshot()["serve.decode_ms"]
        return dict(clean_decode_step_ms_mean=clean["sum"] / clean["count"],
                    clean_decode_step_ms_max=clean["max"],
                    clean_decode_steps=clean["count"],
                    gc_collections=[b - a for a, b in zip(gc0, gc1)])

    one_pass(True)  # untimed: the incident manager's first use
    arms = {"full_run": [], "compare": []}
    for rep in range(rounds):
        for arm in (("full_run", "compare") if rep % 2 == 0
                    else ("compare", "full_run")):
            arms[arm].append(one_pass(arm == "full_run"))
    check(eng.decode_compiles == 1,
          f"serving turns: {eng.decode_compiles} captures")
    row = dict(phase="serving_turns", card=card, rounds=rounds,
               **{arm: dict(clean_decode_step_ms_median=float(np.median(
                   [p["clean_decode_step_ms_mean"] for p in ps])),
                   passes=ps) for arm, ps in arms.items()})
    emit(row)
    return row


def phase_policy(dev, card, seed):
    """Two tenants at full width, after the JAX serving benchmark's
    ``--multitenant`` arm: an adversarial tenant's burst of twice the
    engine's capacity queued at t=0 ahead of a latency-sensitive
    tenant's requests, served FIFO and then through a ``PolicyPlane``
    giving the SLO tenant a 4:1 weighted-fair share, best of two passes
    each in turns.  Prints the SLO tenant's p95 both ways; checks
    completions, the ledger's books and one capture, not the timings."""
    from chainermn_tpu_torch.observability import MetricsRegistry
    from chainermn_tpu_torch.serving import (
        PolicyPlane,
        Request,
        Scheduler,
        TenantPolicy,
    )

    cap = ENGINE["capacity"]
    rng = np.random.RandomState(seed + 5)
    base = draw_requests(rng, 2 * cap + cap // 2, FULL["vocab"])
    reqs = [Request(id=r.id, prompt=r.prompt,
                    max_new_tokens=min(r.max_new_tokens, 16),
                    tenant="adv" if r.id < 2 * cap else "slo")
            for r in base]
    eng, _, _ = serving_engine(dev, seed, reqs)

    def one_pass(policy):
        eng.drop_prefix_cache()
        sched = Scheduler(eng, registry=MetricsRegistry(), policy=policy)
        t0 = time.perf_counter()
        comps = sched.run(reqs)
        wall = time.perf_counter() - t0
        check(all(c.status == "ok" and len(c.tokens) == r.max_new_tokens
                  for c, r in zip(sorted(comps, key=lambda c: c.id), reqs)),
              "policy arm: a request did not complete")
        cons = sched.ledger.verify_conservation(reqs)
        check(cons["holds"], f"policy arm: ledger books not exact: {cons}")
        lat = {t: sorted(c.finished_at - c.arrival for c in comps
                         if reqs[c.id].tenant == t) for t in ("adv", "slo")}
        p95 = {t: v[min(len(v) - 1, int(round(0.95 * (len(v) - 1))))]
               for t, v in lat.items()}
        return dict(tokens_per_s=sum(len(c.tokens) for c in comps) / wall,
                    slo_p95_s=p95["slo"], adv_p95_s=p95["adv"])

    runs = {"fifo": [], "policy": []}
    plane = None
    for _ in range(2):
        runs["fifo"].append(one_pass(None))
        plane = PolicyPlane(
            tenants={"slo": TenantPolicy("slo", weight=4.0),
                     "adv": TenantPolicy("adv", weight=1.0)},
            registry=MetricsRegistry())
        runs["policy"].append(one_pass(plane))
    check(eng.decode_compiles == 1,
          f"policy arm: {eng.decode_compiles} captures")
    row = dict(phase="policy", card=card, adv_requests=2 * cap,
               slo_requests=cap // 2, weights={"slo": 4.0, "adv": 1.0},
               **{arm: dict(
                   tokens_per_s=max(r["tokens_per_s"] for r in rs),
                   slo_p95_s=min(r["slo_p95_s"] for r in rs),
                   adv_p95_s=min(r["adv_p95_s"] for r in rs),
                   runs=rs) for arm, rs in runs.items()},
               admission_order=[t for _, t, _ in plane.admission_log[:12]],
               virtual_clock=dict(plane.virtual))
    emit(row)
    return row


#: the serving bench's ``--spec-k`` A/B (benchmarks/serving.py:691-790):
#: k draft proposals per round from the zero-tail distilled draft of
#: ``layers // 4`` blocks; 16 requests of 16-token prompts, 24 new tokens
#: each (its ``n_sp``/``sp_new`` at the defaults), drain pairs in turns.
SERVE_SPEC_K = 4
SERVE_SPEC_PAIRS = 4


def zero_tail_pair(dev, seed, dtype, max_len):
    """The serving bench's distilled draft on the serving model: the
    target's blocks past ``layers // 4`` write nothing back (``proj`` and
    ``ff2`` zeroed), so the target's function is its first blocks', which
    with the embeddings, ``ln_f`` and the head are the draft."""
    from chainermn_tpu_torch.models import TransformerLM

    dl = max(1, FULL["n_layers"] // 4)
    cfg = dict(FULL, max_len=max_len)
    target = TransformerLM(**cfg, dtype=dtype, device=dev, seed=seed)
    with torch.no_grad():
        for blk in target.blocks[dl:]:
            for lin in (blk.proj, blk.ff2):
                lin.weight.zero_()
                lin.bias.zero_()
    draft = TransformerLM(**{**cfg, "n_layers": dl}, dtype=dtype,
                          device=dev, seed=seed)
    draft.load_state_dict({
        n: t for n, t in target.state_dict().items()
        if not n.startswith("blocks.") or int(n.split(".")[1]) < dl})
    return target, draft, dl


def phase_serving_spec(ops, dev, card, seed):
    """The engine's speculative round, captured once and replayed every
    round, against the plain engine on the same zero-tail target:
    drain-mode passes in turns (plain, spec, spec, plain, ...), the
    tokens/s ratio the median of the pairs'; acceptance; one
    ``spec_round`` capture; K4's runs counted on the card = rounds x the
    launches the capture recorded (``k + 1`` draft steps of the draft's
    layers and the verify forward's); and in fp32 on the same weights the
    speculative engine's tokens = the plain engine's (greedy output is
    the target's own)."""
    from chainermn_tpu_torch.observability import MetricsRegistry, SLOMonitor
    from chainermn_tpu_torch.serving import (
        DecodeEngine,
        Request,
        Scheduler,
        blocks_for,
    )

    k, cap, bl = SERVE_SPEC_K, ENGINE["capacity"], ENGINE["block_len"]
    rng = np.random.RandomState(seed + 40)
    n_sp, sp_new, plen = 16, 24, 16
    reqs = [Request(id=30_000 + i, prompt=rng.randint(
        1, FULL["vocab"], size=plen).tolist(), max_new_tokens=sp_new)
        for i in range(n_sp)]
    chunk = ENGINE["prefill_chunk"]
    # Tables as wide as the warm-up's longest request (a 128-token prompt
    # and 20 new tokens, padded to a chunk) and the round's k headroom.
    mbs = blocks_for(128 + 20 + chunk + k, bl)
    geo = dict(num_blocks=1 + cap * (mbs + 1), max_blocks_per_slot=mbs,
               device=dev, **ENGINE)

    def engines(dtype):
        target, draft, dl = zero_tail_pair(dev, seed, dtype,
                                           max(256, mbs * bl))
        plain = DecodeEngine(target, **geo)
        spec = DecodeEngine(target, draft_model=draft, spec_k=k, **geo)
        for eng in (plain, spec):
            warm_engine(eng, seed)
        return plain, spec, dl

    plain, spec, dl = engines(torch.bfloat16)
    check(spec.verify_compiles == 1 and len(spec._spec_graphs) == 1
          and not spec._graphs,
          f"serving_spec: {spec.verify_compiles} round captures, "
          f"{len(spec._graphs)} decode-step captures on the spec engine")
    per_round = next(iter(spec._spec_graphs.values())).captured
    want_round = (k + 1) * dl + FULL["n_layers"]
    check(per_round == {"paged_decode_attention": want_round,
                        "fused_decode_attention": 0},
          f"serving_spec: the round's capture recorded {per_round}, "
          f"expected {want_round} K4 launches")

    def one_pass(eng):
        eng.drop_prefix_cache()
        reg = MetricsRegistry()
        # A check cadence of 4: a pass takes ~11 rounds, and the device
        # feed publishes on the cadence and at a drain that crossed it.
        sched = Scheduler(eng, registry=reg,
                          slo=SLOMonitor(registry=reg, check_every=4))
        replays0 = eng.spec_replays
        torch.cuda.synchronize()
        ops.paged_decode_attention.launches = 0
        ops.zero_kernel_runs(dev)
        t0 = time.perf_counter()
        comps = sched.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs = ops.kernel_runs(dev)["paged_decode_attention"]
        byid = check_complete("serving_spec", reqs, comps)
        return dict(wall=wall, sched=sched, byid=byid, runs=runs, reg=reg,
                    wrapper=ops.paged_decode_attention.launches,
                    replays=eng.spec_replays - replays0,
                    span=max(c.finished_at for c in comps))

    ratios, passes = [], {False: [], True: []}
    for rep in range(SERVE_SPEC_PAIRS):
        spans = {}
        for is_spec in ((False, True) if rep % 2 == 0 else (True, False)):
            p = one_pass(spec if is_spec else plain)
            passes[is_spec].append(p)
            spans[is_spec] = p["wall"]
        ratios.append(spans[False] / spans[True])
    last = passes[True][-1]
    sched = last["sched"]
    rounds = sched.decode_iterations
    check(last["replays"] == rounds and last["wrapper"] == 0
          and last["runs"] == rounds * want_round,
          f"serving_spec: {rounds} rounds, {last['replays']} replays, "
          f"the wrapper launched {last['wrapper']}, the card counted "
          f"{last['runs']} K4 runs for {rounds} x {want_round}")
    accept = sched.spec_accepted / max(sched.spec_proposed, 1)
    useful = n_sp * sp_new

    def clean_ms(p):
        h = p["reg"].snapshot()["serve.decode_ms"]
        return h["sum"] / max(h["count"], 1)
    # The capture watch's roofline of the round, published at the drain.
    gauges = {k.split(".")[-1]: v.get("value")
              for k, v in last["reg"].snapshot().items()
              if k.startswith("device.spec_round.")}
    check(gauges.get("tflops", 0) > 0
          and 0 < (gauges.get("mfu_pct") or 0) <= 100,
          f"serving_spec: device.spec_round gauges {gauges}")
    # bf16: reported, as the decode phase's speculative arm reports it
    # (the verify forward and the single-token step round differently,
    # so near-ties may flip); the fp32 drive below is the check.
    firsts = first_divergences(
        {r: c.tokens for r, c in last["byid"].items()},
        {r: c.tokens for r, c in passes[False][-1]["byid"].items()})
    div = sorted(d for d in firsts.values() if d is not None)
    bf16 = dict(rows_exact=len(firsts) - len(div), rows=len(firsts),
                first_divergences=div)
    check(spec.verify_compiles == 1 and plain.decode_compiles == 1
          and spec.prefill_compiles == len(spec.prefill_ladder),
          f"serving_spec: captures spec {spec.verify_compiles}, plain "
          f"{plain.decode_compiles}, prefill {spec.prefill_compiles}")
    for eng in (plain, spec):
        eng.release()
    # fp32: the speculative engine emits the target's greedy tokens.
    plain32, spec32, _ = engines(torch.float32)
    got = {c.id: c.tokens for c in Scheduler(spec32).run(reqs[:cap])}
    want = {c.id: c.tokens for c in Scheduler(plain32).run(reqs[:cap])}
    fp32 = first_divergences(got, want)
    for eng in (plain32, spec32):
        eng.release()
    row = dict(phase="serving_spec", card=card, k=k, draft_layers=dl,
               target_layers=FULL["n_layers"], requests=n_sp,
               max_new=sp_new, prompt_len=plen, pairs=SERVE_SPEC_PAIRS,
               accept_rate=accept,
               tokens_per_s_spec=useful / min(p["wall"]
                                              for p in passes[True]),
               tokens_per_s_plain=useful / min(p["wall"]
                                               for p in passes[False]),
               speedup_vs_plain=float(np.median(ratios)),
               pair_ratios=ratios, rounds=rounds,
               clean_round_ms=clean_ms(last),
               clean_plain_step_ms=clean_ms(passes[False][-1]),
               plain_steps=passes[False][-1]["sched"].decode_iterations,
               spec_round_captures=spec.verify_compiles,
               device_spec_round=gauges,
               k4_launches_per_round=want_round, k4_runs=last["runs"],
               bf16_agreement=bf16,
               fp32_first_divergence=sorted(
                   (d for d in fp32.values() if d is not None)),
               fp32_rows_exact=sum(d is None for d in fp32.values()))
    emit(row)
    check(all(d is None for d in fp32.values()),
          f"serving_spec fp32: first divergences {fp32}")
    check(accept >= 0.5, f"serving_spec: acceptance {accept}")
    return row


# ------------------------------------------------------------------ fleet
#: requests per fleet phase (the JAX bench's --chaos and --elastic arms
#: take at most 32: benchmarks/serving.py:1223-1227, :1322).
FLEET_REQUESTS = 32


def pct(xs, q):
    """The ``q``-quantile of ``xs`` by nearest rank (None when empty)."""
    xs = sorted(xs)
    if not xs:
        return None
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def card_allocated():
    """Bytes held by live tensors on the card, after a collection and a
    sync."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def first_divergences(got, want):
    """Per request id, the first generated position where two runs'
    tokens differ (None: equal)."""
    return {rid: next((j for j, (x, y) in enumerate(zip(got[rid], w))
                       if x != y), None if len(got[rid]) == len(w)
                      else min(len(got[rid]), len(w)))
            for rid, w in want.items()}


def check_divergence(label, firsts):
    """The bf16 comparison of two runs of one model: a replica's decode
    step and its prefill see the same inputs as the single engine's, so
    rows agree unless an eviction re-prefilled a row at another chunk
    boundary (a bf16 near-tie may then flip); a logic fault diverges at
    the first tokens of every row."""
    div = [d for d in firsts.values() if d is not None]
    exact = len(firsts) - len(div)
    check(all(d >= 1 for d in div) and 4 * exact >= 3 * len(firsts),
          f"{label}: {exact}/{len(firsts)} rows equal, first divergences "
          f"{sorted(div)}")
    return dict(rows_exact=exact, rows=len(firsts),
                min_first_divergence=min(div) if div else None)


class Fleet:
    """Warmed full-width engines over one shared model.  Each call builds
    one engine, warms it as :func:`serving_engine` does (its decode step
    is captured then, at construction), and records what the card holds
    for it once warm; every engine built stays listed, so its replays
    (a host counter, kept after :meth:`DecodeEngine.release`) feed the
    card-count cross-check."""

    def __init__(self, model, dev, seed, reqs):
        self.model, self.dev, self.seed = model, dev, seed
        self.num_blocks, self.max_blocks = engine_geometry(reqs)
        self.built, self.footprint, self.captured = [], [], []
        self.build_s = 0.0

    def __call__(self, params=None):  # RollingDeploy passes params=
        from chainermn_tpu_torch.serving import DecodeEngine

        t0 = time.perf_counter()
        before = card_allocated()
        eng = DecodeEngine(self.model, num_blocks=self.num_blocks,
                           max_blocks_per_slot=self.max_blocks,
                           device=self.dev, **ENGINE)
        warm_engine(eng, self.seed)
        self.footprint.append(card_allocated() - before)
        graph = next(iter(eng._graphs.values()), None)
        self.captured.append(
            graph.captured["paged_decode_attention"] if graph else 0)
        self.built.append(eng)
        self.build_s += time.perf_counter() - t0
        return eng

    def settle(self):
        """Build, run and drop one engine that no count or footprint
        keeps: the process-wide state a first engine's warm-up can create
        (cuBLAS workspaces, the kernels' run counter) then sits in the
        baseline, not in the footprint of an engine that may leave."""
        self()
        eng = self.built.pop()
        self.footprint.pop()
        self.captured.pop()
        eng.release()
        return card_allocated()

    def mark(self):
        """Each built engine's replays now."""
        return [e.decode_replays for e in self.built]

    def k4_runs(self, mark):
        """K4 runs each engine replayed since ``mark`` (an engine built
        later counts from 0)."""
        return [(e.decode_replays - (mark[i] if i < len(mark) else 0))
                * self.captured[i] for i, e in enumerate(self.built)]

    def live_bytes(self):
        """What the engines not released should hold on the card."""
        return sum(fp for e, fp in zip(self.built, self.footprint)
                   if not e.released)

    def stats(self):
        return dict(engines_built=len(self.built),
                    captures=sum(e.decode_compiles for e in self.built),
                    build_s=self.build_s,
                    engine_bytes=sorted(set(self.footprint)))


def fleet_counts(ops, dev, fleet, mark, label):
    """K4's runs on the card since :func:`zero_decode_counts`, checked to
    be the wrappers' eager launches (engine warm-ups built inside the
    window) plus every engine's replays x the launches its capture
    recorded."""
    wrapper = ops.paged_decode_attention.launches
    runs = ops.kernel_runs(dev)
    replayed = fleet.k4_runs(mark)
    check(runs["paged_decode_attention"] == wrapper + sum(replayed)
          and runs["fused_decode_attention"] == 0,
          f"{label}: the card counted {runs} runs; the wrappers launched "
          f"{wrapper} and the replays ran {replayed}")
    return runs["paged_decode_attention"], replayed


def check_complete(label, reqs, comps, statuses=("ok",)):
    byid = {}
    for c in comps:
        check(c.id not in byid, f"{label}: request {c.id} completed twice")
        byid[c.id] = c
    check(sorted(byid) == sorted(r.id for r in reqs),
          f"{label}: completions {sorted(byid)} for {len(reqs)} requests")
    for r in reqs:
        c = byid[r.id]
        check(c.status in statuses, f"{label}: request {r.id} {c.status}")
        if c.status == "ok":
            check(len(c.tokens) == r.max_new_tokens
                  and all(0 <= t < FULL["vocab"] for t in c.tokens),
                  f"{label}: request {r.id} has {len(c.tokens)} tokens "
                  f"for {r.max_new_tokens}")
    return byid


def fleet_phases(ops, dev, card, seed):
    """The serving fleet's four phases, in order; the elastic arrivals'
    base rate comes from the router phase's single-engine run."""
    out = {"router": phase_router(ops, dev, card, seed)}
    out["disagg"] = phase_disagg(ops, dev, card, seed)
    out["chaos"] = phase_chaos(ops, dev, card, seed)
    out["elastic"] = phase_elastic(
        ops, dev, card, seed,
        out["router"]["single_engine_requests_per_s"])
    return out


def phase_router(ops, dev, card, seed):
    """The JAX bench's ``--replicas`` arm (benchmarks/serving.py:821-870)
    on one card: two replicas of the full-width engine over one model's
    weights behind a ``Router`` (``max_queue`` 2 x capacity, ledger on),
    32 requests at t = 0.  Both replicas contend for the same card, so
    tokens/s here is not replica scaling.  Checks: every request
    completes once; tokens against a single ``Scheduler`` on one of the
    engines (bf16: divergence structure); one capture per engine; K4's
    card runs = the replicas' replays x 12; the shared ledger conserved;
    a stolen request's spans on both replicas' pids in the fleet trace;
    no block leaked.  Then an fp32 twin (8 requests, pools that never
    evict): router tokens = single-scheduler tokens exactly."""
    import os
    import tempfile

    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.observability import MetricsRegistry
    from chainermn_tpu_torch.serving import DecodeEngine, Router, Scheduler

    rng = np.random.RandomState(seed + 20)
    reqs = draw_requests(rng, FLEET_REQUESTS, FULL["vocab"])
    model = TransformerLM(**FULL, device=dev, seed=seed)
    fleet = Fleet(model, dev, seed, reqs)
    engines = [fleet(), fleet()]
    cap = ENGINE["capacity"]
    reg = MetricsRegistry()
    router = Router(engines, registry=reg, max_queue=2 * cap)
    mark = fleet.mark()
    zero_decode_counts(ops, dev)
    t0 = time.perf_counter()
    comps = router.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, per_replica = fleet_counts(ops, dev, fleet, mark, "router")
    byid = check_complete("router", reqs, comps)
    check(all(e.decode_compiles == 1 for e in engines),
          f"router: captures {[e.decode_compiles for e in engines]}")
    cons = router.ledger.verify_conservation(reqs)
    check(cons["holds"], f"router: ledger books not exact: {cons}")
    stolen = sorted(rid for rid, reps in router.assignments.items()
                    if len(set(reps)) > 1)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fleet.json")
        summary = router.export_fleet_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    pids = {}
    for e in events:
        detail = e.get("args", {}).get("detail")
        if e.get("ph") == "X" and isinstance(detail, str):
            pids.setdefault(detail, set()).add(e["pid"])
    for rid in stolen:
        check(pids.get(f"req={rid}", set()) >= set(router.assignments[rid]),
              f"router: stolen request {rid} on pids "
              f"{pids.get(f'req={rid}')}, assigned "
              f"{router.assignments[rid]}")
    for i, (s, e) in enumerate(zip(router.schedulers, engines)):
        check(s.memory.check_drained(e) == 0,
              f"router: replica {i} leaked KV blocks")
        e.drop_prefix_cache()
        check(e.free_blocks() == fleet.num_blocks - 1,
              f"router: replica {i} leaked blocks after gc")
    stats = router.replica_stats()
    occ = [s["occupancy_mean"] for s in stats]
    tokens = sum(len(c.tokens) for c in comps)
    # The single-replica reference: one of the same engines, alone.
    t1 = time.perf_counter()
    single = Scheduler(engines[0], registry=MetricsRegistry()).run(reqs)
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t1
    bf16 = check_divergence("router bf16", first_divergences(
        {r: byid[r].tokens for r in byid}, {c.id: c.tokens for c in single}))
    engines[0].drop_prefix_cache()
    # fp32 twin: pools that hold every slot's longest request.
    rng32 = np.random.RandomState(seed + 24)
    reqs32 = draw_requests(rng32, 8, FULL["vocab"], new=(16, 16))
    _, mb = engine_geometry(reqs32)
    model32 = TransformerLM(**FULL, dtype=torch.float32, device=dev,
                            seed=seed)

    def eng32():
        return DecodeEngine(model32, num_blocks=1 + cap * mb,
                            max_blocks_per_slot=mb, device=dev, **ENGINE)

    got32 = Router([eng32(), eng32()], registry=MetricsRegistry(),
                   max_queue=2).run(reqs32)
    want32 = Scheduler(eng32(), registry=MetricsRegistry()).run(reqs32)
    fp32 = first_divergences({c.id: c.tokens for c in got32},
                             {c.id: c.tokens for c in want32})
    check(all(d is None for d in fp32.values()),
          f"router fp32: first divergences {fp32}")
    row = dict(
        phase="router", card=card, replicas=2, requests=len(reqs),
        max_queue=2 * cap, shares_one_card=True, tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall,
        single_engine_tokens_per_s=tokens / single_wall,
        single_engine_requests_per_s=len(reqs) / single_wall,
        occupancy_mean=occ, occupancy_spread=max(occ) - min(occ),
        dispatch_ms_p50=pct(router.dispatch_ms, 0.50),
        dispatch_ms_p95=pct(router.dispatch_ms, 0.95),
        dispatched=reg.peek("serve.router.dispatched").value,
        steals=reg.peek("serve.router.migrated").value,
        backpressure=reg.peek("serve.router.backpressure").value,
        stolen=stolen, served=[s["served"] for s in stats],
        evictions=sum(c.evictions for c in comps),
        launches=launches, k4_runs_per_replica=per_replica,
        decode_compiles=[e.decode_compiles for e in engines],
        fleet_trace_spans=summary["spans"],
        ledger_tokens=router.ledger.totals["tokens"],
        bf16_vs_single=bf16, fp32_rows_exact=sum(
            d is None for d in fp32.values()), fp32_rows=len(fp32),
        **fleet.stats())
    emit(row)
    return row


def phase_disagg(ops, dev, card, seed):
    """The JAX bench's ``--disagg`` arm (benchmarks/serving.py:1056-1206)
    on one card: a prefill-role engine and a decode-role engine over the
    in-process ``LocalComm``, against a colocated engine on the same 32
    requests.  Checks: the decode role books no mixed iteration, captures
    once and installs through one ``kv_put`` signature; every request
    migrates; tokens against the colocated run (divergence structure);
    K4's card runs = replays x 12; and a migrated block re-reads byte for
    byte, for this bf16 engine and for the int8-GQA one."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.observability import MetricsRegistry
    from chainermn_tpu_torch.serving import (
        DecodeRole,
        LocalComm,
        MigrationTransport,
        PrefillRole,
        Scheduler,
        serve_disaggregated,
    )
    from chainermn_tpu_torch.serving import disagg as dz
    from chainermn_tpu_torch.serving.scheduler import _Clock

    rng = np.random.RandomState(seed + 21)
    reqs = draw_requests(rng, FLEET_REQUESTS, FULL["vocab"])
    model = TransformerLM(**FULL, device=dev, seed=seed)
    fleet = Fleet(model, dev, seed, reqs)
    co, pf, de = fleet(), fleet(), fleet()
    reg_co = MetricsRegistry()
    co_sched = Scheduler(co, registry=reg_co)
    t0 = time.perf_counter()
    co_comps = co_sched.run(reqs)
    torch.cuda.synchronize()
    co_wall = time.perf_counter() - t0
    clock, comm = _Clock(), LocalComm(2)
    reg_p, reg_d = MetricsRegistry(), MetricsRegistry()
    pr = PrefillRole(Scheduler(pf, registry=reg_p, clock=clock),
                     MigrationTransport(comm.endpoint(0), registry=reg_p),
                     decode_ranks=[1])
    dr = DecodeRole(Scheduler(de, registry=reg_d, clock=clock),
                    MigrationTransport(comm.endpoint(1), registry=reg_d),
                    prefill_ranks=[0])
    migrate_ms = []
    observe = pr.transport.observe_ms

    def observe_ms(ms):
        migrate_ms.append(ms)
        observe(ms)

    pr.transport.observe_ms = observe_ms
    mark = fleet.mark()
    zero_decode_counts(ops, dev)
    t0 = time.perf_counter()
    comps = serve_disaggregated(pr, dr, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, per_engine = fleet_counts(ops, dev, fleet, mark, "disagg")
    byid = check_complete("disagg", reqs, comps)
    snap_d, snap_p = reg_d.snapshot(), reg_p.snapshot()
    mixed = snap_d.get("serve.mixed_ms", {}).get("count", 0)
    check(mixed == 0, f"disagg: the decode role booked {mixed} mixed "
          "iterations")
    check(de.decode_compiles == 1 and de.put_compiles == 1,
          f"disagg: decode role captures {de.decode_compiles}, kv_put "
          f"signatures {de.put_compiles}")
    migrated = snap_p["serve.migration.slots_migrated"]["value"]
    check(migrated == len(reqs),
          f"disagg: {migrated} slots migrated for {len(reqs)} requests")
    colocated = check_divergence("disagg bf16", first_divergences(
        {r: byid[r].tokens for r in byid},
        {c.id: c.tokens for c in co_comps}))
    # Byte identity of a migrated block, bf16 and int8-GQA engines.
    identity = {}
    for label, kw in (("bf16", {}),
                      ("int8_gqa", dict(n_kv_heads=4, kv_dtype=torch.int8))):
        if kw:
            m8 = TransformerLM(**{**FULL, **kw}, device=dev, seed=seed)
            f8 = Fleet(m8, dev, seed, reqs)
            src_e, dst_e = f8(), f8()
        else:
            pf.drop_prefix_cache()
            de.drop_prefix_cache()
            src_e, dst_e = pf, de
        src = Scheduler(src_e, registry=MetricsRegistry())
        dst = Scheduler(dst_e, registry=MetricsRegistry())
        for r in reqs[:3]:
            src.submit(r)
        for _ in range(64):
            while src._try_admit():
                pass
            src._prefill_round()
            live = [s for s in src._slots if s is not None]
            if live and all(not s.prefilling for s in live):
                break
        want = {s.entry.req.id: [src_e.read_block(b) for b in s.blocks]
                for s in live}
        body = dz.pack_slots(src, live)
        dz.detach_slots(src, live)
        n, _, _ = dz.install_payload(dst, body)
        same = n == len(live)
        for s in dst._slots:
            if s is None:
                continue
            for b, w in zip(s.blocks, want[s.entry.req.id]):
                got = dst_e.read_block(b)["target"]
                same = same and all(
                    np.array_equal(g[k], x[k]) and g[k].dtype == x[k].dtype
                    for g, x in zip(got, w["target"]) for k in x)
        check(same, f"disagg: a migrated {label} block did not re-read "
              "byte for byte")
        identity[label] = dict(slots=n, blocks=len(body["blocks"]),
                               bytes=dz.payload_bytes(body),
                               names=sorted(body["blocks"][next(iter(
                                   body["blocks"]))]["target"][0]))
    tokens = sum(len(c.tokens) for c in comps)
    row = dict(
        phase="disagg", card=card, requests=len(reqs), shares_one_card=True,
        tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        colocated_tokens_per_s=tokens / co_wall,
        migrate_ms_p50=pct(migrate_ms, 0.50),
        migrate_ms_p95=pct(migrate_ms, 0.95), migrations=len(migrate_ms),
        slots_migrated=migrated,
        blocks_moved=snap_p["serve.migration.blocks_moved"]["value"],
        bytes_moved=snap_p["serve.migration.bytes"]["value"],
        install_ms_mean=(snap_d["serve.migration.install_ms"]["sum"]
                         / max(snap_d["serve.migration.install_ms"]["count"],
                               1)),
        clean_decode_ms_p95={
            "colocated": co_sched.slo.last_report["token"]["p95_ms"],
            "decode_role": dr.sched.slo.last_report["token"]["p95_ms"]},
        colocated_mixed_iterations=reg_co.snapshot().get(
            "serve.mixed_ms", {}).get("count", 0),
        decode_role_mixed_iterations=mixed,
        decode_compiles=de.decode_compiles, put_compiles=de.put_compiles,
        launches=launches, k4_runs_per_engine=per_engine,
        bf16_vs_colocated=colocated, byte_identity=identity,
        **fleet.stats())
    emit(row)
    return row


def phase_chaos(ops, dev, card, seed):
    """The JAX bench's ``--chaos`` arm (benchmarks/serving.py:1207-1294):
    ``ChaosHarness(replicas=3, revive_after=4, max_revives=2,
    shed_depth=4 x capacity)`` under ``chaos_schedule(seed, 3)`` on 32
    requests, every engine warmed (captured) as it is built, revivals
    mid-traffic included.  Checks: the terminal invariant (zero lost,
    zero duplicated); the ``serve.health.*`` counters against the
    schedule and the statuses; one capture per engine; K4's card runs =
    warm-ups + replays x 12; and the card's allocated bytes = the
    footprint of the engines still in the fleet (dead ones freed)."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.observability import MetricsRegistry
    from chainermn_tpu_torch.serving import ChaosHarness

    rng = np.random.RandomState(seed + 22)
    reqs = draw_requests(rng, FLEET_REQUESTS, FULL["vocab"])
    model = TransformerLM(**FULL, device=dev, seed=seed)
    fleet = Fleet(model, dev, seed, reqs)
    base = fleet.settle()
    cap = ENGINE["capacity"]
    reg = MetricsRegistry()
    harness = ChaosHarness(fleet, replicas=3, seed=seed, registry=reg,
                           revive_after=4, max_revives=2,
                           shed_depth=4 * cap)
    mark = fleet.mark()
    zero_decode_counts(ops, dev)
    t0 = time.perf_counter()
    report = harness.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, per_engine = fleet_counts(ops, dev, fleet, mark, "chaos")
    router = harness.router
    comps = router.completions
    check(report["holds"] and not report["lost"]
          and not report["duplicated"],
          f"chaos: terminal invariant broken: {report}")
    check_complete("chaos", reqs, comps,
                   statuses=("ok", "poisoned", "shed", "deadline"))

    def cnt(name):
        inst = reg.peek(name)
        return inst.value if inst is not None else 0

    crashes = sum(1 for s in report["schedule"]["replica_faults"]
                  if s and "crash" in s)
    deaths = cnt("serve.health.replica_dead")
    by = report["by_status"]
    check(1 <= deaths <= crashes and report["revived"] <= 2
          and report["revived"] <= deaths
          and cnt("serve.health.shed") == by["shed"]
          and cnt("serve.health.poisoned") == by["poisoned"]
          and cnt("serve.health.retries")
          >= sum(c.retries for c in comps)
          and cnt("serve.health.recovered")
          >= sum(1 for c in comps if c.retries and c.status == "ok"),
          f"chaos: health counters {reg.snapshot()} against schedule "
          f"{report['schedule']} and statuses {by}")
    for i, s in enumerate(router.schedulers):
        if router.health.is_up(i) and s._iterations:
            check(s.engine.decode_compiles == 1,
                  f"chaos: replica {i} captured {s.engine.decode_compiles}")
    check(all(e.decode_compiles == 1 for e in fleet.built),
          f"chaos: captures {[e.decode_compiles for e in fleet.built]}")
    held = card_allocated() - base
    live = fleet.live_bytes()
    check(held == live, f"chaos: the card holds {held} bytes past the "
          f"model's, the engines still in the fleet {live}")
    tokens = sum(len(c.tokens) for c in comps if c.status == "ok")
    row = dict(
        phase="chaos", card=card, replicas=3, requests=len(reqs),
        shares_one_card=True, schedule=report["schedule"], by_status=by,
        revived=report["revived"], health=report["health"],
        counters={n.split(".")[-1]: cnt(n) for n in (
            "serve.health.replica_dead", "serve.health.recovered",
            "serve.health.retries", "serve.health.poisoned",
            "serve.health.shed")},
        retried=sum(1 for c in comps if c.retries), tokens=tokens,
        wall_s=wall, tokens_per_s=tokens / wall, launches=launches,
        k4_runs_per_engine=per_engine, card_bytes_past_model=held,
        live_engine_bytes=live,
        engines_released=sum(e.released for e in fleet.built),
        **fleet.stats())
    emit(row)
    return row


def drive_fleet(router, scaler=None):
    """Drain ``router`` as the JAX bench's elastic arm does
    (benchmarks/serving.py:1364-1396): tick (and the autoscaler), skip
    idle gaps to the next arrival, and integrate the up-replica count
    over the clock (replica-seconds).  Returns ``(ticks,
    replica_seconds)``."""
    area, last, ticks = 0.0, router.clock.now(), 0
    while router.pending:
        progressed = router.tick()
        ticks += 1
        if scaler is not None:
            scaler.tick()
        now = router.clock.now()
        area += (now - last) * sum(
            1 for i, s in enumerate(router.schedulers)
            if s is not None and router.health.is_up(i))
        last = now
        if not progressed:
            nxt = [t for t in (
                [r.arrival for r in router.queued_requests()[:1]]
                + [s.next_arrival() for i, s in enumerate(router.schedulers)
                   if s is not None and router.health.is_up(i)])
                if t is not None and t > now]
            if nxt:
                router.clock.skip_to(min(nxt))
    router.finish()
    return ticks, area


def phase_elastic(ops, dev, card, seed, one_replica_rate):
    """The JAX bench's ``--elastic`` arm (benchmarks/serving.py:1295-1480):
    32 requests of at most 24 new tokens on sinusoid-plus-burst arrivals
    (base rate half of ``one_replica_rate``, one replica's measured
    requests/s; tripled in the middle third), served by a static fleet of
    2 replicas and by an ``Autoscaler`` fleet that starts at 1 (at most
    2; up on a backlog over 1.5, down below 25% occupancy after a 3-tick
    streak, cooldown 8), scale-ups taken from warm spares; then a
    ``RollingDeploy`` of a 2-replica fleet mid-traffic.  Checks: both
    fleets' terminal invariant, the rollout zero-loss with one capture
    per replacement engine, K4's card runs = replays x 12, and the card's
    allocated bytes = the footprint of the engines not released."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.observability import MetricsRegistry
    from chainermn_tpu_torch.serving import (
        Autoscaler,
        Request,
        RollingDeploy,
        Router,
        verify_terminal_invariant,
    )

    rng = np.random.RandomState(seed + 23)
    base_reqs = draw_requests(rng, FLEET_REQUESTS, FULL["vocab"])
    n = len(base_reqs)
    base_rate = max(0.5 * one_replica_rate, 1e-6)
    t, arrivals = 0.0, []
    for i in range(n):
        lam = base_rate * (1.0 + 0.8 * np.sin(2.0 * np.pi * i / n))
        if n // 3 <= i < 2 * n // 3:
            lam *= 3.0
        t += float(rng.exponential(1.0 / max(lam, 1e-9)))
        arrivals.append(t)

    def batch(base_id, timed=True):
        return [Request(id=base_id + r.id, prompt=r.prompt,
                        max_new_tokens=min(r.max_new_tokens, 24),
                        arrival=arrivals[i] if timed else 0.0)
                for i, r in enumerate(base_reqs)]

    model = TransformerLM(**FULL, device=dev, seed=seed)
    # Every engine is built and warmed before any drive (a scale-up
    # takes a warm spare, as the bench's does): a router's clock starts
    # at its construction, right before its drive, so no build ages the
    # arrivals.
    fleet = Fleet(model, dev, seed, base_reqs)
    base = fleet.settle()
    st_engines = [fleet(), fleet()]
    spares = [fleet() for _ in range(3)]
    el_engine = fleet()
    rolled = [fleet(), fleet()]

    def from_spares(params=None):
        return spares.pop() if spares else fleet()

    mark = fleet.mark()
    zero_decode_counts(ops, dev)
    static = Router(st_engines, registry=MetricsRegistry())
    st_reqs = batch(80_000)
    for r in st_reqs:
        static.submit(r)
    t0 = time.perf_counter()
    st_ticks, st_area = drive_fleet(static)
    st_wall = time.perf_counter() - t0
    ez_reg = MetricsRegistry()
    elastic = Router([el_engine], registry=ez_reg)
    scaler = Autoscaler(elastic, from_spares, registry=ez_reg,
                        min_replicas=1, max_replicas=2, up_depth=1.5,
                        down_occ=0.25, hysteresis=1, down_hysteresis=3,
                        cooldown_ticks=8)
    el_reqs = batch(81_000)
    for r in el_reqs:
        elastic.submit(r)
    t0 = time.perf_counter()
    el_ticks, el_area = drive_fleet(elastic, scaler)
    el_wall = time.perf_counter() - t0
    rl_reg = MetricsRegistry()
    rolling = Router(rolled, registry=rl_reg, probation_ticks=8)
    rl_reqs = batch(85_000, timed=False)[:16]
    for r in rl_reqs:
        rolling.submit(r)
    for _ in range(3):
        rolling.tick()
    rollout = RollingDeploy(rolling, from_spares, registry=rl_reg)
    guard = 0
    while not rollout.done and not rollout.paused:
        rolling.tick()
        rollout.tick()
        guard += 1
        check(guard < 400, f"elastic: rollout stuck: {rollout.replaced}")
    rolling.run()
    torch.cuda.synchronize()
    launches, per_engine = fleet_counts(ops, dev, fleet, mark, "elastic")
    reports = {}
    for label, rs, comps in (("static", st_reqs, static.completions),
                             ("autoscaled", el_reqs, elastic.completions),
                             ("rollout", rl_reqs, rolling.completions)):
        reports[label] = verify_terminal_invariant(rs, comps)
        check(reports[label]["holds"] and all(
            c.status == "ok" for c in comps),
            f"elastic: {label} fleet lost work: {reports[label]}")
        check_complete(f"elastic {label}", rs, comps)
    check(rollout.done and not rollout.paused
          and sorted(rollout.replaced) == [0, 1]
          and all(s.engine not in rolled for s in rolling.schedulers)
          and all(e.released for e in rolled),
          f"elastic: rollout replaced {rollout.replaced}, paused "
          f"{rollout.paused}")
    check(all(e.decode_compiles == 1 for e in fleet.built),
          f"elastic: captures {[e.decode_compiles for e in fleet.built]}")
    def p95(comps):
        return pct([c.finished_at - c.arrival for c in comps], 0.95)

    row = dict(
        phase="elastic", card=card, requests=n, shares_one_card=True,
        base_rate_per_s=base_rate, burst_multiplier=3.0, replicas_max=2,
        static=dict(replica_seconds=st_area, ticks=st_ticks,
                    wall_s=st_wall, p95_s=p95(static.completions)),
        autoscaled=dict(replica_seconds=el_area, ticks=el_ticks,
                        wall_s=el_wall, p95_s=p95(elastic.completions),
                        decisions=scaler.decisions, flaps=scaler.flaps,
                        mean_replicas=scaler.replica_ticks / max(
                            el_ticks, 1)),
        saved_pct=100.0 * (1.0 - el_area / max(st_area, 1e-9)),
        rollout=dict(replaced=list(rollout.replaced), ticks=guard,
                     zero_loss=reports["rollout"]["holds"],
                     replacement_captures=[
                         s.engine.decode_compiles
                         for s in rolling.schedulers]),
        launches=launches, k4_runs_per_engine=per_engine,
        **fleet.stats())
    # The card holds what the engines not released hold; then, with
    # every fleet dropped, what the model alone held.
    held, live = card_allocated() - base, fleet.live_bytes()
    check(held == live, f"elastic: the card holds {held} bytes past the "
          f"model's, the engines not released {live}")
    del static, elastic, rolling, scaler, rollout, spares, rolled
    del st_engines, el_engine
    fleet.built.clear()
    after = card_allocated() - base
    check(after == 0, f"elastic: {after} bytes still held with every "
          "fleet dropped")
    row.update(card_bytes_past_model=held, live_engine_bytes=live,
               card_bytes_after_drop=after)
    emit(row)
    return row


# -------------------------------------------------------------- generation
def phase_generation(ops, dev, card, seed):
    from chainermn_tpu_torch.models import TransformerLM, lm_generate

    rng = np.random.RandomState(seed + 2)
    B, P, N = 8, 128, 64
    model = TransformerLM(**FULL, device=dev, seed=seed)
    prompt = torch.from_numpy(
        rng.randint(1, FULL["vocab"], size=(B, P))).to(dev)
    lm_generate(model, prompt[:, :16], 2)  # warm-up
    with torch.no_grad():
        logits = model(prompt[:, :32])
    check(tuple(logits.shape) == (B, 32, FULL["vocab"])
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          "full forward: logits not finite fp32 of the expected shape")
    zero_decode_counts(ops, dev)
    out, wall = timed(lambda: lm_generate(model, prompt, N))
    launches = decode_counts(ops, dev, "lm_generate")
    check(tuple(out.shape) == (B, N), f"lm_generate shape {out.shape}")
    check(bool(((out >= 0) & (out < FULL["vocab"])).all()),
          "lm_generate emitted a token outside the vocab")
    want = (N - 1) * FULL["n_layers"]
    check(launches["fused_decode_attention"] == want,
          f"fused kernel launched {launches['fused_decode_attention']} "
          f"times, expected {N - 1} steps x {FULL['n_layers']} layers")
    row = dict(phase="generation", card=card, batch=B, prompt=P,
               new_tokens=N,
               wall_s=wall, tokens_per_s=B * N / wall,
               ms_per_token_step=wall * 1e3 / N, launches=launches)
    emit(row)
    return row


def phase_agreement(dev, seed):
    """Engine vs lm_generate, full width in fp32, ragged prompts.  Exact
    equality is not the claim: two attention paths sum in different
    orders, and a random-weight model has near-tied logits, so the check
    is the divergence structure (a logic bug diverges at the first tokens
    of every request)."""
    from chainermn_tpu_torch.models import TransformerLM, lm_generate
    from chainermn_tpu_torch.serving import DecodeEngine, Scheduler

    rng = np.random.RandomState(seed + 3)
    reqs = draw_requests(rng, 8, FULL["vocab"], new=(32, 32))
    num_blocks, max_blocks = engine_geometry(reqs)
    model = TransformerLM(**FULL, dtype=torch.float32, device=dev,
                          seed=seed)
    eng = DecodeEngine(model, num_blocks=num_blocks,
                       max_blocks_per_slot=max_blocks, device=dev, **ENGINE)
    got = {c.id: c.tokens for c in Scheduler(eng).run(reqs)}
    lens = [len(r.prompt) for r in reqs]
    prompt = np.zeros((len(reqs), max(lens)), np.int64)
    for i, r in enumerate(reqs):
        prompt[i, :lens[i]] = r.prompt
    want = lm_generate(model, torch.from_numpy(prompt).to(dev), 32,
                       prompt_lengths=torch.tensor(lens)).cpu().tolist()
    first_div = []
    for i, r in enumerate(reqs):
        d = next((j for j, (x, y) in enumerate(zip(got[r.id], want[i]))
                  if x != y), None)
        first_div.append(d)
    exact = sum(d is None for d in first_div)
    diverged = [d for d in first_div if d is not None]
    row = dict(phase="agreement", dtype="float32", requests=len(reqs),
               exact=exact, first_divergence=first_div)
    emit(row)
    check(exact * 2 >= len(reqs) and all(d >= 8 for d in diverged),
          f"engine vs lm_generate (fp32): {exact}/{len(reqs)} exact, first "
          f"divergences {first_div}; a near-tie flips late, a bug early")
    return row


# ------------------------------------------------------- decoding slice
#: the decode benchmark's default model (benchmarks/decode.py:45-53:
#: learned positions, bf16) with the fused decode kernel; batch 8, prompt
#: 128, and 64 new tokens (the bench's 512 cut to 64, as in phase 6).
DECODE = dict(vocab=32768, n_layers=12, d_model=768, n_heads=12, d_ff=3072,
              decode_attention="fused")
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 8, 128, 64
#: the decode bench's ``--speculative 4 --draft-mode distilled`` arm: a
#: draft of the target's first layers // 6 = 2 blocks.
SPEC_K, DRAFT_LAYERS = 4, 2
#: the long-context bench's window (benchmarks/longcontext.py:34) and a
#: generation long enough that the ring wraps; the fp32 check generates
#: past the window.
#: The prompt's 128 positions and 896 new tokens fill the window: 1024
#: new tokens run the last 128 steps on a wrapped ring.  The fp32 check
#: starts from a 960-token prompt, so that its 128 new tokens run the
#: last 64 on a wrapped ring.
ROLL_WINDOW, ROLL_NEW = 1024, 1024
ROLL_CHECK_PROMPT, ROLL_CHECK_NEW = 960, 128
#: benchmarks/moe.py's MoE model (:26-37, :165-170) at its cf = 1.25 arm.
MOE = dict(vocab=32768, n_layers=12, d_model=768, n_heads=12, d_ff=1536,
           max_len=2048, n_experts=8, moe_k=2, moe_capacity_factor=1.25)
MOE_BATCH, MOE_CHUNK = 8, 8192
DECODE_CUTS = ["n_new 64 (the decode bench runs 512)", "random weights"]


def zero_decode_counts(ops, dev):
    torch.cuda.synchronize()
    ops.paged_decode_attention.launches = 0
    ops.fused_decode_attention.launches = 0
    ops.zero_kernel_runs(dev)


def decode_counts(ops, dev, label):
    """The decode kernels' launches since :func:`zero_decode_counts`, as
    the card counted them, checked against the wrappers' counts."""
    wrapper = {"paged_decode_attention": ops.paged_decode_attention.launches,
               "fused_decode_attention": ops.fused_decode_attention.launches}
    runs = ops.kernel_runs(dev)
    check(runs == wrapper, f"{label}: the card counted {runs} kernel runs, "
          f"the wrappers {wrapper} launches")
    check(runs["paged_decode_attention"] == 0,
          f"{label}: the paged kernel ran")
    return runs


def decode_prompt(seed, dev, vocab):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(
        0, vocab, size=(DECODE_BATCH, DECODE_PROMPT))).to(dev)


def timed(fn):
    """``fn()``'s result and its wall seconds, up to a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profiled_device_ms(fn):
    """Device ms of the kernels ``fn()`` launches, by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ms for _, ms, _ in device_kernels(prof))


def sequence_logprob(model, prompt, toks):
    """Each row's summed log-probability of ``toks`` after ``prompt``,
    from one full (training-path) forward: independent of the decode
    path."""
    with torch.no_grad():
        logits = model(torch.cat([prompt, toks.long()], dim=1))
    P, N = prompt.shape[1], toks.shape[1]
    logp = torch.log_softmax(logits[:, P - 1:P + N - 1].float(), dim=-1)
    return logp.gather(-1, toks.long()[..., None])[..., 0].sum(dim=1)


def phase_beam(ops, dev, card, seed):
    """``lm_beam_search`` (beam 4) on the decode benchmark's model: 32
    rows through K5 per step.  Then the same weights in fp32: beam 1
    equals ``lm_generate`` token for token, and each search's score is
    the summed log-probability of the tokens it returned, taken from one
    full forward (|err| <= 1e-5 |ref| + 1e-4: fp32 sums of 64 terms in
    another order).  Beam 4's best is compared with greedy's per row and
    reported, not checked: beam search does not bound it from below (the
    greedy prefix can fall out of the beam), and the JAX package's search
    scores below greedy on some rows too (``tests/test_torch_decoding.py``
    ``test_beam_search_can_score_below_greedy``)."""
    from chainermn_tpu_torch.models import (
        TransformerLM,
        lm_beam_search,
        lm_generate,
    )
    from chainermn_tpu_torch.models.decoding import reorder_cache

    B, P, N, K = DECODE_BATCH, DECODE_PROMPT, DECODE_NEW, 4
    L = DECODE["n_layers"]
    cfg = dict(DECODE, max_len=P + N)
    prompt = decode_prompt(seed + 20, dev, DECODE["vocab"])
    model = TransformerLM(**cfg, device=dev, seed=seed)
    lm_beam_search(model, prompt[:, :16], 3, beam=K)  # warm-up
    zero_decode_counts(ops, dev)
    (toks, scores), wall = timed(lambda: lm_beam_search(model, prompt, N,
                                                        beam=K))
    launches = decode_counts(ops, dev, "beam")
    check(launches["fused_decode_attention"] == (N - 1) * L,
          f"beam: the fused kernel ran {launches} times, expected "
          f"{N - 1} steps x {L} layers")
    check(tuple(toks.shape) == (B, N)
          and bool(((toks >= 0) & (toks < cfg["vocab"])).all())
          and bool(torch.isfinite(scores).all()),
          "beam: tokens outside the vocab or non-finite scores")
    # One step's reorder of every layer's cache, 32 rows of a 192-slot
    # bf16 cache, under the profiler.
    cache = model.init_cache(B * K, P + N)
    g = torch.Generator().manual_seed(seed)
    parent = (torch.arange(B)[:, None] * K
              + torch.randint(0, K, (B, K), generator=g)).reshape(-1).to(dev)
    reorder_cache(cache, parent)
    reorder_ms = profiled_device_ms(lambda: reorder_cache(cache, parent))
    cache_bytes = sum(t.numel() * t.element_size() for c in cache
                      for t in c.values())
    del cache, model
    m32 = TransformerLM(**cfg, dtype=torch.float32, device=dev, seed=seed)
    b1, s1 = lm_beam_search(m32, prompt, N, beam=1)
    greedy = lm_generate(m32, prompt, N)
    b4, s4 = lm_beam_search(m32, prompt, N, beam=K)
    greedy_lp = sequence_logprob(m32, prompt, greedy)
    beam_lp = sequence_logprob(m32, prompt, b4)

    def score_err(got, ref):
        return ((got - ref).abs() - 1e-5 * ref.abs()).max().item()
    row = dict(phase="beam", card=card, batch=B, prompt=P, new_tokens=N,
               beam=K, rows=B * K, cuts=DECODE_CUTS, wall_s=wall,
               tokens_per_s=B * N / wall, launches=launches,
               reorder_device_ms_per_step=reorder_ms,
               reorder_bytes_per_step=2 * cache_bytes,
               fp32=dict(beam1_equals_greedy=bool(torch.equal(b1, greedy)),
                         beam1_score=s1.tolist(),
                         greedy_full_forward_logprob=greedy_lp.tolist(),
                         beam4_score=s4.tolist(),
                         beam4_full_forward_logprob=beam_lp.tolist(),
                         score_excess=[score_err(s1, greedy_lp),
                                       score_err(s4, beam_lp)],
                         score_tolerance={"rtol": 1e-5, "atol": 1e-4},
                         rows_beam4_at_least_greedy=int(
                             (s4 >= greedy_lp).sum())))
    emit(row)
    check(torch.equal(b1, greedy), "beam: beam 1 differs from lm_generate "
          "in fp32")
    check(max(row["fp32"]["score_excess"]) <= 1e-4,
          f"beam: search scores {s1.tolist()} / {s4.tolist()} differ from "
          f"the full forward's {greedy_lp.tolist()} / {beam_lp.tolist()}")
    del m32
    torch.cuda.empty_cache()
    return row


def distilled_pair(dev, seed, dtype):
    """The decode bench's distilled draft: the target's blocks past
    ``DRAFT_LAYERS`` write nothing back (``proj`` and ``ff2`` zeroed), so
    its function is its first blocks', which with the embeddings,
    positions, ``ln_f`` and the head are the draft."""
    from chainermn_tpu_torch.models import TransformerLM

    cfg = dict(DECODE, max_len=DECODE_PROMPT + DECODE_NEW + SPEC_K + 1)
    target = TransformerLM(**cfg, dtype=dtype, device=dev, seed=seed)
    with torch.no_grad():
        for blk in target.blocks[DRAFT_LAYERS:]:
            for lin in (blk.proj, blk.ff2):
                lin.weight.zero_()
                lin.bias.zero_()
    draft = TransformerLM(**{**cfg, "n_layers": DRAFT_LAYERS}, dtype=dtype,
                          device=dev, seed=seed)
    draft.load_state_dict({
        n: t for n, t in target.state_dict().items()
        if not n.startswith("blocks.") or int(n.split(".")[1]) < DRAFT_LAYERS})
    return target, draft


def divergence(a, b):
    """Per-row first divergence of two generations (None: equal), as
    ``benchmarks/decode.py``'s ``_divergence_stats``."""
    firsts = []
    for x, y in zip(a.tolist(), b.tolist()):
        firsts.append(next((j for j, (u, v) in enumerate(zip(x, y))
                            if u != v), None))
    div = [f for f in firsts if f is not None]
    return dict(rows_exact=len(firsts) - len(div), rows=len(firsts),
                first_divergence_per_row=firsts,
                min_first_divergence=min(div) if div else None)


def phase_speculative(ops, dev, card, seed):
    """The decode bench's ``--speculative 4 --draft-mode distilled`` arm:
    greedy speculative generation against ``lm_generate`` of the same
    target, K5 counted on the card (draft layers x (k + 1) per round, the
    backfill forward being the + 1); one sampled drive; then in fp32 the
    tokens must equal the target's greedy generation."""
    from chainermn_tpu_torch.models import (
        lm_generate,
        lm_speculative_generate,
    )

    B, P, N, k = DECODE_BATCH, DECODE_PROMPT, DECODE_NEW, SPEC_K
    prompt = decode_prompt(seed + 21, dev, DECODE["vocab"])
    target, draft = distilled_pair(dev, seed, torch.bfloat16)
    lm_generate(target, prompt[:, :16], 3)  # warm-up
    lm_speculative_generate(target, draft, prompt[:, :16], 6, k=k)
    plain, plain_wall = timed(lambda: lm_generate(target, prompt, N))
    zero_decode_counts(ops, dev)
    (toks, fwd), wall = timed(lambda: lm_speculative_generate(
        target, draft, prompt, N, k=k))
    launches = decode_counts(ops, dev, "speculative")
    rounds = fwd - 1
    want = DRAFT_LAYERS * (k + 1) * rounds
    check(launches["fused_decode_attention"] == want,
          f"speculative: the fused kernel ran {launches}, expected "
          f"{DRAFT_LAYERS} draft layers x (k + 1) x {rounds} rounds")
    g = torch.Generator(device=dev).manual_seed(seed)
    sampled, sampled_fwd = lm_speculative_generate(
        target, draft, prompt, N, k=k, temperature=1.0, generator=g)
    check(tuple(sampled.shape) == (B, N)
          and bool(((sampled >= 0) & (sampled < DECODE["vocab"])).all()),
          "speculative: the sampled drive emitted a token outside the vocab")
    del target, draft
    t32, d32 = distilled_pair(dev, seed, torch.float32)
    toks32, fwd32 = lm_speculative_generate(t32, d32, prompt, N, k=k)
    greedy32 = lm_generate(t32, prompt, N)
    row = dict(phase="speculative", card=card, batch=B, prompt=P,
               new_tokens=N, k=k, draft_layers=DRAFT_LAYERS,
               draft=f"distilled (the target's first {DRAFT_LAYERS} of "
                     f"{DECODE['n_layers']} blocks; the others write "
                     "nothing back)", cuts=DECODE_CUTS,
               target_forwards=fwd, rounds=rounds,
               plain_sequential_steps=N,
               tokens_per_target_forward=N / fwd,
               mean_accepted_per_round=(N - 1) / max(rounds, 1) - 1.0,
               wall_s=wall, tokens_per_s=B * N / wall,
               plain_wall_s=plain_wall, plain_tokens_per_s=B * N / plain_wall,
               speedup_vs_plain=plain_wall / wall,
               matches_target_greedy=bool(torch.equal(toks, plain)),
               greedy_tie_divergence=divergence(toks, plain),
               launches=launches,
               sampled=dict(temperature=1.0, target_forwards=sampled_fwd),
               fp32=dict(target_forwards=fwd32,
                         equals_greedy=bool(torch.equal(toks32, greedy32)),
                         divergence=divergence(toks32, greedy32)))
    emit(row)
    check(torch.equal(toks32, greedy32),
          "speculative: fp32 tokens differ from the target's greedy run")
    del t32, d32
    torch.cuda.empty_cache()
    return row


def phase_rolling(ops, dev, card, seed):
    """``lm_generate(rolling=True)`` on the decode model's widths with a
    1024-position window, RoPE and the einsum cache: 1024 new tokens
    after a 128-token prompt, so that the ring wraps.  Every decode step's
    cache must be the W-slot ring; no decode kernel runs.  In fp32 the
    tokens must equal the full cache's over 128 new tokens after a
    960-token prompt (the ring wraps for the last 64)."""
    from chainermn_tpu_torch.models import TransformerLM, lm_generate

    B, P, W = DECODE_BATCH, DECODE_PROMPT, ROLL_WINDOW
    cfg = dict(DECODE, decode_attention="einsum", pos_enc="rope", window=W,
               max_len=P + ROLL_NEW)
    prompt = decode_prompt(seed + 22, dev, DECODE["vocab"])
    model = TransformerLM(**cfg, device=dev, seed=seed)
    lm_generate(model, prompt[:, :16], 3, rolling=True)  # warm-up
    seen = set()

    def hook(_, args, kwargs):  # block 0's cache at each decode step
        c = args[1]
        if args[0].shape[1] == 1:
            seen.add((tuple(c["k"].shape), tuple(c["v"].shape),
                      sum(t.numel() * t.element_size() for t in c.values())))

    handle = model.blocks[0].register_forward_pre_hook(hook, with_kwargs=True)
    zero_decode_counts(ops, dev)
    out, wall = timed(lambda: lm_generate(model, prompt, ROLL_NEW,
                                          rolling=True))
    launches = decode_counts(ops, dev, "rolling")
    handle.remove()
    KH, Dh = model.kv_heads, model.head_dim
    ring = (B, W, KH, Dh)
    want_bytes = B * W * KH * Dh * 2 * torch.tensor(
        [], dtype=model.dtype).element_size()
    check(seen == {(ring, ring, want_bytes)},
          f"rolling: decode steps saw caches {seen}, expected the ring "
          f"{ring} of {want_bytes} bytes per layer")
    check(launches["fused_decode_attention"] == 0,
          "rolling: the fused kernel ran")
    check(tuple(out.shape) == (B, ROLL_NEW)
          and bool(((out >= 0) & (out < cfg["vocab"])).all()),
          "rolling: tokens outside the vocab")
    del model
    m32 = TransformerLM(**cfg, dtype=torch.float32, device=dev, seed=seed)
    long = torch.from_numpy(np.random.RandomState(seed + 23).randint(
        0, DECODE["vocab"], size=(B, ROLL_CHECK_PROMPT))).to(dev)
    ring32 = lm_generate(m32, long, ROLL_CHECK_NEW, rolling=True)
    full32 = lm_generate(m32, long, ROLL_CHECK_NEW)
    row = dict(phase="rolling", card=card, batch=B, prompt=P,
               new_tokens=ROLL_NEW, window=W, cuts=["random weights"],
               wall_s=wall, tokens_per_s=B * ROLL_NEW / wall,
               cache_shape=list(ring), cache_bytes_per_layer=want_bytes,
               full_cache_bytes_per_layer=want_bytes * (P + ROLL_NEW) // W,
               launches=launches,
               fp32=dict(prompt=ROLL_CHECK_PROMPT, new_tokens=ROLL_CHECK_NEW,
                         equals_full_cache=bool(torch.equal(ring32, full32)),
                         divergence=divergence(ring32, full32)))
    emit(row)
    check(torch.equal(ring32, full32),
          "rolling: fp32 ring tokens differ from the full cache's")
    del m32
    torch.cuda.empty_cache()
    return row


def phase_moe_generation(ops, dev, card, seed):
    """``lm_generate`` of benchmarks/moe.py's MoE model on the fused
    decode path: K5 once per layer per step, the share of routings the
    prefill and a decode step drop (batch 8, one token per row: groups of
    8, capacity 3 per expert, as in the JAX package).  In fp32: the decode
    prefill's logits equal the full forward's (the same token groups,
    so the same routing), and at ample capacity single-token decode steps
    reproduce the full forward (``test_moe_lm.py``'s property)."""
    from chainermn_tpu_torch.models import (
        TransformerLM,
        lm_generate,
        moe_stats,
    )

    B, P, N = DECODE_BATCH, DECODE_PROMPT, DECODE_NEW
    L = MOE["n_layers"]
    prompt = decode_prompt(seed + 23, dev, MOE["vocab"])
    model = TransformerLM(**MOE, decode_attention="fused", device=dev,
                          seed=seed)
    lm_generate(model, prompt[:, :16], 3)  # warm-up
    with torch.no_grad():
        cache = model.init_cache(B, P + 1)
        logits, _ = model(prompt, cache=cache, decode_pos=0)
        drop_prefill = float(moe_stats(model)[1])
        model(logits[:, -1].argmax(-1)[:, None], cache=cache, decode_pos=P)
        drop_step = float(moe_stats(model)[1])
    zero_decode_counts(ops, dev)
    out, wall = timed(lambda: lm_generate(model, prompt, N))
    launches = decode_counts(ops, dev, "moe_generation")
    check(launches["fused_decode_attention"] == (N - 1) * L,
          f"moe_generation: the fused kernel ran {launches}, expected "
          f"{N - 1} steps x {L} layers")
    check(tuple(out.shape) == (B, N)
          and bool(((out >= 0) & (out < MOE["vocab"])).all()),
          "moe_generation: tokens outside the vocab")
    del model, cache
    m32 = TransformerLM(**MOE, decode_attention="fused",
                        dtype=torch.float32, attention="xla", device=dev,
                        seed=seed)
    with torch.no_grad():
        full = m32(prompt)
        pre, _ = m32(prompt, cache=m32.init_cache(B, P), decode_pos=0)
        prefill_err = (pre - full).abs().max().item()
        ample = TransformerLM(**{**MOE, "moe_capacity_factor": float(
            MOE["n_experts"])}, decode_attention="fused",
            dtype=torch.float32, attention="xla", device=dev, seed=seed)
        T = min(32, P)
        full = ample(prompt[:, :T])
        c = ample.init_cache(B, T)
        steps = torch.stack([ample(prompt[:, i:i + 1], cache=c,
                                   decode_pos=i)[0][:, 0]
                             for i in range(T)], dim=1)
        step_err = (steps - full).abs().max().item()
    row = dict(phase="moe_generation", card=card, batch=B, prompt=P,
               new_tokens=N, cuts=DECODE_CUTS + [
                   "no trained MoE checkpoint: random weights"],
               wall_s=wall, tokens_per_s=B * N / wall,
               moe_dropped_prefill=drop_prefill,
               moe_dropped_decode_step=drop_step, launches=launches,
               fp32=dict(prefill_vs_full_max_abs=prefill_err,
                         ample_steps_vs_full_max_abs=step_err, atol=1e-4))
    emit(row)
    check(prefill_err <= 1e-4 and step_err <= 1e-4,
          f"moe_generation: fp32 decode logits differ from the full "
          f"forward by {prefill_err} (prefill), {step_err} (steps)")
    del m32, ample
    torch.cuda.empty_cache()
    return row


def moe_trace(step, state, batch):
    """One MoE training step under ``torch.profiler``, device ms by group:
    every kernel launched inside a block's MoE FFN (dispatch, experts,
    combine, the routing) in ``moe_ffn`` -- its forward, its recompute
    under remat, and the backward nodes its forward ops made (matched by
    autograd sequence number) -- the rest by :func:`lm_group`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from chainermn_tpu_torch.models.transformer import DecoderBlock

    inner = DecoderBlock.moe_ffn

    def ranged(self, x):
        with record_function("moe_ffn"):
            return inner(self, x)

    DecoderBlock.moe_ffn = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        DecoderBlock.moe_ffn = inner
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]

    def under(e, pred):
        while e is not None:
            if pred(e):
                return True
            e = e.cpu_parent
        return False

    seqs = {e.sequence_nr for e in events if e.sequence_nr >= 0
            and under(e, lambda x: x.name == "moe_ffn")}

    def moe(x):
        return x.name == "moe_ffn" or (
            x.name.startswith("autograd::engine::evaluate_function")
            and x.sequence_nr in seqs)

    backward_nodes = sum(x.name.startswith("autograd::engine::evaluate_"
                                           "function") and moe(x)
                         for x in events)
    groups, kernels = {}, {}
    for e in events:
        for kern in e.kernels:
            grp = "moe_ffn" if under(e, moe) else lm_group(kern.name)
            groups[grp] = groups.get(grp, 0.0) + kern.duration / 1e3
            kernels[kern.name] = kernels.get(kern.name, 0.0) \
                + kern.duration / 1e3
    device_ms = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return dict(loss=loss, wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, groups_ms=groups,
                moe_backward_nodes=backward_nodes,
                top=[dict(name=n[:100], ms=ms) for n, ms in top])


def phase_moe_training(fa, dev, card, seed):
    """benchmarks/moe.py's cf = 1.25 arm at its training geometry (batch
    8, seq 2048, remat, flash attention, ``lm_loss_chunked`` with chunk
    8192, targets = tokens, a bf16 gradient wire) through
    ``create_communicator`` -> ``create_multi_node_optimizer`` ->
    ``make_train_step``: 2 warm-up and 5 timed steps, K1/K2/K3 24/12/12
    per step, one more step traced; then a small fp32 model holds
    ``lm_loss_chunked`` against ``lm_loss`` on the same weights."""
    import gc

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import (
        TransformerLM,
        lm_loss,
        lm_loss_chunked,
    )
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )

    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(
        0, MOE["vocab"], size=(MOE_BATCH, MOE["max_len"]))).to(dev)
    batch = (toks, toks)
    L = MOE["n_layers"]
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L,
            "flash_attention_bwd_dq": L}

    def arm(capture):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = TransformerLM(**MOE, attention="flash", remat=True,
                              device=dev, seed=seed)
        opt = create_multi_node_optimizer(adamw(3e-4), comm)
        state = opt.init(model)
        step = opt.make_train_step(
            lm_loss_chunked(model, chunk_size=MOE_CHUNK), has_aux=True,
            capture=capture)
        losses, aux, dropped = [], [], []

        def one():
            nonlocal state
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))  # syncs: step done
            aux.append(float(metrics["moe_aux"]))
            dropped.append(float(metrics["moe_dropped"]))

        for _ in range(2):
            one()
        torch.cuda.synchronize()
        reset_flash(fa)
        r0 = replays_of(step)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            one()
            times.append(time.perf_counter() - t0)
        launches = step_launches(step, flash_launches(fa),
                                 replays_of(step) - r0)
        out = dict(model=model, losses=losses, aux=aux, dropped=dropped,
                   launches=launches,
                   step_ms=sorted(times)[len(times) // 2] * 1e3,
                   times=[t * 1e3 for t in times],
                   peak=torch.cuda.max_memory_allocated())
        if capture is None:
            # The kernels of one replay, counted from its profile.
            _, out["traced"] = traced_step(
                "moe_training captured", None, step, state, batch, want)
            step.release()
        else:
            # The eager step's trace groups the MoE FFNs' kernels by the
            # host ops that launched them.
            emit({"phase": "moe_training_trace", "card": card,
                  **moe_trace(step, state, batch)})
        return out

    cap = arm(None)
    model = cap.pop("model")
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = sum(p.numel() for n, p in model.named_parameters()
                   if ".moe_" in n)
    del model
    eager = arm(False)
    del eager["model"]
    per_step = {k: v / 5 for k, v in cap["launches"].items()}
    row = dict(phase="moe_training", card=card, params=n_params,
               expert_params=n_expert, batch=list(toks.shape),
               experts=MOE["n_experts"], k=MOE["moe_k"],
               capacity_factor=MOE["moe_capacity_factor"],
               chunk_size=MOE_CHUNK, cuts=[
                   "AdamW 3e-4 (the bench runs adafactor, not ported)",
                   "only the bench's cf 1.25 arm of its 1.0/1.25/2.0 sweep",
                   "random weights"],
               losses=cap["losses"], step_ms_median=cap["step_ms"],
               step_ms_runs=cap["times"],
               tokens_per_s=toks.numel() / (cap["step_ms"] / 1e3),
               peak_memory_gb=cap["peak"] / 1e9, moe_aux=cap["aux"],
               moe_dropped=cap["dropped"], launches=cap["launches"],
               launches_per_step=per_step,
               launches_per_replay_profiled=cap["traced"],
               eager=dict(step_ms_median=eager["step_ms"],
                          step_ms_runs=eager["times"],
                          losses=eager["losses"],
                          peak_memory_gb=eager["peak"] / 1e9,
                          launches_per_step={
                              k: v / 5
                              for k, v in eager["launches"].items()}),
               captured_over_eager_step_ratio=cap["step_ms"]
               / eager["step_ms"])
    gc.collect()
    torch.cuda.empty_cache()
    row["fp32_chunked_check"] = chunked_check(dev, seed)
    emit(row)
    check(all(math.isfinite(x)
              for x in cap["losses"] + cap["aux"] + cap["dropped"]),
          f"moe_training: non-finite losses {cap['losses']} or statistics")
    check(per_step == want and row["eager"]["launches_per_step"] == want,
          f"moe_training: flash launches per step {per_step} (eager "
          f"{row['eager']['launches_per_step']}), expected {want} "
          f"({L} layers, remat)")
    c = row["fp32_chunked_check"]
    check(c["loss_rel_diff"] <= 1e-5 and c["grad_max_abs_diff"] <= 1e-5,
          f"moe_training: lm_loss_chunked vs lm_loss (fp32): {c}")
    moe32 = dict(MOE, n_layers=2, d_model=128, n_heads=4, d_ff=256,
                 vocab=1000, max_len=256)
    g = np.random.RandomState(seed + 31)
    batches = [(torch.from_numpy(t).to(dev),) * 2 for t in
               (g.randint(0, 1000, size=(4, 256)) for _ in range(3))]

    def make():
        m = TransformerLM(**moe32, dtype=torch.float32, attention="flash",
                          remat=True, device=dev, seed=seed)
        return (m, create_multi_node_optimizer(adamw(1e-3), comm32),
                lm_loss_chunked(m, chunk_size=384), dict(has_aux=True))

    comm32 = create_communicator("xla", device=dev)
    capture_agreement("moe", capture_pair(make, batches))
    return row


def chunked_check(dev, seed):
    """``lm_loss_chunked`` (chunk 384 over vocab 1000: a ragged tail of
    232) against ``lm_loss`` on one small fp32 MoE model: the loss and
    every gradient."""
    from chainermn_tpu_torch.models import (
        TransformerLM,
        lm_loss,
        lm_loss_chunked,
    )

    model = TransformerLM(vocab=1000, n_layers=2, d_model=128, n_heads=4,
                          d_ff=256, max_len=256, n_experts=4,
                          dtype=torch.float32, attention="flash", device=dev,
                          seed=seed)
    rng = np.random.RandomState(seed + 6)
    toks = torch.from_numpy(rng.randint(0, 1000, size=(4, 256))).to(dev)
    tgts = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], -1)], dim=1)
    out = {}
    for name, fn in (("full", lm_loss(model)),
                     ("chunked", lm_loss_chunked(model, chunk_size=384))):
        model.zero_grad(set_to_none=True)
        loss, _ = fn(model, (toks, tgts))
        loss.backward()
        out[name] = (loss.item(), {n: p.grad.clone()
                                   for n, p in model.named_parameters()})
    (lf, gf), (lc, gc_) = out["full"], out["chunked"]
    return dict(loss_full=lf, loss_chunked=lc,
                loss_rel_diff=abs(lc - lf) / abs(lf),
                grad_max_abs_diff=max((gc_[n] - gf[n]).abs().max().item()
                                      for n in gf),
                tolerance={"loss_rtol": 1e-5, "grad_atol": 1e-5})


# ------------------------------------------------------------ flash parity
#: Tolerances of the flash kernels against their plain versions, element by
#: element: |got - want| <= rtol * |want| + atol * rms(row of want), the row
#: being the head-dim vector (of o, dq, dk or dv) that holds the element.
#: rtol covers each side's rounding of its output to the input dtype (bf16:
#: two roundings, 2^-7); atol covers the error inside the sums, which scales
#: with the row, not with the element (fp32: sums in another order; bf16: P
#: and dS rounded to bf16 as tensor-core operands, unit roundoff 2^-8).
#: lse is fp32 on both sides: |got - want| <= rtol * |want| + atol.
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
             torch.bfloat16: dict(rtol=2 ** -7, atol=3e-2),
             "lse": dict(rtol=1e-5, atol=1e-5)}


def excess(got, want, rtol, rows=True):
    """The least atol with which every element meets its tolerance
    (``FLASH_TOL``): max of (|got - want| - rtol |want|) over the RMS of
    the reference's row (``rows``) or over 1.  A row whose reference is
    all zero must match exactly."""
    got, want = got.float(), want.float()
    slack = (got - want).abs() - rtol * want.abs()
    if rows:
        rms = want.pow(2).mean(-1, keepdim=True).sqrt()
        slack = torch.where(slack > 0, slack / rms, torch.zeros_like(slack))
    return max(slack.max().item(), 0.0)


def seg_runs(rows, T):
    """Segment ids ``(len(rows), T)`` from per-row (id, length) runs."""
    out = torch.zeros((len(rows), T), dtype=torch.int32)
    for r, runs in enumerate(rows):
        at = 0
        for sid, n in runs:
            out[r, at:at + n] = sid
            at += n
    return out


# name -> (B, T, S, H, KH, kwargs of flash_attention_lse)
FLASH_CASES = {
    "causal": (2, 256, 256, 4, 4, dict(causal=True)),
    "noncausal": (2, 192, 192, 4, 4, dict()),
    "window": (2, 256, 256, 4, 4, dict(causal=True, window=48)),
    "packed_fully_masked": (2, 200, 200, 4, 4, dict(
        segment_ids=seg_runs([[(1, 70), (9, 60), (2, 70)], [(3, 200)]], 200),
        kv_segment_ids=seg_runs([[(1, 100), (2, 100)],
                                 [(3, 150), (0, 50)]], 200))),
    "cross_kv_segments": (2, 96, 160, 4, 4, dict(
        segment_ids=seg_runs([[(1, 50), (2, 46)], [(1, 96)]], 96),
        kv_segment_ids=seg_runs([[(1, 80), (2, 70), (0, 10)],
                                 [(1, 150), (0, 10)]], 160))),
    "gqa_12_4": (1, 256, 256, 12, 4, dict(causal=True)),
    "mqa": (1, 192, 192, 4, 1, dict(causal=True, window=40)),
    "ragged_1000": (1, 1000, 1000, 2, 2, dict(causal=True)),
    # The wgmma kernels' tile edges (q tiles of 128 and 64, kv tiles of
    # 128): lengths just under, at and over a tile, S != T both ways, a
    # window and segment boundaries inside a tile, GQA and MQA.
    "tile_127": (2, 127, 127, 4, 4, dict(causal=True)),
    "tile_128": (1, 128, 128, 4, 2, dict(causal=True)),
    "tile_129": (2, 129, 129, 4, 4, dict()),
    "cross_s_over_t": (2, 129, 300, 4, 4, dict()),
    "cross_t_over_s": (2, 300, 127, 4, 4, dict()),
    "window_straddles_tile": (1, 384, 384, 4, 4, dict(causal=True,
                                                       window=100)),
    "window_two_sided": (1, 320, 320, 2, 2, dict(window=70)),
    "gqa_12_4_ragged": (1, 200, 200, 12, 4, dict(causal=True)),
    "mqa_noncausal": (1, 129, 129, 6, 1, dict()),
    "packed_in_tile": (2, 300, 300, 4, 4, dict(
        causal=True, segment_ids=seg_runs(
            [[(1, 100), (2, 90), (3, 110)], [(5, 37), (6, 263)]], 300))),
    # T a multiple of no q tile (128) and S of no kv tile (128, or 64 in
    # dQ at D = 128), with segments on both sides and GQA.
    "ragged_both_segments": (2, 200, 333, 4, 2, dict(
        segment_ids=seg_runs([[(1, 90), (2, 110)], [(4, 200)]], 200),
        kv_segment_ids=seg_runs([[(1, 150), (2, 183)],
                                 [(4, 300), (0, 33)]], 333))),
}


def flash_case(fa, g, dev, spec, D, dtype):
    """Kernels through the autograd Function vs the plain versions at
    ``spec`` = (B, T, S, H, KH, kwargs): the ``excess`` of each output,
    whether fully masked rows are exact, how many there are, and whether
    every output is finite."""
    B, T, S, H, KH, kw = spec
    q, k, v = (torch.randn(shape, generator=g).to(dev, dtype)
               for shape in ((B, T, H, D), (B, S, KH, D), (B, S, KH, D)))
    do = torch.randn((B, T, H, D), generator=g).to(dev, dtype)
    dlse = torch.randn((B, H, T), generator=g).to(dev)
    kw = {key: (val.to(dev) if isinstance(val, torch.Tensor) else val)
          for key, val in kw.items()}
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = fa.flash_attention_lse(*qkv, **kw)
    dq, dk, dv = torch.autograd.grad((o, lse), qkv, (do, dlse))
    seg_q, seg_kv = fa._validate(q, k, v, kw.get("causal", False),
                                 kw.get("segment_ids"),
                                 kw.get("kv_segment_ids"), kw.get("window"))
    args = (seg_q, seg_kv, kw.get("causal", False), kw.get("window"))
    o_r, lse_r = fa.flash_attention_fwd_reference(q, k, v, *args)
    # The plain backward takes what K2 and K3 took: the kernel's lse, and
    # delta formed from the kernel's o as the autograd Function forms it.
    # (From the plain o, delta would differ by the two sides' bf16
    # roundings of o, which moves dq by up to ~0.2 of its row's RMS on
    # rows of few keys -- no fault of K2 or K3.)
    delta = ((do.float() * o.detach().float()).sum(-1).transpose(1, 2)
             - dlse).contiguous()
    lse_k = lse.detach()
    dk_r, dv_r = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse_k,
                                                      delta, *args)
    dq_r = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse_k, delta,
                                               *args)
    torch.cuda.synchronize()
    live = lse_r > -1e29
    rtol = FLASH_TOL[dtype]["rtol"]
    out = {"o": excess(o, o_r, rtol),
           "lse": excess(lse[live], lse_r[live], FLASH_TOL["lse"]["rtol"],
                         rows=False),
           "dq": excess(dq, dq_r, rtol), "dk": excess(dk, dk_r, rtol),
           "dv": excess(dv, dv_r, rtol)}
    dead = ~live
    out["dead_rows_exact"] = bool(
        (lse[dead] == -1e30).all() and (o.transpose(1, 2)[dead] == 0).all()
        and (dq.transpose(1, 2)[dead] == 0).all())
    out["dead_rows"] = int(dead.sum())
    out["finite"] = bool(all(torch.isfinite(t).all()
                             for t in (o, dq, dk, dv)))
    return out


def flash_main_shape():
    """(B, T, H, D) of the training path's attention."""
    return (LM_BATCH, LM["max_len"], LM["n_heads"],
            LM["d_model"] // LM["n_heads"])


def flash_main_inputs(g, dev):
    """The training path's shapes: q/k/v as views of one fused qkv
    projection output (the layout the model hands the kernels), and
    dO."""
    B, T, H, D = flash_main_shape()
    qkv = torch.randn((B, T, 3, H, D), generator=g).to(dev, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn((B, T, H, D), generator=g).to(dev, torch.bfloat16)
    return dict(q=q, k=k, v=v, do=do)


def flash_main_check(fa, g, dev):
    """Each kernel alone at the training path's shapes, the backward
    kernels fed the plain forward's lse and delta (the same on both sides,
    so each kernel is held alone; delta takes a random lse cotangent, as
    the autograd Function forms it)."""
    a = flash_main_inputs(g, dev)
    q, k, v, do = a["q"], a["k"], a["v"], a["do"]
    B, T, H, _ = q.shape
    dlse = torch.randn((B, H, T), generator=g).to(dev)
    o_r, lse_r = fa.flash_attention_fwd_reference(q, k, v, None, None, True)
    delta = ((do.float() * o_r.float()).sum(-1).transpose(1, 2)
             - dlse).contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v, None, None, True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse_r, delta, None,
                                        None, True)
    dk_r, dv_r = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse_r,
                                                      delta, None, None,
                                                      True)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_r, delta, None, None,
                                   True)
    dq_r = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse_r, delta,
                                               None, None, True)
    torch.cuda.synchronize()
    rtol = FLASH_TOL[torch.bfloat16]["rtol"]
    out = {}
    for kname, pairs in (
            ("flash_attention_fwd", (("o", o, o_r), ("lse", lse, lse_r))),
            ("flash_attention_bwd_dkv", (("dk", dk, dk_r), ("dv", dv, dv_r))),
            ("flash_attention_bwd_dq", (("dq", dq, dq_r),))):
        for out_name, got, want in pairs:
            lse_out = out_name == "lse"
            out[out_name] = dict(
                kernel=kname,
                excess=excess(got, want, FLASH_TOL["lse"]["rtol"] if lse_out
                              else rtol, rows=not lse_out),
                max_abs_err=(got.float() - want.float()).abs().max().item(),
                ref_max_abs=want.float().abs().max().item(),
                ref_rms=want.float().pow(2).mean().sqrt().item())
    return out


def phase_flash_parity(fa, dev, seed):
    """Every case, then the training path's shapes; the line is printed
    before any check, so a failing run still shows every reading."""
    g = torch.Generator().manual_seed(seed + 4)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for D in (32, 64, 128):
            for name in FLASH_CASES:
                rows.append({"case": name, "D": D, "dtype": dtype,
                             **flash_case(fa, g, dev, FLASH_CASES[name], D,
                                          dtype)})
    main = flash_main_check(fa, g, dev)
    emit({"phase": "flash_parity",
          "cases": [{**r, "dtype": str(r["dtype"]).replace("torch.", "")}
                    for r in rows],
          "tolerance": {"fp32": FLASH_TOL[torch.float32],
                        "bf16": FLASH_TOL[torch.bfloat16],
                        "lse": FLASH_TOL["lse"],
                        "measure": "excess = max over elements of (|err| - "
                                   "rtol |ref|) / rms(ref row); <= atol"},
          "main_shape": main})
    for r in rows:
        tol = FLASH_TOL[r["dtype"]]
        for key in ("o", "dq", "dk", "dv", "lse"):
            t = FLASH_TOL["lse"]["atol"] if key == "lse" else tol["atol"]
            check(r[key] <= t, f"flash case {r['case']} D{r['D']} "
                  f"{r['dtype']}: {key} excess {r[key]} > {t}")
        check(r["dead_rows_exact"], f"flash case {r['case']}: a fully "
              "masked row is not o = 0, lse = -1e30, dq = 0")
    worst = {}
    for out_name, m in main.items():
        t = FLASH_TOL["lse" if out_name == "lse" else torch.bfloat16]["atol"]
        check(m["excess"] <= t, f"{m['kernel']} at the training shapes: "
              f"{out_name} excess {m['excess']} > {t}")
        worst[m["kernel"]] = max(worst.get(m["kernel"], 0.0),
                                 m["max_abs_err"])
    return worst


# ------------------------------------------------------------ flash timing
def flash_bounds(B, T, H, D, itemsize=2):
    """Bytes and operations of each kernel at causal (B, T, H, D): each
    input read once and each output written once; 2 operations per
    multiply-add over the admitted (q, k) pairs -- two products in the
    forward, four in dK/dV, three in dQ (the score product recomputed)."""
    pairs = B * H * T * (T + 1) // 2
    x = B * T * H * D * itemsize  # one of q, k, v, dO, o, dq, dk, dv
    row = B * H * T * 4           # one fp32 per-row vector (lse, delta)
    return {
        "flash_attention_fwd": bound(4 * x + row, 4 * D * pairs,
                                     torch.bfloat16),
        "flash_attention_bwd_dkv": bound(6 * x + 2 * row, 8 * D * pairs,
                                         torch.bfloat16),
        "flash_attention_bwd_dq": bound(5 * x + 2 * row, 6 * D * pairs,
                                        torch.bfloat16),
    }


def sdpa_times(a):
    """SDPA forward, and forward + backward, on the kernels' inputs in
    SDPA's (B, H, T, D) layout.  Graph replay like the kernels; the
    backward is captured through autograd."""
    lib = {n: a[n].transpose(1, 2).contiguous().requires_grad_(True)
           for n in ("q", "k", "v")}
    lib["do"] = a["do"].transpose(1, 2).contiguous()
    copies = copies_for(lib)
    for c in copies[1:]:
        for n in ("q", "k", "v"):
            c[n] = c[n].detach().requires_grad_(True)

    def fwd(x):
        with torch.no_grad():
            return F.scaled_dot_product_attention(x["q"], x["k"], x["v"],
                                                  is_causal=True)

    def fwd_bwd(x):
        out = F.scaled_dot_product_attention(x["q"], x["k"], x["v"],
                                             is_causal=True)
        return torch.autograd.grad(out, (x["q"], x["k"], x["v"]), x["do"])

    return time_ms(fwd, copies, 50), time_ms(fwd_bwd, copies, 20), fwd(lib)


def phase_flash_timing(fa, dev, seed):
    B, T, H, D = flash_main_shape()
    g = torch.Generator().manual_seed(seed + 6)
    m = flash_main_inputs(g, dev)
    a = {n: m[n].contiguous() for n in ("q", "k", "v", "do")}
    o_r, lse = fa.flash_attention_fwd_reference(a["q"], a["k"], a["v"],
                                                None, None, True)
    a["lse"] = lse
    a["delta"] = (a["do"].float() * o_r.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    del o_r
    bounds = flash_bounds(B, T, H, D)
    f_ms, fb_ms, lib_o = sdpa_times(a)
    want = fa.flash_attention_fwd_reference(a["q"], a["k"], a["v"], None,
                                            None, True)[0]
    lib_err = (lib_o.transpose(1, 2).float() - want.float()).abs().max() \
        .item()
    check(lib_err <= 2e-2, f"SDPA yardstick disagrees: {lib_err}")
    del want, lib_o
    fwd_in = {n: a[n] for n in ("q", "k", "v")}
    calls = {
        "flash_attention_fwd": (
            fwd_in,
            lambda x: fa.flash_attention_fwd(x["q"], x["k"], x["v"], None,
                                             None, True),
            lambda x: fa.flash_attention_fwd_reference(
                x["q"], x["k"], x["v"], None, None, True)),
        "flash_attention_bwd_dkv": (
            a,
            lambda x: fa.flash_attention_bwd_dkv(
                x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                None, None, True),
            lambda x: fa.flash_attention_bwd_dkv_reference(
                x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                None, None, True)),
        "flash_attention_bwd_dq": (
            a,
            lambda x: fa.flash_attention_bwd_dq(
                x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                None, None, True),
            lambda x: fa.flash_attention_bwd_dq_reference(
                x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                None, None, True)),
    }
    out = {}
    for name, (inp, kernel, plain) in calls.items():
        copies = copies_for(inp)
        # Turns: plain, kernel, kernel, plain.
        p1 = time_ms(plain, copies, 3)
        k1 = time_ms(kernel, copies, 20)
        k2 = time_ms(kernel, copies, 20)
        p2 = time_ms(plain, copies, 3)
        k_eager = eager_ms(kernel, copies, 20)
        bound_ms, bound_by = bounds[name]
        lib_ms = f_ms if name == "flash_attention_fwd" else fb_ms - f_ms
        row = dict(kernel=name, kernel_ms=min(k1, k2),
                   kernel_ms_runs=[k1, k2], kernel_eager_ms=k_eager,
                   plain_ms=min(p1, p2), plain_ms_runs=[p1, p2],
                   library_ms=lib_ms,
                   library=("sdpa forward" if name == "flash_attention_fwd"
                            else "sdpa backward (fwd+bwd - fwd), covers "
                                 "dK/dV and dQ together"),
                   library_max_abs_err=lib_err,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_fraction=bound_ms / min(k1, k2),
                   shape=dict(B=B, T=T, H=H, KH=H, D=D, dtype="bfloat16",
                              causal=True),
                   copies=len(copies))
        emit({"phase": "flash_timing", **row})
        out[name] = row
        torch.cuda.empty_cache()
    return out


#: the crossover's sequence lengths; each at the LM step's token count.
CROSSOVER_T = (128, 256, 512, 1024, 2048, 4096)
CROSSOVER_TOKENS = LM_BATCH * LM["max_len"]


def crossover_min_seq(rows, causal):
    """The smallest measured T from which flash is at least as fast as
    the eager path at every longer measured T (None: flash loses at the
    longest)."""
    out = None
    for r in sorted((r for r in rows if r["causal"] == causal),
                    key=lambda r: -r["T"]):
        if r["flash_ms"] > r["xla_ms"]:
            break
        out = r["T"]
    return out


def phase_flash_crossover(fa, dev, seed, card):
    """K1-K3 forward + backward (through ``flash_attention``'s autograd
    Function) against the eager ``"xla"`` path (``reference_attention``:
    fp32 materialized scores, autograd's backward) at the LM's widths (12
    heads, Dh 64, bf16), T in ``CROSSOVER_T``, batch ``CROSSOVER_TOKENS //
    T`` (the LM step's tokens at every T), causal and not: device ms per
    forward + backward, each timed by CUDA-graph replay as the captured
    train step runs it, in turns xla, flash, flash, xla.  The lengths
    from which flash wins are what ``FLASH_MIN_SEQ`` /
    ``FLASH_MIN_SEQ_NONCAUSAL`` were set from."""
    H, D = LM["n_heads"], LM["d_model"] // LM["n_heads"]
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    rows = []
    for causal in (True, False):
        for T in CROSSOVER_T:
            B = max(1, CROSSOVER_TOKENS // T)

            def draw():
                return torch.randn((B, T, H, D), generator=g, device=dev,
                                   dtype=torch.bfloat16)

            inp = {n: draw().requires_grad_(True) for n in ("q", "k", "v")}
            inp["do"] = draw()
            copies = [inp] + [{n: (t.detach().clone().requires_grad_(True)
                                   if n != "do" else t.clone())
                               for n, t in inp.items()}]

            def run(attend):
                def f(x):
                    o = attend(x["q"], x["k"], x["v"], causal=causal)
                    return torch.autograd.grad(o, (x["q"], x["k"], x["v"]),
                                               x["do"])
                return f

            iters = max(2, min(6, 12288 // T))
            flash, xla = run(fa.flash_attention), run(fa.reference_attention)
            x1 = time_ms(xla, copies, iters)
            f1 = time_ms(flash, copies, iters)
            f2 = time_ms(flash, copies, iters)
            x2 = time_ms(xla, copies, iters)
            row = dict(T=T, B=B, causal=causal, flash_ms=min(f1, f2),
                       xla_ms=min(x1, x2), flash_ms_runs=[f1, f2],
                       xla_ms_runs=[x1, x2])
            row["xla_over_flash"] = row["xla_ms"] / row["flash_ms"]
            rows.append(row)
            del inp, copies
            torch.cuda.empty_cache()
    measured = {"causal": crossover_min_seq(rows, True),
                "noncausal": crossover_min_seq(rows, False)}
    constants = {"causal": fa.FLASH_MIN_SEQ,
                 "noncausal": fa.FLASH_MIN_SEQ_NONCAUSAL}
    emit({"phase": "flash_crossover", "card": card, "heads": H,
          "head_dim": D, "dtype": "bfloat16", "tokens": CROSSOVER_TOKENS,
          "rows": rows, "measured_min_seq": measured,
          "constants": constants,
          "agrees_with_constants": measured == constants})
    check(all(math.isfinite(r["flash_ms"]) and math.isfinite(r["xla_ms"])
              for r in rows), "flash_crossover: a time is not finite")
    return rows


# ---------------------------------------------------------------- training
def flash_launches(fa):
    return {k: getattr(fa, k).launches for k in FLASH}


def reset_flash(fa):
    for k in FLASH:
        getattr(fa, k).launches = 0


#: a substring of the name of each kernel's functions (bf16 and fp32), as
#: a profile lists them.
KERNEL_SYMBOLS = {"flash_attention_fwd": "flash_fwd",
                  "flash_attention_bwd_dkv": "flash_bwd_dkv",
                  "flash_attention_bwd_dq": "flash_bwd_dq",
                  "matmul_affine_fwd": "matmul_affine",
                  "paged_decode_attention": "decode_paged",
                  "fused_decode_attention": "decode_fused"}


def step_graph(step):
    """The one graph a captured train step holds (None: it ran
    eagerly)."""
    graphs = getattr(step, "graphs", None)
    if not graphs:
        return None
    check(len(graphs) == 1, f"train step: {len(graphs)} captures for one "
                            "batch signature")
    return next(iter(graphs.values()))


def replays_of(step):
    prog = getattr(step, "program", None)
    return prog.replays if prog is not None else 0


def step_launches(step, eager, replays):
    """Each kernel's launches in a stretch of steps: its wrapper's eager
    launches (``eager``, by kernel name) plus the step's ``replays`` x
    what its graph's capture recorded; the replays run the kernels
    without their wrappers."""
    graph = step_graph(step)
    return {k: v + (replays * graph.captured[k] if graph is not None
                    else 0) for k, v in eager.items()}


def lm_group(name):
    """Kernel groups of the LM training trace."""
    n = name.lower()
    if "flash_" in n:
        return "flash_kernels"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "matmul")):
        return "matrix_products"
    return "other"


#: Kernels (``torch.cuda._sleep``'s ``spin_kernel``) that ``trace_step``
#: launches and waits for inside each profile, before the step, between
#: a captured step's uncounted and counted replays, and after the step:
#: a profile can miss its first few kernel records (every trace of one
#: call read 3-7 kernels short, a K1 among the LM step's first ones),
#: and these take that loss instead of the step.  Device time orders a
#: profile's kernels, so the spin kernels also mark where each step
#: begins and ends.  Every count and time leaves them out.
PROFILE_LEAD_KERNELS = 16
PROFILE_LEAD_NAME = "spin_kernel"


def device_kernels(prof):
    """``(name, device ms, launches)`` of each kernel a profile saw,
    longest first.  Device-side events only: a host op's entry repeats
    the time of the kernels it launched."""
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        if PROFILE_LEAD_NAME in e.key:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            kernels.append((e.key, us / 1e3, e.count))
    return sorted(kernels, key=lambda k: -k[1])


def device_segments(prof):
    """The profile's kernels in device-time order, cut at the spin
    kernels: one list of ``(name, device ms)`` per stretch between
    them."""
    events = sorted((e for e in prof.events()
                     if getattr(e, "device_type", None)
                     == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    segments, cur = [], []
    for e in events:
        if PROFILE_LEAD_NAME in e.name:
            if cur:
                segments.append(cur)
            cur = []
        else:
            cur.append((e.name, e.time_range.elapsed_us() / 1e3))
    if cur:
        segments.append(cur)
    return segments


def segment_kernels(segment):
    """``(name, device ms, launches)`` of each kernel of one segment,
    longest first."""
    by = {}
    for name, ms in segment:
        t, c = by.get(name, (0.0, 0))
        by[name] = (t + ms, c + 1)
    return sorted(((n, t, c) for n, (t, c) in by.items()),
                  key=lambda k: -k[1])


def segment_counts(segment):
    """The port's kernels' runs in one segment, by kernel."""
    return {k: sum(sym in n for n, _ in segment)
            for k, sym in KERNEL_SYMBOLS.items()}


def spin(n=PROFILE_LEAD_KERNELS):
    """``n`` spin kernels, waited for."""
    torch.cuda.synchronize()
    for _ in range(n):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def trace_step(step, state, batch, group=lm_group, top=15):
    """One more training step under ``torch.profiler``: its loss, device
    time by kernel (self time, summed over launches), summed by ``group``
    of the kernel's name, and the device's busy share of the step's wall
    time (one stream, so kernel times do not overlap).  The profiler's own
    host cost stretches the wall time a little.

    A captured step is replayed twice under the profiler and only the
    second replay is counted: the first replay of a profile can lose
    kernel records (``warm_kernel_counts`` keeps what the profile saw of
    it).  ``kernel_counts`` is None when the spin kernels around the
    counted step did not show as expected (their records were lost)."""
    from torch.profiler import ProfilerActivity, profile

    warm = step_graph(step) is not None
    warm_loss = None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spin()
        if warm:
            state, metrics = step(state, batch)
            warm_loss = float(metrics["loss"])
            spin()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
        spin()
    segments = device_segments(prof)
    want = 2 if warm else 1
    counted = segments[-1] if len(segments) == want else []
    kernels = segment_kernels(counted)
    device_ms = sum(k[1] for k in kernels)
    groups = {}
    for name, ms, _ in kernels:
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    return dict(loss=loss, warm_loss=warm_loss, wall_ms=wall_ms,
                device_ms=device_ms,
                busy_share=device_ms / wall_ms if wall_ms else None,
                groups_ms=groups, kernel_launches=sum(k[2] for k in kernels),
                # The port's kernels counted from the profile (the card's
                # record of what ran, a replay included), by kernel.
                kernel_counts=segment_counts(counted)
                if len(segments) == want else None,
                warm_kernel_counts=segment_counts(segments[0])
                if warm and len(segments) == want else None,
                segments=len(segments),
                top=[dict(name=n[:100], ms=ms, launches=c, group=group(n))
                     for n, ms, c in kernels[:top]])


#: profiles of one step that ``traced_step`` may take.  The profiler can
#: lose kernel records of a graph replay, and never adds one: in one call
#: it counted ~3790 of the ~4450 kernels of a ResNet-50 replay and ~2145
#: of the ~2235 of an LM replay, 20 of its 24 K1 runs among them; in
#: another, three profiles in a row each counted 23 of the LM replay's 24
#: K1 runs, when the replay was the profile's first.
TRACE_ATTEMPTS = 3


def traced_step(label, row, step, state, batch, kernels, group=lm_group,
                top=15):
    """``trace_step`` of one more step, emitted with the fields ``row``
    (None: not emitted), then checked: the kernels the profile saw equal
    what the step's graph recorded at its capture (one replay), or, for an
    eager step, what its wrappers launched (``kernels``: expected counts
    by name).  A profile that counts fewer runs than that, or whose spin
    kernels did not show, lost records and is taken again, up to
    ``TRACE_ATTEMPTS`` profiles (the trace's ``short_profiles`` keeps
    their counts); one that counts more fails.  Returns
    ``(trace, counts)``."""
    graph = step_graph(step)
    want = {k: (graph.captured[k] if graph is not None else n)
            for k, n in kernels.items()}
    short = []
    for _ in range(TRACE_ATTEMPTS):
        trace = trace_step(step, state, batch, group=group, top=top)
        got = None
        if trace["kernel_counts"] is not None:
            got = {k: trace["kernel_counts"][k] for k in kernels}
            if got == want or any(got[k] > want[k] for k in want):
                break
        short.append(dict(counts=got, segments=trace["segments"]))
    trace["short_profiles"] = short
    if row is not None:
        emit({**row, **trace})
    check(got == want, f"{label}: the profile counted {got} kernel runs in "
                       f"one step, the step launches {want}")
    return trace, got


def train_arm(fa, dev, card, seed, impl, comm, batch, warmup=2, timed=5,
              capture=None):
    """``warmup`` + ``timed`` steps of the LM step, captured (the default
    on the card) or eager (``capture=False``), then one traced step."""
    import gc

    from chainermn_tpu_torch.models import TransformerLM, lm_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(**LM, attention=impl, remat=True, device=dev,
                          seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    opt = create_multi_node_optimizer(adamw(3e-4), comm)
    state = opt.init(model)
    step = opt.make_train_step(lm_loss(model), has_aux=True,
                               capture=capture)
    losses = []
    for _ in range(warmup):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    reset_flash(fa)
    replays0 = replays_of(step)
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # syncs: the step is done
        times.append(time.perf_counter() - t0)
    launches = step_launches(step, flash_launches(fa),
                             replays_of(step) - replays0)
    peak = torch.cuda.max_memory_allocated()
    captured = step_graph(step) is not None
    arm = "captured" if captured else "eager"
    trace, traced = traced_step(
        f"training {impl} {arm}",
        {"phase": "training_trace", "attention": impl, "arm": arm,
         "card": card}, step, state, batch,
        {k: v // timed for k, v in launches.items()})
    check(all(math.isfinite(x) for x in losses),
          f"training {impl}: non-finite loss {losses}")
    tokens = batch[0].numel()
    step_ms = sorted(times)[len(times) // 2] * 1e3
    row = dict(phase="training", attention=impl, arm=arm, card=card,
               params=n_params, batch=list(batch[0].shape),
               warmup_steps=warmup, timed_steps=timed, losses=losses,
               step_ms_median=step_ms,
               step_ms_runs=[t * 1e3 for t in times],
               tokens_per_s=tokens / (step_ms / 1e3),
               peak_memory_gb=peak / 1e9, launches=launches,
               launches_per_step={k: v / timed for k, v in launches.items()},
               launches_per_replay_profiled=traced,
               captures=len(getattr(step, "graphs", {})),
               replays=replays_of(step))
    emit(row)
    if captured:
        step.release()
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_training(fa, dev, card, seed):
    from chainermn_tpu_torch.comm import create_communicator

    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(
        0, LM["vocab"], size=(LM_BATCH, LM["max_len"]))).to(dev)
    batch = (toks, toks)  # benchmarks/lm.py: targets = tokens
    flash = train_arm(fa, dev, card, seed, "flash", comm, batch)
    check(flash["arm"] == "captured" and flash["captures"] == 1,
          f"training: the flash step was not captured once: {flash}")
    L = LM["n_layers"]  # remat: the forward runs twice per layer
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L,
            "flash_attention_bwd_dq": L}
    for k, n in want.items():
        check(flash["launches_per_step"][k] == n
              and flash["launches_per_replay_profiled"][k] == n,
              f"training: {k} ran {flash['launches_per_step'][k]} times per "
              f"step ({flash['launches_per_replay_profiled'][k]} in the "
              f"profiled replay), expected {n} ({L} layers, remat)")
    check(flash["losses"][-1] < flash["losses"][0],
          f"training: flash loss did not fall: {flash['losses']}")
    flash_eager = train_arm(fa, dev, card, seed, "flash", comm, batch,
                            capture=False)
    check(flash_eager["launches_per_step"] == want,
          f"training: the eager flash arm launched "
          f"{flash_eager['launches_per_step']} per step")
    # The plain-attention arm, captured too (3 timed steps: ~0.58 s
    # each).
    eager = train_arm(fa, dev, card, seed, "xla", comm, batch, timed=3)
    check(all(v == 0 for v in eager["launches"].values()),
          "training: the eager-attention arm launched a flash kernel")
    ratio = flash["step_ms_median"] / eager["step_ms_median"]
    emit({"phase": "training_summary", "card": card,
          "flash_step_ms": flash["step_ms_median"],
          "flash_eager_step_ms": flash_eager["step_ms_median"],
          "captured_over_eager_step_ratio":
          flash["step_ms_median"] / flash_eager["step_ms_median"],
          # Same weights and batch; bf16 (the fp32 check is
          # phase_training_agreement's).
          "captured_eager_loss_max_rel_diff": max(
              abs(a - b) / abs(b) for a, b in zip(flash["losses"],
                                                  flash_eager["losses"])),
          "xla_step_ms": eager["step_ms_median"],
          "eager_step_ms": eager["step_ms_median"],
          "flash_over_eager_step_ratio": ratio,
          "flash_tokens_per_s": flash["tokens_per_s"],
          "eager_tokens_per_s": eager["tokens_per_s"],
          "flash_peak_memory_gb": flash["peak_memory_gb"],
          "flash_eager_peak_memory_gb": flash_eager["peak_memory_gb"],
          "eager_peak_memory_gb": eager["peak_memory_gb"]})

    # The example entry point itself, at its own small defaults.
    from chainermn_tpu_torch.examples import train_lm

    t0 = time.perf_counter()
    loss = train_lm.main(["--steps", "3", "--eval"])
    check(math.isfinite(loss), f"train_lm example: loss {loss}")
    emit({"phase": "train_lm_example", "steps": 3, "eval": True,
          "final_loss": loss,
          "wall_s": time.perf_counter() - t0})
    return flash


#: captured against eager train steps in fp32 on the card: the same
#: kernels on the same inputs, in the same order.  On an H100 80GB HBM3
#: at 700 W every captured run read the eager one's bits exactly (LM, MoE,
#: ResNetTiny frozen and sync-BN, MNIST); ``tests/test_torch_capture_cuda.py``
#: holds the small models to 1e-5.
CAPTURE_TOL = dict(loss_rtol=1e-6, param_atol=1e-6)


def capture_agreement(label, runs):
    """``runs[True]``/``runs[False]``: (losses, {name: tensor}) of the
    captured and the eager run from the same weights; emits and checks
    their largest differences against :data:`CAPTURE_TOL`."""
    (lc, tc), (le, te) = runs[True], runs[False]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lc, le))
    param_err = max((tc[n].float() - te[n].float()).abs().max().item()
                    for n in te)
    row = dict(phase="capture_agreement", model=label, dtype="float32",
               losses_captured=lc, losses_eager=le,
               loss_max_rel_diff=loss_rel, param_max_abs_diff=param_err,
               tolerance=CAPTURE_TOL)
    emit(row)
    check(loss_rel <= CAPTURE_TOL["loss_rtol"]
          and param_err <= CAPTURE_TOL["param_atol"],
          f"{label}: captured and eager steps differ: losses {lc} vs {le}, "
          f"parameters by {param_err}")
    return row


def capture_pair(make, batches):
    """Three train steps captured and three eager from the same weights
    (``make()`` -> ``(model, optimizer, loss_fn, step kwargs)``, called
    once per run): ``{True: (losses, tensors), False: ...}``, the tensors
    being the parameters, buffers and the options' state after them."""
    runs = {}
    for capture in (True, False):
        model, opt, loss_fn, kw = make()
        state = opt.init(model)
        step = opt.make_train_step(loss_fn, capture=capture, **kw)
        losses = [float(step(state, b)[1]["loss"]) for b in batches]
        tensors = {f"p:{n}": p.detach().clone()
                   for n, p in model.named_parameters()}
        tensors.update({f"b:{n}": b.clone()
                        for n, b in model.named_buffers()})
        for name in ("pending_grads", "ef_residual", "ema_params"):
            for n, t in (getattr(state, name) or {}).items():
                tensors[f"{name}:{n}"] = t.clone()
        check((step_graph(step) is not None) == capture,
              f"capture_pair: capture={capture} but graphs "
              f"{len(getattr(step, 'graphs', {}))}")
        runs[capture] = (losses, tensors)
        if capture:
            step.release()
        del model, opt, state, step
    return runs


def phase_training_agreement(fa, dev, seed):
    """The flash kernels (fp32 instantiations) against the plain path,
    both on the card, through three optimizer steps from the same
    weights; and the flash arm captured against eager."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import TransformerLM, lm_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )

    cfg = dict(vocab=1024, n_layers=2, d_model=128, n_heads=4, d_ff=512,
               max_len=256, pos_enc="rope")
    rng = np.random.RandomState(seed + 5)
    batches = []
    for _ in range(3):
        tok = rng.randint(0, 1024, size=(4, 256))
        tgt = rng.randint(0, 1024, size=(4, 256))
        seg = np.ones((4, 256), np.int32)
        seg[:, 100:] = 2  # two packed documents per row
        batches.append(tuple(torch.from_numpy(x).to(dev)
                             for x in (tok, tgt, seg)))
    comm = create_communicator("xla", device=dev)
    runs = {}
    for impl, capture in (("flash", None), ("xla", None),
                          ("flash", False)):
        model = TransformerLM(**cfg, dtype=torch.float32, attention=impl,
                              device=dev, seed=seed)
        opt = create_multi_node_optimizer(
            adamw(1e-3, eps=1e-6, weight_decay=0.01), comm)
        state = opt.init(model)
        step = opt.make_train_step(lm_loss(model), has_aux=True,
                                   capture=capture)
        before = flash_launches(fa)
        r0 = replays_of(step)
        losses = [float(step(state, b)[1]["loss"]) for b in batches]
        used = step_launches(step, {k: flash_launches(fa)[k] - before[k]
                                    for k in FLASH}, replays_of(step) - r0)
        runs[impl, capture] = (losses, {n: p.detach().clone()
                                        for n, p in model.named_parameters()},
                               used)
        if step_graph(step) is not None:
            step.release()
    # Captured: the first step eager, its capture's warm-ups, then two
    # replays.
    from chainermn_tpu_torch.optimizers import CAPTURE_WARMUP

    for key, n in ((("flash", None), 3 + CAPTURE_WARMUP),
                   (("flash", False), 3)):
        check(all(v == n * cfg["n_layers"] for v in runs[key][2].values()),
              f"training_agreement: flash arm {key} ran {runs[key][2]}")
    check(all(v == 0 for v in runs["xla", None][2].values()),
          "training_agreement: the plain arm launched a kernel")
    lf, lx = runs["flash", None][0], runs["xla", None][0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, lx))
    param_err = max((runs["flash", None][1][n] - runs["xla", None][1][n])
                    .abs().max().item() for n in runs["xla", None][1])
    emit({"phase": "training_agreement", "dtype": "float32",
          "losses_flash": lf, "losses_plain": lx,
          "loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_err,
          "tolerance": {"loss_rtol": 1e-5, "param_atol": 1e-4}})
    check(loss_rel <= 1e-5 and param_err <= 1e-4,
          f"training_agreement: losses {lf} vs {lx}, parameters differ "
          f"by {param_err}")
    capture_agreement("lm_flash", {True: runs["flash", None][:2],
                                   False: runs["flash", False][:2]})


# -------------------------------------------------------------- conv K6
def k6_launches(batch=RESNET_BATCH, size=RESNET_SIZE,
                stages=(3, 4, 6, 3), width=64):
    """(N, Cin, Cout) of every K6 launch of one ResNet-50 training step
    with ``conv1="pallas"``, in forward order: each bottleneck block's fc1
    (before its strided 3x3), fc3 and, where the shape changes, proj_f
    (after its stride-2 subsample).  The stem and the max-pool take 224 px
    to 56."""
    h = -(-(-(-size // 2)) // 2)
    cin, out = width, []
    for i, n in enumerate(stages):
        for j in range(n):
            feats, s = width * 2 ** i, 2 if i > 0 and j == 0 else 1
            out.append((batch * h * h, cin, feats))
            h = -(-h // s)
            out.append((batch * h * h, feats, 4 * feats))
            if s != 1 or cin != 4 * feats:
                out.append((batch * h * h, cin, 4 * feats))
            cin = 4 * feats
    return out


def k6_shapes():
    """The distinct main-path shapes, each with its launches per step."""
    counts = {}
    for shp in k6_launches():
        counts[shp] = counts.get(shp, 0) + 1
    return counts


def k6_inputs(dev, N, K, C, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((N, K), generator=g, device=dev).to(dtype)
    w = (torch.randn((K, C), generator=g, device=dev) / K ** 0.5).to(dtype)
    s = torch.rand((C,), generator=g, device=dev) + 0.5
    b = torch.randn((C,), generator=g, device=dev) * 0.1
    return dict(x=x, w=w, s=s, b=b)


def phase_conv_parity(cf, dev, seed):
    """K6 at every main-path shape and the ragged ones, ReLU on and off,
    bf16 and fp32, against the plain version on the same inputs; returns
    the largest |err| over the main-path bf16 cases."""
    rows = []
    shapes = list(k6_shapes()) + K6_RAGGED
    for i, (N, K, C) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            a = k6_inputs(dev, N, K, C, dtype, seed + i)
            for relu in (True, False):
                got = cf.matmul_affine_fwd(a["x"], a["w"], a["s"], a["b"],
                                           relu)
                want = cf.matmul_affine_reference(a["x"], a["w"], a["s"],
                                                  a["b"], relu)
                torch.cuda.synchronize()
                rows.append(dict(
                    N=N, K=K, C=C, relu=relu,
                    dtype=str(dtype).replace("torch.", ""),
                    main_path=(N, K, C) not in K6_RAGGED,
                    excess=excess(got, want, K6_TOL[dtype]["rtol"]),
                    max_abs_err=(got.float() - want.float()).abs().max()
                    .item(),
                    ref_rms=want.float().pow(2).mean().sqrt().item(),
                    finite=bool(torch.isfinite(got.float()).all()),
                    relu_nonneg=(not relu) or float(got.float().min()) >= 0))
                del got, want
            del a
    torch.cuda.empty_cache()
    emit({"phase": "conv_parity", "cases": rows,
          "tolerance": {"fp32": K6_TOL[torch.float32],
                        "bf16": K6_TOL[torch.bfloat16],
                        "measure": "excess = max over elements of (|err| - "
                                   "rtol |ref|) / rms(ref row); <= atol"}})
    for r in rows:
        tol = K6_TOL[getattr(torch, r["dtype"])]["atol"]
        check(r["excess"] <= tol and r["finite"] and r["relu_nonneg"],
              f"K6 {r['dtype']} relu={r['relu']} at ({r['N']}, {r['K']}, "
              f"{r['C']}): excess {r['excess']} > {tol}, or not finite, or "
              "a negative ReLU output")
    return max(r["max_abs_err"] for r in rows
               if r["main_path"] and r["dtype"] == "bfloat16")


def phase_conv_timing(cf, dev, seed):
    """Device ms per launch at each main-path shape (bf16): K6, the plain
    version and ``torch.matmul(x, w)``, beside the bound; then the sums
    over one training step's 36 launches."""
    rows = []
    for i, ((N, K, C), n) in enumerate(k6_shapes().items()):
        a = k6_inputs(dev, N, K, C, torch.bfloat16, seed + 100 + i)
        nbytes = 2 * (N * K + K * C + N * C) + 8 * C
        bound_ms, bound_by = bound(nbytes, 2 * N * K * C, torch.bfloat16)
        copies = copies_for(a)

        def kernel(t):
            return cf.matmul_affine_fwd(t["x"], t["w"], t["s"], t["b"], True)

        def plain(t):
            return cf.matmul_affine_reference(t["x"], t["w"], t["s"],
                                              t["b"], True)

        def library(t):
            return torch.matmul(t["x"], t["w"])

        # Turns: plain, kernel, library, kernel, plain.
        p1 = time_ms(plain, copies, 3)
        k1 = time_ms(kernel, copies, 30)
        lib_ms = time_ms(library, copies, 30)
        k2 = time_ms(kernel, copies, 30)
        p2 = time_ms(plain, copies, 3)
        k_eager = eager_ms(kernel, copies, 30)
        row = dict(N=N, K=K, C=C, launches_per_step=n,
                   kernel_ms=min(k1, k2), kernel_ms_runs=[k1, k2],
                   kernel_eager_ms=k_eager, plain_ms=min(p1, p2),
                   plain_ms_runs=[p1, p2], library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_fraction=bound_ms / min(k1, k2),
                   copies=len(copies))
        emit({"phase": "conv_timing", **row})
        rows.append(row)
        del a, copies
        torch.cuda.empty_cache()
    step = {key: sum(r[key] * r["launches_per_step"] for r in rows)
            for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    by_ops = sum(r["bound_ms"] * r["launches_per_step"] for r in rows
                 if r["bound_by"] == "operations")
    step["bound_by"] = ("operations" if by_ops * 2 > step["bound_ms"]
                        else "bytes")
    step["launches"] = sum(r["launches_per_step"] for r in rows)
    step["distinct_shapes"] = len(rows)
    emit({"phase": "conv_timing_step", **step})
    return step


# ------------------------------------------------------------------ resnet
def resnet_group(name):
    n = name.lower()
    if "matmul_affine" in n:
        return "k6"
    if any(t in n for t in ("fprop", "dgrad", "wgrad", "conv", "implicit")):
        return "convolutions"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "matmul")):
        return "matrix_products"
    if "reduce" in n:
        return "reductions"
    if "nccl" in n:
        return "collectives"
    if any(t in n for t in ("elementwise", "vectorized", "copy", "fill")):
        return "elementwise_and_copies"
    return "other"


def resnet_arm(cf, dev, card, seed, bn, conv1, comm, batch, warmup=2,
               timed=5, total=0, capture=None):
    """``warmup`` + ``timed`` steps, captured (the default on the card)
    or eager (``capture=False``), one traced step, then untimed steps up
    to ``total`` (the losses of every step are kept)."""
    import gc

    from chainermn_tpu_torch.models import FusedConv1x1, ResNet50, resnet_loss
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer, sgd

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = ResNet50(num_classes=RESNET_CLASSES, axis_name=comm.axis_name,
                     bn=bn, conv1=conv1, device=dev, seed=seed)
    if bn == "frozen":
        model.scale_residual_branches(FROZEN_BRANCH_SCALE)
    opt = create_multi_node_optimizer(sgd(0.1, 0.9), comm)
    state = opt.init(model)
    step = opt.make_train_step(resnet_loss(model), stateful=True,
                               capture=capture)
    # The first warm-up step records the (N, Cin, Cout) of every fused 1x1
    # conv, to hold the parity and timing phases' shapes to the model's.
    seen = []

    def record(mod, inp, out):
        seen.append((out.shape[0] * out.shape[2] * out.shape[3],
                     inp[0].shape[1], out.shape[1]))

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, FusedConv1x1)]
    losses = []
    for i in range(warmup):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            for h in hooks:
                h.remove()
    torch.cuda.synchronize()
    cf.matmul_affine_fwd.launches = 0
    r0 = replays_of(step)
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # syncs: the step is done
        times.append(time.perf_counter() - t0)
    launches = step_launches(
        step, {"matmul_affine_fwd": cf.matmul_affine_fwd.launches},
        replays_of(step) - r0)["matmul_affine_fwd"]
    peak = torch.cuda.max_memory_allocated()
    arm = f"{bn}/{conv1}"
    mode = "captured" if step_graph(step) is not None else "eager"
    trace, traced = traced_step(
        f"resnet {arm} {mode}",
        {"phase": "resnet_trace", "arm": arm, "mode": mode, "card": card},
        step, state, batch, {"matmul_affine_fwd": launches // timed},
        group=resnet_group, top=20)
    losses.append(trace["loss"])
    while len(losses) < total:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    step_ms = sorted(times)[len(times) // 2] * 1e3
    row = dict(phase="resnet", arm=arm, mode=mode, card=card,
               params=sum(p.numel() for p in model.parameters()),
               batch=RESNET_BATCH, image_size=RESNET_SIZE,
               cudnn_benchmark=torch.backends.cudnn.benchmark,
               warmup_steps=warmup, timed_steps=timed, losses=losses,
               step_ms_median=step_ms, step_ms_runs=[t * 1e3 for t in times],
               images_per_s=RESNET_BATCH / (step_ms / 1e3),
               peak_memory_gb=peak / 1e9,
               launches={"matmul_affine_fwd": launches},
               launches_per_step=launches / timed,
               launches_per_replay_profiled=traced["matmul_affine_fwd"],
               k6_device_ms_per_step=trace["groups_ms"].get("k6", 0.0),
               fused_conv_shapes_seen=len(seen),
               captures=len(getattr(step, "graphs", {})))
    emit(row)
    check(all(math.isfinite(x) for x in losses),
          f"resnet {arm}: non-finite loss {losses}")
    if conv1 != "none":
        # The first call ran the step eagerly, then (captured) its
        # warm-ups and the capture: each forward the same 36 shapes.
        want = sorted(k6_launches())
        check(sorted(seen[:len(want)]) == want
              and sorted(seen) == sorted(want * (len(seen) // len(want))),
              f"resnet {arm}: the fused convs ran at {sorted(set(seen))}, "
              "not at the shapes the parity and timing phases used")
    if mode == "captured":
        step.release()
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_resnet(cf, dev, card, seed):
    from chainermn_tpu_torch.comm import create_communicator

    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    batch = (torch.randn((RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3),
                         generator=g, device=dev),
             torch.randint(0, RESNET_CLASSES, (RESNET_BATCH,), generator=g,
                           device=dev))
    torch.backends.cudnn.benchmark = True
    try:
        arms = {}
        for bn, conv1 in (("sync", "none"), ("frozen", "pallas"),
                          ("frozen", "xla")):
            # The headline runs on to the bench's 25 steps (5 warm-up +
            # 20 timed, bench.py:1069) on its one fixed batch.  At lr 0.1
            # and momentum 0.9 its loss falls over the first two steps
            # (7.397 -> 6.43 -> 6.07-6.10 on an H100, every run) and then
            # wanders: from step 5 on, runs of one tree part ways through
            # cuDNN's nondeterministic sums, and the loss at step 25 read
            # 5.43-7.96 over seven runs of two trees, above the first
            # step's in two of them.  So the check is on the first two
            # steps; the 25 steps must stay finite.
            arms[f"{bn}/{conv1}"] = resnet_arm(
                cf, dev, card, seed, bn, conv1, comm, batch,
                total=RESNET_BENCH_STEPS if bn == "sync" else 0)
        # The same steps eager, on the same card.
        eager = {f"{bn}/{conv1}": resnet_arm(
            cf, dev, card, seed, bn, conv1, comm, batch, capture=False)
            for bn, conv1 in (("sync", "none"), ("frozen", "pallas"))}
    finally:
        torch.backends.cudnn.benchmark = False
    sync, fused, plain = (arms["sync/none"], arms["frozen/pallas"],
                          arms["frozen/xla"])
    emit({"phase": "resnet_summary", "card": card,
          "step_ms": {k: a["step_ms_median"] for k, a in arms.items()},
          "eager_step_ms": {k: a["step_ms_median"]
                            for k, a in eager.items()},
          "captured_over_eager_step_ratio": {
              k: arms[k]["step_ms_median"] / a["step_ms_median"]
              for k, a in eager.items()},
          "images_per_s": {k: a["images_per_s"] for k, a in arms.items()},
          "peak_memory_gb": {k: a["peak_memory_gb"] for k, a in arms.items()},
          "pallas_over_xla_step_ratio": fused["step_ms_median"]
          / plain["step_ms_median"]})
    n = len(k6_launches())
    check(all(a["mode"] == "captured" and a["captures"] == 1
              for a in arms.values()),
          "resnet: an arm's step was not captured once")
    check(fused["launches_per_step"] == n
          and fused["launches_per_replay_profiled"] == n
          and eager["frozen/pallas"]["launches_per_step"] == n,
          f"resnet frozen/pallas: K6 ran {fused['launches_per_step']} "
          f"times per step ({fused['launches_per_replay_profiled']} in the "
          f"profiled replay, {eager['frozen/pallas']['launches_per_step']} "
          f"eager), expected {n}")
    check(sync["launches"]["matmul_affine_fwd"] == 0
          and plain["launches"]["matmul_affine_fwd"] == 0,
          "resnet: the sync or frozen/xla arm launched K6")
    first = sync["losses"][:3]
    check(first[0] > first[1] > first[2],
          f"resnet sync/none: loss did not fall over its first two steps: "
          f"{sync['losses']}")
    return arms


def phase_resnet_agreement(cf, dev, seed):
    """K6's fp32 instantiation against the plain twin inside the model,
    both on the card, through three SGD steps from the same weights."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import ResNetTiny, resnet_loss
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer, sgd

    rng = np.random.RandomState(seed + 8)
    batches = [(torch.from_numpy(rng.randn(8, 32, 32, 3).astype(np.float32))
                .to(dev), torch.from_numpy(rng.randint(0, 10, size=8)).to(dev))
               for _ in range(3)]
    comm = create_communicator("xla", device=dev)
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for impl in ("pallas", "xla"):
            model = ResNetTiny(num_classes=10, width=16, dtype=torch.float32,
                               bn="frozen", conv1=impl, device=dev, seed=seed)
            model.scale_residual_branches(FROZEN_BRANCH_SCALE)
            opt = create_multi_node_optimizer(sgd(0.1, 0.9), comm)
            state = opt.init(model)
            step = opt.make_train_step(resnet_loss(model), stateful=True)
            before = cf.matmul_affine_fwd.launches
            r0 = replays_of(step)
            losses = [float(step(state, b)[1]["loss"]) for b in batches]
            runs[impl] = (losses, {n: p.detach().clone()
                                   for n, p in model.named_parameters()},
                          step_launches(step, {
                              "matmul_affine_fwd":
                              cf.matmul_affine_fwd.launches - before},
                              replays_of(step) - r0)["matmul_affine_fwd"])
            step.release()
        # Captured against eager in fp32: the frozen K6 model and the
        # sync-BN one (its all-reduces and running statistics inside the
        # graph).
        for bn, conv1 in (("frozen", "pallas"), ("sync", "none")):
            def make():
                m = ResNetTiny(num_classes=10, width=16,
                               dtype=torch.float32, bn=bn, conv1=conv1,
                               axis_name=comm.axis_name, device=dev,
                               seed=seed)
                if bn == "frozen":
                    m.scale_residual_branches(FROZEN_BRANCH_SCALE)
                return (m, create_multi_node_optimizer(sgd(0.1, 0.9), comm),
                        resnet_loss(m), dict(stateful=True))

            capture_agreement(f"resnet_tiny_{bn}_{conv1}",
                              capture_pair(make, batches))
    finally:
        torch.backends.cudnn.deterministic = False
    lf, lx = runs["pallas"][0], runs["xla"][0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, lx))
    param_err = max((runs["pallas"][1][n] - runs["xla"][1][n]).abs().max()
                    .item() for n in runs["xla"][1])
    emit({"phase": "resnet_agreement", "dtype": "float32",
          "losses_pallas": lf, "losses_plain": lx,
          "loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_err,
          "launches": {k: v[2] for k, v in runs.items()},
          "tolerance": {"loss_rtol": 1e-5, "param_atol": 1e-4}})
    # Three steps (the first eager, two replays) and the capture's
    # warm-ups, each 4 blocks x fc1, fc3, proj_f.
    from chainermn_tpu_torch.optimizers import CAPTURE_WARMUP

    want = (3 + CAPTURE_WARMUP) * 12
    check(runs["pallas"][2] == want and runs["xla"][2] == 0,
          f"resnet_agreement: K6 ran {runs['pallas'][2]} / "
          f"{runs['xla'][2]} times, expected {want} / 0")
    check(all(math.isfinite(x) for x in lf + lx),
          f"resnet_agreement: non-finite losses {lf} {lx}")
    check(loss_rel <= 1e-5 and param_err <= 1e-4,
          f"resnet_agreement: losses {lf} vs {lx}, parameters differ by "
          f"{param_err}")


def phase_train_imagenet_example():
    from chainermn_tpu_torch.examples import train_imagenet

    t0 = time.perf_counter()
    loss = train_imagenet.main(["--steps", "3", "--iters-per-epoch", "4"])
    check(math.isfinite(loss), f"train_imagenet example: loss {loss}")
    emit({"phase": "train_imagenet_example", "steps": 3, "final_loss": loss,
          "wall_s": time.perf_counter() - t0})


# ----------------------------------------------------- the training loop
#: the MNIST example's configuration (examples/mnist/train_mnist.py): the
#: synthetic task, MLP (1000, 1000) (the class default and the
#: reference's width), global batch 256, SGD 0.05 momentum 0.9, 3 epochs.
MNIST_ARGS = ["--epoch", "3", "--unit", "1000", "--batchsize", "256",
              "--lr", "0.05", "--out", ""]
MNIST_ARMS = {"plain": [], "double_buffering": ["--double-buffering"],
              "int8_ef": ["--grad-compression", "int8_ef"],
              "ema_0.99": ["--ema-decay", "0.99"],
              "plain_eager": ["--eager-step"]}
#: the plain arm captured against eager (fp32, TF32 off): per-epoch mean
#: losses over 96 steps of the same kernels on the same batches.
MNIST_CAPTURE_RTOL = 1e-5
#: the Trainer's host cost: pairs of (bare step loop, Trainer.run) turns.
MNIST_PAIRS, MNIST_PAIR_STEPS = 20, 64
#: the ImageNet example's pipeline at the bench's ResNet-50 configuration:
#: the synthetic pool is IMAGENET_ITERS batches (the example's
#: --iters-per-epoch, cut from its default 50), validation 512 images;
#: epoch 2 runs IMAGENET_TIMED steps timed by events, then
#: IMAGENET_PROFILED under torch.profiler, both short of its end.
IMAGENET_ITERS, IMAGENET_VAL = 12, 512
IMAGENET_TIMED, IMAGENET_PROFILED = 6, 4


def phase_mnist_trainer(dev, card, seed):
    """The ``train_mnist`` twin through the ``Trainer`` in each arm, then
    the Trainer's host cost per iteration against a bare step loop."""
    from chainermn_tpu_torch.examples import train_mnist

    arms = {}
    for arm, flags in MNIST_ARMS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer, history = train_mnist.main(MNIST_ARGS + flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log = trainer.extensions[0].log
        (step,) = trainer.optimizer._step_cache.values()
        captures = len(step.graphs)
        check(captures == (0 if "--eager-step" in flags else 1),
              f"mnist_trainer {arm}: {captures} captures")
        row = dict(phase="mnist_trainer", arm=arm, card=card,
                   captures=captures, replays=replays_of(step),
                   log_entries=len(log),
                   epoch_loss=[e["loss"] for e in log],
                   epoch_train_accuracy=[e["accuracy"] for e in log],
                   epoch_val_accuracy=[h["val/accuracy"] for h in history],
                   epoch_val_loss=[h["val/loss"] for h in history],
                   iterations=trainer.iteration,
                   ms_per_iteration=wall * 1e3 / trainer.iteration,
                   ms_per_iteration_includes="the run's wall over its "
                   "iterations: data, steps, 3 LogReport and 3 evaluator "
                   "passes")
        emit(row)
        arms[arm] = row
        losses = row["epoch_loss"]
        check(row["log_entries"] == 3,
              f"mnist_trainer {arm}: {row['log_entries']} LogReport "
              "entries, expected 3")
        check(all(math.isfinite(x) for x in losses)
              and all(b < a for a, b in zip(losses, losses[1:])),
              f"mnist_trainer {arm}: loss not finite and falling: {losses}")
        check(row["epoch_val_accuracy"][-1] > 0.1,
              f"mnist_trainer {arm}: val accuracy "
              f"{row['epoch_val_accuracy']} not above chance (0.1)")
        if captures:
            step.release()
        del trainer, step
    cap, eag = arms["plain"]["epoch_loss"], arms["plain_eager"]["epoch_loss"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(cap, eag))
    emit({"phase": "capture_agreement", "model": "mnist_trainer",
          "dtype": "float32", "epoch_loss_captured": cap,
          "epoch_loss_eager": eag, "loss_max_rel_diff": rel,
          "val_accuracy_captured": arms["plain"]["epoch_val_accuracy"],
          "val_accuracy_eager": arms["plain_eager"]["epoch_val_accuracy"],
          "tolerance": {"loss_rtol": MNIST_CAPTURE_RTOL}})
    check(rel <= MNIST_CAPTURE_RTOL,
          f"mnist_trainer: captured epoch losses {cap}, eager {eag}")
    emit({"phase": "mnist_trainer_host_cost", "card": card,
          **mnist_host_cost(dev, seed)})
    return arms


class _DeviceBatches:
    """Epoch-aware iterator cycling over batches already on the card: it
    costs the host nothing, so a loop driven by it shows its own cost."""

    def __init__(self, batches):
        self.batches, self.batch_size = batches, len(batches[0][0])
        self._n = len(batches) * self.batch_size
        self.epoch, self.iteration, self.is_new_epoch = 0, 0, False

    def __iter__(self):
        return self

    def __next__(self):
        b = self.batches[self.iteration % len(self.batches)]
        self.iteration += 1
        self.is_new_epoch = self.iteration % len(self.batches) == 0
        self.epoch += self.is_new_epoch
        return b


def mnist_host_cost(dev, seed):
    """The same steps driven by a bare ``step`` loop and by ``Trainer.run``
    with a ``LogReport``, in turns, on batches already on the card: the
    per-iteration ms of each and the median per-pair difference, the
    Trainer's host cost per iteration."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import make_synthetic_classification
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        sgd,
    )
    from chainermn_tpu_torch.training import LogReport, Trainer

    comm = create_communicator("hierarchical", device=dev)
    x, y = make_synthetic_classification(8192, 784, 10, seed=1).arrays
    it = _DeviceBatches([(torch.from_numpy(x[i:i + 256]).to(dev),
                          torch.from_numpy(y[i:i + 256]).to(dev))
                         for i in range(0, 8192, 256)])
    model = MLP(hidden=(1000, 1000), device=dev, seed=seed)
    opt = create_multi_node_optimizer(sgd(0.05, momentum=0.9), comm)
    state = opt.init(model)
    loss = classification_loss(model)
    step = opt.make_train_step(loss, has_aux=True)
    n = MNIST_PAIR_STEPS

    def bare():
        nonlocal state
        for _ in range(n):
            state, _ = step(state, next(it))

    def trainer():
        tr = Trainer(opt, state, loss, it, stop=(n, "iteration"),
                     has_aux=True)
        tr.extend(LogReport(trigger=(n, "iteration"), print_report=False))
        tr.run()

    for fn in (bare, trainer):  # warm both
        fn()
    bare_ms, trainer_ms = [], []
    turns = [(bare, bare_ms), (trainer, trainer_ms)]
    for i in range(MNIST_PAIRS):
        for fn, out in (turns if i % 2 == 0 else turns[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3 / n)
    diffs = sorted(t - b for t, b in zip(trainer_ms, bare_ms))
    # The bare loop's step eager on the same card, for the captured one.
    eager_step = opt.make_train_step(loss, has_aux=True, capture=False)
    eager_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = eager_step(state, next(it))
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3 / n)
    check(len(step.graphs) == 1,
          f"mnist_host_cost: {len(step.graphs)} captures of the bare step")
    step.release()
    return dict(pairs=MNIST_PAIRS, steps_per_turn=n,
                bare_eager_ms_per_iteration=sorted(eager_ms)[2],
                bare_eager_ms_runs=eager_ms,
                batches="on the card, cycled",
                bare_ms_per_iteration=sorted(bare_ms)[len(bare_ms) // 2],
                trainer_ms_per_iteration=sorted(trainer_ms)[
                    len(trainer_ms) // 2],
                trainer_host_cost_us_per_iteration=diffs[len(diffs) // 2]
                * 1e3,
                trainer_host_cost_us_quartiles=[
                    diffs[len(diffs) // 4] * 1e3,
                    diffs[3 * len(diffs) // 4] * 1e3],
                trainer_faster_pairs=sum(d < 0 for d in diffs),
                bare_ms_runs=bare_ms, trainer_ms_runs=trainer_ms)


class _Fingerprints:
    """Pass-through of a batch iterator recording, per batch, its labels
    and each image's sum (device tensors: no sync), so that two pipelines'
    batches can be compared afterwards."""

    def __init__(self, it):
        self._it = it
        self.seen = []

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self._it)
        x, y = torch.as_tensor(b[0]), torch.as_tensor(b[1])
        self.seen.append((y.clone(), x.float().sum(dim=(1, 2, 3))))
        return b

    def __getattr__(self, name):
        return getattr(self.__dict__["_it"], name)


def device_timeline(prof_path, steps):
    """Idle time of the card over a profiled stretch of ``steps`` steps,
    from the trace's kernel, copy and memset events: the union of busy
    intervals against the span, the largest gap, and the share of the
    host-to-device copies' time that kernels overlapped."""
    with open(prof_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e.get("cat", ""), e.get("name", ""))
           for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                               "gpu_memset")]
    check(dev, "imagenet_trainer: the profile holds no device event")
    dev.sort()

    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    busy = union([(a, b) for a, b, _, _ in dev])
    span = busy[-1][1] - busy[0][0]
    busy_us = sum(b - a for a, b in busy)
    gaps = [b2[0] - b1[1] for b1, b2 in zip(busy, busy[1:])]
    kernels = union([(a, b) for a, b, c, _ in dev if c == "kernel"])
    h2d = [(a, b) for a, b, c, n in dev if c == "gpu_memcpy" and "HtoD" in n]
    h2d_us = sum(b - a for a, b in h2d)
    covered = 0.0
    for a, b in h2d:
        for ka, kb in kernels:
            covered += max(0.0, min(b, kb) - max(a, ka))
    return dict(steps=steps, span_ms=span / 1e3, busy_ms=busy_us / 1e3,
                idle_ms=(span - busy_us) / 1e3,
                idle_ms_per_step=(span - busy_us) / 1e3 / steps,
                idle_share=(span - busy_us) / span if span else None,
                largest_gap_ms=max(gaps, default=0.0) / 1e3,
                h2d_copies=len(h2d), h2d_ms_per_copy=h2d_us / 1e3
                / max(len(h2d), 1),
                h2d_overlapped_share=covered / h2d_us if h2d_us else None)


def imagenet_args(bn, conv1, ckdir):
    args = ["--bn", bn, "--conv1", conv1, "--batch-per-chip",
            str(RESNET_BATCH), "--image-size", str(RESNET_SIZE),
            "--num-classes", str(RESNET_CLASSES), "--iters-per-epoch",
            str(IMAGENET_ITERS), "--val-size", str(IMAGENET_VAL),
            "--augment", "--maxpool", "fused", "--eval", "--checkpoint",
            ckdir, "--wire-dtype", "bfloat16", "--epoch", "1"]
    if bn == "frozen":
        args += ["--branch-scale", str(FROZEN_BRANCH_SCALE)]
    return args


def imagenet_arm(cf, dev, card, seed, bn, conv1, bare_ms):
    """One arm of the ``train_imagenet`` twin's main path: epoch 1 (K6
    counted over its steps and the evaluator's batches, the checkpoint
    written at its end), the evaluator timed, a stretch of epoch 2 timed
    by events between iterations and a shorter one under
    ``torch.profiler``; then a fresh model and pipeline restored from the
    snapshot, byte for byte, whose next batches must be the uninterrupted
    run's."""
    import gc
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from chainermn_tpu_torch.examples import train_imagenet
    from chainermn_tpu_torch.training import Extension

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arm = f"{bn}/{conv1}"
    ckdir = tempfile.mkdtemp(prefix="cmn_imagenet_ckpt_")
    args = train_imagenet.parse_args(imagenet_args(bn, conv1, ckdir))
    t0 = time.perf_counter()
    run = train_imagenet.build(args)
    build_s = time.perf_counter() - t0
    tr = run.trainer
    fp = _Fingerprints(tr.train_iter)
    tr.train_iter = fp
    marks = []
    tr.extend(Extension(lambda t: marks.append(_event()), (1, "iteration")))
    torch.cuda.synchronize()
    cf.matmul_affine_fwd.launches = 0
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    epoch1_s = time.perf_counter() - t0
    (step,) = tr.optimizer._step_cache.values()
    check(len(step.graphs) == 1,
          f"imagenet_trainer {arm}: {len(step.graphs)} captures")
    # The step's K6 runs: its wrapper's launches (the first, eager, step,
    # the capture's warm-ups, the evaluator's batches) and the replays'.
    k6_epoch1 = step_launches(
        step, {"matmul_affine_fwd": cf.matmul_affine_fwd.launches},
        replays_of(step))["matmul_affine_fwd"]
    eval_batches = run.evaluator.batches
    ckpt = run.checkpointer
    ckpt.finalize()
    saved = dict(ckpt.last_save)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = run.evaluator.evaluate(tr.state.model)
    torch.cuda.synchronize()
    eval_ms_per_batch = (time.perf_counter() - t0) * 1e3 / eval_batches
    # Epoch 2: a timed stretch, then a profiled one (no epoch end inside:
    # no evaluator, no checkpoint).
    n_seen = len(fp.seen)
    marks.clear()
    tr.stop_n, tr.stop_unit = tr.iteration + IMAGENET_TIMED, "iteration"
    cf.matmul_affine_fwd.launches = 0
    replays1 = replays_of(step)
    tr.run()
    torch.cuda.synchronize()
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    step_ms_med = step_ms[len(step_ms) // 2]
    trace = os.path.join(ckdir, "trace.json")
    tr.stop_n = tr.iteration + IMAGENET_PROFILED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run()
        torch.cuda.synchronize()
    k6_epoch2 = step_launches(
        step, {"matmul_affine_fwd": cf.matmul_affine_fwd.launches},
        replays_of(step) - replays1)["matmul_affine_fwd"]
    replays = replays_of(step)
    prof.export_chrome_trace(trace)
    timeline = device_timeline(trace, IMAGENET_PROFILED)
    want_next = [(y.cpu(), v.cpu()) for y, v in fp.seen[n_seen:n_seen + 2]]
    h2d_ms = sorted(run.train_iter.h2d_ms)
    losses = [float(tr.last_metrics["loss"])]
    peak = torch.cuda.max_memory_allocated()
    saved_model = torch.load(ckpt._rank_file(saved["step"]),
                             map_location="cpu", weights_only=False)["model"]
    run.train_iter.close()
    step.release()
    del run, tr, fp, prof, step
    gc.collect()
    torch.cuda.empty_cache()
    # Resume into a fresh model (at its initial weights), optimizer and
    # pipeline over the same pool: the twin's build restores the snapshot
    # itself, and its checkpointer times that restore.
    run2 = train_imagenet.build(train_imagenet.parse_args(
        imagenet_args(bn, conv1, ckdir)))
    tr2 = run2.trainer
    resumed_at = run2.resumed_at
    restored = dict(run2.checkpointer.last_restore)
    now = tr2.state.model.state_dict()
    exact = sorted(now) == sorted(saved_model) and all(
        now[k].cpu().numpy().tobytes() == v.numpy().tobytes()
        for k, v in saved_model.items())
    fp2 = _Fingerprints(tr2.train_iter)
    tr2.train_iter = fp2
    tr2.stop_n, tr2.stop_unit = tr2.iteration + 2, "iteration"
    tr2.run()
    got_next = [(y.cpu(), v.cpu()) for y, v in fp2.seen[:2]]
    same_batches = len(got_next) == len(want_next) == 2 and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(got_next, want_next))
    losses.append(float(tr2.last_metrics["loss"]))
    run2.train_iter.close()
    del run2, tr2, fp2, saved_model, now
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckdir, ignore_errors=True)
    row = dict(
        phase="imagenet_trainer", arm=arm, card=card, batch=RESNET_BATCH,
        image_size=RESNET_SIZE, iters_per_epoch=IMAGENET_ITERS,
        augment=True, maxpool="fused", prefetch_depth=2,
        build_s=build_s, epoch1_s=epoch1_s,
        step_ms_median=step_ms_med, step_ms_runs=step_ms,
        bare_step_ms=bare_ms,
        step_over_bare=step_ms_med / bare_ms if bare_ms else None,
        images_per_s=RESNET_BATCH / (step_ms_med / 1e3),
        device_timeline=timeline,
        h2d_ms_per_batch_events=h2d_ms[len(h2d_ms) // 2] if h2d_ms
        else None,
        eval_batches=eval_batches, eval_ms_per_batch=eval_ms_per_batch,
        val_accuracy=val.get("val/accuracy"),
        checkpoint_step=saved.get("step"),
        checkpoint_bytes=saved.get("bytes"),
        checkpoint_host_copy_ms=saved.get("host_copy_s", 0) * 1e3,
        checkpoint_write_ms=saved.get("write_s", 0) * 1e3,
        restore_step=restored.get("step"),
        restore_read_ms=restored.get("load_s", math.nan) * 1e3,
        restore_ms=restored.get("seconds", math.nan) * 1e3,
        resumed_at=resumed_at,
        restored_byte_exact=exact, resumed_batches_equal=same_batches,
        k6_launches_epoch1=k6_epoch1, k6_launches_epoch2=k6_epoch2,
        captures=1, replays=replays,
        training_steps_epoch1=IMAGENET_ITERS,
        training_steps_epoch2=IMAGENET_TIMED + IMAGENET_PROFILED,
        losses=losses, peak_memory_gb=peak / 1e9)
    emit(row)
    from chainermn_tpu_torch.optimizers import CAPTURE_WARMUP

    n_k6 = len(k6_launches()) if conv1 == "pallas" else 0
    check(k6_epoch1 == n_k6 * (IMAGENET_ITERS + eval_batches
                               + CAPTURE_WARMUP)
          and k6_epoch2 == n_k6 * (IMAGENET_TIMED + IMAGENET_PROFILED),
          f"imagenet_trainer {arm}: K6 ran {k6_epoch1} / {k6_epoch2} "
          f"times, expected {n_k6} x ({IMAGENET_ITERS} steps + "
          f"{eval_batches} eval batches + {CAPTURE_WARMUP} warm-ups) / "
          f"{n_k6} x {IMAGENET_TIMED + IMAGENET_PROFILED} steps")
    check(resumed_at == IMAGENET_ITERS == restored.get("step") and exact,
          f"imagenet_trainer {arm}: resumed at {resumed_at} from "
          f"{restored}, or the restored model differs from the snapshot")
    check(same_batches, f"imagenet_trainer {arm}: the resumed run's next "
          "batches differ from the uninterrupted run's")
    check(all(math.isfinite(x) for x in losses),
          f"imagenet_trainer {arm}: non-finite loss {losses}")
    return row


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def imagenet_path_extras(dev, card, seed, rows, reps=10):
    """Device ms of what the twin's path runs and the bare step does not,
    in turns with events: the fused max-pool's forward and backward at
    the stem's output against the bare step's ``max_pool_same``, and the
    crop/flip of one batch (its draw included); their sum beside each
    arm's step under the ``Trainer`` minus its bare step."""
    from chainermn_tpu_torch.models.resnet import max_pool_same
    from chainermn_tpu_torch.ops import max_pool_fused, random_crop_flip
    from chainermn_tpu_torch.optimizers import augment_generator

    g = torch.Generator(device=dev).manual_seed(seed)
    h = RESNET_SIZE // 2
    # The stem's output: NHWC memory, which the bare step sees as an NCHW
    # channels_last view.
    x = torch.randn(RESNET_BATCH, h, h, 64, device=dev, generator=g,
                    dtype=torch.bfloat16).requires_grad_()
    dy = torch.randn(RESNET_BATCH, h // 2, h // 2, 64, device=dev,
                     generator=g, dtype=torch.bfloat16)
    images = torch.rand(RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3,
                        device=dev, generator=g)
    labels = torch.zeros(RESNET_BATCH, dtype=torch.long, device=dev)
    augment = random_crop_flip(padding=4)

    def fused():
        max_pool_fused(x, (3, 3), (2, 2), "SAME").backward(dy)

    def plain():
        max_pool_same(x.permute(0, 3, 1, 2), 3, 2).backward(
            dy.permute(0, 3, 1, 2))

    def crop_flip(step):
        augment(augment_generator(seed, step, 0, dev), (images, labels))

    ops = {"maxpool_fused": fused, "maxpool_plain": plain,
           "crop_flip": crop_flip}
    times = {k: [] for k in ops}
    for i in range(reps + 1):
        for k, fn in ops.items():
            torch.cuda.synchronize()
            a = _event()
            fn(i) if k == "crop_flip" else fn()
            b = _event()
            b.synchronize()
            x.grad = None
            if i:  # the first turn warms
                times[k].append(a.elapsed_time(b))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    added = med["maxpool_fused"] - med["maxpool_plain"] + med["crop_flip"]
    row = {"phase": "imagenet_trainer_path_extras", "card": card,
           "stem_output": [RESNET_BATCH, h, h, 64], "reps": reps,
           **{f"{k}_ms": v for k, v in med.items()},
           **{f"{k}_ms_runs": sorted(v) for k, v in times.items()},
           "added_ms": added,
           "trainer_minus_bare_ms": {
               arm: r["step_ms_median"] - r["bare_step_ms"]
               for arm, r in rows.items() if r["bare_step_ms"]}}
    emit(row)
    check(all(math.isfinite(v) and v > 0 for v in med.values()),
          f"imagenet_trainer_path_extras: times {med}")
    return row


def imagenet_eager(dev, card, seed, bn, conv1, captured):
    """The twin's pipeline with ``--eager-step`` on the same card: the
    Trainer's steps of epoch 1 after the first, timed by events between
    iterations (no epoch end inside), against the captured arm's."""
    import gc
    import shutil
    import tempfile

    from chainermn_tpu_torch.examples import train_imagenet
    from chainermn_tpu_torch.training import Extension

    ckdir = tempfile.mkdtemp(prefix="cmn_imagenet_eager_")
    run = train_imagenet.build(train_imagenet.parse_args(
        imagenet_args(bn, conv1, ckdir) + ["--eager-step"]))
    tr = run.trainer
    marks = []
    tr.extend(Extension(lambda t: marks.append(_event()), (1, "iteration")))
    tr.stop_n, tr.stop_unit = IMAGENET_TIMED + 2, "iteration"
    tr.run()
    torch.cuda.synchronize()
    (step,) = tr.optimizer._step_cache.values()
    check(not step.graphs, f"imagenet_trainer {bn}/{conv1} eager: captured")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(marks[1:],
                                                        marks[2:]))
    run.train_iter.close()
    del run, tr, step
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckdir, ignore_errors=True)
    med = step_ms[len(step_ms) // 2]
    row = dict(phase="imagenet_trainer_eager", arm=f"{bn}/{conv1}",
               card=card, step_ms_median=med, step_ms_runs=step_ms,
               captured_step_ms=captured["step_ms_median"],
               captured_over_eager=captured["step_ms_median"] / med)
    emit(row)
    return row


def phase_imagenet_trainer(cf, dev, card, seed, bare):
    torch.backends.cudnn.benchmark = True
    try:
        rows = {f"{bn}/{c1}": imagenet_arm(cf, dev, card, seed, bn, c1,
                                           bare.get(f"{bn}/{c1}"))
                for bn, c1 in (("sync", "none"), ("frozen", "pallas"))}
        for key, row in rows.items():
            row["eager"] = imagenet_eager(dev, card, seed,
                                          *key.split("/"), row)
        imagenet_path_extras(dev, card, seed, rows)
    finally:
        torch.backends.cudnn.benchmark = False
    return rows


#: the wrong-mask control of ``lm_eval``: the plain attention with a
#: sliding window where the LM is causal over its whole length.
LM_EVAL_CONTROL_WINDOW = 256
#: ``lm_eval``'s limit on the largest relative difference between the
#: flash and the plain evaluation's per-row cross-entropy sums.  On an
#: H100 (seeds 0-2, 32 rows each) the flash rows differ by at most
#: 3.8e-5-6.0e-5, and the wrong-mask control's by 2.4e-3-3.3e-3: the
#: limit sits 5x above the one and 8x below the other.
LM_EVAL_ROW_RTOL = 3e-4


def phase_lm_eval(fa, dev, card, seed, val_rows=32, batch=LM_BATCH):
    """``train_lm --eval``'s evaluator (its metric and finalize) at the LM
    bench's geometry with flash attention: K1 launches per val batch, and
    each val row's cross-entropy sum, as the evaluator's metric computes
    it, against the same parameters evaluated with the plain attention;
    a plain evaluation with a wrong mask (a sliding window) is the
    control that the limit must tell apart."""
    import gc

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import ArrayDataset
    from chainermn_tpu_torch.examples.train_lm import (
        lm_eval_finalize,
        lm_eval_metric,
    )
    from chainermn_tpu_torch.extensions import (
        Evaluator,
        create_multi_node_evaluator,
    )
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import TransformerLM

    comm = create_communicator("xla", device=dev)
    rng = np.random.RandomState(seed + 11)
    toks = rng.randint(0, LM["vocab"], size=(val_rows, LM["max_len"] + 1))
    val = ArrayDataset(toks[:, :-1].astype(np.int32),
                       toks[:, 1:].astype(np.int32))
    out, rows = {}, {}
    state = None
    for arm, impl, window in (("flash", "flash", 0), ("plain", "xla", 0),
                              ("control", "xla", LM_EVAL_CONTROL_WINDOW)):
        model = TransformerLM(**LM, attention=impl, window=window,
                              device=dev, seed=seed)
        if state is None:
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        model.eval()
        metric, kept = lm_eval_metric(model), []

        def recording(m, b, metric=metric, kept=kept):
            got = metric(m, b)
            kept.append(got["ce_sum"])
            return got

        ev = create_multi_node_evaluator(Evaluator(
            lambda: SerialIterator(val, batch, repeat=False, shuffle=False),
            recording, comm, finalize=lm_eval_finalize), comm)
        ev.evaluate(model)  # warm
        torch.cuda.synchronize()
        kept.clear()
        reset_flash(fa)
        t0 = time.perf_counter()
        scores = ev.evaluate(model)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / ev.batches
        rows[arm] = torch.cat(kept).double().cpu()
        out[arm] = dict(val_ppl=scores["val_ppl"],
                        val_loss=math.log(scores["val_ppl"]),
                        val_tokens=scores["val_tokens"], batches=ev.batches,
                        ms_per_batch=ms, launches=flash_launches(fa))
        del model, ev, kept
        gc.collect()
        torch.cuda.empty_cache()
    flash, plain, control = out["flash"], out["plain"], out["control"]
    per_batch = flash["launches"]["flash_attention_fwd"] / flash["batches"]

    def row_gap(arm):
        d = (rows[arm] - rows["plain"]).abs() / rows["plain"].abs()
        return float(d.max())

    gap, control_gap = row_gap("flash"), row_gap("control")
    emit({"phase": "lm_eval", "card": card, "rows": val_rows, "batch": batch,
          "seq_len": LM["max_len"], "flash": flash, "plain": plain,
          "control": {**control, "window": LM_EVAL_CONTROL_WINDOW},
          "k1_launches_per_val_batch": per_batch,
          "row_ce_sum_max_rel_diff": gap,
          "control_row_ce_sum_max_rel_diff": control_gap,
          "control_row_ce_sum_min_rel_diff": float(
              ((rows["control"] - rows["plain"]).abs()
               / rows["plain"].abs()).min()),
          "val_loss_rel_diff": abs(flash["val_loss"] - plain["val_loss"])
          / abs(plain["val_loss"]),
          "tolerance": {"row_rtol": LM_EVAL_ROW_RTOL}})
    check(per_batch == LM["n_layers"]
          and flash["launches"]["flash_attention_bwd_dkv"] == 0
          and flash["launches"]["flash_attention_bwd_dq"] == 0,
          f"lm_eval: flash launches {flash['launches']} over "
          f"{flash['batches']} val batches, expected {LM['n_layers']} K1 "
          "per batch and no backward kernel")
    check(all(v == 0 for a in ("plain", "control")
              for v in out[a]["launches"].values()),
          "lm_eval: a plain evaluation launched a flash kernel")
    check(all(math.isfinite(out[a]["val_loss"]) for a in out)
          and rows["flash"].shape == (val_rows,),
          f"lm_eval: val losses {[out[a]['val_loss'] for a in out]}, "
          f"{tuple(rows['flash'].shape)} rows")
    check(gap <= LM_EVAL_ROW_RTOL < control_gap,
          f"lm_eval: per-row cross-entropy sums differ from the plain "
          f"evaluation's by up to {gap} relative (limit "
          f"{LM_EVAL_ROW_RTOL}); the wrong-mask control by {control_gap}")
    return flash


# -------------------------------------------------------------- model zoo
#: the NMT bench's default geometry (benchmarks/seq2seq.py:22-33): 6 + 6
#: layers, d_model 512, 8 heads, d_ff 2048, vocab 32000, src/tgt 512, batch
#: 64, bf16 compute, AdamW 3e-4, a bf16 gradient wire.
SEQ2SEQ = dict(vocab_src=32000, vocab_tgt=32000, d_model=512, n_heads=8,
               d_ff=2048, n_enc=6, n_dec=6, max_len=512)
SEQ2SEQ_BATCH = 64
#: the bucketed tier's non-pad share the bench simulates (:123-133).
SEQ2SEQ_NONPAD = 0.87
#: greedy and beam decoding after training: rows and positions (the
#: decoders re-apply the whole model per position; the bench decodes
#: nothing).
SEQ2SEQ_DECODE = dict(rows=2, max_len=32, beam=4)
#: ViT-S/16 at 224 px, batch 256, SGD 0.1 momentum 0.9 (bench.py:1140-1169).
VIT_BATCH, VIT_SIZE, VIT_CLASSES = 256, 224, 1000
#: the LoRA rank on the LM bench's geometry.
LORA_RANK = 16


def zoo_arm(fa, dev, card, phase, label, build, comm, batch, units,
            warmup=2, timed=5, capture=None, stateful=False, group=lm_group,
            trace=True):
    """``warmup`` + ``timed`` steps of one model's train step through the
    entry path (``create_multi_node_optimizer(tx, comm)`` ->
    ``make_train_step``), captured (the default on the card) or eager,
    then (``trace``) one profiled step whose kernel count must equal the
    capture's record.  ``build()`` gives ``(module, loss_fn, tx)``;
    ``units`` is what one step processes (tokens or images)."""
    import gc

    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    module, loss_fn, tx = build()
    opt = create_multi_node_optimizer(tx, comm)
    state = opt.init(module)
    step = opt.make_train_step(loss_fn, has_aux=not stateful,
                               stateful=stateful, capture=capture)
    losses = []
    for _ in range(warmup):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    reset_flash(fa)
    r0 = replays_of(step)
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # syncs: the step is done
        times.append(time.perf_counter() - t0)
    launches = step_launches(step, flash_launches(fa),
                             replays_of(step) - r0)
    peak = torch.cuda.max_memory_allocated()
    mode = "captured" if step_graph(step) is not None else "eager"
    traced = None
    if trace:
        tr, traced = traced_step(
            f"{phase} {label} {mode}",
            {"phase": f"{phase}_trace", "arm": label, "mode": mode,
             "card": card}, step, state, batch,
            {k: v // timed for k, v in launches.items()}, group=group)
        losses.append(tr["loss"])
    step_ms = sorted(times)[len(times) // 2] * 1e3
    row = dict(phase=phase, arm=label, mode=mode, card=card,
               trained_params=sum(p.numel() for p in module.parameters()),
               warmup_steps=warmup, timed_steps=timed, losses=losses,
               step_ms_median=step_ms, step_ms_runs=[t * 1e3 for t in times],
               units_per_step=units, units_per_s=units / (step_ms / 1e3),
               peak_memory_gb=peak / 1e9,
               optimizer_state_bytes=sum(
                   v.numel() * v.element_size()
                   for st in state.optimizer.state.values()
                   for v in st.values() if isinstance(v, torch.Tensor)),
               launches=launches,
               launches_per_step={k: v / timed for k, v in launches.items()},
               launches_per_replay_profiled=traced,
               captures=len(getattr(step, "graphs", {})),
               replays=replays_of(step))
    emit(row)
    check(all(math.isfinite(x) for x in losses),
          f"{phase} {label}: non-finite loss {losses}")
    if mode == "captured":
        step.release()
    del module, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def check_flash_per_step(label, row, want):
    """K1-K3 runs per step, counted and in the profiled replay."""
    for k, n in want.items():
        got = row["launches_per_step"][k]
        prof = (row["launches_per_replay_profiled"] or {}).get(k, got)
        check(got == n and prof == n,
              f"{label}: {k} ran {got} times per step ({prof} in the "
              f"profiled replay), expected {n}")


def seq2seq_batch(seed, dev, packed=False):
    """The bench's batch (``benchmarks/seq2seq.py:98-133``): bucketed rows
    of random tokens whose last 13% are PAD, or (``packed``) pairs drawn
    around 0.4 of the row width packed by ``pack_pairs``.  Returns the
    device batch, its non-pad target tokens and the packing efficiency."""
    from chainermn_tpu_torch.datasets import pack_pairs, packing_efficiency
    from chainermn_tpu_torch.datasets.seq import PAD

    rng = np.random.RandomState(seed)
    B, L, V = SEQ2SEQ_BATCH, SEQ2SEQ["max_len"], SEQ2SEQ["vocab_src"]
    if packed:
        def draw(mean, cap):
            n = int(np.clip(rng.normal(mean, 0.25 * mean), 4, cap))
            return rng.randint(3, V, size=n).astype(np.int32)

        pairs = []
        while True:
            pairs.extend((draw(0.4 * L, L), draw(0.4 * L, L))
                         for _ in range(B * 2))
            arrays = pack_pairs(pairs, L, L)
            if arrays[0].shape[0] >= B:
                break
        arrays = [a[:B] for a in arrays]
        real, eff = int((arrays[3] != 0).sum()), packing_efficiency(arrays[3])
    else:
        arrays = []
        for _ in range(2):
            toks = rng.randint(3, V, size=(B, L)).astype(np.int32)
            toks[:, max(1, int(round(L * SEQ2SEQ_NONPAD))):] = PAD
            arrays.append(toks)
        real, eff = int((arrays[1] != PAD).sum()), None
    return tuple(torch.from_numpy(a).to(dev) for a in arrays), real, eff


def seq2seq_mask_specs(seed):
    """Flash parity at the model's mask shapes (B 64, T = S = 512, 8
    heads): the encoder's segment-masked non-causal self-attention
    (real 1 / pad 0), the decoder's causal self-attention on packed rows,
    and cross-attention of packed target rows against source rows that
    half the time have no pad tail (their pad queries match no key)."""
    from chainermn_tpu_torch.datasets.seq import PAD

    rng = np.random.RandomState(seed)
    B, L, H = SEQ2SEQ_BATCH, SEQ2SEQ["max_len"], SEQ2SEQ["n_heads"]
    n_real = int(round(L * SEQ2SEQ_NONPAD))
    pad_seg = seg_runs([[(1, n_real), (PAD, L - n_real)]] * B, L)
    tgt_rows, src_rows = [], []
    for r in range(B):
        # Two target pairs of 20-47% of the row each, a pad tail after;
        # the source's first pair 30-70% of the row.
        a, b = (int(x) for x in rng.randint(L // 5, L * 15 // 32, size=2))
        tgt_rows.append([(1, a), (2, b), (0, L - a - b)])
        c = int(rng.randint(L * 3 // 10, L * 7 // 10))
        src_rows.append([(1, c), (2, L - c)] if r % 2 == 0 else
                        [(1, c), (2, (L - c) // 2), (0, L - c - (L - c) // 2)])
    tgt_seg, src_seg = seg_runs(tgt_rows, L), seg_runs(src_rows, L)
    return {"encoder": (B, L, L, H, H, dict(segment_ids=pad_seg)),
            "decoder_packed": (B, L, L, H, H, dict(causal=True,
                                                   segment_ids=tgt_seg)),
            "cross_packed_dead_rows": (B, L, L, H, H, dict(
                segment_ids=tgt_seg, kv_segment_ids=src_seg))}


def phase_seq2seq(fa, dev, card, seed):
    """``TransformerSeq2Seq`` at the NMT bench's geometry: the flash arm
    captured and eager, the eager-attention ("xla") arm captured, the
    packed arm; K1-K3 per step (6 encoder, 6 decoder and 6 cross layers:
    18 each); flash against the plain path at the model's mask shapes;
    greedy and beam decoding."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import (
        TransformerSeq2Seq,
        beam_decode,
        greedy_decode,
        seq2seq_loss,
    )
    from chainermn_tpu_torch.optimizers import adamw

    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)

    def arm_build(impl):
        def build():
            m = TransformerSeq2Seq(**SEQ2SEQ, dtype=torch.bfloat16,
                                   attention=impl, device=dev, seed=seed)
            return m, seq2seq_loss(m), adamw(3e-4)
        return build

    batch, real, _ = seq2seq_batch(seed, dev)
    per_layer = 3 * SEQ2SEQ["n_enc"]  # encoder self, decoder self, cross
    want = {k: per_layer for k in FLASH}
    arms = {}
    arms["flash"] = zoo_arm(fa, dev, card, "seq2seq", "flash",
                            arm_build("flash"), comm, batch, real)
    check(arms["flash"]["captures"] == 1, "seq2seq: the flash step was not "
          "captured once")
    check_flash_per_step("seq2seq flash", arms["flash"], want)
    check(arms["flash"]["losses"][-1] < arms["flash"]["losses"][0],
          f"seq2seq: the flash loss did not fall: {arms['flash']['losses']}")
    arms["flash_eager"] = zoo_arm(fa, dev, card, "seq2seq", "flash",
                                  arm_build("flash"), comm, batch, real,
                                  capture=False, trace=False)
    check_flash_per_step("seq2seq flash eager", arms["flash_eager"], want)
    try:
        arms["xla"] = zoo_arm(fa, dev, card, "seq2seq", "xla",
                              arm_build("xla"), comm, batch, real, timed=3)
        check(all(v == 0 for v in arms["xla"]["launches"].values()),
              "seq2seq: the eager-attention arm launched a flash kernel")
    except torch.cuda.OutOfMemoryError as e:
        # As the bench records it: the materialized scores' failure is
        # this arm's result, not the phase's.
        arms["xla"] = {"error": f"OutOfMemoryError: {str(e)[:200]}"}
        emit({"phase": "seq2seq", "arm": "xla", "card": card,
              **arms["xla"]})
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    pbatch, preal, eff = seq2seq_batch(seed, dev, packed=True)
    arms["packed"] = zoo_arm(fa, dev, card, "seq2seq", "packed_flash",
                             arm_build("flash"), comm, pbatch, preal)
    check_flash_per_step("seq2seq packed", arms["packed"], want)

    g = torch.Generator().manual_seed(seed + 31)
    parity = {name: flash_case(fa, g, dev, spec, SEQ2SEQ["d_model"]
                               // SEQ2SEQ["n_heads"], torch.bfloat16)
              for name, spec in seq2seq_mask_specs(seed).items()}

    # Decoding on a few rows: the whole model re-applied per position,
    # 18 K1 launches per forward; beam=1 against greedy in fp32 (a small
    # model: near-ties cannot flip tokens there).
    model = TransformerSeq2Seq(**SEQ2SEQ, dtype=torch.bfloat16,
                               attention="flash", device=dev, seed=seed)
    n, rows, beam = (SEQ2SEQ_DECODE[k] for k in ("max_len", "rows", "beam"))
    src = batch[0][:rows]
    decode = {}
    for name, fn in (("greedy", lambda: greedy_decode(model, src, n)),
                     ("beam", lambda: beam_decode(model, src, n, beam=beam))):
        torch.cuda.synchronize()
        reset_flash(fa)
        t0 = time.perf_counter()
        toks = fn()
        torch.cuda.synchronize()
        decode[name] = dict(ms=(time.perf_counter() - t0) * 1e3,
                            shape=list(toks.shape),
                            launches=flash_launches(fa),
                            tokens_row0=toks[0].tolist())
        check(tuple(toks.shape) == (rows, n) and int(toks.min()) >= 0
              and int(toks.max()) < SEQ2SEQ["vocab_tgt"],
              f"seq2seq {name} decode: tokens {tuple(toks.shape)}")
        check(decode[name]["launches"]["flash_attention_fwd"] == per_layer * n
              and decode[name]["launches"]["flash_attention_bwd_dq"] == 0,
              f"seq2seq {name} decode: {decode[name]['launches']}, expected "
              f"{per_layer} K1 per forward x {n} forwards")
    del model
    small = TransformerSeq2Seq(vocab_src=512, vocab_tgt=512, d_model=128,
                               n_heads=2, d_ff=256, n_enc=2, n_dec=2,
                               max_len=64, attention="flash", device=dev,
                               seed=seed)
    ssrc = torch.randint(3, 512, (4, 64), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(seed))
    decode["fp32_beam1_equals_greedy"] = bool(torch.equal(
        beam_decode(small, ssrc, 24, beam=1), greedy_decode(small, ssrc, 24)))
    emit({"phase": "seq2seq_summary", "card": card,
          "geometry": {**SEQ2SEQ, "batch": SEQ2SEQ_BATCH,
                       "nonpad": SEQ2SEQ_NONPAD},
          "nonpad_tgt_tokens": real, "packed_nonpad_tgt_tokens": preal,
          "packing_efficiency": eff,
          "step_ms": {k: a.get("step_ms_median") for k, a in arms.items()},
          "nonpad_tgt_tokens_per_s": {k: a.get("units_per_s")
                                      for k, a in arms.items()},
          "xla": arms["xla"].get("error", "ran"),
          "captured_over_eager_step_ratio":
          arms["flash"]["step_ms_median"]
          / arms["flash_eager"]["step_ms_median"],
          "flash_parity": parity, "decode": decode,
          "tolerance": {"bf16": FLASH_TOL[torch.bfloat16],
                        "lse": FLASH_TOL["lse"]}})
    for name, r in parity.items():
        for key in ("o", "dq", "dk", "dv", "lse"):
            t = FLASH_TOL["lse" if key == "lse" else torch.bfloat16]["atol"]
            check(r[key] <= t, f"seq2seq flash parity {name}: {key} excess "
                  f"{r[key]} > {t}")
        check(r["dead_rows_exact"] and r["finite"],
              f"seq2seq flash parity {name}: dead rows exact "
              f"{r['dead_rows_exact']}, finite {r['finite']}")
    check(parity["cross_packed_dead_rows"]["dead_rows"] > 0,
          "seq2seq flash parity: the cross case has no dead row")
    check(decode["fp32_beam1_equals_greedy"],
          "seq2seq: beam_decode(beam=1) differs from greedy_decode in fp32")
    return {"arms": arms, "decode": decode}


#: the twin's epochs on the card, and the corpus BLEU each arch must reach
#: there.  At the default 3 epochs BLEU is 4-gram noise (1.2-1.9 on the
#: CPU for the JAX example and the twin alike); after 20 the JAX example
#: reaches 46.9 (LSTM) and 97.7 (Transformer), the twin 44.2-46.2 and
#: 93.6-99.0 over seeds 0-2 (``scripts/seq2seq_twins.py``,
#: ``result/seq2seq_twins_cpu*.json``).
S2S_EXAMPLE_EPOCHS = 20
S2S_EXAMPLE_MIN_BLEU = {"lstm": 25.0, "transformer": 50.0}


def phase_seq2seq_example(dev, card):
    """The twin ``examples/seq2seq.py`` at its defaults (batch 64, bucket
    width 4) for ``S2S_EXAMPLE_EPOCHS`` epochs over the synthetic corpus,
    LSTM and Transformer: the loss and token accuracy per epoch, corpus
    BLEU (at least ``S2S_EXAMPLE_MIN_BLEU``), and the captures it makes
    (one per bucket signature) with the card bytes they hold."""
    import gc

    from chainermn_tpu_torch.examples import seq2seq as twin

    out = {}
    for arch in ("lstm", "transformer"):
        gc.collect()
        torch.cuda.empty_cache()
        args = twin.parse_args(["--arch", arch,
                                "--epoch", str(S2S_EXAMPLE_EPOCHS)])
        comm, model, trainer, ev, _ = twin.build(args)
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        steps = list(trainer.optimizer._step_cache.values())
        signatures = {tuple(tuple(a.shape) for a in b)
                      for b in trainer.train_iter.batches}
        captures = sum(len(s.graphs) for s in steps)
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        scores = ev.evaluate(model)
        eval_s = time.perf_counter() - t0
        for s in steps:
            s.release()
        gc.collect()
        graph_bytes = held - torch.cuda.memory_allocated()
        log = trainer.extensions[0].log
        row = dict(phase="seq2seq_example", arch=arch, card=card,
                   epochs=args.epoch, steps=trainer.iteration,
                   batches_per_epoch=len(trainer.train_iter.batches),
                   signatures=len(signatures), captures=captures,
                   captured_graph_bytes=graph_bytes, train_s=train_s,
                   steps_per_s=trainer.iteration / train_s,
                   epochs_log=[{k: e[k] for k in ("epoch", "loss",
                                                  "token_accuracy")}
                               for e in log],
                   eval_s=eval_s, **scores)
        emit(row)
        check(captures == len(signatures),
              f"seq2seq_example {arch}: {captures} captures for "
              f"{len(signatures)} bucket signatures")
        check(math.isfinite(log[-1]["loss"])
              and S2S_EXAMPLE_MIN_BLEU[arch] <= scores["bleu"] <= 100
              and scores["n_sentences"] == 512,
              f"seq2seq_example {arch}: loss {log[-1]['loss']}, {scores}")
        out[arch] = row
        del model, trainer, ev, steps
    return out


def phase_vit(fa, dev, card, seed):
    """ViT-S/16 at 224 px, batch 256, SGD 0.1 momentum 0.9, a bf16 wire
    (the bench's ``--arch vit``), captured and eager: images/s and K1-K3
    per step (12 layers, no remat: 12 each); then the ``train_imagenet
    --arch vit`` twin for 3 steps under LARS with warmup."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.examples import train_imagenet
    from chainermn_tpu_torch.models import ViT, vit_loss
    from chainermn_tpu_torch.optimizers import sgd

    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    batch = (torch.rand((VIT_BATCH, VIT_SIZE, VIT_SIZE, 3), generator=g,
                        device=dev),
             torch.randint(0, VIT_CLASSES, (VIT_BATCH,), generator=g,
                           device=dev))

    def build():
        m = ViT(num_classes=VIT_CLASSES, image_size=VIT_SIZE, device=dev,
                seed=seed)
        return m, vit_loss(m), sgd(0.1, 0.9)

    want = {k: 12 for k in FLASH}
    cap = zoo_arm(fa, dev, card, "vit", "s16", build, comm, batch,
                  VIT_BATCH)
    check(cap["captures"] == 1, "vit: the step was not captured once")
    check_flash_per_step("vit", cap, want)
    eager = zoo_arm(fa, dev, card, "vit", "s16", build, comm, batch,
                    VIT_BATCH, capture=False, trace=False)
    check_flash_per_step("vit eager", eager, want)
    # Flash against the plain path at the model's attention shape: batch
    # 256, T = 196 (a multiple of no tile), 6 heads, Dh 64, bf16.
    T = (VIT_SIZE // 16) ** 2
    parity = flash_case(fa, torch.Generator().manual_seed(seed + 23), dev,
                        (VIT_BATCH, T, T, 6, 6, {}), 64, torch.bfloat16)
    t0 = time.perf_counter()
    loss = train_imagenet.main(["--arch", "vit", "--optimizer", "lars",
                                "--base-batch", "256", "--warmup-epochs",
                                "1", "--batch-per-chip", "64",
                                "--iters-per-epoch", "3", "--steps", "3"])
    check(math.isfinite(loss), f"train_imagenet --arch vit: loss {loss}")
    emit({"phase": "vit_summary", "card": card, "batch": VIT_BATCH,
          "image_size": VIT_SIZE, "tokens": (VIT_SIZE // 16) ** 2,
          "images_per_s_captured": cap["units_per_s"],
          "images_per_s_eager": eager["units_per_s"],
          "captured_over_eager_step_ratio":
          cap["step_ms_median"] / eager["step_ms_median"],
          "launches_per_step": cap["launches_per_step"],
          "flash_parity": parity,
          "train_imagenet_vit_lars": {"steps": 3, "final_loss": loss,
                                      "wall_s": time.perf_counter() - t0}})
    for key in ("o", "dq", "dk", "dv", "lse"):
        t = FLASH_TOL["lse" if key == "lse" else torch.bfloat16]["atol"]
        check(parity[key] <= t and parity["finite"],
              f"vit flash parity: {key} excess {parity[key]} > {t}")
    return cap


def lm_batch(seed, dev):
    """The LM bench's fixed batch (targets = tokens, benchmarks/lm.py)."""
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(
        0, LM["vocab"], size=(LM_BATCH, LM["max_len"]))).to(dev)
    return toks, toks


def phase_lora(fa, dev, card, seed):
    """LoRA rank 16 on the LM bench's geometry (flash, remat, bf16 wire,
    AdamW 3e-4) against full fine-tuning of the same model, both
    captured: step ms, trained parameters, optimizer-state bytes; the
    base stays frozen."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import (
        TransformerLM,
        lm_loss,
        lora_init,
        make_lora_loss,
    )
    from chainermn_tpu_torch.optimizers import adamw

    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    batch = lm_batch(seed, dev)
    base = {}

    def full():
        m = TransformerLM(**LM, attention="flash", remat=True, device=dev,
                          seed=seed)
        return m, lm_loss(m), adamw(3e-4)

    def adapted():
        m = TransformerLM(**LM, attention="flash", remat=True, device=dev,
                          seed=seed)
        lora = lora_init(m, LORA_RANK, seed=1)
        # The parametrized layer's frozen weight.
        base["w"] = m.blocks[0].qkv.parametrizations.weight.original
        base["w0"] = base["w"].clone()
        base["lora"] = lora
        return lora, make_lora_loss(lm_loss(m)), adamw(3e-4)

    tokens = batch[0].numel()
    L = LM["n_layers"]
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L,
            "flash_attention_bwd_dq": L}
    f = zoo_arm(fa, dev, card, "lora", "full", full, comm, batch, tokens)
    a = zoo_arm(fa, dev, card, "lora", f"rank{LORA_RANK}", adapted, comm,
                batch, tokens)
    check_flash_per_step("lora", a, want)
    moved = float(base["lora"].adapter("blocks.0.qkv").b.detach().abs()
                  .sum())
    frozen = torch.equal(base["w"], base["w0"])
    emit({"phase": "lora_summary", "card": card, "rank": LORA_RANK,
          "step_ms_full": f["step_ms_median"],
          "step_ms_lora": a["step_ms_median"],
          "lora_over_full_step_ratio":
          a["step_ms_median"] / f["step_ms_median"],
          "trained_params_full": f["trained_params"],
          "trained_params_lora": a["trained_params"],
          "optimizer_state_bytes_full": f["optimizer_state_bytes"],
          "optimizer_state_bytes_lora": a["optimizer_state_bytes"],
          "peak_memory_gb_full": f["peak_memory_gb"],
          "peak_memory_gb_lora": a["peak_memory_gb"],
          "adapter_b_abs_sum": moved, "base_unchanged": frozen})
    check(frozen and moved > 0, f"lora: base unchanged {frozen}, adapters "
          f"moved {moved}")
    check(a["optimizer_state_bytes"] * 50 < f["optimizer_state_bytes"],
          "lora: the optimizer state is not adapter-sized")
    base.clear()
    return a


def phase_large_batch(fa, dev, card, seed, sgd_resnet_ms, adamw_lm_ms):
    """The ResNet-50 ``sync/none`` step (the bench's batch) under LARS and
    LAMB with the kernel mask and under scheduled SGD, and the LM bench's
    step under Adafactor and scheduled AdamW, all captured, against the
    same call's constant-rate SGD-momentum and AdamW steps (``resnet`` and
    ``training`` phases)."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import ResNet50, TransformerLM
    from chainermn_tpu_torch.models import lm_loss, resnet_loss
    from chainermn_tpu_torch.optimizers import (
        adafactor,
        adamw,
        kernel_mask,
        lamb,
        lars,
        sgd,
        warmup_cosine_schedule,
    )
    from chainermn_tpu_torch.utils import (
        flax_shapes,
        params_to_flax,
        resnet_params_to_flax,
    )

    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    rbatch = (torch.randn((RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3),
                          generator=g, device=dev),
              torch.randint(0, RESNET_CLASSES, (RESNET_BATCH,), generator=g,
                            device=dev))

    # train_imagenet --warmup-epochs / train_lm --warmup: a ramp of 100
    # steps into cosine decay over 1000, evaluated on the card.
    def sched(peak):
        return warmup_cosine_schedule(peak, 100, 1000)

    def resnet(make_tx):
        def build():
            m = ResNet50(num_classes=RESNET_CLASSES,
                         axis_name=comm.axis_name, device=dev, seed=seed)
            return m, resnet_loss(m), make_tx(m)
        return build

    def lm(make_tx):
        def build():
            m = TransformerLM(**LM, attention="flash", remat=True,
                              device=dev, seed=seed)
            return m, lm_loss(m), make_tx(m)
        return build

    def lm_shapes(m):
        return flax_shapes(m, functools.partial(
            params_to_flax, n_heads=m.n_heads, n_kv_heads=m.n_kv_heads))

    resnet_arms = (
        ("lars", lambda m: lars(
            0.1, mask=kernel_mask(m, resnet_params_to_flax))),
        ("lamb", lambda m: lamb(
            0.1, mask=kernel_mask(m, resnet_params_to_flax))),
        ("sgd_warmup", lambda m: sgd(sched(0.1), 0.9)))
    lm_arms = (
        ("adafactor", lambda m: adafactor(3e-4, shapes=lm_shapes(m))),
        ("adamw_warmup", lambda m: adamw(sched(3e-4))))
    rows = {}
    for name, make_tx in resnet_arms:
        rows[name] = zoo_arm(fa, dev, card, "large_batch", f"resnet50_{name}",
                             resnet(make_tx), comm, rbatch, RESNET_BATCH,
                             stateful=True, group=resnet_group)
    for name, make_tx in lm_arms:
        rows[name] = zoo_arm(fa, dev, card, "large_batch", f"lm_{name}",
                             lm(make_tx), comm, lm_batch(seed, dev),
                             LM_BATCH * LM["max_len"])
    L = LM["n_layers"]
    for name, _ in lm_arms:
        check_flash_per_step(f"large_batch {name}", rows[name],
                             {"flash_attention_fwd": 2 * L,
                              "flash_attention_bwd_dkv": L,
                              "flash_attention_bwd_dq": L})
    for name, r in rows.items():
        check(r["captures"] == 1, f"large_batch {name}: not captured once")
    emit({"phase": "large_batch_summary", "card": card,
          "resnet50_sgd_momentum_step_ms": sgd_resnet_ms,
          "resnet50_lars_step_ms": rows["lars"]["step_ms_median"],
          "resnet50_lamb_step_ms": rows["lamb"]["step_ms_median"],
          "resnet50_sgd_warmup_step_ms":
          rows["sgd_warmup"]["step_ms_median"],
          "lm_adamw_step_ms": adamw_lm_ms,
          "lm_adafactor_step_ms": rows["adafactor"]["step_ms_median"],
          "lm_adamw_warmup_step_ms": rows["adamw_warmup"]["step_ms_median"],
          "lars_over_sgd": rows["lars"]["step_ms_median"] / sgd_resnet_ms,
          "lamb_over_sgd": rows["lamb"]["step_ms_median"] / sgd_resnet_ms,
          "sgd_warmup_over_sgd":
          rows["sgd_warmup"]["step_ms_median"] / sgd_resnet_ms,
          "adafactor_over_adamw":
          rows["adafactor"]["step_ms_median"] / adamw_lm_ms,
          "adamw_warmup_over_adamw":
          rows["adamw_warmup"]["step_ms_median"] / adamw_lm_ms,
          "optimizer_state_bytes": {k: r["optimizer_state_bytes"]
                                    for k, r in rows.items()}})
    return rows


# ------------------------------------------------------------------ SASS
#: the bf16 flash kernels (K1, K2, K3) by the name of their function, each
#: instantiated at head dims 32, 64 and 128, and the bf16 fused 1x1-conv
#: kernel (K6), instantiated at column tiles 64 and 128: every one must be
#: built on Hopper's wgmma and TMA.
# ------------------------------------------------------ model parallel
#: BASELINE.json configuration 4 at VGG-11's published widths (64-512):
#: 32x32x3 inputs, 10 classes, 4 stages on 4 ranks x 1 data rank.
MP = dict(cfg="vgg11", num_classes=10, n_stages=4, width_mult=1.0)
MP_BATCH = 64
MP_LR = 0.01
MP_AGREE_STEPS = 3
MP_WARMUP, MP_TIMED = 2, 5
#: Each launched job's time limit: a hang fails the phase.
MP_TIMEOUT_S = 420
#: The seq2seq twin's held-out pairs (``make_synthetic_translation(512,
#: ..., seed=99)``), which its evaluator shares out over the ranks.
S2S_HELD_OUT = 512
#: The 4-rank chain against the one-process network, fp32 with TF32 off
#: and cuDNN deterministic on both sides: the same convolutions on the
#: same shapes, so the only differences are the order of the gradient
#: sums (the broadcast's backward adds four equal copies, then divides by
#: 4).  Losses within rtol 1e-5; parameters elementwise within atol 1e-6
#: + rtol 1e-5 after 3 SGD steps of lr 0.01.
MP_TOL = dict(loss_rtol=1e-5, param_atol=1e-6, param_rtol=1e-5)
MP_NOTE = ("4 ranks share one card over gloo, each wire message staged "
           "through pinned host memory: a check of the model-parallel "
           "path, not a scaling figure")


def mp_batches(n: int):
    """The twin's synthetic CIFAR-shaped data (``RandomState(0)``), cut
    into ``n`` batches of ``MP_BATCH``."""
    from chainermn_tpu_torch.examples.train_vgg_model_parallel import (
        synthetic_cifar,
    )

    x, y = synthetic_cifar(MP["num_classes"])
    return [(x[i * MP_BATCH:(i + 1) * MP_BATCH],
             y[i * MP_BATCH:(i + 1) * MP_BATCH]) for i in range(n)]


def _fp32_exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


WIRE_METHODS = ("post_send", "recv_tensor", "wait_pending", "broadcast",
                "reduce", "bcast_obj", "allreduce", "allreduce_grad")


def time_wire(comms, dev, box, methods=WIRE_METHODS):
    """Wrap the communicators' wire ``methods`` to add their wall seconds
    (after a card sync, so queued compute is not counted) to
    ``box["s"]``."""
    def wrap(fn):
        def timed(*a, **k):
            _sync(dev)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                _sync(dev)
                box["s"] += time.perf_counter() - t0
        return timed

    for c in comms:
        for name in methods:
            setattr(c, name, wrap(getattr(c, name)))


def mp_vgg_rank(out: str, device: str) -> None:
    """One rank of the 4-rank model-parallel VGG-11 (run by
    ``phase_model_parallel`` through the port's launcher): the user's
    path (``create_communicator("naive", device=...)`` on a ``data x
    model`` grid, ``build_chain``, ``create_multi_node_optimizer`` with
    ``model_parallel_grad_reduce``, ``make_train_step``), 3 agreement
    steps, then timed steps, then steps with the wire timed."""
    import pickle

    from chainermn_tpu_torch import functions as MF
    from chainermn_tpu_torch.comm import create_communicator, hybrid_mesh
    from chainermn_tpu_torch.models import (
        build_chain,
        vgg_loss,
        vgg_stage_modules,
    )
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        model_parallel_grad_reduce,
        sgd,
    )

    dev = torch.device(device)
    _fp32_exact()
    S = MP["n_stages"]
    comm = create_communicator("naive", device=dev,
                               mesh=hybrid_mesh({"data": 1, "model": S}))
    dcomm, mcomm = comm.sub("data"), comm.sub("model")
    r = mcomm.rank
    chain = build_chain(vgg_stage_modules(**MP, device=dev, seed=0,
                                          stages=[r]), mcomm)

    def loss_fn(model, batch):
        x = torch.as_tensor(batch[0], device=dev)
        logits = MF.bcast(mcomm, model(x), root=S - 1)
        return vgg_loss(logits, batch[1])[0]

    opt = create_multi_node_optimizer(
        sgd(MP_LR, momentum=0.9), dcomm,
        grad_reduce=model_parallel_grad_reduce(dcomm, mcomm))
    state = opt.init(chain)
    step = opt.make_train_step(loss_fn)
    batches = mp_batches(MP_AGREE_STEPS)
    losses = [float(step(state, b)[1]["loss"]) for b in batches]
    params = {n: p.detach().cpu().numpy().copy()
              for n, p in chain.stages[0].named_parameters()}
    times = []
    for i in range(MP_WARMUP + MP_TIMED):
        _sync(dev)
        t0 = time.perf_counter()
        float(step(state, batches[0])[1]["loss"])
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    box = {"s": 0.0}
    time_wire((mcomm, dcomm), dev, box)
    t0 = time.perf_counter()
    for _ in range(MP_TIMED):
        float(step(state, batches[0])[1]["loss"])
    _sync(dev)
    wired = time.perf_counter() - t0
    with open(os.path.join(out, f"vgg.rank{comm.rank}.pkl"), "wb") as f:
        pickle.dump({"rank": r, "losses": losses, "params": params,
                     "step_ms": times[MP_WARMUP:],
                     "wire_share": box["s"] / wired,
                     "params_held": sum(p.numel()
                                        for p in chain.parameters()),
                     "captured": bool(step.graphs)}, f)
    comm.barrier()


def mp_grid_rank(out: str, device: str) -> None:
    """One rank of the 2-rank ``data x model`` = 2 x 1 grid on one card
    (``phase_model_parallel_grid``): ``sub``/``split`` and every
    collective on card tensors through the staged gloo wire, the
    differentiable broadcast and the MPMD send/recv with their
    gradients, and a ragged all-reduce."""
    import pickle

    from chainermn_tpu_torch import functions as MF
    from chainermn_tpu_torch.comm import (
        create_communicator,
        hybrid_mesh,
        ragged_allreduce,
    )

    dev = torch.device(device)
    res = {}
    try:
        create_communicator("xla", device=dev)
        res["nccl_same_card"] = "no error"
    except ValueError as e:
        res["nccl_same_card"] = str(e)
    comm = create_communicator("naive", device=dev,
                               mesh=hybrid_mesh({"data": 2, "model": 1}))
    # The refusal came before any group: the default group is gloo.
    res["default_backend"] = torch.distributed.get_backend()
    torch.distributed.barrier()
    d, m = comm.sub("data"), comm.sub("model")
    r = comm.rank
    res["sub"] = (d.members, m.members, d.rank, m.rank)
    res["split"] = {c: s.members for c, s in comm.split([0, 1]).items()}
    x = torch.tensor([r + 1.0, -r], device=dev)
    got = {"allgather": d.allgather(x), "alltoall": d.alltoall(
        torch.stack([x, 10 * x])), "permute": d.permute(x, [(0, 1),
                                                            (1, 0)]),
           "allreduce": d.allreduce(x), "broadcast": d.broadcast(x, 1),
           "scatter": d.scatter(torch.stack([x, 2 * x]), 0),
           "gather": d.gather(x, 1), "reduce": d.reduce(x, 0)}
    res["devices"] = sorted({t.device.type for t in got.values()
                             if t is not None})
    res.update({k: None if t is None else t.cpu().numpy()
                for k, t in got.items()})
    leaf = torch.tensor([2.0 + r], device=dev, requires_grad=True)
    (MF.bcast(d, leaf, root=0) * (r + 1)).sum().backward()
    res["bcast_grad"] = leaf.grad.cpu().numpy()
    v = torch.tensor([[0.5 + r, -1.0]], device=dev, requires_grad=True)
    if r == 0:
        MF.send(v * 2.0, d, rank=1).data.sum().backward()
    else:
        (MF.recv(d, rank=0) ** 2).sum().backward()
    res["p2p_grad"] = None if v.grad is None else v.grad.cpu().numpy()
    res["ragged"] = ragged_allreduce(
        d, torch.arange(3.0 + 2 * r, device=dev), bucket_width=4
    ).cpu().numpy()
    with open(os.path.join(out, f"grid.rank{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    comm.barrier()


RANK_BODIES = {"vgg": mp_vgg_rank, "grid": mp_grid_rank}


def rank_pythonpath() -> str:
    """This checkout first on the ranks' path, then the caller's."""
    return os.pathsep.join(p for p in (
        os.path.dirname(os.path.abspath(__file__)),
        os.environ.get("PYTHONPATH")) if p)


def launch_ranks(n: int, argv, label: str, env=None):
    """``argv`` on ``n`` ranks through the port's launcher with
    ``MP_TIMEOUT_S``; fails the phase on a non-zero exit or the limit."""
    from chainermn_tpu_torch.launch import launch

    extra = {"PYTHONPATH": rank_pythonpath(), **(env or {})}
    t0 = time.perf_counter()
    rc = launch(n, list(argv), grace_s=5.0, env_extra=extra,
                timeout_s=MP_TIMEOUT_S)
    check(rc == 0, f"{label}: {n} ranks exited {rc} (124: the "
          f"{MP_TIMEOUT_S}s limit)")
    return time.perf_counter() - t0


def rank_results(out: str, name: str, n: int):
    import pickle

    res = []
    for r in range(n):
        with open(os.path.join(out, f"{name}.rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def phase_collectives_nccl(dev, card):
    """Every collective of the rest of the communicator, its
    differentiable form and the ragged functions on one NCCL rank (the
    card run has one card): each an identity on one rank."""
    from chainermn_tpu_torch import functions as MF
    from chainermn_tpu_torch.comm import (
        create_communicator,
        ragged_allreduce,
        ragged_permute,
    )

    comm = create_communicator("xla", device=dev)
    check(comm.backend == "nccl" and comm.capturable,
          f"the one-rank communicator is {comm.backend}")
    x = torch.arange(6.0, device=dev).reshape(2, 3)
    outs = {"allgather": (comm.allgather(x), x[None]),
            "alltoall": (comm.alltoall(x[None]), x[None]),
            "permute": (comm.permute(x, [(0, 0)]), x),
            "permute_no_edge": (comm.permute(x, []), torch.zeros_like(x)),
            "gather": (comm.gather(x, 0), x[None]),
            "scatter": (comm.scatter(x[None], 0), x),
            "reduce": (comm.reduce(x, 0), x),
            "broadcast": (comm.broadcast(x, 0), x),
            "reduce_scatter": (comm.reduce_scatter(x[None]), x),
            "split": (comm.split([5])[5].allreduce(x), x),
            "sub": (comm.sub("data").allreduce(x), x),
            "ragged_permute": (ragged_permute(comm, x, [(0, 0)]), x),
            "ragged_allreduce": (ragged_allreduce(comm, x), x)}
    leaf = x.clone().requires_grad_()
    y = MF.bcast(comm, MF.allgather(comm, MF.alltoall(comm, leaf[None]))
                 [0, 0], root=0)
    (y * 3.0).sum().backward()
    outs["grad_bcast_allgather_alltoall"] = (leaf.grad,
                                             torch.full_like(x, 3.0))
    errs = {k: float((a.float() - b.float()).abs().max())
            for k, (a, b) in outs.items()}
    devices = sorted({a.device.type for a, _ in outs.values()})
    comm.send_obj({"k": 1}, 0)
    obj = comm.recv_obj(0, timeout=5.0)
    emit({"phase": "collectives_nccl", "card": card, "backend": "nccl",
          "ranks": comm.size, "errs": errs, "devices": devices,
          "send_obj": obj})
    check(all(e == 0.0 for e in errs.values()) and devices == ["cuda"]
          and obj == {"k": 1}, f"collectives on one NCCL rank: {errs}")


def mp_one_process(dev, batches, capture):
    """The same VGG-11 in one process on the card: all stages through
    ``apply_sequential`` (one ``nn.Sequential``), the same seeds and
    batches, SGD with momentum over a one-rank NCCL communicator."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import (
        apply_sequential,
        vgg_loss,
        vgg_stage_modules,
    )
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        sgd,
    )

    stages = torch.nn.Sequential(*vgg_stage_modules(**MP, device=dev,
                                                    seed=0))

    def loss_fn(model, batch):
        x = torch.as_tensor(batch[0], device=dev)
        return vgg_loss(apply_sequential(list(model), x), batch[1])[0]

    opt = create_multi_node_optimizer(sgd(MP_LR, momentum=0.9),
                                      create_communicator("xla", device=dev))
    state = opt.init(stages)
    step = opt.make_train_step(loss_fn, capture=capture)
    return stages, state, step


def phase_model_parallel(dev, card):
    """BASELINE.json configuration 4 on the card: 4 ranks sharing it
    through the port's launcher (gloo, host-staged wire, compute on the
    card) train the model-parallel VGG-11 and must agree with the
    one-process network at each of 3 steps; then each side's step ms and
    the wire's share of the 4-rank step; then the twin
    ``examples/train_vgg_model_parallel.py`` through ``python -m
    chainermn_tpu_torch.launch --nproc 4 -m ...`` for 2 steps."""
    import tempfile

    _fp32_exact()
    out = tempfile.mkdtemp(prefix="cmn_mp_")
    S = MP["n_stages"]
    launch_s = launch_ranks(S, [os.path.abspath(__file__), "--rank-body",
                                "vgg", out, "--rank-device", str(dev)],
                            "model_parallel")
    ranks = rank_results(out, "vgg", S)
    batches = mp_batches(MP_AGREE_STEPS)
    stages, state, step = mp_one_process(dev, batches, capture=False)
    ref_losses = [float(step(state, b)[1]["loss"]) for b in batches]
    loss_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], ref_losses))
    # Elementwise |got - want| - rtol |want|, its largest value over every
    # stage's tensors: at most atol.
    excess = {}
    for r in ranks:
        ref = {n: p.detach().cpu().numpy()
               for n, p in stages[r["rank"]].named_parameters()}
        check(set(ref) == set(r["params"]), f"stage {r['rank']} names")
        for n, want in ref.items():
            excess[f"stage{r['rank']}.{n}"] = float(np.max(
                np.abs(r["params"][n] - want)
                - MP_TOL["param_rtol"] * np.abs(want)))
    worst = max(excess, key=excess.get)
    param_err = excess[worst]
    # The one-process step, eager and captured, on the same batch.
    one = {}
    for mode, cap in (("eager", False), ("captured", True)):
        stages, st, stp = mp_one_process(dev, batches, capture=cap)
        times = []
        for _ in range(MP_WARMUP + MP_TIMED):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            float(stp(st, batches[0])[1]["loss"])
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        one[mode] = float(np.median(times[MP_WARMUP:]))
        if cap:
            stp.release()
    rank_ms = [float(np.median(r["step_ms"])) for r in ranks]
    row = {"phase": "model_parallel", "card": card, "config":
           "VGG-11 width_mult 1.0, 32x32x3, 10 classes, batch 64, "
           "4 stages x 1 data rank, fp32, SGD 0.01 momentum 0.9",
           "ranks": S, "wire": "gloo (naive), host-staged",
           "losses_4rank": ranks[0]["losses"],
           "losses_one_process": ref_losses,
           "loss_max_rel_err": loss_err, "param_max_excess": param_err,
           "param_worst": worst, "tol": MP_TOL,
           "params_held_per_rank": [r["params_held"] for r in ranks],
           "step_ms_4rank_per_rank": rank_ms,
           "step_ms_4rank": max(rank_ms),
           "step_ms_one_process_eager": one["eager"],
           "step_ms_one_process_captured": one["captured"],
           "wire_share_per_rank": [r["wire_share"] for r in ranks],
           "captured_4rank": ranks[0]["captured"],
           "launch_s": launch_s, "note": MP_NOTE}
    emit(row)
    check(all(np.isfinite(row["losses_4rank"])), "4-rank losses finite")
    check(loss_err <= MP_TOL["loss_rtol"],
          f"4-rank losses {ranks[0]['losses']} vs one process "
          f"{ref_losses}")
    check(param_err <= MP_TOL["param_atol"],
          f"stage parameters differ by {param_err} ({worst})")
    check(len({tuple(r["losses"]) for r in ranks}) == 1,
          "every model rank computes the same loss")
    check(not ranks[0]["captured"], "a gloo step runs eagerly")
    check(sum(row["params_held_per_rank"]) == sum(
        p.numel() for p in stages.parameters()),
          "the ranks hold the network's parameters once between them")
    twin_s = launch_ranks(
        S, ["-m", "chainermn_tpu_torch.examples.train_vgg_model_parallel",
            "--communicator", "naive", "--device", "cuda:0",
            "--width-mult", "1.0", "--iters-per-epoch", "2", "--epoch", "1"],
        "train_vgg_model_parallel")
    emit({"phase": "model_parallel_example", "card": card,
          "command": "python -m chainermn_tpu_torch.launch --nproc 4 -m "
          "chainermn_tpu_torch.examples.train_vgg_model_parallel "
          "--communicator naive --device cuda:0 --width-mult 1.0 "
          "--iters-per-epoch 2 --epoch 1", "seconds": twin_s})
    return row


def phase_model_parallel_grid(dev, card):
    """2 ranks on the card as a ``data x model`` = 2 x 1 grid: NCCL
    refuses them (one card), the gloo communicator's sub-grids, ``split``
    and collectives on card tensors, the differentiable broadcast and
    point-to-point with gradients, a ragged all-reduce; then the seq2seq
    twin data-parallel over 2 ranks (1 epoch, LSTM, its defaults)."""
    import tempfile

    out = tempfile.mkdtemp(prefix="cmn_grid_")
    launch_ranks(2, [os.path.abspath(__file__), "--rank-body", "grid", out,
                     "--rank-device", str(dev)], "model_parallel_grid")
    g = rank_results(out, "grid", 2)
    x = [np.array([r + 1.0, -r], np.float32) for r in range(2)]
    want = {0: {"allgather": np.stack(x), "alltoall": np.stack(
        [x[0], x[1]]), "permute": x[1], "allreduce": x[0] + x[1],
        "broadcast": x[1], "scatter": x[0], "gather": None,
        "reduce": x[0] + x[1], "bcast_grad": np.array([3.0], np.float32),
        "p2p_grad": 8.0 * np.array([[0.5, -1.0]], np.float32)},
        1: {"allgather": np.stack(x), "alltoall": np.stack(
            [10 * x[0], 10 * x[1]]), "permute": x[0],
            "allreduce": x[0] + x[1], "broadcast": x[1],
            "scatter": 2 * x[0], "gather": np.stack(x), "reduce": None,
            "bcast_grad": np.array([0.0], np.float32), "p2p_grad": None}}
    bad = []
    for r in range(2):
        for k, w in want[r].items():
            got = g[r][k]
            if (got is None) != (w is None) or (
                    w is not None and not np.array_equal(got, w)):
                bad.append((r, k, got, w))
    ragged = np.arange(5.0)
    ragged[:3] += np.arange(3.0)
    row = {"phase": "model_parallel_grid", "card": card, "ranks": 2,
           "grid": "data 2 x model 1", "sub": [g[r]["sub"] for r in range(2)],
           "split": g[0]["split"], "devices": g[0]["devices"],
           "nccl_same_card": g[0]["nccl_same_card"], "mismatches": len(bad),
           "ragged_allreduce": g[0]["ragged"].tolist()}
    emit(row)
    check(not bad, f"2-rank collectives on the card: {bad[:3]}")
    check("naive" in g[0]["nccl_same_card"]
          and "same card" in g[0]["nccl_same_card"],
          f"NCCL with two ranks on one card: {g[0]['nccl_same_card']}")
    check(g[0]["default_backend"] == g[1]["default_backend"] == "gloo",
          "the refused NCCL attempt left no NCCL default group")
    check(g[0]["sub"] == ((0, 1), (0,), 0, 0) and g[1]["sub"] ==
          ((0, 1), (1,), 1, 0), f"sub-grids {row['sub']}")
    check(g[0]["devices"] == ["cuda"], "collective results on the card")
    check(np.array_equal(g[0]["ragged"], ragged) and np.array_equal(
        g[1]["ragged"], ragged), f"ragged all-reduce {row['ragged_allreduce']}")
    phase_seq2seq_two_ranks(dev, card)


def phase_seq2seq_two_ranks(dev, card):
    """The seq2seq twin data-parallel over 2 ranks sharing the card
    (gloo): both ranks train an epoch of their shards of the buckets, and
    the multi-node evaluator's corpus BLEU covers every held-out
    sentence once."""
    import re
    import tempfile

    from chainermn_tpu_torch.launch import launch

    log = os.path.join(tempfile.mkdtemp(prefix="cmn_s2s_"), "ranks.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)
        try:
            rc = launch(2, ["-m", "chainermn_tpu_torch.examples.seq2seq",
                            "--communicator", "naive", "--device",
                            str(dev), "--epoch", "1"], grace_s=5.0,
                        env_extra={"PYTHONPATH": rank_pythonpath()},
                        timeout_s=MP_TIMEOUT_S)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
    text = open(log).read()
    m = re.search(r"corpus BLEU ([0-9.]+) +\((\d+) sentences\)", text)
    row = {"phase": "seq2seq_two_ranks", "card": card, "ranks": 2,
           "rc": rc, "seconds": time.perf_counter() - t0,
           "bleu": float(m.group(1)) if m else None,
           "sentences": int(m.group(2)) if m else None}
    emit(row)
    check(rc == 0, f"seq2seq twin on 2 ranks exited {rc}: {text[-2000:]}")
    check(m is not None and np.isfinite(row["bleu"])
          and row["sentences"] == S2S_HELD_OUT,
          f"seq2seq twin's BLEU over both ranks: {row}")


# ---------------------------------------------------- pipelines, ParallelLM
#: GPipe microbatches of the ``pipeline`` phase.
PIPE_M = 4
#: The pipeline against one process: the CPU test's tolerance
#: (``tests/test_torch_pipeline.py``: losses rtol 1e-5, parameters atol
#: 2e-5 + rtol 1e-4 after the steps); microbatching sums each stage's
#: gradient over 4 microbatches instead of one batch, in another order.
PIPE_TOL = dict(loss_rtol=1e-5, param_atol=2e-5, param_rtol=1e-4)


def pipe_rank(out: str, device: str) -> None:
    """One rank of the ``pipeline`` phase: VGG-11 on
    ``build_hetero_pipeline`` (this rank's stage only), 3 agreement
    steps and timed steps under ``model_parallel_grad_reduce``; then
    ``to_pipeline`` of the same chain, 3 agreement steps."""
    import pickle

    from chainermn_tpu_torch.comm import create_communicator, hybrid_mesh
    from chainermn_tpu_torch.models import (
        build_chain,
        build_hetero_pipeline,
        vgg_loss,
        vgg_stage_modules,
    )
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        model_parallel_grad_reduce,
        sgd,
    )

    dev = torch.device(device)
    _fp32_exact()
    S = MP["n_stages"]
    comm = create_communicator("naive", device=dev,
                               mesh=hybrid_mesh({"data": 1, "model": S}))
    dcomm, mcomm = comm.sub("data"), comm.sub("model")
    r = mcomm.rank
    batches = mp_batches(MP_AGREE_STEPS)

    def loss_fn(model, batch):
        x = torch.as_tensor(batch[0], device=dev)
        return vgg_loss(model(x), batch[1])[0]

    res, io = {"rank": r}, None
    for arm in ("hetero", "to_pipeline"):
        modules = vgg_stage_modules(**MP, device=dev, seed=0, stages=[r])
        if arm == "hetero":
            model = build_hetero_pipeline(modules, mcomm, batches[0][0][:1],
                                          n_microbatches=PIPE_M)
            io = model.io_shapes
        else:
            model = build_chain(modules, mcomm).to_pipeline(io, PIPE_M)
        opt = create_multi_node_optimizer(
            sgd(MP_LR, momentum=0.9), dcomm,
            grad_reduce=model_parallel_grad_reduce(dcomm, mcomm))
        state = opt.init(model)
        step = opt.make_train_step(loss_fn)
        losses = [float(step(state, b)[1]["loss"]) for b in batches]
        res[arm] = {
            "losses": losses,
            "params": {n: p.detach().cpu().numpy().copy()
                       for n, p in model.stage.named_parameters()},
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}
        if arm == "hetero":
            times = []
            for _ in range(MP_WARMUP + MP_TIMED):
                _sync(dev)
                t0 = time.perf_counter()
                float(step(state, batches[0])[1]["loss"])
                _sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            res[arm]["step_ms"] = times[MP_WARMUP:]
            res["io_shapes"] = io
            box = {"s": 0.0}
            time_wire((mcomm, dcomm), dev, box)
            t0 = time.perf_counter()
            for _ in range(MP_TIMED):
                float(step(state, batches[0])[1]["loss"])
            _sync(dev)
            res[arm]["wire_share"] = box["s"] / (time.perf_counter() - t0)
    with open(os.path.join(out, f"pipe.rank{comm.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    comm.barrier()


def phase_pipeline(dev, card, mp_row):
    """Configuration 4's distributed-speedup tier: the VGG-11 of
    ``model_parallel`` on GPipe over the same 4 ranks sharing the card,
    against the same network in one process."""
    import tempfile

    _fp32_exact()
    out = tempfile.mkdtemp(prefix="cmn_pipe_")
    S = MP["n_stages"]
    launch_s = launch_ranks(S, [os.path.abspath(__file__), "--rank-body",
                                "pipe", out, "--rank-device", str(dev)],
                            "pipeline")
    ranks = rank_results(out, "pipe", S)
    batches = mp_batches(MP_AGREE_STEPS)
    stages, state, step = mp_one_process(dev, batches, capture=False)
    ref_losses = [float(step(state, b)[1]["loss"]) for b in batches]
    ref = [{n: p.detach().cpu().numpy() for n, p in st.named_parameters()}
           for st in stages]
    stage_bytes = [sum(p.numel() * p.element_size() for p in st.parameters())
                   for st in stages]
    errs = {}
    for arm in ("hetero", "to_pipeline"):
        loss_err = max(abs(a - b) / abs(b) for rk in ranks
                       for a, b in zip(rk[arm]["losses"], ref_losses))
        excess = {}
        for rk in ranks:
            want = ref[rk["rank"]]
            check(set(want) == set(rk[arm]["params"]),
                  f"{arm} stage {rk['rank']} names")
            for n, w in want.items():
                excess[f"stage{rk['rank']}.{n}"] = float(np.max(
                    np.abs(rk[arm]["params"][n] - w)
                    - PIPE_TOL["param_rtol"] * np.abs(w)))
        worst = max(excess, key=excess.get)
        errs[arm] = {"loss_max_rel_err": loss_err,
                     "param_max_excess": excess[worst],
                     "param_worst": worst,
                     "losses": ranks[0][arm]["losses"]}
    rank_ms = [float(np.median(rk["hetero"]["step_ms"])) for rk in ranks]
    row = {"phase": "pipeline", "card": card, "config":
           "VGG-11 width_mult 1.0, 32x32x3, 10 classes, batch 64, "
           f"4 stages x 1 data rank, GPipe {PIPE_M} microbatches, fp32, "
           "SGD 0.01 momentum 0.9",
           "ranks": S, "wire": "gloo (naive), host-staged",
           "losses_one_process": ref_losses, "arms": errs, "tol": PIPE_TOL,
           "io_shapes": ranks[0]["io_shapes"],
           "param_bytes_per_rank": [rk["hetero"]["param_bytes"]
                                    for rk in ranks],
           "stage_param_bytes": stage_bytes,
           "step_ms_per_rank": rank_ms, "step_ms": max(rank_ms),
           "wire_share_per_rank": [rk["hetero"]["wire_share"]
                                   for rk in ranks],
           "model_parallel_step_ms_per_rank":
           mp_row["step_ms_4rank_per_rank"],
           "model_parallel_step_ms": mp_row["step_ms_4rank"],
           "launch_s": launch_s, "note": MP_NOTE}
    emit(row)
    for arm, e in errs.items():
        check(all(np.isfinite(e["losses"])), f"{arm} losses finite")
        check(e["loss_max_rel_err"] <= PIPE_TOL["loss_rtol"],
              f"{arm}: losses {e['losses']} vs one process {ref_losses}")
        check(e["param_max_excess"] <= PIPE_TOL["param_atol"],
              f"{arm}: stage parameters differ by {e['param_max_excess']} "
              f"({e['param_worst']})")
    check(row["param_bytes_per_rank"] == stage_bytes,
          f"each rank holds its own stage only: "
          f"{row['param_bytes_per_rank']} vs stages {stage_bytes}")
    return row


#: The ``sequence_parallel`` phase: the LM bench's attention widths
#: (``benchmarks/lm.py:39-46``: 12 heads, Dh 64), bf16, causal, one row
#: of 8192 positions over 4 ranks (2048 each).
SP = dict(B=1, T=8192, H=12, KH=4, D=64)
SP_RANKS = 4
#: (3 before PR 17: cut for time.)
SP_ITERS = 2
#: Segments of the packed variant: boundaries off the ranks' blocks, so
#: that rows of segments 1 and 2 are dead in whole visiting blocks.
SP_SEGMENTS = [(0, 3000), (1, 2600), (2, 2592)]
#: name -> (function, keyword arguments, zigzag layout, compact kv,
#: packed).  The plain ring is held against the plain attention over the
#: whole sequence (its backward takes delta from the fp32 output, the
#: flash kernels' from the bf16 one), in the parent process (its (T, T)
#: scores are ~13 GB with their gradients); every other variant against
#: flash attention over the whole sequence, on each rank.
_CAUSAL = {"causal": True}
SP_VARIANTS = {
    "ring_plain": ("ring_self_attention", _CAUSAL, False, False, False),
    "ring_flash": ("ring_flash_self_attention", _CAUSAL, False, False,
                   False),
    "zigzag_flash": ("zigzag_ring_self_attention", {"impl": "flash"}, True,
                     False, False),
    "ulysses_flash": ("ulysses_attention", _CAUSAL, False, False, False),
    "ring_flash_gqa": ("ring_flash_self_attention", _CAUSAL, False, True,
                       False),
    "ring_flash_packed": ("ring_flash_self_attention", _CAUSAL, False,
                          False, True),
}
#: Output and gradients against one-process attention over the whole
#: sequence.  The output in ``excess`` (max over elements of (|err| -
#: rtol |ref|) / rms(ref row)) <= atol, ``FLASH_TOL``'s bf16 bound: both
#: sides round once to bf16 (the ring's merges are fp32).  The gradients
#: by their relative Frobenius error |got - want| / |want| <= 2^-6: a
#: rank's dQ and the dK/dV that come back round the ring are sums of up
#: to 4 partial blocks, each rounded to bf16 by its kernel and added in
#: bf16 (the JAX ring's arithmetic), where the one-process kernels sum in
#: fp32 and round once; a partial's rounding is 2^-9 of the partial, not
#: of the sum, so where the partials cancel an element can be off by
#: more than the output's bound (an H100 read row excesses up to 0.12 on
#: dK) while the whole stays within a few roundings.  The elementwise
#: excess of each gradient is printed as a reading.
SP_TOL = {"o": dict(rtol=2 ** -7, atol=3e-2), "grad_fro": 2 ** -6,
          "grad_rtol": 2 ** -7}


def sp_predicted(name, r, S=SP_RANKS):
    """K1, K2 and K3 launches of one forward and backward on rank ``r``:
    a causal flash ring runs the diagonal block and the ``r`` past ones
    (future blocks skipped); zigzag attends ``2S + 1`` chunk quadrants on
    every rank; Ulysses one call over the whole sequence; the plain ring
    none."""
    if name == "ring_plain":
        return 0
    if name == "zigzag_flash":
        return 2 * S + 1
    if name == "ulysses_flash":
        return 1
    return r + 1


def sp_inputs(seed):
    """The global inputs on the CPU (every rank draws the same)."""
    g = torch.Generator().manual_seed(seed + 14)
    B, T, H, KH, D = (SP[k] for k in ("B", "T", "H", "KH", "D"))
    qkv = [torch.randn((B, T, H, D), generator=g) * 0.5 for _ in range(3)]
    kv = [torch.randn((B, T, KH, D), generator=g) * 0.5 for _ in range(2)]
    probe = torch.randn((B, T, H, D), generator=g)
    seg = seg_runs([SP_SEGMENTS], T)
    return ([t.to(torch.bfloat16) for t in qkv],
            [t.to(torch.bfloat16) for t in kv], probe, seg)


def sp_errors(got, want):
    """The output's and each gradient's ``excess`` (``SP_TOL``), relative
    Frobenius error and largest absolute error."""
    errs = {}
    for key, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        errs[key] = excess(a, b, SP_TOL["o"]["rtol"] if key == "o"
                           else SP_TOL["grad_rtol"])
        errs[key + "_fro"] = float((a - b).norm() / b.norm())
        errs[key + "_max_abs"] = float((a - b).abs().max())
    return errs


def sp_plain_errors(dev, ranks, seed):
    """The plain ring's blocks, joined, against plain attention over the
    whole sequence in this process."""
    from chainermn_tpu_torch.ops.flash_attention import reference_attention

    (q, k, v), _, probe, _ = sp_inputs(seed)
    full = [x.to(dev).clone().requires_grad_() for x in (q, k, v)]
    ro = reference_attention(*full, causal=True)
    (ro.float() * probe.to(dev)).sum().backward()
    want = [ro.detach(), *[t.grad for t in full]]
    got = [torch.cat([rk["plain_blocks"][i] for rk in ranks], dim=1).to(dev)
           for i in range(4)]
    errs = sp_errors(got, want)
    del full, ro, want, got
    torch.cuda.empty_cache()
    return errs


def sp_rank(out: str, device: str) -> None:
    """One rank of ``sequence_parallel``: each variant forward and
    backward on this rank's block, its K1-K3 launches, the output and
    gradients against one-process flash attention over the whole
    sequence (computed here, outside the counted window; the plain ring's
    blocks go to the parent), and its ms."""
    import importlib
    import pickle

    from chainermn_tpu_torch import parallel as par
    from chainermn_tpu_torch.comm import create_communicator, hybrid_mesh

    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    dev = torch.device(device)
    comm = create_communicator("naive", device=dev,
                               mesh=hybrid_mesh({"seq": SP_RANKS}))
    r, S = comm.rank, comm.size
    (q, k, v), (kc, vc), probe, seg = sp_inputs(int(os.environ.get(
        "CMN_SMOKE_SEED", "0")))
    res = {"rank": r, "variants": {}}
    for name, (fn_name, kw, zig, gqa, packed) in SP_VARIANTS.items():
        fn = getattr(par, fn_name)
        kk, vv = (kc, vc) if gqa else (k, v)

        def block(x):
            x = par.zigzag_shard(x, S) if zig else x
            t = x.shape[1] // S
            return x[:, r * t:(r + 1) * t].detach().to(dev).clone(
                memory_format=torch.contiguous_format)

        # This rank's blocks on the card, made once: the timed calls
        # start from them.
        mine = [block(x) for x in (q, kk, vv)]
        mine_probe = block(probe)
        args = dict(kw)
        if packed:
            args["segment_ids"] = block(seg)

        def fwd_bwd():
            leaves = [t.clone().requires_grad_() for t in mine]
            o = fn(*leaves, comm, **args)
            (o.float() * mine_probe).sum().backward()
            return o, [t.grad for t in leaves]

        reset_flash(fa)
        o, grads = fwd_bwd()
        _sync(dev)
        counts = flash_launches(fa)
        got = [o.detach(), *grads]
        if name == "ring_plain":
            # Held in the parent: the plain attention over the whole
            # sequence needs its (T, T) scores, too much for every rank.
            res["plain_blocks"] = [t.cpu() for t in got]
            errs = None
        else:
            # The one-process reference, uncounted.
            full = [x.to(dev).clone().requires_grad_() for x in (q, kk, vv)]
            ro = fa.flash_attention(
                *full, causal=True,
                segment_ids=seg.to(dev) if packed else None)
            (ro.float() * probe.to(dev)).sum().backward()
            want = [block(ro.detach()), *[block(t.grad) for t in full]]
            errs = sp_errors(got, want)
            del full, ro, want
        finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
        times = []
        for _ in range(SP_ITERS + 1):
            _sync(dev)
            t0 = time.perf_counter()
            fwd_bwd()
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        res["variants"][name] = {"launches": counts, "errs": errs,
                                 "finite": finite,
                                 "predicted": sp_predicted(name, r, S),
                                 "ms": float(np.median(times[1:]))}
    with open(os.path.join(out, f"sp.rank{comm.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    comm.barrier()


def phase_sequence_parallel(dev, card, seed):
    """Ring, zigzag and Ulysses attention on 4 ranks sharing the card, at
    the LM bench's attention widths over 8192 positions; each rank's
    output block and gradients against one-process flash attention, and
    its K1-K3 launches against the prediction."""
    import tempfile

    out = tempfile.mkdtemp(prefix="cmn_sp_")
    launch_s = launch_ranks(SP_RANKS, [os.path.abspath(__file__),
                                       "--rank-body", "sp", out,
                                       "--rank-device", str(dev)],
                            "sequence_parallel",
                            env={"CMN_SMOKE_SEED": str(seed)})
    ranks = rank_results(out, "sp", SP_RANKS)
    plain = sp_plain_errors(dev, ranks, seed)
    for rk in ranks:
        rk["variants"]["ring_plain"]["errs"] = plain
    variants = {}
    for name in SP_VARIANTS:
        per = [rk["variants"][name] for rk in ranks]
        variants[name] = {
            "ms_per_rank": [p["ms"] for p in per],
            "launches_per_rank": {k: [p["launches"][k] for p in per]
                                  for k in FLASH},
            "predicted_per_rank": [p["predicted"] for p in per],
            "excess_per_rank": {key: [p["errs"][key] for p in per]
                                for key in ("o", "dq", "dk", "dv")},
            "fro_per_rank": {key: [p["errs"][key + "_fro"] for p in per]
                             for key in ("o", "dq", "dk", "dv")},
            "max_abs_err": {key: max(p["errs"][key + "_max_abs"]
                                     for p in per)
                            for key in ("o", "dq", "dk", "dv")},
            "finite": all(p["finite"] for p in per)}
    row = {"phase": "sequence_parallel", "card": card,
           "config": "B 1, T 8192 (2048 per rank), 12 heads (GQA: 4 kv "
           "heads), Dh 64, bf16, causal; packed: segments "
           f"{SP_SEGMENTS}", "ranks": SP_RANKS,
           "wire": "gloo (naive), host-staged", "tol": SP_TOL,
           "variants": variants, "launch_s": launch_s, "note": MP_NOTE}
    emit(row)
    for name, v in variants.items():
        check(v["finite"], f"{name}: non-finite output or gradient")
        e = max(v["excess_per_rank"]["o"])
        check(e <= SP_TOL["o"]["atol"], f"{name}: output excess {e} > "
              f"{SP_TOL['o']['atol']}")
        for key in ("dq", "dk", "dv"):
            e = max(v["fro_per_rank"][key])
            check(e <= SP_TOL["grad_fro"], f"{name}: {key} relative error "
                  f"{e} > {SP_TOL['grad_fro']}")
        for k in FLASH:
            check(v["launches_per_rank"][k] == v["predicted_per_rank"],
                  f"{name}: {k} launches {v['launches_per_rank'][k]} per "
                  f"rank, predicted {v['predicted_per_rank']}")
    return row


#: The ``parallel_lm`` phase: the LM bench's widths (``benchmarks/lm.py``:
#: d_model 768, 12 heads, d_ff 3072, vocab 32768) as a 2-stage, 2-expert
#: ``ParallelLM`` (one block per stage, top-2, ample capacity).
PLM_FULL = dict(vocab=32768, n_stages=2, d_model=768, n_heads=12,
                d_ff=3072, max_len=2048, n_experts=2, moe_k=2)
PLM_GRID = {"data": 1, "stage": 2, "model": 2, "seq": 2}
PLM_B, PLM_M = 4, 2
#: (3 before PR 17: cut for time.)
PLM_STEPS = 2
PLM_LR = 0.05
#: Step 0 against ``dense_lm_reference`` in one process, fp32 with TF32
#: off on both sides: the loss within rtol 1e-5; each gradient leaf
#: within 1e-4 of its largest magnitude (the sharded program sums the
#: heads, the experts' outputs, the ring's blocks (the flash kernels'
#: fp32 online softmax) and the replicated leaves' copies in other
#: orders than the dense one).
PLM_TOL = dict(loss_rtol=1e-5, grad_rel=1e-4)


def plm_setup(seed):
    from chainermn_tpu_torch.models import ParallelLMConfig, init_parallel_lm

    cfg = ParallelLMConfig(**PLM_FULL)
    rng = np.random.RandomState(seed)
    host = init_parallel_lm(rng, cfg)
    T = cfg.max_len
    tokens = rng.randint(0, cfg.vocab, size=(PLM_B, T)).astype(np.int64)
    targets = np.concatenate(
        [tokens[:, 1:], np.full((PLM_B, 1), -1, np.int64)], axis=1)
    return cfg, host, tokens, targets


def plm_rank(out: str, device: str) -> None:
    """One rank of ``parallel_lm``: the step-0 loss and this rank's
    reduced gradients (the leaves it is the first holder of), then SGD
    momentum steps with their K1-K3 launches and ms."""
    import importlib
    import pickle

    from chainermn_tpu_torch.comm import create_communicator, hybrid_mesh
    from chainermn_tpu_torch.models import ParallelLM
    from chainermn_tpu_torch.models.transformer import _tree_items
    from chainermn_tpu_torch.utils import parallel_lm_shard

    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    dev = torch.device(device)
    _fp32_exact()
    comm = create_communicator("naive", device=dev,
                               mesh=hybrid_mesh(PLM_GRID))
    cfg, host, tokens, targets = plm_setup(int(os.environ.get(
        "CMN_SMOKE_SEED", "0")))
    lm = ParallelLM(cfg, comm, n_microbatches=PLM_M)
    c = lm.coords
    b = PLM_B // PLM_GRID["data"]
    t = tokens.shape[1] // PLM_GRID["seq"]

    def local(a):
        return torch.as_tensor(a[c["data"] * b:(c["data"] + 1) * b,
                                 c["seq"] * t:(c["seq"] + 1) * t],
                               device=dev)

    batch = (local(tokens), local(targets))
    params = parallel_lm_shard(host, cfg, c, device=dev)
    del host
    leaves = [p for _, p in _tree_items(params)]
    opt = torch.optim.SGD(leaves, lr=PLM_LR, momentum=0.9)
    res = {"coords": c, "losses": [], "step_ms": [], "launches": []}
    for step in range(PLM_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        reset_flash(fa)
        loss = lm.loss(params, batch)
        loss.backward()
        grads = lm.grad_reduce(lm.grads_of(params))
        for p, (_, g) in zip(leaves, _tree_items(grads)):
            p.grad = g
        total = float(lm.total_loss(loss))
        _sync(dev)
        res["launches"].append(flash_launches(fa))
        if step == 0:
            # The first holder of each block keeps it for the check.
            first = c["data"] == 0 and c["seq"] == 0
            res["grads"] = {
                "/".join(k): g.detach().cpu().numpy()
                for k, g in _tree_items(grads)
                if (k[0] == "stages" and first) or
                (k[0] != "stages" and comm.rank == 0)}
        opt.step()
        opt.zero_grad(set_to_none=True)
        _sync(dev)
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        res["losses"].append(total)
    # One more step with every collective and pair timed.
    box = {"s": 0.0}
    time_wire([comm, *comm._subs.values()], dev, box,
              WIRE_METHODS + ("permute", "alltoall", "allgather"))
    _sync(dev)
    t0 = time.perf_counter()
    loss = lm.loss(params, batch)
    loss.backward()
    lm.grad_reduce(lm.grads_of(params))
    float(lm.total_loss(loss))
    _sync(dev)
    res["wire_share"] = box["s"] / (time.perf_counter() - t0)
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else None
    with open(os.path.join(out, f"plm.rank{comm.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    comm.barrier()


def plm_predicted(seq_rank):
    """K1 (and K2, K3) launches per rank per step: each of the ``PLM_M``
    microbatches runs this rank's one block, whose causal flash ring runs
    ``seq_rank + 1`` blocks."""
    return PLM_M * (seq_rank + 1)


def phase_parallel_lm(dev, card, seed):
    """``ParallelLM`` on 8 ranks sharing the card against
    ``dense_lm_reference`` in this process; then the dryrun twin."""
    import tempfile

    from chainermn_tpu_torch.models import dense_lm_reference
    from chainermn_tpu_torch.models.transformer import _tree_items
    from chainermn_tpu_torch.utils import parallel_lm_unshard

    _fp32_exact()
    out = tempfile.mkdtemp(prefix="cmn_plm_")
    n = int(np.prod(list(PLM_GRID.values())))
    launch_s = launch_ranks(n, [os.path.abspath(__file__), "--rank-body",
                                "plm", out, "--rank-device", str(dev)],
                            "parallel_lm", env={"CMN_SMOKE_SEED": str(seed)})
    ranks = rank_results(out, "plm", n)
    cfg, host, tokens, targets = plm_setup(seed)
    # The dense oracle's step 0, differentiated leaf by leaf.
    params = {}
    for path, a in _tree_items(host):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.as_tensor(a, device=dev).requires_grad_()
    logits = dense_lm_reference(params, cfg, tokens, device=dev)
    tg = torch.as_tensor(targets, device=dev)
    mask = (tg >= 0).float()
    ce = -torch.log_softmax(logits.float(), -1).gather(
        -1, tg.clamp_min(0)[..., None])[..., 0]
    ref_loss = (ce * mask).sum() / mask.sum()
    ref_loss.backward()
    del logits, ce
    ref = {"/".join(p): t.grad.detach().cpu().numpy()
           for p, t in _tree_items(params)}
    del params
    torch.cuda.empty_cache()
    shards = []
    for rk in ranks:
        if "grads" in rk and rk["grads"]:
            tree = {}
            for k, g in rk["grads"].items():
                node = tree
                *head, leaf = k.split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[leaf] = g
            shards.append((rk["coords"], tree))
    # Replicated leaves come from rank 0, stage leaves from each
    # (stage, model) block's first holder.
    stage_shards = [(c, t) for c, t in shards if "stages" in t]
    got = parallel_lm_unshard(
        [(c, {**shards[0][1], **t}) for c, t in stage_shards], cfg)
    rel = {}
    for path, g in _tree_items(got):
        key = "/".join(path)
        w = ref[key]
        rel[key] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    worst = max(rel, key=rel.get)
    loss0 = [rk["losses"][0] for rk in ranks]
    loss_err = abs(loss0[0] - float(ref_loss)) / abs(float(ref_loss))
    per_step = {k: [[lc[k] for lc in rk["launches"]] for rk in ranks]
                for k in FLASH}
    predicted = [plm_predicted(rk["coords"]["seq"]) for rk in ranks]
    step_ms = [float(np.median(rk["step_ms"][1:])) for rk in ranks]
    row = {"phase": "parallel_lm", "card": card,
           "config": f"{PLM_FULL}, grid {PLM_GRID}, T {cfg.max_len}, batch "
           f"{PLM_B}, {PLM_M} microbatches, fp32, learned positions, "
           f"attention auto (flash ring at T_local "
           f"{cfg.max_len // PLM_GRID['seq']}), SGD {PLM_LR} momentum 0.9",
           "ranks": n, "wire": "gloo (naive), host-staged",
           "loss0_dense": float(ref_loss), "loss0_ranks": loss0,
           "loss_rel_err": loss_err, "grad_rel_err": rel,
           "grad_worst": worst, "tol": PLM_TOL,
           "losses_per_rank": [rk["losses"] for rk in ranks],
           "launches_per_rank_per_step": per_step,
           "predicted_per_rank_per_step": predicted,
           "step_ms_per_rank": step_ms, "step_ms": max(step_ms),
           "wire_share_per_rank": [rk["wire_share"] for rk in ranks],
           "peak_bytes_per_rank": [rk["peak_bytes"] for rk in ranks],
           "launch_s": launch_s, "note": MP_NOTE}
    emit(row)
    losses = row["losses_per_rank"]
    check(all(np.isfinite(losses[0])), f"losses {losses[0]}")
    check(loss_err <= PLM_TOL["loss_rtol"],
          f"step-0 loss {loss0[0]} vs dense {float(ref_loss)}")
    check(rel[worst] <= PLM_TOL["grad_rel"],
          f"gradient {worst} off by {rel[worst]} of its largest magnitude")
    check(all(ls == losses[0] for ls in losses),
          "every rank reads the same global loss")
    check(losses[0][-1] < losses[0][0], f"the loss falls: {losses[0]}")
    for k in FLASH:
        for r, steps in enumerate(per_step[k]):
            check(all(x == predicted[r] for x in steps),
                  f"{k} on rank {r}: {steps} per step, predicted "
                  f"{predicted[r]}")
    twin_s = launch_ranks(
        n, ["-m", "chainermn_tpu_torch.examples.dryrun_multichip",
            "--communicator", "naive", "--device", str(dev)],
        "dryrun_multichip")
    emit({"phase": "dryrun_multichip", "card": card,
          "command": "python -m chainermn_tpu_torch.launch --nproc 8 -m "
          "chainermn_tpu_torch.examples.dryrun_multichip --communicator "
          f"naive --device {dev}", "seconds": twin_s})
    return row


RANK_BODIES.update(pipe=pipe_rank, sp=sp_rank, plm=plm_rank)


# ------------------------------------------- tensor-parallel serving (2b)
#: ``tp_serving``: 16 requests in 4 families sharing a 32-token prefix (2
#: full blocks of 16) with 4-12-token tails, 12 new tokens each, ordered
#: member by member (the second wave of admissions maps the first's
#: cached prefixes).  Kept short: over gloo every forward pays ~25
#: staged collectives and the ranks' turns on the shared card.
TP_FAMILIES, TP_PER_FAMILY, TP_PREFIX, TP_NEW = 4, 4, 32, 12
#: the speculative arm: a 1-layer draft, 4 proposals per round.
TP_SPEC_K, TP_DRAFT_LAYERS = 4, 1
#: a flip between the tensor-parallel and the one-rank engine (fp32) is
#: a near-tie only at or past this generated position
#: (``tests/torch_fleet_common.assert_greedy_agreement``'s rule).
TP_MIN_FIRST_DIVERGENCE = 8
#: ``lm_generate`` on the tensor-parallel model (K5 on each rank's
#: ``KH/M`` heads): 4 prompts of 32 tokens, 12 new.
TP_GEN_BATCH, TP_GEN_PROMPT, TP_GEN_NEW = 4, 32, 12
TP_NOTE = ("model ranks share one card over gloo, each wire message "
           "staged through pinned host memory: the path and its "
           "arithmetic, not a scaling figure")


def tp_requests(seed):
    from chainermn_tpu_torch.serving import Request

    rng = np.random.RandomState(seed + 41)
    prefixes = [rng.randint(1, DECODE["vocab"], size=TP_PREFIX).tolist()
                for _ in range(TP_FAMILIES)]
    reqs = []
    for j in range(TP_PER_FAMILY):
        for f in range(TP_FAMILIES):
            tail = rng.randint(1, DECODE["vocab"],
                               size=int(rng.randint(4, 13))).tolist()
            reqs.append(Request(id=len(reqs), prompt=prefixes[f] + tail,
                                max_new_tokens=TP_NEW))
    return reqs


def greedy_agreement(got, want):
    """``(rows equal, sorted first divergences of the others)`` of two
    runs' tokens by request id."""
    firsts = first_divergences(got, want)
    div = sorted(d for d in firsts.values() if d is not None)
    return len(firsts) - len(div), div


def tp_engine_kw(reqs):
    num_blocks, max_blocks = engine_geometry(reqs)
    return dict(num_blocks=num_blocks, max_blocks_per_slot=max_blocks,
                **ENGINE)


def tp_rank(out: str, device: str) -> None:
    """One model rank of ``tp_serving`` (``CMN_TP_M`` ranks sharing the
    card over gloo, fp32, ``CMN_TP_KV`` kv heads): the one-rank engine's
    tokens, then the tensor-parallel engine's on the same requests (a
    speculative arm too at 2 ranks), the decode kernel's runs on the card
    for this rank, the decode-step ms and the wire's share."""
    import pickle

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import decode_attention as ops
    from chainermn_tpu_torch.serving import DecodeEngine, Scheduler
    from chainermn_tpu_torch.serving.sharding import serving_mesh

    dev = torch.device(device)
    _fp32_exact()
    seed = int(os.environ.get("CMN_SMOKE_SEED", "0"))
    M, kv = int(os.environ["CMN_TP_M"]), int(os.environ["CMN_TP_KV"])
    comm = create_communicator("naive", device=dev)
    mesh = serving_mesh(M, comm)
    reqs = tp_requests(seed)
    kw = tp_engine_kw(reqs)
    model = TransformerLM(**DECODE, n_kv_heads=kv, dtype=torch.float32,
                          device=dev, seed=seed)
    arms = {"plain": {}}
    if M == 2:
        draft = TransformerLM(**{**DECODE, "n_layers": TP_DRAFT_LAYERS},
                              n_kv_heads=kv, dtype=torch.float32,
                              device=dev, seed=seed + 1)
        arms["spec"] = dict(draft_model=draft, spec_k=TP_SPEC_K)
    res = {"rank": comm.rank, "M": M, "kv_heads": model.kv_heads}
    for arm, extra in arms.items():
        one = DecodeEngine(model, **kw, **extra, device=dev)
        want = {c.id: c.tokens for c in Scheduler(one).run(reqs)}
        one.release()
        # The ranks run with the planes off (``CMN_OBS=0``): no cost model
        # steps beside the drive's, whose K4 runs are counted.
        eng = DecodeEngine(model, **kw, **extra, mesh=mesh)
        box = {"s": 0.0}
        time_wire([mesh], dev, box, ("allreduce", "allgather", "bcast_obj"))
        sched = Scheduler(eng)
        _sync(dev)
        ops.paged_decode_attention.launches = 0
        ops.zero_kernel_runs(dev)
        t0 = time.perf_counter()
        comps = sched.run(reqs)
        _sync(dev)
        wall = time.perf_counter() - t0
        got = {c.id: c.tokens for c in comps}
        res[arm] = dict(
            tokens=got, want=want, wall_s=wall, wire_share=box["s"] / wall,
            iterations=sched.decode_iterations,
            decode_ms=sched.decode_ms_total / max(sched.decode_iterations,
                                                  1),
            hits=sched.prefix_hit_tokens,
            runs=ops.kernel_runs(dev)["paged_decode_attention"],
            wrapper=ops.paged_decode_attention.launches,
            captured=bool(eng._graphs or eng._spec_graphs),
            pool_heads=int(eng.pools[0]["k"].shape[0]),
            accepted=getattr(sched, "spec_accepted", 0),
            proposed=getattr(sched, "spec_proposed", 0))
        eng.release()
    res["generate"] = tp_generate(ops, dev, seed, model, mesh)
    with open(os.path.join(out, f"tp.rank{comm.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    comm.barrier()


def tp_generate(ops, dev, seed, model, mesh):
    """``lm_generate`` of the one-rank model, then of this rank's
    tensor-parallel part (``shard_model``): the tokens of both and K5's
    runs on the card in the second (each rank's ``KH/M`` heads through
    ``sharded_fused_decode_attention``), with its wrapper's launches."""
    from chainermn_tpu_torch.models import lm_generate
    from chainermn_tpu_torch.serving.sharding import shard_model

    prompt = torch.from_numpy(np.random.RandomState(seed + 43).randint(
        1, DECODE["vocab"], size=(TP_GEN_BATCH, TP_GEN_PROMPT))).to(dev)
    want = lm_generate(model, prompt, TP_GEN_NEW).cpu().tolist()
    local = shard_model(model, mesh)
    _sync(dev)
    ops.fused_decode_attention.launches = 0
    ops.zero_kernel_runs(dev)
    t0 = time.perf_counter()
    got = lm_generate(local, prompt, TP_GEN_NEW).cpu().tolist()
    wall = time.perf_counter() - t0
    return dict(tokens=got, want=want, wall_s=wall,
                k5_runs=ops.kernel_runs(dev)["fused_decode_attention"],
                k5_wrapper=ops.fused_decode_attention.launches,
                local_kv_heads=local.local_kv_heads)


def tp_k4_per_step(arm):
    """K4 launches per decode step (12 layers) or per speculative round
    (the draft's ``k + 1`` steps of its layers, then the 12-layer
    verify)."""
    n = DECODE["n_layers"]
    return n + (TP_SPEC_K + 1) * TP_DRAFT_LAYERS if arm == "spec" else n


def tp_one_rank_nccl(ops, dev, seed, reqs, kw):
    """The plain engine and the tensor-parallel one on a one-rank NCCL
    communicator (bf16), each warmed, on ``reqs``: the row of
    ``tp_serving``'s ``nccl_one_rank``."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import DecodeEngine, Scheduler

    comm = create_communicator("xla", device=dev)
    check(comm.capturable, "tp_serving: the one-rank communicator is not "
          "NCCL")
    model = TransformerLM(**DECODE, device=dev, seed=seed)
    runs = {}
    for name, extra in (("plain", dict(device=dev)), ("tp1", dict(
            mesh=comm))):
        eng = DecodeEngine(model, **kw, **extra)
        warm_engine(eng, seed)
        sched = Scheduler(eng)
        replays0 = eng.decode_replays
        _sync(dev)
        ops.paged_decode_attention.launches = 0
        ops.zero_kernel_runs(dev)
        comps = sched.run(reqs)
        _sync(dev)
        graph = next(iter(eng._graphs.values()))
        runs[name] = dict(
            eng=eng, tokens={c.id: c.tokens for c in comps},
            iterations=sched.decode_iterations,
            replays=eng.decode_replays - replays0,
            k4=ops.kernel_runs(dev)["paged_decode_attention"],
            wrapper=ops.paged_decode_attention.launches,
            logits=graph.out[0].clone(), hits=sched.prefix_hit_tokens,
            decode_ms=sched.decode_ms_total / max(sched.decode_iterations,
                                                  1))
    tp1, plain = runs["tp1"], runs["plain"]
    eng = tp1["eng"]
    row = dict(
        ranks=1, backend="nccl", dtype="bfloat16", captured=eng.capture,
        decode_captures=eng.decode_compiles, graphs=len(eng._graphs),
        prefill_captures=eng.prefill_compiles,
        tokens_equal=tp1["tokens"] == plain["tokens"],
        logits_bit_equal=bool(torch.equal(tp1["logits"], plain["logits"])),
        decode_steps=tp1["iterations"], replays=tp1["replays"],
        k4_runs=tp1["k4"], k4_wrapper=tp1["wrapper"],
        prefix_hit_tokens=tp1["hits"],
        decode_step_ms=tp1["decode_ms"],
        plain_decode_step_ms=plain["decode_ms"])
    for r in runs.values():
        r.pop("eng").release()
    del model
    torch.cuda.empty_cache()
    return row


def phase_tp_serving(ops, dev, card, seed):
    """Item 2b on the card, and K5 on local heads through ``lm_generate``
    (:func:`tp_generate`).  One model rank over NCCL in this process
    (bf16, the decode bench's model): the tensor-parallel engine captures
    one decode graph with its all-reduces and all-gather inside, and its
    tokens and last-step logits are bit-equal to the plain engine's.
    Then 2 ranks (a speculative arm beside) and 4 ranks with 4 kv heads
    (one local kv head each) sharing the card over gloo in fp32: greedy
    tokens equal the one-rank engine's up to a late near-tie flip, equal
    on every rank; K4's runs on the card per rank = steps x 12 (rounds x
    17 speculative)."""
    import tempfile

    reqs = tp_requests(seed)
    row1 = tp_one_rank_nccl(ops, dev, seed, reqs, tp_engine_kw(reqs))
    ranks = {}
    out = tempfile.mkdtemp(prefix="cmn_tp_")
    for M, kv in ((2, 0), (4, 4)):
        launch_ranks(M, [os.path.abspath(__file__), "--rank-body", "tp",
                         out, "--rank-device", str(dev)],
                     f"tp_serving M={M}",
                     env={"CMN_SMOKE_SEED": str(seed), "CMN_TP_M": str(M),
                          "CMN_TP_KV": str(kv), "CMN_OBS": "0"})
        ranks[M] = rank_results(out, "tp", M)
    rows = {}
    for M, rs in ranks.items():
        for arm in rs[0]:
            if arm not in ("plain", "spec"):
                continue
            a = [r[arm] for r in rs]
            exact, div = greedy_agreement(a[0]["tokens"], a[0]["want"])
            rows[f"M{M}_{arm}"] = dict(
                ranks=M, kv_heads=rs[0]["kv_heads"], dtype="float32",
                local_kv_heads=a[0]["pool_heads"],
                rows_exact=exact, first_divergences=div,
                equal_on_every_rank=all(x["tokens"] == a[0]["tokens"]
                                        for x in a),
                decode_steps=a[0]["iterations"],
                k4_runs_per_rank=[x["runs"] for x in a],
                k4_predicted=a[0]["iterations"] * tp_k4_per_step(arm),
                k4_wrapper_per_rank=[x["wrapper"] for x in a],
                decode_step_ms_per_rank=[x["decode_ms"] for x in a],
                wire_share_per_rank=[x["wire_share"] for x in a],
                wall_s_per_rank=[x["wall_s"] for x in a],
                prefix_hit_tokens=a[0]["hits"],
                accepted=a[0]["accepted"], proposed=a[0]["proposed"],
                captured=any(x["captured"] for x in a))
    gen = {}
    for M, rs in ranks.items():
        g = [r["generate"] for r in rs]
        gen[f"M{M}"] = dict(
            ranks=M, local_kv_heads=g[0]["local_kv_heads"],
            tokens_equal_one_rank=all(x["tokens"] == x["want"] for x in g),
            equal_on_every_rank=all(x["tokens"] == g[0]["tokens"]
                                    for x in g),
            k5_runs_per_rank=[x["k5_runs"] for x in g],
            k5_wrapper_per_rank=[x["k5_wrapper"] for x in g],
            k5_predicted=(TP_GEN_NEW - 1) * DECODE["n_layers"],
            wall_s_per_rank=[x["wall_s"] for x in g])
    row = dict(phase="tp_serving", card=card,
               config=f"{DECODE}, {len(reqs)} requests ({TP_FAMILIES} "
               f"families sharing a {TP_PREFIX}-token prefix), "
               f"{TP_NEW} new each, engine {ENGINE}; lm_generate batch "
               f"{TP_GEN_BATCH}, prompt {TP_GEN_PROMPT}, {TP_GEN_NEW} new",
               nccl_one_rank=row1, gloo=rows, generate=gen, note=TP_NOTE)
    emit(row)
    for name, g in gen.items():
        check(g["tokens_equal_one_rank"] and g["equal_on_every_rank"],
              f"tp_serving lm_generate {name}: tokens differ from the "
              "one-rank model's or across ranks")
        check(all(k == g["k5_predicted"] for k in g["k5_runs_per_rank"])
              and g["k5_runs_per_rank"] == g["k5_wrapper_per_rank"],
              f"tp_serving lm_generate {name}: K5 ran "
              f"{g['k5_runs_per_rank']} times per rank (wrappers "
              f"{g['k5_wrapper_per_rank']}), predicted {g['k5_predicted']}")
    check(gen["M4"]["local_kv_heads"] == 1,
          "tp_serving lm_generate M=4: not one kv head per rank")
    check(row1["captured"] and row1["decode_captures"] == 1
          and row1["graphs"] == 1,
          f"tp_serving M=1: {row1['decode_captures']} captures")
    check(row1["tokens_equal"] and row1["logits_bit_equal"],
          "tp_serving M=1: tokens or last-step logits differ from the "
          "plain engine's")
    check(row1["k4_runs"] == row1["k4_wrapper"] + row1["replays"] *
          DECODE["n_layers"] and row1["replays"] == row1["decode_steps"],
          f"tp_serving M=1: K4 ran {row1['k4_runs']} times for "
          f"{row1['replays']} replays")
    for name, r in rows.items():
        check(r["prefix_hit_tokens"] > 0, f"tp_serving {name}: no prefix "
              "hit")
        check(r["equal_on_every_rank"], f"tp_serving {name}: ranks emitted "
              "different tokens")
        check(all(d >= TP_MIN_FIRST_DIVERGENCE
                  for d in r["first_divergences"]),
              f"tp_serving {name}: first divergences "
              f"{r['first_divergences']} against the one-rank engine")
        check(all(k == r["k4_predicted"] for k in r["k4_runs_per_rank"])
              and r["k4_runs_per_rank"] == r["k4_wrapper_per_rank"],
              f"tp_serving {name}: K4 ran {r['k4_runs_per_rank']} times "
              f"per rank (wrappers {r['k4_wrapper_per_rank']}), predicted "
              f"{r['k4_predicted']}")
        check(not r["captured"], f"tp_serving {name}: a gloo engine "
              "captured")
    check(rows["M4_plain"]["local_kv_heads"] == 1,
          "tp_serving M=4: not one kv head per rank")
    return row


# ------------------------------------------------------ ZeRO (item 11)
#: ``zero``: the LM benchmark's model (``LM``) in fp32 (TF32 off) with
#: flash attention and remat, AdamW 3e-4 (weight decay 0.01), the global
#: batch ``LM_BATCH`` x 2048 split over the ranks.
ZERO_RANKS, ZERO_STEPS, ZERO_ELASTIC_RANKS = 4, 2, 2
ZERO_LR, ZERO_WD = 3e-4, 0.01
#: against one process's replicated AdamW on the same global batch: the
#: losses within rtol 1e-5; the parameters within the JAX ZeRO test's
#: atol 3e-5 + rtol 3e-5 after ``ZERO_STEPS`` steps (2 since PR 17, 3
#: before: cut for time), and within the JAX elastic
#: test's 5e-5 after the elastic restore's step, but for the elements
#: whose gradient the sums' rounding noise drowns, which Adam moves by
#: up to 2 x lr per step either way: the key biases
#: (:func:`zero_key_bias`) and at most a millionth of the rest
#: (``flip_share``; the count and their largest difference reported).
ZERO_TOL = dict(loss_rtol=1e-5, param=3e-5, elastic=5e-5, flip_share=1e-6)


def zero_k13():
    """K1/K2/K3 launches per step: the forward's and remat's recompute
    per layer, then one dK/dV and one dQ per layer."""
    n = LM["n_layers"]
    return {FLASH[0]: 2 * n, FLASH[1]: n, FLASH[2]: n}


def zero_lm(dev, seed):
    from chainermn_tpu_torch.models import TransformerLM

    return TransformerLM(**LM, dtype=torch.float32, attention="flash",
                         remat=True, device=dev, seed=seed)


def zero_batch(seed):
    rng = np.random.RandomState(seed + 61)
    tokens = rng.randint(0, LM["vocab"], size=(LM_BATCH, LM["max_len"]))
    targets = np.concatenate([tokens[:, 1:], np.full((LM_BATCH, 1), -1)],
                             axis=1)
    return tokens.astype(np.int64), targets.astype(np.int64)


def zero_bytes(state):
    """Bytes a rank keeps as its own: the parameters (ZeRO: its shards)
    and the optimizer's state."""
    params = state.flat_params if hasattr(state, "flat_params") \
        else list(state.model.parameters())
    tensors = [p.detach() for p in params]
    for st in state.optimizer.state.values():
        tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in tensors)


def zero_key_bias(name):
    """The slice of a fused ``qkv`` bias that adds to the keys: the same
    constant on every score of a query, which the softmax cancels, so
    its gradient is 0 in exact arithmetic and only rounding noise
    remains, which Adam normalizes to steps of about the learning rate
    whatever its size."""
    if not name.endswith("qkv.bias"):
        return None
    hd = LM["d_model"]
    return slice(hd, 2 * hd)


def zero_param_check(got, want, tol):
    """The parameters of two AdamW runs whose gradients were summed in
    other orders: ``(worst excess, its leaf, elements past tol, their
    largest |diff|, the key biases' largest |diff|, elements)``, the
    excess ``|got - want| - tol (1 + |want|)`` over every element but the
    key biases (:func:`zero_key_bias`).  An element whose true gradient
    is below the sums' rounding noise takes an Adam step of about the
    learning rate in either direction, so a few elements of a large
    model land past any tolerance tighter than ``2 lr`` per step."""
    worst, where, flips, flip_max, kb, n = -np.inf, None, 0, 0.0, 0.0, 0
    for k, w in want.items():
        d = (got[k].float().to(w.device) - w).abs()
        cut = zero_key_bias(k)
        if cut is not None:
            kb = max(kb, float(d[cut].max()))
            d[cut] = 0
        ex = d - tol * (1 + w.abs())
        e = float(ex.max())
        if e > worst:
            worst, where = e, k
        past = ex > 0
        flips += int(past.sum())
        if past.any():
            flip_max = max(flip_max, float(d[past].max()))
        n += w.numel()
    return worst, where, flips, flip_max, kb, n


def zero_rank(out: str, device: str) -> None:
    """One rank of ``zero`` (``CMN_ZERO_PHASE`` ``train``: 4 ranks, 3
    steps, the last one profiled, then a checkpoint; ``elastic``: 2
    ranks restore it and take one more step)."""
    import importlib
    import pickle

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.models import lm_loss
    from chainermn_tpu_torch.optimizers import adamw, create_zero_optimizer

    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    dev = torch.device(device)
    _fp32_exact()
    seed = int(os.environ.get("CMN_SMOKE_SEED", "0"))
    phase = os.environ["CMN_ZERO_PHASE"]
    comm = create_communicator("naive", device=dev)
    n, r = comm.size, comm.rank
    tokens, targets = zero_batch(seed)
    b = LM_BATCH // n
    batch = (torch.as_tensor(tokens[r * b:(r + 1) * b], device=dev),
             torch.as_tensor(targets[r * b:(r + 1) * b], device=dev))
    model = zero_lm(dev, seed if phase == "train" else seed + 7)
    opt = create_zero_optimizer(adamw(ZERO_LR, weight_decay=ZERO_WD), comm)
    ckpt = create_multi_node_checkpointer("zero", comm, path=out,
                                          async_save=False)
    loss_fn = lm_loss(model)
    res = {"rank": r, "losses": [], "step_ms": [], "launches": []}
    if phase == "train":
        state = opt.init(model)
        steps = ZERO_STEPS
    else:
        state, _ = ckpt.maybe_load_elastic(opt, model)
        res["restored_step"] = state.step
        res["restore_s"] = ckpt.last_restore["seconds"]
        steps = 1
    step = opt.make_train_step(loss_fn, has_aux=True)
    for i in range(steps):
        reset_flash(fa)
        if phase == "train" and i == steps - 1:
            trace, counts = traced_step("zero", None, step, state, batch,
                                        zero_k13())
            res["losses"].append(trace["loss"])
            res["profiled"] = counts
            res["step_ms"].append(trace["wall_ms"])
            res["busy_share"] = trace["busy_share"]
        else:
            _sync(dev)
            t0 = time.perf_counter()
            state, met = step(state, batch)
            res["losses"].append(float(met["loss"]))
            _sync(dev)
            res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        res["launches"].append(flash_launches(fa))
    res["bytes"] = zero_bytes(state)
    res["padding"] = sum(s.padded - s.size for s in opt.specs)
    res["leaves"] = len(opt.specs)
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else None
    if phase == "train":
        ckpt.save(state)
    got = opt.materialize_params(state)
    if r == 0:
        want = torch.load(os.path.join(out, f"ref_{phase}.pt"),
                          map_location=dev, weights_only=True)
        tol = ZERO_TOL["param" if phase == "train" else "elastic"]
        (res["param_excess"], res["param_worst"], res["flips"],
         res["flip_max"], res["key_bias"], res["elements"]) = \
            zero_param_check(got, want, tol)
        del want
    with open(os.path.join(out, f"zero_{phase}.rank{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    comm.barrier()


def zero_reference(dev, seed, out):
    """One process's replicated AdamW on the whole batch: ``ZERO_STEPS``
    + 1 steps; the parameters after the last two saved for the ranks.
    Returns the losses and the bytes one process keeps."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import lm_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )

    tokens, targets = zero_batch(seed)
    batch = (torch.as_tensor(tokens, device=dev),
             torch.as_tensor(targets, device=dev))
    model = zero_lm(dev, seed)
    opt = create_multi_node_optimizer(adamw(ZERO_LR, weight_decay=ZERO_WD),
                                      create_communicator("xla", device=dev))
    state = opt.init(model)
    step = opt.make_train_step(lm_loss(model), has_aux=True, capture=False)
    losses = []
    for i in range(ZERO_STEPS + 1):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        if i >= ZERO_STEPS - 1:
            name = "train" if i == ZERO_STEPS - 1 else "elastic"
            torch.save({k: p.detach() for k, p in model.named_parameters()},
                       os.path.join(out, f"ref_{name}.pt"))
    one_bytes = zero_bytes(state)
    del state, model, step
    torch.cuda.empty_cache()
    return losses, one_bytes


def zero_capture_pair(dev, seed):
    """A one-rank NCCL ZeRO step captured (its all-gather and
    reduce-scatter inside the graph) against the same step eager, from
    the same weights, over ``ZERO_STEPS`` steps: losses and parameters
    bit-equal."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import lm_loss
    from chainermn_tpu_torch.optimizers import adamw, create_zero_optimizer

    tokens, targets = zero_batch(seed)
    batch = (torch.as_tensor(tokens[:2], device=dev),
             torch.as_tensor(targets[:2], device=dev))
    comm = create_communicator("xla", device=dev)
    outs = {}
    for capture in (True, False):
        model = zero_lm(dev, seed)
        opt = create_zero_optimizer(adamw(ZERO_LR, weight_decay=ZERO_WD),
                                    comm)
        state = opt.init(model)
        step = opt.make_train_step(lm_loss(model), has_aux=True,
                                   capture=capture)
        losses = [float(step(state, batch)[1]["loss"])
                  for _ in range(ZERO_STEPS)]
        outs[capture] = (losses, {k: v.cpu() for k, v in
                                  opt.materialize_params(state).items()},
                         len(step.graphs), step.program.replays)
        step.release()
        del state, model, opt, step
        torch.cuda.empty_cache()
    (lc, pc, graphs, replays), (le, pe, _, _) = outs[True], outs[False]
    worst = max(float((pc[k] - pe[k]).abs().max()) for k in pc)
    return dict(losses_captured=lc, losses_eager=le, max_param_diff=worst,
                graphs=graphs, replays=replays,
                bit_equal=lc == le and worst == 0.0)


def phase_zero(dev, card, seed):
    """Item 11 on the card: ZeRO over 4 ranks sharing the card (gloo)
    against one process's replicated AdamW on the same global batch (the
    LM bench's model in fp32), the ranks' bytes, K1-K3 per rank per step
    in a profiled step; a one-rank NCCL ZeRO step captured against
    eager; and the 4-rank checkpoint restored at 2 ranks
    (``maybe_load_elastic``) for one more step."""
    import shutil
    import tempfile

    _fp32_exact()
    out = tempfile.mkdtemp(prefix="cmn_zero_")
    ref_losses, one_bytes = zero_reference(dev, seed, out)
    pair = zero_capture_pair(dev, seed)
    times = {}
    rows = {}
    for phase, n in (("train", ZERO_RANKS), ("elastic", ZERO_ELASTIC_RANKS)):
        times[phase] = launch_ranks(
            n, [os.path.abspath(__file__), "--rank-body", "zero", out,
                "--rank-device", str(dev)], f"zero {phase}",
            env={"CMN_SMOKE_SEED": str(seed), "CMN_ZERO_PHASE": phase})
        rows[phase] = rank_results(out, f"zero_{phase}", n)
    shutil.rmtree(out, ignore_errors=True)
    train, elastic = rows["train"], rows["elastic"]
    loss_err = max(abs(a - b) / abs(b) for rk in train
                   for a, b in zip(rk["losses"], ref_losses))
    elastic_loss_err = abs(elastic[0]["losses"][0] - ref_losses[-1]) \
        / abs(ref_losses[-1])
    quarter = [(rk["bytes"] * ZERO_RANKS - one_bytes) for rk in train]
    row = dict(
        phase="zero", card=card,
        config=f"{LM}, fp32 (TF32 off), flash, remat, batch {LM_BATCH} x "
        f"{LM['max_len']} over {ZERO_RANKS} ranks, AdamW {ZERO_LR} "
        f"weight decay {ZERO_WD}",
        ranks=ZERO_RANKS, wire="gloo (naive), host-staged",
        losses_replicated=ref_losses,
        losses_per_rank=[rk["losses"] for rk in train],
        loss_rel_err=loss_err,
        param_excess_3_steps=train[0]["param_excess"],
        param_worst=train[0]["param_worst"],
        elements_past_tol=train[0]["flips"],
        elements_past_tol_max_abs_diff=train[0]["flip_max"],
        elements=train[0]["elements"],
        key_bias_max_abs_diff=train[0]["key_bias"],
        launches_per_rank_per_step=[rk["launches"] for rk in train],
        profiled_step_per_rank=[rk["profiled"] for rk in train],
        step_ms_per_rank=[rk["step_ms"] for rk in train],
        busy_share_per_rank=[rk["busy_share"] for rk in train],
        bytes_per_rank=[rk["bytes"] for rk in train],
        bytes_one_process=one_bytes,
        padding_elements=train[0]["padding"], leaves=train[0]["leaves"],
        quarter_excess_bytes=quarter,
        peak_bytes_per_rank=[rk["peak_bytes"] for rk in train],
        capture_one_rank_nccl=pair,
        elastic=dict(ranks=ZERO_ELASTIC_RANKS,
                     restored_step=elastic[0]["restored_step"],
                     restore_s=[rk["restore_s"] for rk in elastic],
                     loss=elastic[0]["losses"][0],
                     loss_replicated=ref_losses[-1],
                     loss_rel_err=elastic_loss_err,
                     param_excess=elastic[0]["param_excess"],
                     param_worst=elastic[0]["param_worst"],
                     elements_past_tol=elastic[0]["flips"],
                     elements_past_tol_max_abs_diff=elastic[0]["flip_max"],
                     key_bias_max_abs_diff=elastic[0]["key_bias"],
                     step_ms=[rk["step_ms"] for rk in elastic]),
        launch_s=times, tol=ZERO_TOL, note=MP_NOTE.replace("4 ranks",
                                                           "the ranks"))
    emit(row)
    check(loss_err <= ZERO_TOL["loss_rtol"],
          f"zero: losses {row['losses_per_rank'][0]} vs {ref_losses}")
    # Adam's steps bound what rounding noise can move an element whose
    # gradient it drowns: the key biases, and at most a millionth of the
    # rest.
    for name, rk, steps in (("zero", train[0], ZERO_STEPS),
                            ("zero elastic", elastic[0], ZERO_STEPS + 1)):
        bound = 2 * ZERO_LR * steps
        check(rk["flips"] <= ZERO_TOL["flip_share"] * rk["elements"]
              and rk["flip_max"] <= bound and rk["key_bias"] <= bound,
              f"{name}: {rk['flips']} of {rk['elements']} parameters past "
              f"the tolerance (worst excess {rk['param_excess']} in "
              f"{rk['param_worst']}), up to {rk['flip_max']}; key biases "
              f"{rk['key_bias']} apart; Adam's bound {bound}")
    for rk in train:
        check(all(lc == zero_k13() for lc in rk["launches"])
              and rk["profiled"] == zero_k13(),
              f"zero: rank {rk['rank']} K1-K3 {rk['launches']}, profiled "
              f"{rk['profiled']}, predicted {zero_k13()}")
    # A quarter of one process's bytes, plus the padding (at most N - 1
    # elements per leaf, in the parameter and both moments) and each
    # rank's own 4-byte step count per leaf.
    want_q = 3 * 4 * train[0]["padding"] + (ZERO_RANKS - 1) * 4 \
        * train[0]["leaves"]
    check(all(q == want_q for q in quarter),
          f"zero: {ZERO_RANKS} x rank bytes - one process's = {quarter}, "
          f"predicted {want_q}")
    check(pair["bit_equal"] and pair["graphs"] == 1,
          f"zero: captured vs eager {pair}")
    check(elastic[0]["restored_step"] == ZERO_STEPS,
          f"zero: restored step {elastic[0]['restored_step']}")
    check(elastic_loss_err <= ZERO_TOL["loss_rtol"],
          f"zero elastic: loss {elastic[0]['losses']} vs "
          f"{ref_losses[-1]}")
    return row


# ----------------------------------- the convnets and DCGAN (item 8c)
#: ``gan_convnet``: the examples' widths (convnet ``32,64,128,128`` on
#: 32x32x3, 10 classes; DCGAN ``ch`` 64, ``nz`` 64, 32x32x1), batch 64,
#: 3 SGD-momentum steps on 2 ranks, fp32 (TF32 off, cuDNN
#: deterministic), against one process; the JAX tests' tolerances
#: (convnet loss 1e-5 and parameters rtol 2e-4 + atol 2e-5, DCGAN atol
#: 5e-5 + rtol 5e-4).
GC_WIDTHS, GC_BATCH, GC_STEPS, GC_RANKS = (32, 64, 128, 128), 64, 3, 2
GC_CH, GC_NZ = 64, 64
GC_TOL = dict(cnn_loss=1e-5, cnn_rtol=2e-4, cnn_atol=2e-5, gan_atol=5e-5,
              gan_rtol=5e-4)


def gc_excess(got, want, atol, rtol):
    return max(float(((g.float() - w.float()).abs() - atol - rtol *
                      w.float().abs()).max()) for g, w in zip(got, want))


def gc_rank(out: str, device: str) -> None:
    """One rank of ``gan_convnet``: the channel-parallel convnet (its
    filter shard) and the data-parallel DCGAN (its half of the batch),
    each beside the same model in this process on the whole batch."""
    import copy
    import pickle

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.examples.train_parallel_convnet import (
        synthetic_task,
    )
    from chainermn_tpu_torch.models import (
        Discriminator,
        Generator,
        channel_parallel_leaves,
        channel_parallel_loss,
        gan_init,
        init_channel_parallel,
        make_channel_parallel_train_step,
        make_gan_train_step,
        shard_channel_parallel,
    )
    from chainermn_tpu_torch.models.dcgan import _bce_logits
    from chainermn_tpu_torch.optimizers import sgd

    dev = torch.device(device)
    _fp32_exact()
    seed = int(os.environ.get("CMN_SMOKE_SEED", "0"))
    comm = create_communicator("naive", device=dev)
    r, n = comm.rank, comm.size
    res = {"rank": r}
    x, y = synthetic_task(GC_BATCH * GC_STEPS, seed=seed + 5)
    x = torch.as_tensor(x.transpose(0, 3, 1, 2).copy(), device=dev)
    y = torch.as_tensor(y, device=dev)
    full = init_channel_parallel(GC_WIDTHS, 10, device=dev, seed=seed)
    params = shard_channel_parallel(full, r, n)
    step = make_channel_parallel_train_step(comm)
    carry = (params, sgd(0.05, momentum=0.9)(channel_parallel_leaves(params)))
    dense = shard_channel_parallel(full, 0, 1)
    dopt = sgd(0.05, momentum=0.9)(channel_parallel_leaves(dense))
    dloss = channel_parallel_loss(None)
    ms, losses, ref = [], [], []
    for i in range(GC_STEPS):
        sl = slice(i * GC_BATCH, (i + 1) * GC_BATCH)
        _sync(dev)
        t0 = time.perf_counter()
        carry, loss = step(carry, (x[sl], y[sl]))
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        dopt.zero_grad()
        lv = dloss(dense, (x[sl], y[sl]))
        lv.backward()
        dopt.step()
        ref.append(float(lv.detach()))
    mine = channel_parallel_leaves(carry[0])
    want = channel_parallel_leaves(shard_channel_parallel(dense, r, n))
    res["cnn"] = dict(losses=losses, ref=ref, step_ms=ms,
                      excess=gc_excess(mine, want, GC_TOL["cnn_atol"],
                                       GC_TOL["cnn_rtol"]))
    # DCGAN: this rank's half of the batch against the whole batch here.
    g = Generator(ch=GC_CH, out_ch=1, nz=GC_NZ, device=dev, seed=seed)
    d = Discriminator(ch=GC_CH, device=dev, seed=seed + 1)
    g1, d1 = copy.deepcopy(g), copy.deepcopy(d)
    tx = sgd(1e-3, momentum=0.9)
    state = gan_init(g, d, tx, tx, comm)
    gstep = make_gan_train_step(comm)
    g_opt, d_opt = tx(g1.parameters()), tx(d1.parameters())
    rng = np.random.RandomState(seed + 13)
    hist, ref, ms = [], [], []
    b = GC_BATCH // n
    for _ in range(GC_STEPS):
        real = torch.as_tensor(rng.uniform(-1, 1, size=(GC_BATCH, 32, 32, 1))
                               .astype(np.float32), device=dev)
        z = torch.as_tensor(rng.normal(size=(GC_BATCH, GC_NZ))
                            .astype(np.float32), device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, met = gstep(state, (real[r * b:(r + 1) * b],
                                   z[r * b:(r + 1) * b]))
        hist.append({k: float(v) for k, v in met.items()})
        ms.append((time.perf_counter() - t0) * 1e3)
        fake = g1(z)
        dl = _bce_logits(d1(real), 1.0) + _bce_logits(d1(fake.detach()), 0.0)
        gl = _bce_logits(d1(fake), 1.0)
        dg = torch.autograd.grad(dl, list(d1.parameters()))
        gg = torch.autograd.grad(gl, list(g1.parameters()))
        for ps, gs in ((d1.parameters(), dg), (g1.parameters(), gg)):
            for p, gr in zip(ps, gs):
                p.grad = gr
        d_opt.step()
        g_opt.step()
        ref.append({"loss_dis": float(dl), "loss_gen": float(gl)})
    res["gan"] = dict(history=hist, ref=ref, step_ms=ms, excess=max(
        gc_excess(list(a.parameters()), list(b_.parameters()),
                  GC_TOL["gan_atol"], GC_TOL["gan_rtol"])
        for a, b_ in ((g, g1), (d, d1))))
    with open(os.path.join(out, f"gc.rank{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    comm.barrier()


def phase_gan_convnet(dev, card, seed):
    """Item 8c on the card: the channel-parallel convnet and the DCGAN
    over 2 ranks sharing it (gloo), each against the same model in one
    process (in the rank) for ``GC_STEPS`` steps."""
    import tempfile

    out = tempfile.mkdtemp(prefix="cmn_gc_")
    secs = launch_ranks(GC_RANKS, [os.path.abspath(__file__), "--rank-body",
                                   "gc", out, "--rank-device", str(dev)],
                        "gan_convnet", env={"CMN_SMOKE_SEED": str(seed)})
    ranks = rank_results(out, "gc", GC_RANKS)
    cnn_err = max(abs(a - b) / abs(b) for rk in ranks
                  for a, b in zip(rk["cnn"]["losses"], rk["cnn"]["ref"]))
    gan_err = max(abs(h[k] - f[k]) for rk in ranks
                  for h, f in zip(rk["gan"]["history"], rk["gan"]["ref"])
                  for k in h)
    row = dict(phase="gan_convnet", card=card, ranks=GC_RANKS,
               convnet=f"widths {GC_WIDTHS}, 32x32x3, 10 classes, batch "
               f"{GC_BATCH}, SGD 0.05 momentum 0.9, filters cut over the "
               "ranks, batch replicated",
               dcgan=f"ch {GC_CH}, nz {GC_NZ}, 32x32x1, batch {GC_BATCH} "
               "split over the ranks, SGD 1e-3 momentum 0.9 for both "
               "players",
               dtype="float32", steps=GC_STEPS,
               cnn_losses=[rk["cnn"]["losses"] for rk in ranks],
               cnn_losses_one_process=ranks[0]["cnn"]["ref"],
               cnn_loss_rel_err=cnn_err,
               cnn_param_excess=[rk["cnn"]["excess"] for rk in ranks],
               cnn_step_ms=[rk["cnn"]["step_ms"] for rk in ranks],
               gan_history=ranks[0]["gan"]["history"],
               gan_one_process=ranks[0]["gan"]["ref"],
               gan_loss_abs_err=gan_err,
               gan_param_excess=[rk["gan"]["excess"] for rk in ranks],
               gan_step_ms=[rk["gan"]["step_ms"] for rk in ranks],
               tol=GC_TOL, launch_s=secs, note=MP_NOTE.replace(
                   "4 ranks", f"{GC_RANKS} ranks"))
    emit(row)
    check(cnn_err <= GC_TOL["cnn_loss"]
          and all(e <= 0 for e in row["cnn_param_excess"]),
          f"gan_convnet: convnet losses off by {cnn_err}, parameter "
          f"excess {row['cnn_param_excess']}")
    check(gan_err <= GC_TOL["gan_atol"]
          and all(e <= 0 for e in row["gan_param_excess"]),
          f"gan_convnet: DCGAN losses off by {gan_err}, parameter excess "
          f"{row['gan_param_excess']}")
    return row


RANK_BODIES.update(tp=tp_rank, zero=zero_rank, gc=gc_rank)


# --------------------------------------- training health (item 12a)
#: ``health_guard``: the LM bench's configuration (``LM``, batch
#: ``LM_BATCH``, flash attention, remat, AdamW 3e-4, bf16 wire),
#: captured; the check's spike test armed after 2 healthy steps.
HG_SPIKE_WARMUP = 2
#: the guarded run's faults (1-based steps of 7): a NaN at 3, a 1000x
#: spike at 5, each carried by the batch's one-element loss weight.
HG_FAULTS, HG_FAULT_STEPS, HG_STEPS = "nan@grad:3;spike@loss:5", (3, 5), 7
#: the ranks' part: 3 gloo ranks sharing the card, the LM cut to 2
#: layers (full widths), 2 rows of 2048 a rank, AdamW 3e-4; a vote and a
#: checkpoint every 2 iterations over 4; ``flip@param:3`` on rank 1
#: (PR 17 cut it from every 4 over 8, ``flip@param:5``, for time).
HG_RANKS, HG_LAYERS, HG_ROWS, HG_EVERY, HG_STOP = 3, 2, 2, 2, 4
HG_FLIP = "flip@param:3"
#: the ranks' heartbeats: every 0.1 s, dead after 10 silent intervals.
HG_HB = dict(interval_s=0.1, suspect_after=2.0, dead_after=10.0)


def hg_loss(model):
    """``lm_loss`` times the batch's one-element fp32 weight (1 unless a
    fault scaled it): an LM batch has no float leaf of its own, and
    ``nan@grad`` / ``spike@loss`` poison the float leaves."""
    from chainermn_tpu_torch.models import lm_loss

    inner = lm_loss(model)

    def loss_fn(m, batch):
        tokens, targets, w = batch
        loss, aux = inner(m, (tokens, targets))
        return loss * w.sum(), aux

    return loss_fn


def hg_batches(seed, dev, n):
    rng = np.random.RandomState(seed + 71)
    out = []
    for _ in range(n):
        toks = torch.from_numpy(rng.randint(
            0, LM["vocab"], size=(LM_BATCH, LM["max_len"]))).to(dev)
        out.append((toks, toks, torch.ones(1, device=dev)))
    return out


def hg_setup(dev, seed, comm, health):
    """The LM step of the main path, with or without the health check."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
        seed_health,
    )

    model = TransformerLM(**LM, attention="flash", remat=True, device=dev,
                          seed=seed)
    opt = create_multi_node_optimizer(adamw(3e-4), comm)
    state = opt.init(model)
    if health:
        seed_health(state)
    step = opt.make_train_step(hg_loss(model), has_aux=True,
                               health_check=health,
                               spike_warmup=HG_SPIKE_WARMUP)
    return model, opt, state, step


def hg_state(state):
    """The parameters and the optimizer's state, by name."""
    out = dict(state.model.named_parameters())
    for i, p in enumerate(state.model.parameters()):
        for k, v in state.optimizer.state.get(p, {}).items():
            if torch.is_tensor(v):
                out[f"optimizer.{i}.{k}"] = v
    return out


def hg_equal(a, b):
    """Two ``hg_state`` dicts bit for bit (on the card)."""
    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


def hg_arm(fa, dev, card, seed, comm, batch, health, warmup=2, timed=5):
    """Step ms (median of ``timed`` after ``warmup``) and peak bytes of
    the captured LM step, check on or off, then one profiled replay."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, state, step = hg_setup(dev, seed, comm, health)
    for _ in range(warmup):
        state, m = step(state, batch)
        float(m["loss"])
    reset_flash(fa)
    replays0 = replays_of(step)
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = step_launches(step, flash_launches(fa),
                             replays_of(step) - replays0)
    trace, traced = traced_step(
        f"health_guard check {'on' if health else 'off'}", None, step,
        state, batch, {k: v // timed for k, v in launches.items()})
    row = dict(check=health, captured=step_graph(step) is not None,
               captures=len(step.graphs),
               step_ms_median=sorted(times)[timed // 2] * 1e3,
               step_ms_runs=[t * 1e3 for t in times], peak_bytes=peak,
               launches_per_step={k: v / timed for k, v in launches.items()},
               launches_per_replay_profiled=traced,
               first_replay_profiled={k: trace["warm_kernel_counts"][k]
                                      for k in traced},
               short_profiles=trace["short_profiles"])
    step.release()
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def hg_faults(dev, seed, comm):
    """The guarded run over ``HG_STEPS`` batches with ``HG_FAULTS``
    injected (each poisoned step: ``step_ok`` and the digest of the
    parameters and the optimizer's state before and after it), and the
    unguarded run over the same batches less the poisoned ones; then a
    rollback under the captured step: save after the last step, step,
    restore into the state, step again."""
    import shutil
    import tempfile

    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.resilience import (
        FaultInjector,
        parse_fault_spec,
        poison_batch,
        tree_digest,
    )

    batches = hg_batches(seed, dev, HG_STEPS + 1)
    runs = {}
    for guarded in (True, False):
        model, opt, state, step = hg_setup(dev, seed, comm, guarded)
        inj = FaultInjector(parse_fault_spec(HG_FAULTS)) if guarded \
            else None
        rows = []
        for k, b in enumerate(batches[:HG_STEPS], 1):
            if not guarded and k in HG_FAULT_STEPS:
                continue
            row = {"k": k}
            if guarded:
                b = poison_batch(inj, b, k)
                if k in HG_FAULT_STEPS:
                    row["before"] = tree_digest(hg_state(state))
            state, m = step(state, b)
            row.update(loss=float(m["loss"]),
                       step_ok=float(m.get("step_ok", 1.0)),
                       grad_norm=float(m.get("grad_norm", float("nan"))))
            if "before" in row:
                row["after"] = tree_digest(hg_state(state))
            rows.append(row)
        final = {n: t.clone() for n, t in hg_state(state).items()}
        extra = {}
        if guarded:
            path = tempfile.mkdtemp(prefix="cmn_hg_")
            ckpt = create_multi_node_checkpointer(
                "hg", comm, path=path, async_save=False)
            ckpt.save(state)
            held = {n: t.data_ptr() for n, t in hg_state(state).items()}
            loss1 = float(step(state, batches[-1])[1]["loss"])
            after1 = {n: t.clone() for n, t in hg_state(state).items()}
            ckpt.restore_step(HG_STEPS, state)
            restored = hg_equal(hg_state(state), final)
            loss2 = float(step(state, batches[-1])[1]["loss"])
            extra = dict(
                rollback_restored_bitwise=restored,
                rollback_in_place=held == {
                    n: t.data_ptr() for n, t in hg_state(state).items()},
                rollback_replay_equal=(loss2 == loss1 and hg_equal(
                    hg_state(state), after1)),
                rollback_file_bytes=ckpt.last_save["bytes"],
                rollback_restore_s=ckpt.last_restore["seconds"])
            shutil.rmtree(path, ignore_errors=True)
        runs[guarded] = dict(rows=rows, final=final,
                             captures=len(step.graphs),
                             health=state.health.tolist()
                             if state.health is not None else None,
                             **extra)
        step.release()
        del model, opt, state, step
        torch.cuda.empty_cache()
    g, o = runs[True], runs[False]
    later = [r for r in g["rows"] if r["k"] > HG_FAULT_STEPS[0]
             and r["k"] not in HG_FAULT_STEPS]
    oracle_later = o["rows"][HG_FAULT_STEPS[0] - 1:]
    return dict(
        faults=HG_FAULTS,
        poisoned=[dict(k=r["k"], step_ok=r["step_ok"],
                       grad_norm=r["grad_norm"], loss=r["loss"],
                       state_digest_equal=r["before"] == r["after"])
                  for r in g["rows"] if r["k"] in HG_FAULT_STEPS],
        guarded_losses=[r["loss"] for r in g["rows"]],
        oracle_losses=[r["loss"] for r in o["rows"]],
        later_losses_bit_equal=[r["loss"] for r in later]
        == [r["loss"] for r in oracle_later],
        final_state_bit_equal=hg_equal(g["final"], o["final"]),
        health_carry=g["health"], captures=[g["captures"], o["captures"]],
        **{k: v for k, v in g.items() if k.startswith("rollback")})


def _hg_run(comm, dev, seed, out, label, fault=None, ckpt=True):
    """One guarded ``Trainer`` run of the 2-layer LM over the ranks: a
    vote every ``HG_EVERY`` iterations, and a checkpoint as often."""
    from chainermn_tpu_torch.datasets import ArrayDataset, scatter_dataset
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import TransformerLM, lm_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )
    from chainermn_tpu_torch.resilience import (
        FaultInjector,
        TrainingHealthGuard,
        parse_fault_spec,
        tree_digest,
    )
    from chainermn_tpu_torch.training import Trainer

    rows = HG_RANKS * HG_ROWS * (HG_STOP + 2)
    toks = np.random.RandomState(seed + 73).randint(
        0, LM["vocab"], size=(rows, LM["max_len"]))
    ds = scatter_dataset(ArrayDataset(toks, toks), comm, shuffle=True,
                         seed=0)
    model = TransformerLM(**{**LM, "n_layers": HG_LAYERS},
                          attention="flash", remat=True, device=dev,
                          seed=seed)
    opt = create_multi_node_optimizer(adamw(3e-4), comm)
    exts = []
    if ckpt:
        ckpt = create_multi_node_checkpointer(
            "hg", comm, path=os.path.join(out, f"ckpt_{label}"),
            trigger=(HG_EVERY, "iteration"), async_save=False,
            max_to_keep=2)
        exts.append(ckpt)
    guard = TrainingHealthGuard(comm=comm, checkpointer=ckpt or None,
                                vote_every=HG_EVERY)
    tr = Trainer(opt, opt.init(model), lm_loss(model),
                 SerialIterator(ds, HG_ROWS, shuffle=True, seed=1),
                 stop=(HG_STOP, "iteration"), has_aux=True,
                 health_guard=guard, extensions=exts)
    tr._fault_injector = FaultInjector(parse_fault_spec(fault)) \
        if fault else None
    t0 = time.perf_counter()
    tr.run()
    wall = time.perf_counter() - t0
    res = dict(digest=tree_digest(tr.state.params), report=
               guard.guard_report(), iteration=tr.iteration, wall_s=wall,
               known_good=ckpt.known_good_steps() if ckpt else [],
               restore_s=ckpt.last_restore.get("seconds") if ckpt else None,
               file_bytes=ckpt.last_save.get("bytes") if ckpt else None)
    del tr, opt, model
    torch.cuda.empty_cache()
    return res


class HgUnfreeze(Exception):
    """Ends the injected hang of ``hg_rank`` after a bounded time."""


def hg_rank(out: str, device: str) -> None:
    """One rank of ``health_guard``'s ranks part: the unfaulted run, the
    ``HG_FLIP`` run (on rank 1), then a heartbeat detector from the
    launcher's ``CMN_TPU_HB_HOSTS`` on a ``HostComm``: 3 clean barriers,
    and ``hang@barrier:4`` on rank 2 (its beats frozen, asleep 3 s): the
    others' barrier raises the detector's verdict.  A healthy rank keeps
    beating 1.5 s after its verdict, so its gossip reaches the ring."""
    import pickle

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.hostcomm import HostComm
    from chainermn_tpu_torch.resilience import PeerFailedError, faults
    from chainermn_tpu_torch.resilience import detector as det_mod

    dev = torch.device(device)
    seed = int(os.environ.get("CMN_SMOKE_SEED", "0"))
    comm = create_communicator("naive", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    r = comm.rank
    res = {"plain": _hg_run(comm, dev, seed, out, "plain", ckpt=False),
           "flip": _hg_run(comm, dev, seed, out, "flip",
                           HG_FLIP if r == 1 else None)}
    if r == 2:
        def bounded(s):
            time.sleep(3.0)
            raise HgUnfreeze()

        inj = faults.FaultInjector(faults.parse_fault_spec("hang@barrier:4"),
                                   sleep=bounded)
        inj.add_freeze_callback(
            lambda: res.__setitem__("frozen_at", time.time()))
        faults._process_injector.update(built=True, inj=inj)
    hc = HostComm(timeout_ms=30000)
    det = det_mod.from_env(**HG_HB)
    det.attach(hc)
    det.start()
    for _ in range(3):
        hc.barrier()
    res["control_dead"] = sorted(det.dead_ranks())
    try:
        hc.barrier()
        res["hang"] = "no error"
    except PeerFailedError as e:
        res["hang"] = dict(peer=e.peer, op=e.op, kind=e.kind,
                           message=str(e), at=time.time())
        time.sleep(1.5)
    except HgUnfreeze:
        res["hang"] = "frozen"
    det.stop()
    hc.close()
    with open(os.path.join(out, f"hg.rank{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    comm.barrier()


def phase_health_guard(fa, dev, card, seed):
    """Item 12a on the card.  The captured LM step at the bench's widths
    with the health check on and off (step ms, peak bytes, K1-K3 in a
    profiled replay); a NaN and a spike skipped with the state bitwise
    unchanged and the later steps bitwise those of a run that never saw
    the poisoned batches; a rollback restored into the captured step's
    own tensors.  Then ``HG_RANKS`` gloo ranks sharing the card: a
    flipped parameter named by the vote, rolled back and resumed bitwise
    equal to the unfaulted run, and a hung rank named by the failure
    detector with the op."""
    import tempfile

    from chainermn_tpu_torch.comm import create_communicator

    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    batch = hg_batches(seed, dev, 1)[0]
    arms = {h: hg_arm(fa, dev, card, seed, comm, batch, h)
            for h in (False, True)}
    on, off = arms[True], arms[False]
    faults_row = hg_faults(dev, seed, comm)
    out = tempfile.mkdtemp(prefix="cmn_hg_")
    secs = launch_ranks(HG_RANKS, [os.path.abspath(__file__), "--rank-body",
                                   "hg", out, "--rank-device", str(dev)],
                        "health_guard", env={"CMN_SMOKE_SEED": str(seed)})
    ranks = rank_results(out, "hg", HG_RANKS)
    frozen = ranks[2]["frozen_at"]
    hangs = [rk["hang"] for rk in ranks[:2]]
    L = LM["n_layers"]
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L,
            "flash_attention_bwd_dq": L}
    row = dict(
        phase="health_guard", card=card,
        config=f"{LM}, batch {LM_BATCH}, flash, remat, AdamW 3e-4, bf16 "
        f"wire, captured; spike_warmup {HG_SPIKE_WARMUP}; ranks: "
        f"{HG_RANKS} gloo ranks sharing the card, {HG_LAYERS} layers, "
        f"{HG_ROWS} rows a rank, vote and checkpoint every {HG_EVERY} of "
        f"{HG_STOP}, {HG_FLIP} on rank 1, heartbeats {HG_HB}",
        step_ms_check_off=off["step_ms_median"],
        step_ms_check_on=on["step_ms_median"],
        step_ms_ratio=on["step_ms_median"] / off["step_ms_median"],
        peak_bytes_check_off=off["peak_bytes"],
        peak_bytes_check_on=on["peak_bytes"],
        arms={"off": off, "on": on}, faults=faults_row,
        ranks=dict(
            flip_votes=[[v for v in rk["flip"]["report"]["votes"]
                         if not v["clean"]] for rk in ranks],
            flip_rollbacks=[rk["flip"]["report"]["rollbacks"]["events"]
                            for rk in ranks],
            flip_iteration=[rk["flip"]["iteration"] for rk in ranks],
            flip_equals_plain=[rk["flip"]["digest"] == rk["plain"]["digest"]
                               for rk in ranks],
            plain_digests_equal=len({rk["plain"]["digest"]
                                     for rk in ranks}) == 1,
            plain_rollbacks=[rk["plain"]["report"]["rollbacks"]["count"]
                             for rk in ranks],
            run_s=[[rk["plain"]["wall_s"], rk["flip"]["wall_s"]]
                   for rk in ranks],
            checkpoint_bytes_per_rank=ranks[0]["flip"]["file_bytes"],
            restore_s=[rk["flip"]["restore_s"] for rk in ranks],
            control_dead=[rk["control_dead"] for rk in ranks],
            hang=hangs,
            detection_intervals=[(h["at"] - frozen) / HG_HB["interval_s"]
                                 for h in hangs if isinstance(h, dict)]),
        launch_s=secs, note=MP_NOTE.replace("4 ranks", f"{HG_RANKS} ranks"))
    emit(row)
    for a in (off, on):
        check(a["captured"] and a["captures"] == 1,
              f"health_guard: the step with the check "
              f"{'on' if a['check'] else 'off'} was not captured once")
    check(on["launches_per_replay_profiled"] == want
          and on["launches_per_step"] == want,
          f"health_guard: K1-K3 ran {on['launches_per_replay_profiled']} "
          f"in the profiled replay ({on['launches_per_step']} per step), "
          f"expected {want}")
    for p in faults_row["poisoned"]:
        check(p["step_ok"] == 0.0 and p["state_digest_equal"],
              f"health_guard: the poisoned step {p['k']} was not a no-op: "
              f"{p}")
    check(faults_row["later_losses_bit_equal"]
          and faults_row["final_state_bit_equal"],
          "health_guard: the guarded run after its skipped steps is not "
          "bitwise the run that never saw their batches")
    check(faults_row["captures"] == [1, 1], f"health_guard: captures "
          f"{faults_row['captures']}")
    check(faults_row["rollback_restored_bitwise"]
          and faults_row["rollback_in_place"]
          and faults_row["rollback_replay_equal"],
          "health_guard: the restore under the captured step was not in "
          "place, or the replay after it differs")
    rk = row["ranks"]
    check(all(v == [{"step": HG_STOP, "clean": False, "divergent": [1],
                     "no_majority": False}] for v in rk["flip_votes"]),
          f"health_guard: the flip votes read {rk['flip_votes']}")
    check(all([(e["step"], e["at_iteration"]) for e in ev] ==
              [(HG_EVERY, HG_STOP)] for ev in rk["flip_rollbacks"])
          and all(i == HG_STOP for i in rk["flip_iteration"])
          and all(rk["flip_equals_plain"]) and rk["plain_digests_equal"],
          "health_guard: the flipped run did not roll back and resume "
          "bitwise equal to the unfaulted one")
    check(rk["plain_rollbacks"] == [0] * HG_RANKS
          and rk["control_dead"] == [[]] * HG_RANKS,
          "health_guard: the unfaulted runs were not clean")
    check(ranks[2]["hang"] == "frozen" and all(
        isinstance(h, dict) and (h["peer"], h["op"], h["kind"]) ==
        (2, "barrier", "dead") for h in hangs),
        f"health_guard: the hung rank was not named with the op: {hangs}")
    return row


RANK_BODIES.update(hg=hg_rank)


# ------------------------- preemption, replication, chaos (item 12b)
#: ``preemption``: the LM bench's configuration (``LM``, batch
#: ``LM_BATCH``, flash, remat, AdamW 3e-4, bf16 wire), captured, one rank
#: under ``launch.supervise``; a SIGTERM from a timer thread at iteration
#: ``PRE_AT`` of ``PRE_STOP``.
PRE_AT, PRE_STOP = 3, 6
#: replicator cadences timed on the full-size LM state in one process.
PRE_REP_CADENCES = 2
#: ``replication``: 3 gloo ranks sharing the card, the LM cut to 2 layers
#: (full widths), 2 rows of 2048 a rank, ZeRO AdamW 3e-4, a replicator
#: every ``REP_EVERY`` iterations (factor 1), a checkpoint at the target
#: ``REP_STOP``; the chaos schedule's failures, one per attempt.
REP_RANKS, REP_LAYERS, REP_ROWS, REP_EVERY, REP_STOP = 3, 2, 2, 2, 8
REP_KINDS = ("crash", "preempt", "torn")
#: the rank a ``crash`` kills (its spill is wiped: its host died) and the
#: rank a ``preempt`` signals and a ``torn`` event tears frames from.
REP_CRASH_RANK, REP_SIGNAL_RANK = 1, 0


def lm_rows(seed, rows):
    """``rows`` seeded LM rows of ``LM["max_len"]`` tokens."""
    return np.random.RandomState(seed + 79).randint(
        0, LM["vocab"], size=(rows, LM["max_len"]))


def lm_trainer(dev, seed, comm, rows, batch, stop, layers=None, zero=False,
               exts=(), guard=None):
    """A ``Trainer`` of the LM (flash, remat, AdamW 3e-4) over ``rows``
    (scattered over ``comm``), ``batch`` rows a step, to ``stop``."""
    from chainermn_tpu_torch.datasets import ArrayDataset, scatter_dataset
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import TransformerLM, lm_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
        create_zero_optimizer,
    )
    from chainermn_tpu_torch.training import Trainer

    ds = scatter_dataset(ArrayDataset(rows, rows), comm, shuffle=True,
                         seed=0)
    model = TransformerLM(**{**LM, "n_layers": layers or LM["n_layers"]},
                          attention="flash", remat=True, device=dev,
                          seed=seed)
    opt = (create_zero_optimizer(adamw(3e-4), comm) if zero
           else create_multi_node_optimizer(adamw(3e-4), comm))
    return Trainer(opt, opt.init(model), lm_loss(model),
                   SerialIterator(ds, batch, shuffle=True, seed=1),
                   stop=(stop, "iteration"), has_aux=True,
                   extensions=list(exts), preemption_guard=guard), model


def signal_at(guard, at):
    """An extension that, at iteration ``at``, sends this process SIGTERM
    from a timer thread and waits until the guard's handler ran, so the
    vote closing that iteration sees it."""
    import signal
    import threading

    from chainermn_tpu_torch.training import Extension

    def fire(tr):
        if tr.iteration == at:
            threading.Timer(0.0, os.kill,
                            (os.getpid(), signal.SIGTERM)).start()
            deadline = time.monotonic() + 30
            while not guard.preempted and time.monotonic() < deadline:
                time.sleep(0.001)

    return Extension(fire, (1, "iteration"), name="signal")


def state_digest(opt, state, zero=False):
    """Digest of the parameters (gathered, under ZeRO) and the optimizer's
    state (this rank's shards, under ZeRO)."""
    from chainermn_tpu_torch.resilience import tree_digest

    params = opt.materialize_params(state) if zero else dict(
        state.model.named_parameters())
    moments = {f"optimizer.{i}.{k}": v for i, st in enumerate(
        state.optimizer.state.values()) for k, v in st.items()
        if torch.is_tensor(v)}
    return tree_digest({**params, **moments}), tree_digest(params)


def pre_rank(out: str, device: str) -> None:
    """One attempt of ``preemption``'s supervised job (one NCCL rank).
    Attempt 0: a SIGTERM at ``PRE_AT``; the guard votes, the checkpointer
    saves, the rank exits 75.  Attempt 1: ``maybe_load`` resumes, the run
    ends at ``PRE_STOP``, then one profiled replay of the captured step."""
    import pickle

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.resilience import (
        PreemptionGuard,
        PreemptionInterrupt,
    )

    attempt = int(os.environ["CMN_LAUNCH_ATTEMPT"])
    seed = int(os.environ.get("CMN_SMOKE_SEED", "0"))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    ckpt = create_multi_node_checkpointer(
        "pre", comm, path=os.path.join(out, "ckpt"),
        trigger=(PRE_STOP + 1, "iteration"), async_save=False)
    guard = PreemptionGuard(comm=comm).install()
    exts = [ckpt] + ([signal_at(guard, PRE_AT)] if attempt == 0 else [])
    tr, model = lm_trainer(dev, seed, comm,
                           lm_rows(seed, LM_BATCH * (PRE_STOP + 1)),
                           LM_BATCH, PRE_STOP, exts=exts, guard=guard)
    res = {"attempt": attempt}
    path = os.path.join(out, f"pre.attempt{attempt}.pkl")
    if attempt > 0:
        t0 = time.perf_counter()
        _, res["resumed"] = ckpt.maybe_load(tr.state, tr)
        res["resume_s"] = time.perf_counter() - t0
        res["restore"] = dict(ckpt.last_restore)
    try:
        tr.run()
    except PreemptionInterrupt as e:
        res.update(exit=e.code, iteration=e.iteration,
                   save=dict(ckpt.last_save))
        with open(path, "wb") as f:
            pickle.dump(res, f)
        raise
    res["iteration"] = tr.iteration
    res["state_digest"], res["params_digest"] = state_digest(tr.optimizer,
                                                             tr.state)
    step = next(iter(tr.optimizer._step_cache.values()))
    batch = next(tr.train_iter)
    batch = tuple(torch.as_tensor(x, device=dev) for x in batch)
    _, res["profiled_replay"] = traced_step(
        "preemption: after the resume", None, step, tr.state, batch,
        {k: 0 for k in FLASH})
    res["captures"] = len(step.graphs)
    with open(path, "wb") as f:
        pickle.dump(res, f)


def phase_preemption(fa, dev, card, seed):
    """Item 12b on the card: the captured LM step under
    ``Trainer(preemption_guard=)`` with a ``MultiNodeCheckpointer``, one
    rank under ``launch.supervise``: a SIGTERM from a timer thread at
    ``PRE_AT``, the emergency save and exit 75; the relaunch resumes and
    runs to ``PRE_STOP``; K1/K2/K3 in a profiled replay after the resume;
    the final parameters and AdamW state against this process's
    unpreempted run of the same steps, bit for bit.  That run carries
    ``MetricsReport(device=True)``: the ``device.train_step.*`` gauges."""
    import pickle
    import tempfile

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.launch import supervise
    from chainermn_tpu_torch.observability.device import (
        PEAK_BF16_FLOPS,
        attention_core_flops,
    )
    from chainermn_tpu_torch.resilience import ShardReplicator
    from chainermn_tpu_torch.training import MetricsReport

    out = tempfile.mkdtemp(prefix="cmn_pre_")
    t0 = time.perf_counter()
    rc = supervise(1, [os.path.abspath(__file__), "--rank-body", "pre", out,
                       "--rank-device", str(dev)], restarts=0,
                   preempt_restarts=1, backoff_s=0.0, grace_s=10.0,
                   env_extra={"PYTHONPATH": rank_pythonpath(),
                              "CMN_SMOKE_SEED": str(seed),
                              "CMN_OBS_FLIGHT_DIR":
                              os.path.join(out, "flight")},
                   timeout_s=MP_TIMEOUT_S)
    job_s = time.perf_counter() - t0
    attempts = []
    for a in range(2):
        p = os.path.join(out, f"pre.attempt{a}.pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                attempts.append(pickle.load(f))
    check(rc == 0 and len(attempts) == 2,
          f"preemption: the supervised job ended {rc} with "
          f"{len(attempts)} attempts recorded")
    first, second = attempts
    # The unpreempted run, with the device gauges.
    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    report = MetricsReport(comm, trigger=(2, "iteration"),
                           out_dir=os.path.join(out, "obs"), device=True,
                           aggregate=False, memory=False)
    tr, _ = lm_trainer(dev, seed, comm,
                       lm_rows(seed, LM_BATCH * (PRE_STOP + 1)), LM_BATCH,
                       PRE_STOP, exts=[report])
    tr.run()
    want, want_params = state_digest(tr.optimizer, tr.state)
    roof = report.last_roofline or {}
    step = next(iter(tr.optimizer._step_cache.values()))
    cost = step.program.cost_analysis(capture=False)
    step.release()
    # The replicator's cadence at this model's full size in one process:
    # the host snapshot and the local spill, no peer to ship to.  The
    # first cadence allocates the pinned buffers; the later ones reuse
    # them.
    rep = ShardReplicator(None, every=1, spill_dir=os.path.join(out, "rep"),
                          keep=1, _use_process_injector=False)
    rep_cadences = []
    for _ in range(PRE_REP_CADENCES):
        rep(tr)
        rep_cadences.append(dict(rep.last_cadence))
    del tr, rep
    torch.cuda.empty_cache()
    L = LM["n_layers"]
    kernels = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L,
               "flash_attention_bwd_dq": L}
    # The gauges count the remat recompute (hardware FLOPs); the model's
    # FLOPs are 6·N·T over the matmul weights plus the causal attention
    # core, each forward once.
    d, T = LM["d_model"], LM["max_len"]
    n_matmul = L * (4 * d * d + 2 * d * LM["d_ff"]) + d * LM["vocab"]
    model_flops = 6.0 * n_matmul * LM_BATCH * T + L * attention_core_flops(
        LM_BATCH, LM["n_heads"], T, d // LM["n_heads"], causal=True)
    peak = PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(0))
    model_mfu = (100.0 * model_flops / (roof["step_time_ms"] / 1e3 * peak)
                 if peak and roof.get("step_time_ms") else None)
    row = dict(
        phase="preemption", card=card,
        config=f"{LM}, batch {LM_BATCH}, flash, remat, AdamW 3e-4, bf16 "
        f"wire, captured; SIGTERM at {PRE_AT} of {PRE_STOP}; one rank "
        "under launch.supervise",
        exit_codes=[first.get("exit"), 0], preempted_at=first["iteration"],
        emergency_save_bytes=first["save"].get("bytes"),
        emergency_save_s=first["save"].get("host_copy_s", 0.0)
        + first["save"].get("write_s", 0.0),
        emergency_save=first["save"], resumed_at=second["resumed"],
        resume_s=second["resume_s"], restore=second["restore"],
        final_iteration=second["iteration"],
        profiled_replay_after_resume=second["profiled_replay"],
        captures_after_resume=second["captures"],
        final_state_bit_equal=second["state_digest"] == want,
        final_params_bit_equal=second["params_digest"] == want_params,
        job_s=job_s, device_gauges=roof, train_step_cost=cost,
        model_flops_6nt=model_flops, model_flops_mfu_pct=model_mfu,
        replicator_one_process=rep_cadences,
        replicator_cadence_for_1pct=(
            100 * rep_cadences[-1]["total_s"] * 1e3 / roof["step_time_ms"]
            if roof.get("step_time_ms") else None),
        device_peak_bf16_flops=PEAK_BF16_FLOPS.get(
            torch.cuda.get_device_name(0)))
    emit(row)
    check(first.get("exit") == 75 and first["iteration"] == PRE_AT,
          f"preemption: attempt 0 exited {first.get('exit')} at "
          f"{first['iteration']}")
    check(second["resumed"] == PRE_AT and second["iteration"] == PRE_STOP,
          f"preemption: resumed at {second['resumed']}, ended at "
          f"{second['iteration']}")
    check(second["profiled_replay"] == kernels,
          f"preemption: K1-K3 ran {second['profiled_replay']} in the "
          f"profiled replay after the resume, expected {kernels}")
    check(row["final_state_bit_equal"] and row["final_params_bit_equal"],
          "preemption: the resumed run's parameters and AdamW state are "
          "not bitwise the unpreempted run's")
    check(roof.get("mfu_pct") is not None and roof.get("tflops_per_device"),
          f"preemption: MetricsReport(device=True) published {roof}")
    check(all(c["bytes"] > 0 for c in rep_cadences),
          f"preemption: the one-process replicator cadences {rep_cadences}")
    return row


def rep_schedule(seed):
    """The chaos schedule: the first seed from ``seed * 1000`` whose
    ``chaos_schedule`` (3 failures, ``REP_KINDS``, cadence ``REP_EVERY``,
    target ``REP_STOP``) draws a crash, then a preemption at a later
    iteration, then a torn frame."""
    from chainermn_tpu_torch.resilience import chaos_schedule

    for s in range(seed * 1000, seed * 1000 + 1000):
        sch = chaos_schedule(s, failures=3, target_step=REP_STOP,
                             cadence=REP_EVERY, kinds=REP_KINDS)
        ev = sch["events"]
        if [e["kind"] for e in ev] == list(REP_KINDS) \
                and ev[0]["iter"] < ev[1]["iter"]:
            return sch
    raise AssertionError("no chaos schedule of the wanted shape")


def rep_rank(out: str, device: str) -> None:
    """One attempt of ``replication`` on each of the ranks (gloo, sharing
    the card): ZeRO AdamW on the 2-layer LM with a ``ShardReplicator``
    and a preemption guard; ``CMN_REP_EVENT`` is this attempt's failure
    and ``CMN_REP_PREV`` the last one (a crash wipes the crashed rank's
    spill before the restore: its host died).  Attempt 0 first runs the
    unfaulted oracle.  Every attempt after the first negotiates its
    restore; ``CMN_REP_ELASTIC`` (a relaunch at another world size)
    passes ``maybe_load_elastic`` as the fallback and files the
    incident.  The attempt that reaches the target syncs a
    ``FleetClock`` and exports the merged fleet trace."""
    import pickle
    import shutil

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.observability import fleet, incident
    from chainermn_tpu_torch.observability import metrics as omet
    from chainermn_tpu_torch.resilience import (
        FaultInjector,
        PreemptionGuard,
        PreemptionInterrupt,
        ShardReplicator,
        negotiate_restore,
        parse_fault_spec,
    )

    stamps = {"start": time.time()}
    attempt = int(os.environ["CMN_LAUNCH_ATTEMPT"])
    seed = int(os.environ.get("CMN_SMOKE_SEED", "0"))
    event = json.loads(os.environ.get("CMN_REP_EVENT", "null"))
    prev = json.loads(os.environ.get("CMN_REP_PREV", "null"))
    elastic = os.environ.get("CMN_REP_ELASTIC") == "1"
    dev = torch.device(device)
    comm = create_communicator("naive", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    r = comm.rank
    rows = lm_rows(seed, REP_RANKS * REP_ROWS * (REP_STOP + 1))
    res = {"attempt": attempt, "rank": r, "event": event, "t": stamps}
    path = os.path.join(out, f"rep.attempt{attempt}.rank{r}.pkl")

    def save():
        with open(path, "wb") as f:
            pickle.dump(res, f)

    def trainer(exts=(), guard=None):
        return lm_trainer(dev, seed, comm, rows, REP_ROWS, REP_STOP,
                          layers=REP_LAYERS, zero=True, exts=exts,
                          guard=guard)

    if attempt == 0 and not elastic:
        tr, _ = trainer()
        tr.run()
        res["oracle_state"], res["oracle_params"] = state_digest(
            tr.optimizer, tr.state, zero=True)
        del tr
        torch.cuda.empty_cache()
        stamps["oracle"] = time.time()
    if prev and prev["kind"] == "crash" and r == REP_CRASH_RANK:
        spill = os.path.join(out, "rep", f"rank{r}")
        shutil.rmtree(spill, ignore_errors=True)
        os.makedirs(spill)
    kind = event["kind"] if event else None
    inj = (FaultInjector(parse_fault_spec("flip@replicate:1"))
           if kind == "torn" and r == REP_SIGNAL_RANK else None)
    rep = ShardReplicator(comm, every=REP_EVERY, factor=1,
                          spill_dir=os.path.join(out, "rep"), keep=2,
                          injector=inj, _use_process_injector=False)
    ckpt = create_multi_node_checkpointer(
        "rep", comm, path=os.path.join(out, "ckpt"),
        trigger=(REP_STOP, "iteration"), async_save=False, max_to_keep=2)
    guard = PreemptionGuard(comm=comm).install()
    exts = [rep, ckpt]
    if kind == "preempt" and r == REP_SIGNAL_RANK:
        exts.append(signal_at(guard, event["iter"]))
    tr, model = trainer(exts, guard)
    stamps["built"] = time.time()
    if kind == "crash" and r == REP_CRASH_RANK:
        tr._fault_injector = FaultInjector(parse_fault_spec(
            f"crash@iter:{event['iter']}"))
    res["restored_step"] = 0
    if attempt > 0:
        el = ((lambda: ckpt.maybe_load_elastic(tr.optimizer, model, tr))
              if elastic else None)
        _, it, report = negotiate_restore(rep, tr.state, tr,
                                          checkpointer=ckpt, elastic=el)
        res.update(restored_step=int(it), report=report)
        stamps["restored"] = time.time()
        if elastic:
            mgr = incident.manager()
            mgr.evaluate()
            res["incidents"] = [m["rule"]["name"] for m in mgr.incidents]
            res["final_step"] = tr.iteration
            res["state_digest"], res["params_digest"] = state_digest(
                tr.optimizer, tr.state, zero=True)
            save()
            comm.barrier()
            return
    save()  # what a crashed rank's peers leave behind
    t0 = time.perf_counter()
    try:
        tr.run()
    except PreemptionInterrupt as e:
        res.update(exit=e.code, final_step=e.iteration,
                   run_s=time.perf_counter() - t0)
        save()
        raise
    res["run_s"] = time.perf_counter() - t0
    stamps["ran"] = time.time()
    res["final_step"] = tr.iteration
    res["state_digest"], res["params_digest"] = state_digest(
        tr.optimizer, tr.state, zero=True)
    snap = omet.registry().snapshot()
    res.update(
        torn=snap.get("train.rep.torn", {}).get("value", 0),
        rep_ms=snap.get("train.rep.ms"), step_ms=snap.get("train.step_ms"),
        last_cadence=rep.last_cadence)
    clock = fleet.FleetClock(comm, probes=8)
    offsets = clock.sync()
    trace_path = os.path.join(out, "trace.merged.json")
    summary = fleet.export_fleet_trace(comm, path=trace_path, clock=clock)
    if r == 0:
        from chainermn_tpu_torch.observability import analyze

        with open(trace_path) as f:
            report = analyze.analyze(json.load(f))
        res.update(offsets={k: o.to_dict() for k, o in offsets.items()},
                   trace=summary,
                   critical_path=dict(
                       steps=len(report["steps"]),
                       bounded_steps_by_rank=report["bounded_steps_by_rank"],
                       straggler_rank=report["straggler_rank"],
                       stall_ms_by_rank=report["stall_ms_by_rank"],
                       head=report["steps"][:6]))
    stamps["end"] = time.time()
    save()
    comm.barrier()


def phase_replication(dev, card, seed):
    """Item 12b across ranks: ``REP_RANKS`` gloo ranks sharing the card
    (ZeRO AdamW on the 2-layer LM) through a ``TrainingChaosHarness``
    schedule: a crash (the crashed rank's spill wiped: it restores from
    its successor's replica), a SIGTERM preemption (every rank flushes,
    saves and exits 75; the relaunch restores its own flush) and a torn
    frame (discarded by the receiver's crc), each attempt a fresh
    ``launch``; the final digest against the unfaulted run's on every
    rank, lost steps per failure <= the cadence, the replicator's ms per
    cadence against the step; then a relaunch at 2 ranks falls back to
    ``maybe_load_elastic`` and files ``replication_fallback``; the fleet
    clock's offsets and the merged trace's critical path."""
    import pickle
    import tempfile

    from chainermn_tpu_torch.launch import launch
    from chainermn_tpu_torch.resilience import TrainingChaosHarness

    out = tempfile.mkdtemp(prefix="cmn_rep_")
    schedule = rep_schedule(seed)
    env = {"PYTHONPATH": rank_pythonpath(), "CMN_SMOKE_SEED": str(seed),
           "CMN_OBS_FLIGHT_DIR": os.path.join(out, "flight"),
           "CMN_OBS_INCIDENT_DIR": os.path.join(out, "incidents")}
    argv = [os.path.abspath(__file__), "--rank-body", "rep", out,
            "--rank-device", str(dev)]
    codes, records = [], []

    def load(attempt, n):
        got = []
        for rk in range(n):
            p = os.path.join(out, f"rep.attempt{attempt}.rank{rk}.pkl")
            if os.path.exists(p):
                with open(p, "rb") as f:
                    got.append(pickle.load(f))
        return got

    prev = [None]

    def run_attempt(attempt, event):
        t0, wall0 = time.perf_counter(), time.time()
        rc = launch(REP_RANKS, argv, grace_s=10.0, env_extra={
            **env, "CMN_LAUNCH_ATTEMPT": str(attempt),
            "CMN_REP_EVENT": json.dumps(event),
            "CMN_REP_PREV": json.dumps(prev[0])}, timeout_s=MP_TIMEOUT_S)
        prev[0] = event
        ranks = load(attempt, REP_RANKS)
        codes.append(rc)
        records.append(dict(attempt=attempt, rc=rc, event=event,
                            seconds=time.perf_counter() - t0, ranks=ranks,
                            rank0_stamps_s={k: v - wall0 for k, v in next(
                                (x["t"] for x in ranks if x["rank"] == 0),
                                {}).items()}))
        r0 = next((x for x in ranks if x["rank"] == 0), {})
        report = r0.get("report") or {}
        final = (event["iter"] if event and event["kind"] == "crash"
                 else r0.get("final_step", 0))
        return {"rc": rc, "final_step": final,
                "restored_step": r0.get("restored_step", 0),
                "restore_source": report.get("source"),
                "recovery_ms": report.get("recovery_ms"),
                "digest": r0.get("state_digest") if rc == 0 else None}

    t0 = time.perf_counter()
    result = TrainingChaosHarness(run_attempt, schedule).run()
    oracle = {x["rank"]: x for x in records[0]["ranks"]}
    verdict = TrainingChaosHarness.verify(result, oracle[0]["oracle_state"])
    last = {x["rank"]: x for x in records[-1]["ranks"]}
    chaos_s = time.perf_counter() - t0
    # The relaunch at another world size.
    t1 = time.perf_counter()
    rc2 = launch(2, argv, grace_s=10.0, env_extra={
        **env, "CMN_LAUNCH_ATTEMPT": str(len(records)),
        "CMN_REP_ELASTIC": "1"}, timeout_s=MP_TIMEOUT_S)
    elastic = load(len(records), 2)
    elastic_s = time.perf_counter() - t1
    sources = [[(x["rank"], (x.get("report") or {}).get("source"),
                 x.get("restored_step")) for x in rec["ranks"]]
               for rec in records[1:]]
    rep_ms = {rk: x.get("rep_ms") for rk, x in last.items()}
    step_ms = {rk: x.get("step_ms") for rk, x in last.items()}

    def mean(h):
        return h["sum"] / h["count"] if h and h.get("count") else None

    per_rank = {rk: dict(rep_ms_per_cadence=mean(rep_ms[rk]),
                         step_ms=mean(step_ms[rk]),
                         cadence_split_s=last[rk].get("last_cadence"))
                for rk in last}
    row = dict(
        phase="replication", card=card,
        config=f"{REP_RANKS} gloo ranks sharing the card, LM {REP_LAYERS} "
        f"layers at full widths, {REP_ROWS} rows of {LM['max_len']} a "
        f"rank, ZeRO AdamW 3e-4, flash, remat, bf16 wire; "
        f"ShardReplicator every {REP_EVERY}, factor 1; target {REP_STOP}",
        schedule=schedule, exit_codes=codes,
        attempt_seconds=[rec["seconds"] for rec in records],
        attempt_rank0_stamps_s=[rec["rank0_stamps_s"] for rec in records],
        restores=sources, lost_steps_per_failure=result[
            "lost_steps_per_failure"],
        recovery_ms=result["recovery_ms"], verdict=verdict,
        final_digest_equals_oracle={
            rk: x.get("state_digest") == oracle[rk]["oracle_state"]
            for rk, x in last.items()},
        torn_discarded={rk: x.get("torn") for rk, x in last.items()},
        replicator=per_rank,
        cadence_for_1pct={rk: (100 * v["rep_ms_per_cadence"]
                               / v["step_ms"] if v["step_ms"] else None)
                          for rk, v in per_rank.items()
                          if v["rep_ms_per_cadence"] is not None},
        elastic=dict(rc=rc2, seconds=elastic_s, ranks=[
            dict(rank=x["rank"], report=x.get("report"),
                 incidents=x.get("incidents"),
                 params_equal_oracle=x.get("params_digest")
                 == oracle[0]["oracle_params"]) for x in elastic]),
        fleet=dict(offsets=last[0].get("offsets"),
                   trace_spans=(last[0].get("trace") or {}).get("spans"),
                   trace=last[0].get("trace"),
                   critical_path=last[0].get("critical_path")),
        chaos_s=chaos_s, goodput_steps_per_s=result["goodput_steps_per_s"],
        note=MP_NOTE.replace("4 ranks", f"{REP_RANKS} ranks"))
    emit(row)
    want_codes = [1, 75, 0]
    check(result["completed"] and codes[:1] != [0]
          and codes[1:] == want_codes[1:],
          f"replication: attempts exited {codes}, expected a failure, 75, "
          "then 0")
    check(verdict["holds"], f"replication: {verdict['failures']}")
    check(all(row["final_digest_equals_oracle"].values())
          and len(last) == REP_RANKS,
          f"replication: final digests against the oracle "
          f"{row['final_digest_equals_oracle']}")
    crash_restore = sources[0]
    check(sorted(crash_restore) == [
        (0, "local", crash_restore[0][2]),
        (1, "peer", crash_restore[0][2]),
        (2, "local", crash_restore[0][2])],
        f"replication: the restore after the crash read {crash_restore}")
    check(row["torn_discarded"].get((REP_SIGNAL_RANK + 1) % REP_RANKS, 0)
          >= 1, f"replication: torn frames {row['torn_discarded']}")
    check(rc2 == 0 and len(elastic) == 2 and all(
        e["report"]["reason"] == "world-size-changed"
        and e["report"]["source"] == "orbax"
        and "replication_fallback" in (e["incidents"] or [])
        and e["params_equal_oracle"] for e in row["elastic"]["ranks"]),
        f"replication: the 2-rank relaunch read {row['elastic']}")
    check(row["fleet"]["trace_spans"] and row["fleet"]["critical_path"]
          and row["fleet"]["critical_path"]["steps"] > 0,
          f"replication: the merged fleet trace {row['fleet']}")
    return row


def phase_serving_drain(ops, dev, card, seed):
    """The disaggregated roles of ``disagg`` at the serving bench's
    widths, three of them over the in-process ``LocalComm``: a prefill
    role feeding decode role 1, which a ``PreemptionGuard`` watches, its
    drain bound to role 2 (``guard.attach_drain``).  Once every request reached role 1, this process gets
    a SIGTERM (the roles share it, as ``disagg``'s do; the guard's handler
    only sets its flag): role 1's next tick migrates every live slot and
    queued entry to role 2 and raises exit 75.  Checks: every request
    completes once, the tokens equal an undrained run's, the exit code,
    and K4's runs on the card before and after the drain."""
    import signal

    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.observability import MetricsRegistry
    from chainermn_tpu_torch.resilience import (
        PreemptionGuard,
        PreemptionInterrupt,
    )
    from chainermn_tpu_torch.serving import (
        DecodeRole,
        LocalComm,
        MigrationTransport,
        PrefillRole,
        Scheduler,
    )
    from chainermn_tpu_torch.serving.scheduler import _Clock

    rng = np.random.RandomState(seed + 23)
    reqs = draw_requests(rng, 12, FULL["vocab"])
    model = TransformerLM(**FULL, device=dev, seed=seed)
    fleet = Fleet(model, dev, seed, reqs)

    def run(drain):
        clock, comm = _Clock(), LocalComm(3)
        regs = [MetricsRegistry() for _ in range(3)]
        trs = [MigrationTransport(comm.endpoint(i), registry=regs[i])
               for i in range(3)]
        guard = PreemptionGuard()
        pre = PrefillRole(Scheduler(fleet(), registry=regs[0], clock=clock),
                          trs[0], decode_ranks=[1])
        d1 = DecodeRole(Scheduler(fleet(), registry=regs[1], clock=clock),
                        trs[1], prefill_ranks=[0], guard=guard)
        if drain:
            guard.attach_drain(lambda: d1.drain(2))
        d2 = DecodeRole(Scheduler(fleet(), registry=regs[2], clock=clock),
                        trs[2], prefill_ranks=[], peer_ranks=[1])
        for r in reqs:
            pre.submit(r)
        zero_decode_counts(ops, dev)
        while pre.pending:
            d1.tick()
            pre.tick()
        pre.finish()
        out = {}
        done = list(pre.sched.completions)
        if drain:
            for _ in range(4):
                d1.tick()
            live = sum(s is not None for s in d1.sched._slots)
            queued = len(d1.sched._queue) + len(d1._deferred)
            torch.cuda.synchronize()
            out["k4_before"] = ops.kernel_runs(dev)["paged_decode_attention"]
            with guard:
                os.kill(os.getpid(), signal.SIGTERM)
                deadline = time.monotonic() + 30
                while not guard.preempted and time.monotonic() < deadline:
                    time.sleep(0.001)
                try:
                    for _ in range(8):
                        d1.tick()
                    code = None
                except PreemptionInterrupt as e:
                    code = e.code
            comps = list(d2.run_loop(poll_ms=0))
            done += list(d1.sched.completions) + comps
            torch.cuda.synchronize()
            out.update(exit=code, live_at_signal=live,
                       queued_at_signal=queued,
                       migrated=regs[1].peek(
                           "serve.migration.slots_migrated").value,
                       k4_after=ops.kernel_runs(dev)[
                           "paged_decode_attention"] - out["k4_before"],
                       drained_to_completions=len(comps))
        else:
            done += d1.run_loop(poll_ms=0)
        out["byid"] = check_complete(f"serving_drain drain={drain}", reqs,
                                     done)
        for role in (pre, d1, d2):
            role.sched.engine.release()
        return out

    plain = run(False)
    drained = run(True)
    same = {i: drained["byid"][i].tokens == plain["byid"][i].tokens
            for i in plain["byid"]}
    row = dict(phase="serving_drain", card=card, requests=len(reqs),
               exit=drained["exit"], live_at_signal=drained["live_at_signal"],
               queued_at_signal=drained["queued_at_signal"],
               slots_migrated=drained["migrated"],
               completed_after_drain=drained["drained_to_completions"],
               lost=len(reqs) - len(drained["byid"]),
               tokens_equal_undrained=sum(same.values()),
               k4_runs_before_drain=drained["k4_before"],
               k4_runs_after_drain=drained["k4_after"])
    emit(row)
    check(drained["exit"] == 75, f"serving_drain: exit {drained['exit']}")
    check(drained["live_at_signal"] > 0 and drained["migrated"] > 0,
          f"serving_drain: nothing to drain ({row})")
    check(all(same.values()), f"serving_drain: tokens differ from the "
          f"undrained run for {[i for i, v in same.items() if not v]}")
    check(drained["k4_before"] > 0 and drained["k4_after"] > 0,
          f"serving_drain: K4 ran {drained['k4_before']} / "
          f"{drained['k4_after']} on the card")
    return row


def perf_records(card, name, rows):
    """This run's headline numbers as ``result/``-style records of this
    platform (``gpu``) and card."""
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    return [{"metric": m, "value": float(v), "unit": u, "platform": "gpu",
             "device_kind": name, "power_limit": card.rsplit(",", 1)[-1]
             .strip(), "measured_at": stamp, "source": "chip_smoke.py"}
            for m, v, u in rows if v]


def phase_perf_sentinel(card, name, rows):
    """``observability.perf`` over the repo's ``result/`` history plus
    this run's records: the card's series are judged apart from the TPU
    history (each a single capture here: insufficient, so green)."""
    import shutil
    import tempfile

    from chainermn_tpu_torch.observability import perf
    from chainermn_tpu_torch.utils import atomic_json_dump

    d = tempfile.mkdtemp(prefix="cmn_perf_")
    src = perf.default_result_dir()
    for f in os.listdir(src):
        if f.endswith(".json"):
            shutil.copy(os.path.join(src, f), d)
    recs = perf_records(card, name, rows)
    for i, rec in enumerate(recs):
        atomic_json_dump(rec, os.path.join(d, f"port_gpu_{i}.json"))
    gpu = perf.analyze(d, platform="gpu")
    row = dict(phase="perf_sentinel", card=card, records=recs,
               gpu=perf.sentinel(d, platform="gpu"),
               tpu=perf.sentinel(d, platform="tpu"),
               all=perf.sentinel(d),
               gpu_series=[(r["metric"], r["status"], r["n_samples"])
                           for r in gpu["series"]])
    emit(row)
    check(row["gpu"]["verdict"] != "error"
          and len(gpu["series"]) == len(recs),
          f"perf_sentinel: {row['gpu']}, {len(gpu['series'])} series for "
          f"{len(recs)} records")
    return row


RANK_BODIES.update(pre=pre_rank, rep=rep_rank)


FLASH_SASS = ("flash_fwd_bf16", "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16")
CONV_SASS = ("matmul_affine_bf16",)
CONV_TILES = (64, 128)


def _sass_rows(counts, kernels):
    """``{"<kernel><N>": value}`` of the functions among ``counts``'s
    (mangled) names that instantiate one of ``kernels`` with the integer
    template argument N."""
    import re

    rows = {}
    for fn, c in counts.items():
        for kernel in kernels:
            m = re.search(rf"{kernel}ILi(\d+)E", fn)
            if m:
                rows[f"{kernel}<{m.group(1)}>"] = c
    return rows


def flash_sass_rows(counts):
    """``{"<kernel><D>": counts}`` of the bf16 flash functions among
    ``_kernels.sass_counts``'s (mangled) names."""
    return _sass_rows(counts, FLASH_SASS)


def conv_sass_rows(counts):
    """``{"matmul_affine_bf16<BN>": counts}`` of the bf16 fused-conv
    functions among ``_kernels.sass_counts``'s (mangled) names."""
    return _sass_rows(counts, CONV_SASS)


def _phase_sass(kernels, phase, source, rows_of, expected):
    """Counts of HGMMA (wgmma), HMMA (mma.sync) and UTMALDG (TMA loads) in
    each bf16 function of ``source``'s library, and the functions whose
    wgmmas ptxas serialized (its C75xx warnings in the library's build
    log; null when no log can be read), printed before the check that each
    of the ``expected`` functions is there, uses wgmma and TMA and no
    mma.sync, and keeps its wgmmas asynchronous.  A library without its
    log fails the check."""
    rows = rows_of(kernels.sass_counts(kernels.sass(source)))
    log = kernels.build_log(source)
    serialized = None if log is None else sorted(rows_of(
        dict.fromkeys(kernels.serialized_wgmma(log), 0)))
    emit({"phase": phase, "functions": rows,
          "serialized_wgmma": serialized})
    check(sorted(rows) == sorted(expected),
          f"{phase}: expected the bf16 functions {sorted(expected)}, found "
          f"{sorted(rows)}")
    check(serialized is not None,
          f"{phase}: no build log of the {source} library to read ptxas's "
          "serialization warnings from")
    for name, c in rows.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0,
              f"{phase}: {name} is not built on wgmma and TMA: {c}")
        check(name not in serialized,
              f"{phase}: ptxas serialized the wgmmas of {name}")


def phase_flash_sass(kernels):
    """``_phase_sass`` over the flash library: K1, K2 and K3 at head dims
    32, 64 and 128."""
    _phase_sass(kernels, "flash_sass", "flash_attention", flash_sass_rows,
                [f"{k}<{d}>" for k in FLASH_SASS for d in (32, 64, 128)])


def phase_conv_sass(kernels):
    """``_phase_sass`` over the fused-conv library: K6 at each column
    tile."""
    _phase_sass(kernels, "conv_sass", "conv_fused", conv_sass_rows,
                [f"{k}<{n}>" for k in CONV_SASS for n in CONV_TILES])


#: the decode-attention functions (K4 ``paged``, K5 ``fused``), named
#: ``decode_<kind>_q<type>_kv<type>_rb<rows per CTA>``; those of bf16
#: caches, the main path's, must copy K/V asynchronously and spill nothing.
DECODE_SASS = r"decode_(paged|fused)_q(f32|bf16)_kv(f32|bf16|i8)_rb(\d+)"
DECODE_BF16 = [f"decode_{k}_q{q}_kvbf16_rb{rb}" for k in ("paged", "fused")
               for q in ("f32", "bf16") for rb in (1, 4)]


def decode_sass_rows(counts, resources):
    """``{"decode_<...>": counts and ptxas resources}`` of the decode
    functions among ``_kernels.sass_counts``'s (mangled) names; a function
    ptxas did not report has no resource keys."""
    import re

    rows = {}
    for fn, c in counts.items():
        m = re.search(DECODE_SASS, fn)
        if m:
            rows[m.group(0)] = {**c, **resources.get(fn, {})}
    return rows


def phase_decode_sass(kernels):
    """The asynchronous copies (``UBLKCP``, ``LDGSTS``) of every
    decode-attention function, with ptxas's registers, stack frame and
    spill bytes from the library's build log, printed before the check
    that each bf16-cache function is there, copies asynchronously and
    spills nothing.  A library without its log fails the check."""
    log = kernels.build_log("decode_attention")
    rows = decode_sass_rows(
        kernels.sass_counts(kernels.sass("decode_attention")),
        kernels.ptxas_resources(log) if log is not None else {})
    emit({"phase": "decode_sass", "functions": rows})
    check(log is not None, "decode_sass: no build log of the "
          "decode_attention library to read ptxas's spills from")
    missing = sorted(set(DECODE_BF16) - set(rows))
    check(not missing, f"decode_sass: bf16 functions missing: {missing}")
    for name in DECODE_BF16:
        c = rows[name]
        check(c["UBLKCP"] + c["LDGSTS"] > 0,
              f"decode_sass: {name} has no asynchronous copy: {c}")
        check(c.get("spill_stores") == 0,
              f"decode_sass: {name} spills (or ptxas reported no spill "
              f"line): {c}")


# ------------------------------------------------------- tree comparison
#: what ``--compare-with`` times in each tree: the decode kernels (phase 4
#: with its long rows) and the bf16 and int8 serving drives (phase 5's,
#: without the incident manager), the flash kernels (phase 9), the LM
#: flash-arm step (phase 10's first arm),
#: the fused-conv kernel (phase 13) and the ``frozen/pallas`` ResNet step
#: (an arm of phase 14).
COMPARE_PHASES = ("decode", "flash", "lm", "conv", "resnet")

#: run in another checkout's root: the phases named in its second argument,
#: through that checkout's own chip_smoke.py, except ``decode``: this
#: script (its path is the third argument) times that checkout's own
#: decode kernels and drives its own serving engine, so that both trees
#: are measured by the same code at the same shapes.
_COMPARE_WORKER = """
import importlib, importlib.util, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.ops import conv_fused as cf
seed, phases = int(sys.argv[1]), sys.argv[2].split(",")
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.nvidia_smi()
if "decode" in phases:
    spec = importlib.util.spec_from_file_location("harness", sys.argv[3])
    hs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hs)
    ops = importlib.import_module("chainermn_tpu_torch.ops.decode_attention")
    hs.emit({"phase": "decode_ops", "file": ops.__file__})
    _, mb = hs.engine_geometry(hs.draw_requests(
        np.random.RandomState(seed), 16, hs.FULL["vocab"]))
    hs.phase_timing(ops, dev, seed, mb)
    hs.phase_long_timing(ops, dev, seed)
    hs.drive_serving(ops, dev, card, seed, "bf16_mha", 16, planes=False)
    hs.drive_serving(ops, dev, card, seed + 10, "int8_gqa", 6, planes=False,
                     n_kv_heads=4, kv_dtype=torch.int8)
fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
comm = create_communicator("xla", device=dev,
                           allreduce_grad_dtype=torch.bfloat16)
if "flash" in phases:
    cs.phase_flash_timing(fa, dev, seed)
if "lm" in phases:
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cs.LM["vocab"], size=(cs.LM_BATCH, cs.LM["max_len"]))).to(dev)
    cs.train_arm(fa, dev, card, seed, "flash", comm, (toks, toks))
if "conv" in phases:
    cs.phase_conv_timing(cf, dev, seed)
if "resnet" in phases:
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    batch = (torch.randn((cs.RESNET_BATCH, cs.RESNET_SIZE, cs.RESNET_SIZE,
                          3), generator=g, device=dev),
             torch.randint(0, cs.RESNET_CLASSES, (cs.RESNET_BATCH,),
                           generator=g, device=dev))
    torch.backends.cudnn.benchmark = True
    cs.resnet_arm(cf, dev, card, seed, "frozen", "pallas", comm, batch)
"""


def compare_trees(other, seed, phases=COMPARE_PHASES):
    """``phases`` (of ``COMPARE_PHASES``) of checkout ``other`` (for
    example the parent commit, unpacked with ``git archive``, or a
    patched copy) and of this one, in turns other, this, this, other, each
    in a process of its own; every line is printed with its tree."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    for label, tree in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        proc = subprocess.run(
            [sys.executable, "-c", _COMPARE_WORKER, str(seed),
             ",".join(phases), os.path.abspath(__file__)],
            cwd=tree, capture_output=True, text=True, timeout=1800)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                emit({"tree": label, "dir": tree, **json.loads(line)})
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            check(False, f"compare: the {label} tree failed "
                         f"(exit {proc.returncode})")
    return 0


# -------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-with", metavar="DIR",
                    help="only time the decode, flash and fused-conv "
                         "kernels, the bf16 serving drive, the LM flash "
                         "step and the frozen/pallas ResNet step of the "
                         "checkout DIR and of this one, in turns (see "
                         "compare_trees)")
    ap.add_argument("--compare-phases", default=",".join(COMPARE_PHASES),
                    help="with --compare-with: which of "
                         f"{','.join(COMPARE_PHASES)} to time "
                         "(comma-separated; default all)")
    ap.add_argument("--rank-body", nargs=2, metavar=("NAME", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank-device", default="cuda:0",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_body:
        # One rank of a model-parallel phase, started by launch_ranks.
        name, out = args.rank_body
        RANK_BODIES[name](out, args.rank_device)
        return 0
    phases = args.compare_phases.split(",")
    if any(ph not in COMPARE_PHASES for ph in phases):
        ap.error(f"--compare-phases takes {COMPARE_PHASES}, got {phases}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "the card", file=sys.stderr)
        return 2
    if args.compare_with:
        return compare_trees(args.compare_with, args.seed, phases)

    import importlib

    from chainermn_tpu_torch.ops import _kernels
    from chainermn_tpu_torch.ops import conv_fused as cf
    from chainermn_tpu_torch.ops import decode_attention as ops

    # The module (``chainermn_tpu_torch.ops`` re-exports a function of the
    # same name).
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # Full fp32 products wherever fp32 is asked for (the agreement phase).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _kernels.CSRC_DIR.glob("*.cu"))
    _kernels.build(sources)
    for n in sources:
        print(f"--- nvcc csrc/{n}.cu\n{_kernels.build_log(n) or ''}",
              file=sys.stderr)
    emit({"phase": "build", "sources": sources,
          "seconds": time.perf_counter() - t0})
    phase_flash_sass(_kernels)
    phase_conv_sass(_kernels)
    phase_decode_sass(_kernels)
    # The block-table width the serving phase's engine will have.
    _, mb = engine_geometry(draw_requests(
        np.random.RandomState(args.seed), 16, FULL["vocab"]))
    errs = phase_parity(ops, dev, args.seed, mb)
    errs.update(phase_flash_parity(fa, dev, args.seed))
    timing = phase_timing(ops, dev, args.seed, mb)
    phase_long_timing(ops, dev, args.seed)
    timing.update(phase_flash_timing(fa, dev, args.seed))
    phase_flash_crossover(fa, dev, args.seed, smi)

    serve = drive_serving(ops, dev, smi, args.seed, "bf16_mha", 16)
    phase_serving_turns(dev, smi, args.seed)
    phase_obs_overhead(dev, smi, args.seed)
    phase_policy(dev, smi, args.seed)
    drive_serving(ops, dev, smi, args.seed + 10, "int8_gqa", 6,
                  n_kv_heads=4, kv_dtype=torch.int8)
    serve_spec = phase_serving_spec(ops, dev, smi, args.seed)
    fleet = fleet_phases(ops, dev, smi, args.seed)
    gen = phase_generation(ops, dev, smi, args.seed)
    phase_agreement(dev, args.seed)
    search = {"beam": phase_beam(ops, dev, smi, args.seed),
              "speculative": phase_speculative(ops, dev, smi, args.seed),
              "rolling": phase_rolling(ops, dev, smi, args.seed),
              "moe_generation": phase_moe_generation(ops, dev, smi,
                                                     args.seed)}
    train = phase_training(fa, dev, smi, args.seed)
    phase_training_agreement(fa, dev, args.seed)
    moe_train = phase_moe_training(fa, dev, smi, args.seed)

    errs["matmul_affine_fwd"] = phase_conv_parity(cf, dev, args.seed)
    # K6's row holds the sums over the 36 launches of one training step.
    timing["matmul_affine_fwd"] = phase_conv_timing(cf, dev, args.seed)
    resnet_arms = phase_resnet(cf, dev, smi, args.seed)
    resnet = resnet_arms["frozen/pallas"]
    phase_resnet_agreement(cf, dev, args.seed)
    phase_train_imagenet_example()
    # The training loop (Trainer, extensions, prefetching, checkpoints).
    phase_mnist_trainer(dev, smi, args.seed)
    reset_flash(fa)
    imagenet = phase_imagenet_trainer(
        cf, dev, smi, args.seed,
        {k: a["step_ms_median"] for k, a in resnet_arms.items()})
    lm_eval = phase_lm_eval(fa, dev, smi, args.seed)
    # The rest of the one-card model zoo and the optimizer tiers.
    s2s = phase_seq2seq(fa, dev, smi, args.seed)
    phase_seq2seq_example(dev, smi)
    vit = phase_vit(fa, dev, smi, args.seed)
    lora = phase_lora(fa, dev, smi, args.seed)
    large = phase_large_batch(fa, dev, smi, args.seed,
                              resnet_arms["sync/none"]["step_ms_median"],
                              train["step_ms_median"])
    # The rest of the communicator and the model-parallel surface.
    torch.cuda.empty_cache()
    phase_collectives_nccl(dev, smi)
    mp_row = phase_model_parallel(dev, smi)
    phase_model_parallel_grid(dev, smi)
    # Pipelines, sequence parallelism and the 5-way-parallel LM.
    phase_pipeline(dev, smi, mp_row)
    sp = phase_sequence_parallel(dev, smi, args.seed)
    plm = phase_parallel_lm(dev, smi, args.seed)
    # Tensor-parallel serving, the ZeRO tier, the convnets and DCGAN.
    tp = phase_tp_serving(ops, dev, smi, args.seed)
    zero = phase_zero(dev, smi, args.seed)
    phase_gan_convnet(dev, smi, args.seed)
    # The failure detector, the consistency vote and the health guard.
    hg = phase_health_guard(fa, dev, smi, args.seed)
    # Preemption, peer replication and the chaos harness, the serving
    # drain; the fleet clock, the device gauges and the perf sentinel.
    pre = phase_preemption(fa, dev, smi, args.seed)
    rep = phase_replication(dev, smi, args.seed)
    drain = phase_serving_drain(ops, dev, smi, args.seed)
    phase_perf_sentinel(smi, name, [
        ("lm_train_step_ms", train["step_ms_median"], "ms"),
        ("serving_tokens_per_s", serve["tokens_per_s"], "tok/s"),
        ("resnet50_sync_step_ms",
         resnet_arms["sync/none"]["step_ms_median"], "ms"),
        ("preemption_resume_ms", pre["resume_s"] * 1e3, "ms"),
        ("replication_ms_per_cadence",
         rep["replicator"][0]["rep_ms_per_cadence"], "ms")])

    launches = {"paged_decode_attention":
                serve["launches"]["paged_decode_attention"],
                "fused_decode_attention":
                gen["launches"]["fused_decode_attention"],
                **train["launches"], **resnet["launches"]}
    # Launches on each main path that runs the kernel: K5 per search
    # phase, K1-K3 per step of each training phase.
    by_phase = {"paged_decode_attention": {
        "serving": serve["launches"]["paged_decode_attention"],
        "serving_spec": serve_spec["k4_runs"],
        **{ph: r["launches"] for ph, r in fleet.items()}},
        "fused_decode_attention": {
        "generation": gen["launches"]["fused_decode_attention"],
        **{ph: r["launches"]["fused_decode_attention"]
           for ph, r in search.items()}}}
    for k in FLASH:
        by_phase[k] = {"training_per_step": train["launches_per_step"][k],
                       "moe_training_per_step":
                       moe_train["launches_per_step"][k]}
    for k in FLASH:
        by_phase[k].update(
            seq2seq_per_step=s2s["arms"]["flash"]["launches_per_step"][k],
            seq2seq_packed_per_step=s2s["arms"]["packed"]
            ["launches_per_step"][k],
            vit_per_step=vit["launches_per_step"][k],
            lora_per_step=lora["launches_per_step"][k],
            adafactor_per_step=large["adafactor"]["launches_per_step"][k],
            adamw_warmup_per_step=large["adamw_warmup"]
            ["launches_per_step"][k])
    for k in FLASH:
        by_phase[k].update(
            {f"sequence_parallel_{name}_per_rank": v["launches_per_rank"][k]
             for name, v in sp["variants"].items()},
            parallel_lm_per_rank_per_step=plm["launches_per_rank_per_step"]
            [k])
    for k in FLASH:
        by_phase[k]["zero_per_rank_per_step"] = [
            [lc[k] for lc in steps]
            for steps in zero["launches_per_rank_per_step"]]
        by_phase[k]["zero_profiled_step_per_rank"] = [
            p[k] for p in zero["profiled_step_per_rank"]]
        by_phase[k]["health_guard_per_step"] = \
            hg["arms"]["on"]["launches_per_step"][k]
        by_phase[k]["health_guard_profiled_replay"] = \
            hg["arms"]["on"]["launches_per_replay_profiled"][k]
        by_phase[k]["preemption_profiled_replay_after_resume"] = \
            pre["profiled_replay_after_resume"][k]
    by_phase["paged_decode_attention"]["tp_serving_one_rank_nccl"] = \
        tp["nccl_one_rank"]["k4_runs"]
    by_phase["paged_decode_attention"].update(
        serving_drain_before_drain=drain["k4_runs_before_drain"],
        serving_drain_after_drain=drain["k4_runs_after_drain"])
    by_phase["paged_decode_attention"].update(
        {f"tp_serving_{name}_per_rank": r["k4_runs_per_rank"]
         for name, r in tp["gloo"].items()})
    by_phase["fused_decode_attention"].update(
        {f"tp_generate_{name}_per_rank": g["k5_runs_per_rank"]
         for name, g in tp["generate"].items()})
    by_phase["flash_attention_fwd"].update(
        seq2seq_greedy=s2s["decode"]["greedy"]["launches"]
        ["flash_attention_fwd"],
        seq2seq_beam=s2s["decode"]["beam"]["launches"]["flash_attention_fwd"])
    # The evaluator's forward: K1 alone, per val batch and in all.
    by_phase["flash_attention_fwd"].update(
        lm_eval=lm_eval["launches"]["flash_attention_fwd"],
        lm_eval_per_val_batch=lm_eval["launches"]["flash_attention_fwd"]
        / lm_eval["batches"])
    pallas = imagenet["frozen/pallas"]
    by_phase["matmul_affine_fwd"] = {
        "resnet_per_step": resnet["launches_per_step"],
        "imagenet_trainer": pallas["k6_launches_epoch1"],
        "imagenet_trainer_steps": pallas["training_steps_epoch1"],
        "imagenet_trainer_eval_batches": pallas["eval_batches"]}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": KERNELS[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": timing[k]["kernel_ms"],
         "plain_ms": timing[k]["plain_ms"],
         "bound_ms": timing[k]["bound_ms"],
         "bound_by": timing[k]["bound_by"],
         "library_ms": timing[k]["library_ms"],
         **({"launches_by_phase": by_phase[k]} if k in by_phase else {})}
        for k in KERNELS]})
    emit({"phase": "phase_seconds", "seconds": dict(PHASE_SECONDS)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
