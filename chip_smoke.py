"""Chip smoke test of the PyTorch port (``singa_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right, serves
and trains on the card.

Run from the repository root, with no arguments::

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; nothing is
caught and carried on):

  1. env     the card's name and power limit (nvidia-smi), torch and CUDA
             versions, and the nvcc build of every kernel in
             singa_tpu_torch/csrc/ (one nvcc per source, started together),
             with ptxas's register and spill lines, then the g++ build of
             the native codecs (singa_tpu_torch/native); the flash kernels
             (flash_attention.cu, flash_attention_bf16.cu) and the paged
             kernel (paged_attention.cu) must report no spills.
  2. kernel  the paged-attention kernel, both forms, against its plain
             PyTorch version on the card: decode (S=8, Q=1), prefill
             (S=1, Q=64) and overlay/verify (S=8, Q=5) at head_dim 128 and
             64, block_len 16 and 8, ragged fills with fully-masked rows;
             then the key-range split's edge cases at the serve geometry
             (sequences shorter than one split, more splits than live
             tiles, a prefill chunk from position 0, the position -1 row
             and the dead overlay row, both exact zeros), each form
             launched twice on the same inputs (bitwise equal), and the
             thread blocks of a decode call (at least one per SM); then
             the prefix cache's inputs, each against the plain version
             and launched twice (bitwise equal): tables whose rows share
             their first 63 block ids, a prefill chunk from 1020 (mid
             block) and one from 2040 whose padding positions run past
             max_len and the table.
             Times (CUDA events, L2 flushed before each launch) of the
             kernel (a wrapper call: the split kernel and its combine),
             the plain version and, as a yardstick the port never calls,
             F.scaled_dot_product_attention on the gathered dense view;
             the bound is the larger of modeled bytes / 3.35 TB/s and
             operations / 67 TFLOP/s (f32 without tensor cores).
  3. serve   the d128 LM (vocab 256, d_model 256, 2 heads x 128, 2 layers,
             d_ff 1024, max_len 2048, seeded init_lm) behind Engine +
             Scheduler (8 slots, kv_block_len 16, prefill chunk 64): 16
             greedy requests, ragged prompts of 32-1024 tokens, 64 new
             tokens each, through the kernel ("fused") and through gather +
             cache_attend ("reference") in turns: fused, reference,
             reference, fused. Streams must be identical, the kernel's
             launches must equal layers x (prefill chunks + decode ticks),
             and one stream must equal the sequential ``generate`` oracle.
  4. spec    speculative decode (spec_k 4) on the repeat workload (8
             requests, prompt 64, 64 new tokens) against one-token ticks,
             in turns: streams identical, the overlay form launched.
  5. flash   the flash-attention kernels of each type (FLASH_ROUTES:
             bf16, on the tensor cores in csrc/flash_attention_bf16.cu,
             the forward and the dQ and dK/dV pair; float32, on the CUDA
             cores in csrc/flash_attention.cu, the forward and the fused
             backward) against their plain PyTorch versions on the card:
             B*H in {2, 8}, S in {256, 1024, 8192}, head_dim 64 and 128,
             causal and not, float32 and bfloat16, plus S=32768 causal
             bf16 head_dim 128, B*H 3 at S=192 (S a multiple of 64 but
             not of 128) in both types; the forward's lse is held to the
             plain version's at LSE_TOL at every shape (the backward reads
             it); the float32 forward and the fused backward, each
             launched twice, must give bitwise-equal outputs at every
             float32 shape (the forward's key groups merge in a fixed
             order; the backward's dQ is summed across blocks in one), and
             every kernel at the training shape; the float32 forward's
             resident blocks an SM (the occupancy query through its
             library) are printed. Times at the training shape (B=1, H=2,
             S=8192, D=128, causal) in bf16 and in float32 of each kernel,
             its plain version and, as a yardstick the port never calls,
             F.scaled_dot_product_attention forward and its autograd
             backward (float32 with TF32 off), with each kernel's achieved
             TFLOP/s, the forward's ratio to SDPA's forward and the
             backward's (the bf16 pair's sum, the fused float32 kernel) to
             SDPA's backward, and the share of the fused kernel's block
             time that its blocks spent polling the dQ counters; the bound
             is the larger of bytes / 3.35 TB/s and operations / 989
             TFLOP/s (bf16) or 67 TFLOP/s (float32).
  6. train   the port's Trainer on examples/lm/tinylm_longctx_d128.conf
             (full width, read by the port's load_model_config) over a
             shard of 32 synthetic 8192-token sequences: at float32, 8
             steps through the flash kernels and 8 through dense
             attention, in turns (flash, dense, dense, flash) from the
             same initial params, losses agreeing (and whether they
             agree to the bit, printed) and launches = layers x
             steps of the float32 route's kernels (the forward and the
             fused backward; 0 of the bf16 pair, 0 on dense); the same
             comparison failing on each
             gradient fault of FAULTS planted in the flash backward; then
             the conf as written (bf16) for 30 steps: finite losses, the
             last below the first, step ms (host clock to a device sync
             after each step) and tokens/s, and 3 more steps under
             torch.profiler (wall and device ms per step of that window,
             its idle share, the largest kernels).
  7. ring    the quant_acc kernel (the int8 gradient ring's per-hop
             dequantize + accumulate over a flat bucket row, with the next
             hop's max-abs from the same pass, csrc/quant_acc.cu) against
             its plain version, out and amax bitwise, at m in RING_SIZES
             (the bucket chunks among them), on row 1 of a ragged (4,
             1001) tensor, with a NaN partial and a NaN scale; times with
             and without amax at m = 147648 (the path's largest bucket
             chunk), 65536 and 2^24 of the kernel, its plain version and,
             as a yardstick the port never calls, torch.addcmul; the bound
             is (9 m + 4) bytes / 3.35 TB/s (+ 4 with amax). Then
             examples/lm/tinylm_d128.conf with the q8wire tag and 4
             buckets (as bench.py's lm_d128_q8wire row builds it) over 256
             synthetic 128-token
             sequences, on 4 ranks of one card: the ring alone
             (_ring_reduce_probe) on the global gradient of one step,
             within 3.5 bucket scales of it, bitwise the same on every
             rank and equal to the same probe on the CPU, with four
             planted ring faults each breaking that bar; float32, 8 steps
             in turns (ring, reference q8, reference q8, ring), losses
             within RING_TOL and 48 quant_acc launches per ring step
             (ranks x buckets x hops); then bf16 as written, 30 steps each
             of the flat ring (48 launches per step), q8hier (16) and
             exact data parallel (0): finite falling losses, step ms,
             tokens/s, 3 more flat-ring steps under torch.profiler, and
             the probe's host time as a share of the ring step; last, the
             flat ring with the next hop's max-abs fused into quant_acc
             and without it (a pass of its own per scale) on one trainer:
             the probe's outputs equal to the bit, then 10 pairs in
             alternating order of the probe's host ms and the median of
             5 synced steps.
  8. rbm     examples/mnist/rbm.conf as written (CD-1 over
             784-1000-500-250-30, batch 100) through make_trainer (the
             CDTrainer) on the nets phase's MNIST-shaped shards: with
             one table of uniforms swapped in for the Gibbs chain's draws
             (layers.rbm.bernoulli), 5 float32 CD steps on the card and
             on the CPU from the same seed-0 params, every RBM's
             reconstruction error within NETS_TOL; then the device's own
             draws: two card runs from one seed equal to the bit, 30 more
             steps (finite; every RBM's error below where the run began),
             step ms and images/s (the step is eager by the dispatch
             rule), one test batch, 3 steps under torch.profiler (device
             ms, idle share, the largest kernels); the stack's checkpoint
             unrolled
             (unroll_autoencoder) into autoencoder.conf's init.
  9. nets    the reference's MNIST and CIFAR nets through the port's
             Trainer, each conf as written (examples/mnist/mlp.conf,
             batch 1000; conv.conf, LeNet, batch 64;
             examples/cifar10/alexnet.conf, batch 100, crop 28;
             autoencoder.conf, batch 100, from the rbm phase's unrolled
             checkpoint, checked param by param) on synthetic shards
             (synthetic_arrays;
             structured_rgb and its compute_mean mean file for CIFAR):
             first the tie-sharing max-pool backward and the k² average
             at AlexNet's pool1 shape on inputs full of ties, card vs
             CPU, with a planted fault for each (PyTorch's single-winner
             backward; its ceil_mode average) that must fail the same
             check; then per net 5 float32 steps on the card and on the
             CPU from the same seed-0 params (losses within NETS_TOL),
             30 more on the card (finite, falling; step ms median,
             images/s), one test batch, and 3 steps under
             torch.profiler (device ms per step, idle share, the 5
             largest kernels); for mlp the bound, its operations over
             67 TFLOP/s. No kernel of csrc/ lies on this path.
  10. dispatch host dispatch (the device-resident dataset, multi-step
             chunks, the step and the engine's decode and prefill as
             CUDA graphs): the four image confs as written (float32) on
             full-size synthetic shards (60000 MNIST-shaped records, the
             real training set's size; 50000 CIFAR-shaped, CIFAR-10's)
             and train_longctx as written (bf16, S 8192): 30 steps as
             graphed chunks (windows of 10 through Trainer.train_chunk)
             against 30 eager per-step steps on host batches from the
             same params, window losses within DISPATCH_TOL; under
             graphs the flash kernels' launch counts equal layers x
             steps (each replay adds its capture's counts); step ms of
             a 30-step graphed chunk and of 30 eager steps (synced at
             the end), images/s or tokens/s, the graphed chunk's device
             ms by CUDA events (unprofiled) and its idle share, and its
             largest device rows; two planted faults of a replayed step
             (the step counter frozen, on LeNet; the update not copied
             back into the static params, on mlp), each of which must
             move the losses past DISPATCH_TOL by 100x; one decode
             engine call split into host, ATen and kernel ms, eager and
             graphed; the 16-request serve workload with graphs and
             without, in turns (graph, eager, eager, graph): streams
             identical, tokens/s. The autoencoder starts from the rbm
             phase's unrolled checkpoint here too.
  11. resnet examples/imagenet/resnet50.conf as written (bottleneck [3,
             4, 6, 3], batch 256, crop 224, bf16, SGD with momentum and
             weight decay) on 2560 ImageNet-shaped synthetic records (3 x
             256 x 256 uint8, 1000 classes, each made from the seed; 256
             test records): card vs CPU at float32 with the batch cut to
             8, 3 steps each from the card's state (losses within
             NETS_TOL, running stats within RESNET_STATS_TOL); then at
             full width 30 steps as graphed chunks on the cached dataset
             against 30 eager steps from the same params (window losses
             and the final running stats within DISPATCH_TOL, the loss
             falling), a planted fault (the graphed step does not copy
             the running stats back) that must move the stats by 100x
             DISPATCH_TOL, step ms and images/s of both, the graphed
             chunk's device ms by CUDA events and idle share, its 5
             largest kernels (profiled), BatchNorm's device ms at the
             net's shapes with the cancellation rescue and without it,
             peak memory, and one eval batch from the running stats. No
             kernel of csrc/ lies on the rbm or resnet path.
  12. lmdb   the native codecs (singa_tpu_torch/native, built by g++ into
             singa_tpu_torch/_build/), LMDB and kLMDBData, on a 60000-record
             MNIST-shaped shard (the real training set's size): the
             native shard codec and the Python codec decode to equal
             arrays; shard2lmdb, then the native LMDB walker and the Python
             LMDBReader decode to the shard's arrays (with the C=1 dim);
             lmdb2shard gives the same records back; each step's host ms.
             examples/mnist/mlp.conf as written with its data layers
             swapped to kLMDBData on that database, 5 float32 steps eager
             and as graphed one-step chunks from the seed-0 params: losses
             equal to the kShardData run's to the bit. Every load but the
             comparison's Python ones is served by the native codecs
             (data.pipeline.served); a codec that does not build fails the
             run. No kernel of csrc/ lies on this path.
  13. moe    kMoE's dense path (parallel/moe.py's index form):
             examples/lm/tinylm_moe.conf as written (bf16, batch 64, 4
             heads, 2 blocks of 8 experts, d_ff 1024, cf 1.25, aux 0.01)
             over 256 synthetic 256-token sequences, graphed and eager, 30
             steps each, with SINGA_TPU_DENSE_ATTN_MB at 0 (the bf16 flash
             kernels: launches = 2 layers x steps of each of the three)
             and at its default (dense: 0 launches): finite falling
             losses, graphed within DISPATCH_TOL of eager, step ms and
             tokens/s, the graphed chunk's device ms and idle share, the
             largest kernels, peak memory; 5 float32 steps card vs CPU
             (within NETS_TOL); the index form vs the dense plain form
             (the JAX form) at full width, forward to the bit and grads
             within MOE_GRAD_TOL, a planted fault (the capacity mask
             dropped) that must break it, and both forms' times; then the
             serve phase's checks on its d128 LM with moe_experts 8 and
             d_ff 1024 (16 greedy requests, the paged kernel against the
             reference in turns, launches = layers x (prefill chunks +
             decode ticks), one stream equal to generate()).

  14. prefix (runs after spec) the serve phase's LM and engine with the
             prefix cache on: serve_bench's shared_prefix workload at
             prompt_len 1024 (1020 shared tokens and a 4-token tail, 16
             requests, 64 new tokens), cold (cache off) and warm (seeded
             by two throwaway requests of the first prompt) in turns:
             cold, warm, warm, cold through the kernel, streams equal to
             each other and to the reference path's cold run, launches =
             layers x (prefill chunks + decode ticks) in every run,
             prefill chunks down at least 2x; tokens/s, latency and time
             to first token (p50, p99) of each run. Then a whole-prompt
             hit (one COW, one chunk), tail_stride 4 seeded with the
             1020-token prefix alone (12 tail tokens a request, prefill
             from 1020), the shared prefix's 63 blocks shipped to a fresh
             engine (export_blocks, a cache_ship frame, install_prefix
             timed) whose hits stream as cold, and a decode_blocks
             follow-up turn (its prompt replays the first turn's history:
             67 blocks shared, 3 of them decode-written), each stream
             equal to its cold run; a warm admission's prefill-written
             pool bytes against a cold one's (a block hit from 1008, a
             tail hit from 1020, a whole-prompt hit's chunk at 1023): the
             first layer's equal to the bit, every layer's difference
             printed, and one query through the kernel in a cold and a
             warm chunk (the kernel's split follows the chunk's largest
             position, so its bits may move; the plain version's must
             not); 8 greedy and 2 temperature slots exported after 16
             decode ticks as migrate frames and imported into a second engine that
             already serves a sequence, each continuing bitwise what the
             exporter goes on to emit (export and import ms, frame
             bytes); stage -> flip -> rollback on an engine whose graphs
             are captured, the streams after each equal a fresh engine's
             on that weight set, and a planted fault (a flip that rebinds
             ``self.params``) that must break that check; stage, flip and
             rollback ms and the memory each adds.

  15. fleet  (runs after prefix) the serving fleet on the serve phase's LM
             and engine geometry (8 slots, block 16, chunk 64, the
             kernel), the serve phase's 16 requests, driven by
             serve_bench's fleet loop: a prefill and a decode host in
             this process over LocalTransport (graphs captured by a
             warm-up through the fleet path), an untimed run with the
             migration's export (gather + frame), transport (frame decode)
             and import timed per sequence, then the unified engine and
             the fleet in turns (unified, fleet, fleet, unified):
             tokens/s, time to first token (p50, p99; the fleet's as the
             decode host has it), streams equal to the unified engine's
             and the reference path's, the prefill host's chunks the
             prompts' own, the decode host 0 prefill chunks and the
             prefill host 0 decode ticks, each host's launches = layers x
             its chunks or ticks; a rollout with every weight_ship to the
             prefill host torn (torn_weights@1..3): caught by the frame's
             CRC, quarantined, the canary rolled back, streams equal to
             v0's; a clean rollout: staged, canary-probed, flipped on
             both hosts under their captured graphs, streams equal to a
             fresh v1 engine's; two unified hosts with the prefix cache:
             a shared-prefix request on the host without the blocks
             fetches them (cache_fetch -> cache_ship, 63 blocks) and
             streams as a local hit and a cold engine do, no fetch timing
             out; serve_bench's socket fleet in this process (TCP
             loopback) with wire_drop@WIRE_DROP_AT and
             wire_delay@WIRE_DELAY_AT planted: both fire, streams
             unchanged, the drop retried; then two OS processes through
             ``python -m singa_tpu_torch.main -procsID k`` (prefill,
             decode), once over the Mailbox and once over sockets, this
             process the front door (a warm-up request first): both hosts
             report cuda, every stream equals the unified engine's and
             finishes on the decode host, and each host's counts from its
             first request past the warm-up are the measured run's (the
             prefill host's chunks the prompts' own, launches = layers x
             (chunks + ticks)); last, the drain, twice: a prefill or a
             unified host0 and a unified host1 over the Mailbox, every
             request sent to host0, which gets a SIGTERM mid-run (the
             prefill one once a sequence reached host1, the unified one
             once it has finished its first stream): it forwards its
             prefilling and queued requests, the unified one also
             migrates its decoding sequences (at least one) at a tick
             boundary, and exits 75; every stream is at full parity.
             Every wait on a host has a timeout; every process is
             stopped.
  16. decode (runs after moe) examples/lm/tinylm.conf as written (bf16,
             d 256, 4 heads, 2 blocks, vocab 256, batch 64) on the train
             phase's synthetic shard (32 sequences of 8192 tokens): 5
             graphed steps through the bf16 flash kernels (launches =
             layers x steps), an npz save, then 64 greedy tokens from a
             180-byte prompt: ``python -m
             singa_tpu_torch.tools.generate -raw`` on the card in a
             process of its own, which must report the KV-cache path
             (serve/conf_decode.NetDecoder) on cuda; the KV-cache and the
             rolling-buffer paths in this process on the card (tokens/s of
             each; the rolling one runs a (1, 8192) forward per token,
             its attention the float32 flash forward, layers x 64
             launches) and the KV-cache path on the CPU: all four
             streams equal; the last logits of every emitted token, KV
             against rolling on the card, within 1e-4, and a planted
             fault (K/V written one position late) that must exceed it.
  17. zero   (runs after decode) tinylm.conf as written with ``kernels {
             paged_attention: fused }`` on 4 ranks sharing the card, 3
             steps of each run from the seed-0 params: zero_update
             against the replicated update (losses, params and slots
             equal to the bit; slot bytes per rank a quarter), a planted
             fault (rank r's fresh shard stitched at rank r+1's offset)
             that must break that equality, then both through the int8
             ring (q8wire, 4 buckets): zero + ring against the ring
             alone to the bit, quant_acc launches = ranks x buckets x
             hops a step in both (the conf's buckets: 2 of the 4 asked,
             so 24); the zero + ring trainer's sharded
             save (step ms of each run, save ms) restored on 2 ranks with
             every array equal to the saved one, a planted fault (the
             save's commit marker removed) that must make it
             unresumable, and a serving LM at the conf's geometry booted
             through load_serving_params from the sharded save and from
             an npz save of the same state (the 4 names the conf net
             shares with it restored), whose Engines (the conf's
             paged-attention kernel) stream equal tokens.

  18. procs  (runs after zero) one process per rank group over
             torch.distributed, gloo, both processes on this card (NCCL
             refuses two ranks on one device): examples/lm/tinylm_d128.conf
             with the ring phase's q8wire settings, float32, nworkers 2,
             8 steps, as two processes through ``python -m
             singa_tpu_torch.main -procsID k -hostfile hf`` and as one
             process of 2 ranks, in turns (2, 1, 1, 2): every process
             reports cuda, gloo and its quant_acc launches, which sum to
             the one-process run's; params and slots (each process's
             digest, process 0's npz save) equal the one-process run's
             to the bit; step ms of each run, ring bytes a rank a step
             (equal to the model) and each process's host ms in
             cross-process exchanges. Then through the Python API
             (``init_distributed``, then ``Trainer(mesh=...)``), 2
             processes x 2 ranks: the zero phase's zero + ring run (3
             steps) equal to its 4-rank run to the bit, its sharded save
             holding proc_0, proc_1, both commit markers and nprocs 2,
             restored here on 4 and on 2 ranks bitwise; a planted
             ppermute that delivers every pair one rank past its
             destination, which must change the bits; ResNet-18
             (resnet_conf(depth=18, compute_dtype="float32"), batch 64,
             crop 224, centre crops, 5 steps) with BatchNorm synchronised
             over the ranks equal to 1 process x 4 ranks to the bit
             (cuDNN's deterministic algorithms in both, two 1 x 4 runs
             equal first); here, 4 ranks against 1 rank at the global
             batch, each step from the 1-rank state, losses within
             NETS_TOL and running stats within RESNET_STATS_TOL; a
             planted fault (each process's BatchNorm sums over its own
             ranks only) that must move the losses or a process's
             running stats by more than 100 x NETS_TOL. Every wait on a
             child has a timeout; every child is stopped.

  19. axes   (runs after procs) the other mesh axes, every rank on this
             card, each path (AXES_PATHS) from the seed-0 params:
             sp   tinylm_ring.conf on cluster_sp.conf (data 2 x seq 4, ring
                  attention) over 64 synthetic 2048-token sequences (the
                  sequence cut to 2048: each hop keeps a (32, 4, 512, 512)
                  float32 score block for the backward);
             ep   tinylm_moe.conf on cluster_ep.conf (data 2 x expert 4),
                  the psum and the alltoall dispatch;
             tp   tinylm.conf with kLayerPartition on data 2 x model 2;
             q8   tinylm.conf with q8_hier's named axes (intra model,
                  inter data) on data 2 x model 2;
             pp   tinylm_pp.conf on cluster_pp.conf (data 4 x pipe 2, 4
                  microbatches);
             3axis tinylm_pp.conf on cluster_3axis.conf (data 2 x pipe 2 x
                  model 2);
             the others over the moe_train cell's 256 x 256-token shard.
             Each path: AXES_STEPS float32 steps against the same conf
             with one axis less (AXES_PATHS' counterpart): losses within
             AXES_TOL, and the params after the steps within AXES_TOL of
             each other relative to how far the steps moved them (q8:
             losses within RING_TOL; ep alltoall against the dense path
             on 8 data ranks, the same token shards: step 0 within
             AXES_TOL, the rest within AXES_A2A_TOL, its aux being the
             global batch's and the counterpart's each rank's); the flash kernels' launches (float32 route) and
             quant_acc's counted over the run, set to 0 just before it,
             equal to the path's calls (ring attention's fold is plain
             PyTorch, so sp launches none); a planted fault on four of
             them (sp: each K/V block visiting one rank off; ep psum:
             each expert rank computing the next rank's experts; tp: the
             Concate in reversed rank order; pp: each pipeline hop one
             tick late) that must exceed the bar AXES_FAULT_FACTOR
             times. Then AXES_TIMED bf16 steps of the path and of its
             counterpart (step ms, host clock to a device sync, and the
             bf16 route's launches) and the ranks' exchange: the step's
             gradient sums over the ranks (Trainer._axes_reduce; on one
             card the layers' cross-rank reads are plain tensor reads),
             host clock to a device sync, over 3 more steps; q8: the
             ring's reduction alone (reduce_ms).

  20. replica (runs after axes) the replica engine
             (trainer/replica.py, parallel/consistency.py), every replica
             rank on this card, each reached through make_trainer on
             examples/mnist/cluster_elastic.conf (nservers 1,
             asynchronous) with its nworkers raised: mlp.conf as written
             (2500-2000-1500-1000-500-10, batch 1000 a replica, Elastic,
             moving_rate 0.9, sync_frequency 8, warmup_steps 60) on 4
             replicas over the dispatch phase's full-size synthetic MNIST
             shard (60000 records), REPLICA_STEPS steps from seeded
             stacked params (each replica its own draw): after the
             bootstrap every replica equals the center to the bit; every
             round's replicas and center held to the protocol's formula
             computed in float64 on the host from the state before it
             (REPLICA_ROUND_TOL), a planted fault at the first (the round
             in reversed replica order) that must miss it by
             REPLICA_FAULT_FACTOR x; run()'s chunked windows from the same
             params to the per-step run's bits; finite, falling losses
             and a test batch on replica 0; the replica step's ms and
             samples/s, the sync Trainer's step on the same 4 ranks at
             the same per-rank batch, each round's ms, and 3 steps under
             torch.profiler (device ms, idle share). RandomSync on the
             same net: two rounds at full coverage, one at REPLICA_PARTIAL
             through the dense prefix (and from the same state and draws
             through the serial loop: the two within the bar) and one
             through the serial loop, each held to its formula and timed;
             a planted fault (the snapshot aliased to the params) that
             must miss the formula by REPLICA_FAULT_FACTOR x. tinylm.conf
             at full width under Elastic on 2 replicas (a 256 x 256-token
             shard, the flash kernels forced), 10 steps in float32 and in
             bf16 across rounds: the flash launches, counted from 0 just
             before each run, equal replicas x attention layers x steps of
             each kernel of the type's route. Last, mlp.conf (cut to
             REPLICA_PROCS' schedule) as two processes through ``python
             -m singa_tpu_torch.main -procsID k -hostfile hf`` (gloo, this
             card), one replica each, Elastic and RandomSync at full
             coverage: both processes' digests (replicas, slots, center,
             snapshots) equal one process's on the same 2-rank mesh to
             the bit, and process 0's save and sidecar hold its arrays.
             Every wait on a child has a timeout; every child is stopped.

  21. resilience (runs after replica) the resilience runtime
             (resilience/{guard,context,supervisor,async_ckpt,watchdog}.py
             and the Trainer's seams). Children through ``python -m
             singa_tpu_torch.main`` (every training job goes through the
             supervisor) on the replica phase's full-size MNIST-shaped
             shards (60000 records), all started at once and run while
             this process checks the guard: mlp_resilient.conf and
             mlp_async.conf as written (batch 256, 60 steps, a save every
             5, kRollback) on cluster.conf, uninterrupted, with
             ``-faults crash@7`` (exit 0 after a restart) and with
             ``sigterm@12`` (exit 75, drained at step 12), the async one
             also with ``async_torn_write@2`` (LATEST is never the torn
             save); then the drained runs relaunched: every final save's
             digest equal to the uninterrupted run's, the mlp's dispatch
             ``graph``. Two processes (gloo, this card; the resilient
             conf cut to RES_PROCS_STEPS steps, heartbeat_timeout_s 10):
             ``sigterm@6:rank=1`` drains both at step 6 with exit 75,
             ``crash@6:rank=0`` ends both with 75 (once more with async
             sharded saves, whose writer threads issue no collective), and
             the relaunches end with the uninterrupted pair's digests. In this process:
             tinylm_d128.conf (bf16, flash forced) under kSkip, graphed,
             RES_LM_STEPS steps over 2048 x 128 token rows, row
             RES_POISON of the token table NaN and that token in one
             record step RES_LM_BAD reads (a token feed cannot hold NaN):
             the step leaves every param, slot and buffer byte as the
             step before left it, bad_steps 1, graphed equal to eager to
             the bit, each bf16 flash kernel launched layers x steps
             times (counted from 0 just before the run); a planted fault
             (the verdict ignored, the update always applied) must fail
             that check. mlp_resilient.conf under RES_ROLLBACK_FAULTS
             (the counter is read every 3 steps from step 1, so bad steps
             19-21 trip it at step 22): one rollback to step_20, LR scale
             0.5, the same tensor addresses before and after it and
             graph steps after it, graphed equal to eager, the losses
             within NETS_TOL of the same drill on the CPU.
             tinylm_d128.conf with the q8wire ring on 4 ranks of the
             card, kSkip, the poison in rank RES_RING_RANK's slice of step
             RES_RING_BAD: every rank skips, the ring's residuals bitwise
             as before the step, quant_acc's launches printed. mlp.conf
             on cluster_elastic.conf (4 replicas, warmup cut to 2) and
             rbm.conf, kSkip, one nanloss step each: every replica and
             the center, and the RBM stack, unchanged through it.
             mlp_resilient.conf with watchdog_timeout 2 and
             ``slowstep@3=2.6``: one stack dump showing the train loop's
             frame. After the children: guard on and off, no bad step,
             RES_LM_STEPS graphed steps each in turns (on, off, off, on):
             equal bits, step ms (host clock to a device sync) and 3
             profiled steps' idle share; resnet50.conf as written (bf16,
             batch 256, graphed) over RES_RESNET_RECORDS records (a cut of
             scale), cuDNN deterministic, RES_RESNET_STEPS steps with no
             saves, with no saves under kSkip, with sync saves and with
             async saves every RES_RESNET_EVERY: step ms and the host ms
             each save holds the step loop, the guarded run's params and
             slots equal the unguarded run's to the bit, and the async
             saves' arrays equal the sync saves' to the bit.
             Cuts: steps (the two-process runs, the LM runs, the ResNet
             runs) and the ResNet record count, never widths.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import ctypes
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from singa_tpu_torch import _build, native
from singa_tpu_torch.comm import SocketTransport
from singa_tpu_torch.config import load_model_config, parse_model_config
from singa_tpu_torch.data.loader import (
    compute_mean,
    imagenet_shaped_arrays,
    structured_rgb,
    synthetic_arrays,
    synthetic_token_arrays,
    write_records,
)
from singa_tpu_torch.device import resolve_device
from singa_tpu_torch.models.transformer import (
    TransformerConfig,
    generate,
    init_lm,
    lm_apply,
)
from singa_tpu_torch.layers import rbm as trbm
from singa_tpu_torch.layers.sequence import AttentionLayer
from singa_tpu_torch.ops import attention as ta
from singa_tpu_torch.ops import norm as tnorm
from singa_tpu_torch.ops import nn as tnn
from singa_tpu_torch.ops import paged_attention as pa
from singa_tpu_torch.ops import quantized_collective as qc
from singa_tpu_torch.parallel import consistency as tcons
from singa_tpu_torch.parallel import moe as tmoe
from singa_tpu_torch.parallel import apply_grad_comm_tag, build_mesh
from singa_tpu_torch.resilience.faults import FaultPlan
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler
from singa_tpu_torch.serve.conf_decode import NetDecoder
from singa_tpu_torch.serve.fleet import Mailbox
from singa_tpu_torch.serve.fleet import migrate as tmigrate
from singa_tpu_torch.serve.fleet.router import encode_request
from singa_tpu_torch.serve.rollout import RolloutController
from singa_tpu_torch.tools import serve_bench
from singa_tpu_torch.tools.serve_bench import _percentile
from singa_tpu_torch.trainer import (
    Trainer,
    make_trainer,
    save_checkpoint,
    unroll_autoencoder,
)
from singa_tpu_torch.trainer import replica as trep
from singa_tpu_torch.trainer import trainer as ttr

#: kernel vs plain, float32 on the card: online softmax folds the keys in
#: another order than the plain one-pass softmax (up to 2048 keys), and
#: the kernel's expf and the plain exp differ by a few ulps
TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, f32 without tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, bf16 tensor cores, dense
SOURCE = "singa_tpu_torch/csrc/paged_attention.cu"
REPLACES = "singa_tpu/ops/paged_attention.py:121"
TRAIN_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "lm", "tinylm_longctx_d128.conf")
#: each flash kernel's wrapper, the Pallas kernel it replaces (the staged
#: body; the streamed one is the same function), and its matrix products
#: per visible (q, k) pair, 2*D operations each. flash_bwd is the fused
#: float32 backward: it replaces both backward kernels (:419 and :451)
FLASH = {
    "flash_fwd": (ta.flash_fwd, "singa_tpu/ops/attention.py:386", 2),
    "flash_bwd_dq": (ta.flash_bwd_dq, "singa_tpu/ops/attention.py:419", 3),
    "flash_bwd_dkv": (ta.flash_bwd_dkv, "singa_tpu/ops/attention.py:451", 4),
    "flash_bwd": (ta.flash_bwd, "singa_tpu/ops/attention.py:419", 5),
}
#: the kernels each type runs on the card
FLASH_ROUTES = ta.KERNEL_NAMES
#: flash kernel vs plain, as max |kernel - plain| / max |plain| per
#: output: float32 sums the same products in another order (7.3e-6 at
#: worst on an H100, over 8192-term rows); bf16 outputs are rounded once
#: to 8 bits of mantissa, 2^-8 = 3.9e-3 relative, so 2e-2 allows a few
#: roundings
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: the forward's lse vs plain, |err| / max(1, |lse|) per row: both are
#: float32 m + log(l) over the same float32 scores, summed in other
#: orders, with ex2.approx on the tensor-core path (~2 ulp); a wrong exp
#: base or scale moves it by O(1), which the backward (P = exp(S * scale -
#: lse)) would turn into wrong gradients
LSE_TOL = 1e-4
#: flash vs dense training losses at float32 over 8 steps. The kernels and
#: cuBLAS sum attention in different orders (~1e-6 relative per call);
#: on an H100 the sound runs' losses came out equal (0.0), and 1e-5 is
#: ~20 float32 ulps of a loss near 5.5. Step 0's loss comes before any
#: update, so a gradient fault shows from step 1 on: the smallest of
#: FAULTS (dK zeroed) moved the step-1 loss by 6.2e-3 on an H100, over
#: 600x this limit
TRAIN_TOL = 1e-5
#: gradient faults planted in the flash backward, each of which the
#: flash vs dense comparison must catch: name -> what is done to the
#: backward's (dQ, dK, dV)
FAULTS = {
    "dK zeroed": lambda dq, dk, dv: (dq, torch.zeros_like(dk), dv),
    "dV zeroed": lambda dq, dk, dv: (dq, dk, torch.zeros_like(dv)),
    "dQ unscaled": lambda dq, dk, dv: (dq * dq.shape[-1] ** 0.5, dk, dv),
}
#: (B*H, S, D, causal, dtype) of every kernel-vs-plain check, and the
#: training shape the kernels are timed at (B=1, H=2, S=8192, D=128)
FLASH_SHAPES = [
    (bh, s, d, causal, dtype)
    for dtype in (torch.float32, torch.bfloat16)
    for bh in (2, 8) for s in (256, 1024, 8192) for d in (64, 128)
    for causal in (False, True)
] + [(2, 32768, 128, True, torch.bfloat16),   # the TPU's streamed regime
      # S a multiple of 64 but not 128 and an odd B*H: an odd tile count,
      # the backward's pipeline tail and, in float32, the fused
      # backward's work tiles not a multiple of its grid
      (3, 192, 128, True, torch.bfloat16), (3, 192, 64, False, torch.bfloat16),
      (3, 192, 128, True, torch.float32), (3, 192, 64, False, torch.float32)]
FLASH_TIMED = (2, 8192, 128, True, torch.bfloat16)
#: the float32 route (csrc/flash_attention.cu, CUDA cores) timed at the
#: same shape; the train phase's float32 runs go through it
FLASH_TIMED_F32 = FLASH_TIMED[:4] + (torch.float32,)
#: each flash kernel's source by type: bf16 is the tensor-core file
FLASH_SOURCES = {
    (name, dtype): "singa_tpu_torch/csrc/"
                   f"{ta.kernel_source(name, dtype)[0]}.cu"
    for dtype, names in FLASH_ROUTES.items() for name in names
}
#: the libraries whose ptxas reports must show no spills
SPILL_FREE = ("flash_attention", "flash_attention_bf16", "paged_attention")
RING_SOURCE = "singa_tpu_torch/csrc/quant_acc.cu"
RING_REPLACES = "singa_tpu/ops/quantized_collective.py:341"
RING_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "examples", "lm", "tinylm_d128.conf")
#: the main path's bucket chunks (elements per rank and bucket row) on
#: tinylm_d128.conf with 4 buckets on 4 ranks, largest first
RING_BUCKETS = (147648, 131584, 115136, 41088)
#: quant_acc vs plain sizes (elements): ragged, a 64-element LayerNorm
#: chunk, the largest param chunk (65536), the bucket chunks, a large one
RING_SIZES = (1, 3, 64, 1000, 16384, 65536) + RING_BUCKETS + (1 << 24,)
#: timed: the largest bucket chunk, the previous design's shape (one
#: param's chunk) and 2^24
RING_TIMED = (147648, 65536, 1 << 24)
RING_RANKS = 4
#: ring vs reference q8 losses at float32, every step of 8: the JAX
#: package's bar for the same comparison
#: (tests/test_quantized_collective.py::test_ring_tracks_reference_q8);
#: the ring re-quantizes at every hop where the reference quantizes once
RING_TOL = 2e-2
#: the probe's bar, in bucket scales (max |g| over the bucket / 127):
#: the JAX package's (test_ring_probe_reduces_correctly)
PROBE_BAR = 3.5
#: quant_acc launches per step: ranks x buckets x quantized reduce hops
#: (flat ring: n - 1 = 3; q8_hier with intra_degree 2: M - 1 = 1), so
#: 48, 16 and 0 per step with 4 buckets on 4 ranks
RING_FORMS = {"q8wire": 3, "q8hier": 1, "exact": 0}
REPO = os.path.dirname(os.path.abspath(__file__))
#: the image nets, each conf as written: net -> (conf, dataset, batch)
NETS = {
    "mlp": ("examples/mnist/mlp.conf", "mnist", 1000),
    "lenet": ("examples/mnist/conv.conf", "mnist", 64),
    "alexnet": ("examples/cifar10/alexnet.conf", "cifar", 100),
    "autoencoder": ("examples/mnist/autoencoder.conf", "mnist", 100),
}
#: card vs CPU losses over NETS_PARITY_STEPS float32 steps, relative:
#: the port's card-vs-JAX bar of slice 2 (TF32 off; cuBLAS, cuDNN and
#: the CPU's kernels sum in other orders)
NETS_TOL = 1e-4
NETS_PARITY_STEPS = 5
NETS_STEPS = 30
#: pools on the card vs the CPU, max abs over outputs and input grads:
#: integer inputs, sums of at most 4 window contributions (a planted
#: fault moves a gradient by whole cotangent values, O(1))
POOL_TOL = 1e-5


#: graphed vs eager training losses, relative, per DISPATCH_WINDOW-step
#: window: the same kernels in the same order on the same batches give
#: the same bits (0.0 on an H100 for all five cells), unless a kernel
#: adds with atomics (cuDNN's wgrad_alg0_engine in AlexNet's
#: convolutions), when two eager runs differ as much; each planted fault
#: must move it by DISPATCH_FAULT_FACTOR times more
DISPATCH_TOL = 1e-5
DISPATCH_FAULT_FACTOR = 100
DISPATCH_STEPS = 30
DISPATCH_WINDOW = 10
RBM_CONF = "examples/mnist/rbm.conf"
#: the unrolling of rbm.conf's stack into autoencoder.conf
RBM_PAIRS = [("rbm1", "dec1"), ("rbm2", "dec2"), ("rbm3", "dec3"),
             ("rbm4", "dec4")]
RBM_STEPS = 30
#: the Gibbs chain's real draw (chip_smoke swaps in a table of uniforms
#: for the card-vs-CPU parity only)
RBM_DRAW = trbm.bernoulli
RESNET_CONF = "examples/imagenet/resnet50.conf"
#: ImageNet-shaped synthetic records (3 x 256 x 256 uint8, 1000
#: classes): train and test
RESNET_RECORDS = (2560, 256)
#: the card-vs-CPU parity run: float32, batch cut to 8, 3 steps
RESNET_PARITY_BATCH = 8
RESNET_PARITY_STEPS = 3
#: running stats card vs CPU after each parity step, |a - b| / max(1,
#: |b|). The batch variance is one-pass, E[(x-s)^2] - E[x-s]^2 in
#: float32, summed in another order on each side, so its rounding grows
#: with |mean| / std; at batch 8 the conf's lr of 0.1 takes the loss
#: from 7.2 to 43 in 3 steps, and the stats with it: 1.7e-5 on an H100
#: (NVIDIA H100 80GB HBM3, 700 W), so a bar of 1e-5 fails sound runs
RESNET_STATS_TOL = 1e-4
LMDB_CONF = "examples/mnist/mlp.conf"
#: the MNIST-shaped shard of the lmdb phase: the real training set's size
LMDB_RECORDS = 60000
LMDB_STEPS = 5
MOE_CONF = "examples/lm/tinylm_moe.conf"
#: synthetic sequences x tokens (seq 256 is the text loader's default)
MOE_SEQS = (256, 256)
MOE_PARITY_STEPS = 5
#: the conf's MoE width: batch, seq, d_model, experts, d_ff
MOE_WIDTH = (64, 256, 256, 8, 1024)
#: index form vs plain: the gate's and x's grads, |diff| / max |grad|.
#: Their dot products over D (the gate value's cotangent) sum in another
#: order in the two forms; every other sum has one nonzero term
MOE_GRAD_TOL = 1e-6
#: the prefix phase: serve_bench's shared_prefix workload at this prompt
#: length (1020 shared tokens, a 4-token tail), 16 requests; migration of
#: 8 greedy and 2 temperature slots after 16 decode ticks
PREFIX_LEN, PREFIX_TAIL, PREFIX_REQUESTS = 1024, 4, 16
MIGRATE_SLOTS, MIGRATE_TEMPS, MIGRATE_TICKS = 8, 2, 16
#: the fleet phase's in-process fleets, as serve_bench's arguments: the
#: serve phase's engine geometry and the kernel
FLEET_ARGS = dict(
    fleet_hosts="prefill,decode", concurrency=8, block_len=16, kv_blocks=0,
    prefill_chunk=64, speculate_k=0, kernels="fused", prefix_cache=False,
    transport="local", wire_faults="", workspace=None, sigterm_at_tick=0,
    sigterm_host=None, arrival="batch", rate=0.0, seed=0, max_new=64)
#: every wait on a fleet run or a host process (a hang fails the phase)
FLEET_TIMEOUT_S = 120
#: message-send ordinals of the wire drill's planted faults: past the
#: warm-up's two sends, a request (delayed) and a migrate frame (dropped)
WIRE_DELAY_AT, WIRE_DROP_AT, WIRE_DELAY_MS = 12, 22, 50
#: the decode and zero phases' conf, read as written
TINYLM_CONF = "examples/lm/tinylm.conf"
#: decode: training steps before the save, greedy tokens, the prompt,
#: and the generate CLI's time limit
DECODE_STEPS, DECODE_NEW = 5, 64
DECODE_PROMPT = "the quick brown fox jumps over the lazy dog. " * 4
DECODE_TIMEOUT_S = 300
#: decode: max |KV-cache - rolling| over the last logits of every emitted
#: token on the card. Both are float32 with TF32 off; they differ in sum
#: order only (cache_attend over the masked cache against the float32
#: flash forward, 7.3e-6 relative at worst; cuBLAS GEMMs of other
#: shapes), ~1e-6 relative a reduction. On an H100 they differ by 1.9e-6
#: on logits up to 3.2; K/V one position late moves them by 5.6e-2
DECODE_LOGIT_TOL = 1e-4
#: zero: ranks sharing the card, steps of each run, serving requests
ZERO_RANKS, ZERO_STEPS, ZERO_REQUESTS = 4, 3, 4
#: the procs phase: the LM's steps a run; ResNet-18's global batch, crop
#: (= record size) and steps; the wrong-peer fault's steps; every wait
#: on a child process
PROCS_LM_STEPS = 8
PROCS_BN = {"batch": 64, "size": 224, "steps": 5, "records": 128}
PROCS_FAULT_STEPS = 2
PROCS_TIMEOUT_S = 300


def WARM_PROMPT(cfg):
    """A warm-up request's prompt: three prefill chunks (and a budget of
    three decode ticks), so both of a host's graphs are captured (the
    first call runs eagerly) before anything is counted or timed."""
    return np.arange(130, dtype=np.int32) % cfg.vocab


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def make_case(rs, dev, *, s, h, nq, d, bl, max_len, pos0, overlay,
              valid=None):
    """Random pools and queries; each sequence owns a shuffled disjoint
    set of blocks (block 0 is the trash block)."""
    mb = max_len // bl
    nb = s * mb + 1

    def randn(*shape):
        return torch.from_numpy(
            rs.standard_normal(shape).astype(np.float32)
        ).to(dev)

    tables = (1 + rs.permutation(s * mb)).reshape(s, mb).astype(np.int32)
    positions = (np.asarray(pos0)[:, None] + np.arange(nq)[None, :])
    case = {
        "q": randn(s, h, nq, d),
        "k_pool": randn(nb, h, bl, d),
        "v_pool": randn(nb, h, bl, d),
        "tables": torch.from_numpy(tables).to(dev),
        "positions": torch.from_numpy(positions.astype(np.int32)).to(dev),
    }
    if overlay:
        case["chunk_k"] = randn(s, h, nq, d)
        case["chunk_v"] = randn(s, h, nq, d)
        case["chunk_valid"] = torch.from_numpy(valid).to(dev)
    return case


def run_kernel(case):
    if "chunk_k" in case:
        return pa.paged_attention_overlay(**case)
    return pa.paged_attention(**case)


def run_plain(case):
    if "chunk_k" in case:
        return pa.paged_attention_overlay_plain(**case)
    return pa.paged_attention_plain(**case)


def live_per_seq(case):
    """live_blocks of each sequence, as the kernel computes them."""
    pos = case["positions"].cpu().numpy().astype(np.int64)
    bl, mb = case["k_pool"].shape[2], case["tables"].shape[1]
    last = pos[:, 0] - 1 if "chunk_k" in case else pos.max(1)
    return pa.live_blocks(last, bl, mb)


def visible(case, n_blocks):
    """The kernel's (S, 1, Q, keys) visibility mask over the first
    ``n_blocks`` table entries (and, overlay, the chunk columns)."""
    return pa._mask(case["positions"], case["k_pool"].shape[2], n_blocks,
                    case.get("chunk_valid"))


def library_call(case):
    """F.scaled_dot_product_attention over the dense view gathered to
    the longest live length (built once, outside the timed call)."""
    q, kp, vp, tables = case["q"], case["k_pool"], case["v_pool"], \
        case["tables"]
    n = max(int(live_per_seq(case).max()), 1)
    dk = pa._gather(kp, tables[:, :n])
    dv = pa._gather(vp, tables[:, :n])
    mask = visible(case, n)
    if "chunk_k" in case:
        dk = torch.cat([dk, case["chunk_k"]], dim=2)
        dv = torch.cat([dv, case["chunk_v"]], dim=2)

    def call():
        return F.scaled_dot_product_attention(q, dk, dv, attn_mask=mask)

    return call


def time_ms(fn, flush, iters=30):
    """Mean device ms of one call: CUDA events around each call, the L2
    flushed (64 MB written) before each, after 3 warm-up calls. A device
    sleep (~1 ms) before each start event keeps the card busy while the
    host enqueues the call, so the events time the device's work and not
    the wrapper's Python overhead."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(case):
    """(bound_ms, bound_by) from this case's inputs: the larger of the
    modeled bytes over HBM bandwidth and the operations over the f32
    rate. Operations count only the (query, key) pairs the mask leaves
    visible, QK^T and PV at 2 ops per multiply-add each: causally hidden
    keys and the tail of the last live block need no work."""
    s, h, nq, d = case["q"].shape
    bl = case["k_pool"].shape[2]
    overlay = "chunk_k" in case
    live = live_per_seq(case)
    nbytes = pa.modeled_bytes(s, h, nq, d, bl, int(live.sum()),
                              overlay=overlay)
    pairs = int(visible(case, case["tables"].shape[1]).sum())
    ops = 4 * h * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def split_edges(dev, rs, errs):
    """The key-range split's edge cases at the serve geometry (head_dim
    128, block_len 16, table width 128): decode with sequences shorter
    than one split (1 and 3 keys: one live tile for ~17 splits), a full
    table and the position -1 row; a prefill chunk from position 0 (2
    live tiles, more splits than tiles); an overlay with a dead row and
    an empty pool. Each against the plain version, masked rows exact
    zeros, each launched twice (bitwise equal); prints the thread blocks
    of a decode call. Updates ``errs`` in place."""
    max_len, s, h, d, bl = 2048, 8, 2, 128, 16
    dec = make_case(rs, dev, s=s, h=h, nq=1, d=d, bl=bl, max_len=max_len,
                    pos0=np.array([0, 2, 2047, -1, 31, 32, 700, 1500]),
                    overlay=False)
    pre = make_case(rs, dev, s=1, h=h, nq=64, d=d, bl=bl, max_len=max_len,
                    pos0=[0], overlay=False)
    valid = np.ones((s, 5), np.int32)
    valid[2] = 0
    ovl = make_case(rs, dev, s=s, h=h, nq=5, d=d, bl=bl, max_len=max_len,
                    pos0=np.array([0, 3, 0, 1, 2040, 33, 64, 500]),
                    overlay=True, valid=valid)
    for name, case, dead in (("decode", dec, 3), ("prefill", pre, None),
                             ("overlay", ovl, 2)):
        got, again = run_kernel(case), run_kernel(case)
        want = run_plain(case)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        form = "paged_attention_overlay" if name == "overlay" \
            else "paged_attention"
        errs[form] = max(errs[form], err)
        s_, h_, nq, _ = case["q"].shape
        _, splits, blocks = pa.launch_geometry(
            s_, h_, nq, case["tables"].shape[1], bl, pa._sm_count(dev.index))
        print(f"kernel split edge {name:8s} splits {splits} blocks {blocks} "
              f"max_abs_err {err:.3e} (tol {TOL:g}) bitwise repeat "
              f"{bool(torch.equal(got, again))}")
        check(err <= TOL, f"split edge {name}: max_abs_err {err} > {TOL}")
        check(torch.equal(got, again),
              f"split edge {name}: two launches on the same inputs differ")
        if dead is not None:
            check(bool((got[dead] == 0).all()),
                  f"split edge {name}: fully masked row is not zero")
    n_sms = pa._sm_count(dev.index)
    blocks = pa.launch_geometry(s, h, 1, max_len // bl, bl, n_sms)[2]
    print(f"kernel decode call: {blocks} thread blocks on {n_sms} SMs")
    check(blocks >= n_sms, f"decode launches {blocks} blocks < {n_sms} SMs")


def prefix_edges(dev, rs, errs):
    """The inputs the prefix cache sends the kernel, at the serve
    geometry: tables whose rows share their first 63 block ids (a decode
    tick over one cached prefix), a prefill chunk that starts mid-block
    at 1020 (a partial-tail hit), and a chunk at 2040 whose padding
    positions run past max_len - 1 and past the table (the re-derivation
    chunk of a whole-prompt hit near max_len). Each against the plain
    version, each launched twice (bitwise equal). Updates ``errs``."""
    max_len, h, d, bl = 2048, 2, 128, 16
    shared = make_case(rs, dev, s=8, h=h, nq=1, d=d, bl=bl, max_len=max_len,
                       pos0=1008 + rs.randint(0, 100, size=8), overlay=False)
    shared["tables"][:, :63] = shared["tables"][0, :63].clone()
    cases = (
        ("shared_rows", shared),
        ("mid_block", make_case(rs, dev, s=1, h=h, nq=64, d=d, bl=bl,
                                max_len=max_len, pos0=[1020], overlay=False)),
        ("past_max_len", make_case(rs, dev, s=1, h=h, nq=64, d=d, bl=bl,
                                   max_len=max_len, pos0=[2040],
                                   overlay=False)),
    )
    for name, case in cases:
        got, again = run_kernel(case), run_kernel(case)
        want = run_plain(case)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs["paged_attention"] = max(errs["paged_attention"], err)
        print(f"kernel prefix case {name:12s} max_abs_err {err:.3e} (tol "
              f"{TOL:g}) bitwise repeat {bool(torch.equal(got, again))}")
        check(bool(torch.isfinite(got).all()),
              f"prefix case {name}: non-finite output")
        check(err <= TOL, f"prefix case {name}: max_abs_err {err} > {TOL}")
        check(torch.equal(got, again),
              f"prefix case {name}: two launches on the same inputs differ")


def kernel_phase(dev, rs):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    max_len, s, h = 2048, 8, 2
    errs = {"paged_attention": 0.0, "paged_attention_overlay": 0.0}
    timed = {}
    for d in (128, 64):
        for bl in (16, 8):
            # decode: ragged fills, one row at position -1 (fully masked)
            pos0 = rs.randint(32, 1088, size=s)
            pos0[3] = -1
            dec = make_case(rs, dev, s=s, h=h, nq=1, d=d, bl=bl,
                            max_len=max_len, pos0=pos0, overlay=False)
            # prefill: one slot, a 64-token chunk deep into its prompt
            pre = make_case(rs, dev, s=1, h=h, nq=64, d=d, bl=bl,
                            max_len=max_len, pos0=[960], overlay=False)
            # overlay: ragged pos0 (one at 0), ragged draft validity, one
            # dead row with no pool entry and no valid column
            pos0 = rs.randint(32, 1088, size=s)
            pos0[0] = 0
            pos0[5] = 0
            n_draft = rs.randint(0, 5, size=s)
            valid = (np.arange(5)[None, :] <= n_draft[:, None]).astype(
                np.int32)
            valid[5] = 0
            ovl = make_case(rs, dev, s=s, h=h, nq=5, d=d, bl=bl,
                            max_len=max_len, pos0=pos0, overlay=True,
                            valid=valid)
            for name, case in (("decode", dec), ("prefill", pre),
                               ("overlay", ovl)):
                got = run_kernel(case)
                want = run_plain(case)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"kernel {name} d{d} bl{bl}: non-finite output")
                err = float((got - want).abs().max())
                form = ("paged_attention_overlay" if name == "overlay"
                        else "paged_attention")
                errs[form] = max(errs[form], err)
                print(f"kernel {name:8s} head_dim {d:3d} block_len {bl:2d} "
                      f"max_abs_err {err:.3e} (tol {TOL:g})")
                check(err <= TOL, f"kernel {name} d{d} bl{bl}: max_abs_err "
                      f"{err} > {TOL}")
            # fully-masked rows emit zeros
            check(bool((run_kernel(dec)[3] == 0).all()),
                  "decode row at position -1 is not zero")
            check(bool((run_kernel(ovl)[5] == 0).all()),
                  "dead overlay row is not zero")
            if (d, bl) == (128, 16):   # the serve phase's geometry
                # the timed decode case without the masked row, fills as
                # the serve phase's requests reach them
                dec = make_case(rs, dev, s=s, h=h, nq=1, d=d, bl=bl,
                                max_len=max_len,
                                pos0=rs.randint(32, 1088, size=s),
                                overlay=False)
                timed = {"decode": dec, "prefill": pre, "overlay": ovl}
    split_edges(dev, rs, errs)
    prefix_edges(dev, rs, errs)
    rows = {}
    for name, case in timed.items():
        b_ms, b_by = bound(case)
        rows[name] = {
            "ms": time_ms(lambda: run_kernel(case), flush),
            "plain_ms": time_ms(lambda: run_plain(case), flush),
            "library_ms": time_ms(library_call(case), flush),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "live_blocks": int(live_per_seq(case).sum()),
            "shape": list(case["q"].shape),
        }
        print("kernel_timing", json.dumps({"case": name, **rows[name]}))
    return errs, rows


# ---------------------------------------------------------------------------
# serve and spec phases
# ---------------------------------------------------------------------------


def serve(dev, params, cfg, prompts, *, impl, spec_k=0, max_new=64,
          graphs=True, prefix_cache=False, seeds=None, **serving):
    """One Engine + Scheduler run, warmed by a throwaway request (which
    also captures the engine's graphs); kernel launch counts are zeroed
    just before the measured requests and read just after. With
    ``prefix_cache`` the warm-up is serve_bench's: two throwaway
    requests of the first prompt (the second a whole-prompt hit), or of
    each of ``seeds``; ``serving`` adds EngineConfig fields. ->
    (scheduler, seconds, launches, {rid: tokens})."""
    eng = Engine(params, cfg, EngineConfig(
        slots=8, kv_block_len=16, max_prefill_chunk=64, spec_k=spec_k,
        attend_impl=impl, prefix_cache=prefix_cache, **serving,
    ), device=dev, graphs=graphs)
    sched = Scheduler(eng)
    if not prefix_cache:
        seeds = [prompts[0][:40]]
    for i, p in enumerate(seeds or [prompts[0], prompts[0]]):
        sched.submit(Request(rid=-1 - i, prompt=p,
                             max_new_tokens=2 if prefix_cache else 4))
        sched.serve()
    sched.reset_counters()
    torch.cuda.synchronize()
    pa.paged_attention.launches = 0
    pa.paged_attention_overlay.launches = 0
    for i, pr in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=pr, max_new_tokens=max_new,
                             seed=i))
    t0 = time.perf_counter()
    sched.serve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {
        "paged_attention": pa.paged_attention.launches,
        "paged_attention_overlay": pa.paged_attention_overlay.launches,
    }
    streams = {r.rid: r.tokens for r in sched.finished}
    return sched, seconds, launches, streams


def report(tag, sched, seconds):
    lat = sorted(r.latency_s * 1e3 for r in sched.finished)
    tokens = sched.tokens_emitted + len(sched.finished)
    out = {
        "run": tag,
        "tokens": tokens,
        "seconds": seconds,
        "tokens_per_s": tokens / seconds,
        "p50_ms": _percentile(lat, 0.50),
        "p99_ms": _percentile(lat, 0.99),
        **sched.occupancy(),
    }
    # time to first token from submission (every request is submitted
    # before the run starts, so the queue's wait is in it)
    ttft = sorted((r.first_token_mono - r.enqueue_mono) * 1e3
                  for r in sched.finished)
    out["ttft_p50_ms"] = _percentile(ttft, 0.50)
    out["ttft_p99_ms"] = _percentile(ttft, 0.99)
    print("serve", json.dumps(out))
    return out


def in_turns(dev, params, cfg, prompts, a, b):
    """After an untimed run of ``a``, run configuration ``a``, ``b``,
    ``b``, ``a`` (dicts of serve() keywords; the turns spread host noise
    over both) and check that every run's streams equal the untimed
    run's. -> [(tag, sched, seconds,
    launches)] in run order."""
    # an untimed pass of the whole workload first: the first run in a
    # process pays allocator growth and clock ramp-up
    _, _, _, first = serve(dev, params, cfg, prompts, **a)
    runs = []
    for tag, kw in (("a", a), ("b", b), ("b", b), ("a", a)):
        sched, seconds, launches, streams = serve(dev, params, cfg,
                                                  prompts, **kw)
        name = kw["impl"] + (f"_spec{kw['spec_k']}" if kw.get("spec_k")
                             else "") + ("_eager" if kw.get("graphs") is False
                                         else "") + (
            "_warm" if kw.get("prefix_cache") else "")
        report(name, sched, seconds)
        check(len(streams) == len(prompts) and all(
            len(t) == 64 and all(0 <= x < cfg.vocab for x in t)
            for t in streams.values()
        ), f"{name}: not every request finished with 64 in-vocabulary "
           "tokens")
        mism = sum(streams[i] != first.get(i) for i in streams)
        print(f"{name}: {mism} of {len(prompts)} streams differ from the "
              f"untimed run; launches {launches}")
        check(mism == 0, f"{name}: greedy streams differ")
        runs.append((tag, sched, seconds, launches))
    return runs


def serve_phase(dev, cfg, params):
    prompts = serve_prompts(cfg)
    runs = in_turns(dev, params, cfg, prompts, {"impl": "fused"},
                    {"impl": "reference"})
    for tag, sched, _, launches in runs:
        want = cfg.n_layers * (sched.prefill_chunks + sched.decode_ticks)
        if tag == "a":
            print(f"serve kernel launches {launches['paged_attention']} = "
                  f"layers {cfg.n_layers} x (prefill chunks "
                  f"{sched.prefill_chunks} + decode ticks "
                  f"{sched.decode_ticks}) = {want}")
            check(launches["paged_attention"] == want > 0,
                  "serve: launches != layers x (chunks + ticks)")
        else:
            check(launches["paged_attention"] == 0,
                  "reference run launched the kernel")
    # the sequential oracle on one request, and finite logits
    i = min(range(16), key=lambda j: len(prompts[j]))
    prompt = torch.from_numpy(prompts[i]).to(dev)[None]
    oracle = generate(params, prompt, cfg, 64)[0, len(prompts[i]):]
    got = next(r for r in runs[0][1].finished if r.rid == i).tokens
    check(oracle.tolist() == got,
          "serve: fused stream differs from sequential generate()")
    with torch.no_grad():
        logits = lm_apply(params, prompt[:, :64], cfg)
    check(tuple(logits.shape) == (1, 64, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "lm_apply logits not finite / wrong shape")
    print("serve oracle: request", i, "matches generate()")
    return runs[-1][3]["paged_attention"]


def spec_phase(dev, cfg, params):
    rs = np.random.RandomState(2)
    prompts = [
        np.tile(rs.randint(0, cfg.vocab, size=(4,)), 16)[:64].astype(
            np.int32)
        for _ in range(8)
    ]
    runs = in_turns(dev, params, cfg, prompts, {"impl": "fused"},
                    {"impl": "fused", "spec_k": 4})
    for tag, sched, _, launches in runs:
        if tag == "b":
            check(launches["paged_attention_overlay"]
                  == cfg.n_layers * sched.decode_ticks > 0,
                  "spec: overlay launches != layers x verify ticks")
            check(launches["paged_attention"]
                  == cfg.n_layers * sched.prefill_chunks,
                  "spec: write-then-read launches != layers x chunks")
    return runs[2][3]["paged_attention_overlay"]


# ---------------------------------------------------------------------------
# prefix phase
# ---------------------------------------------------------------------------


def shared_prefix_prompts(cfg, n):
    """serve_bench's shared_prefix workload at prompt_len PREFIX_LEN: one
    common prefix of 1020 tokens and a unique 4-token tail each."""
    return serve_bench._workload(SimpleNamespace(
        seed=0, requests=n, vocab=cfg.vocab, prompt_len=PREFIX_LEN,
        workload="shared_prefix"))


def streams_of(eng, prompts, max_new, temps=None):
    """Serve ``prompts`` on ``eng`` through a Scheduler -> (scheduler,
    {rid: tokens})."""
    sched = Scheduler(eng)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=max_new,
                             seed=i, temperature=temps[i] if temps else 0.0))
    sched.serve()
    return sched, {r.rid: r.tokens for r in sched.finished}


def prefix_engine(dev, params, cfg, **serving):
    return Engine(params, cfg, EngineConfig(
        slots=8, kv_block_len=16, max_prefill_chunk=64, **serving),
        device=dev)


def prefix_drills(dev, cfg, params, prompts, cold):
    """A whole-prompt hit, a tail_stride 4 hit seeded with the 1020-token
    prefix alone, the shared prefix's blocks shipped to a fresh engine
    (export_blocks -> cache_ship frame -> install_prefix, timed), and a
    decode_blocks follow-up turn, each stream equal to its cold run's.
    -> {drill: occupancy or ship numbers}."""
    out = {}
    sched, _, _, got = serve(dev, params, cfg, prompts[:1], impl="fused",
                             prefix_cache=True, seeds=[prompts[0]])
    check(got[0] == cold[0] and sched.cow_copies == 1
          and sched.prefill_chunks == 1,
          "prefix: the whole-prompt hit's stream or its COW")
    out["whole_prompt"] = sched.occupancy()
    base = prompts[0][:PREFIX_LEN - PREFIX_TAIL]
    sched, _, _, got = serve(dev, params, cfg, prompts, impl="fused",
                             prefix_cache=True, seeds=[base],
                             prefix_tail_stride=4)
    n = len(prompts)
    check(got == cold and sched.partial_hits == n
          and sched.tail_tokens_shared == 12 * n
          and sched.prefill_chunks == n,
          "prefix: tail_stride 4 hits (12 tail tokens each from 1020)")
    out["tail_stride4"] = sched.occupancy()
    # the shared prefix's 63 cached blocks shipped to a fresh engine
    src = prefix_engine(dev, params, cfg, prefix_cache=True)
    streams_of(src, prompts[:1], 2)
    chain = src.allocator.cache.chain(prompts[1])
    blocks = src.allocator.cache.match_chain(chain)
    src.allocator.retain(blocks)
    k, v = src.export_blocks(blocks)
    src.allocator.release(blocks)
    frame = tmigrate.serialize_ship(0, chain[:len(blocks)], k, v)
    ship = tmigrate.deserialize_ship(frame)
    dst = prefix_engine(dev, params, cfg, prefix_cache=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = dst.install_prefix(ship["chain"], ship["k"], ship["v"])
    torch.cuda.synchronize()
    install_ms = (time.perf_counter() - t0) * 1e3
    sched, got = streams_of(dst, prompts[1:], 64)
    check(info["installed"] == len(blocks) == 63
          and sched.prefix_hits == n - 1
          and [got[i] for i in range(n - 1)] == [cold[i] for i in range(1, n)],
          "prefix: the installed prefix's hits or their streams")
    out["ship"] = {"blocks": len(blocks), "frame_bytes": len(frame),
                   "install_prefix_ms": install_ms}
    eng = prefix_engine(dev, params, cfg, prefix_cache=True,
                        prefix_decode_blocks=True)
    turn1, first = streams_of(eng, prompts[:1], 64)
    # 1024 prompt + 64 emitted tokens: 67 written blocks, 3 past the prompt
    check(first[0] == cold[0] and turn1.decode_blocks_registered == 3,
          "prefix: the first turn's stream or its decode-written blocks")
    follow = np.concatenate([prompts[0], np.asarray(first[0][:48], np.int32),
                             prompts[1][-8:]])
    sched, warm = streams_of(eng, [follow], 64)
    _, want = streams_of(prefix_engine(dev, params, cfg), [follow], 64)
    check(warm == want, "prefix: the decode_blocks follow-up turn's stream")
    check(sched.blocks_shared == (PREFIX_LEN + 48) // 16,
          "prefix: the follow-up turn did not hit the decode-written blocks")
    out["decode_blocks"] = sched.occupancy()
    for k, v in out.items():
        print(f"prefix drill {k}", json.dumps(v))
    return out


def warm_bytes(dev, cfg, params, prompts):
    """A warm admission's prefill-written pool bytes against a cold
    one's at the serve geometry: a block hit (prefill from 1008: every
    position on another row of the (1, 64) chunk than cold, where the
    chunk starts at 960), a tail_stride 4 hit (from 1020, mid block) and
    a whole-prompt hit (the COW'd re-derivation chunk at 1023). The
    first layer's K/V come from the embeddings, LayerNorm and one GEMM
    and must be equal to the bit; later layers' read the first layer's
    attention, whose bits the kernel's key-range split may move (see
    split_order). The streams are held identical elsewhere. -> {case:
    {pool: max |warm - cold|}}."""
    base = prompts[0][:PREFIX_LEN - PREFIX_TAIL]
    names = [f"{kv}{i}" for kv in "kv" for i in range(cfg.n_layers)]
    out = {}
    for case, seed, stride in (("block", prompts[0], 0), ("tail", base, 4),
                               ("whole_prompt", prompts[1], 0)):
        views = []
        for cache in (True, False):
            eng = prefix_engine(dev, params, cfg, prefix_cache=cache,
                                prefix_tail_stride=stride)
            streams_of(eng, [seed], 2)
            p = prompts[1]
            adm = eng.admit(0, len(p) + 2, prompt=p)
            for c0 in range(adm.prefill_from, len(p), 64):
                eng.prefill_chunk(0, p[c0:c0 + 64], c0)
            rows = eng.state["tables"][:1]
            views.append([eng._gather(pool, rows)[0, :, :len(p)]
                          for pool in eng.state["k"] + eng.state["v"]])
            if cache:
                check(adm.prefill_from == {"block": 1008, "tail": 1020,
                                           "whole_prompt": 1023}[case],
                      f"warm bytes {case}: prefill from {adm.prefill_from}")
        out[case] = {n: float((w - c).abs().max())
                     for n, w, c in zip(names, *views)}
        check(out[case]["k0"] == out[case]["v0"] == 0.0,
              f"prefix: warm {case}'s first-layer K/V differ from cold")
    print("prefix warm vs cold pool bytes, max abs difference by pool",
          json.dumps(out))
    return out


def split_order(dev, rs):
    """One query at position 1010 through the kernel in a cold chunk
    (positions 960-1023: it is row 50) and a warm one (1008-1071, padding
    past 1023: row 2), same pool and table. The kernel splits the live
    key range, which it takes from the chunk's largest position, so the
    two calls fold the query's keys in different pieces; the plain
    version reduces over the whole table in one order. -> (kernel,
    plain) max |warm row - cold row|."""
    case = make_case(rs, dev, s=1, h=2, nq=64, d=128, bl=16, max_len=2048,
                     pos0=[960], overlay=False)
    warm = dict(case, q=case["q"].clone(), positions=case["positions"] + 48)
    warm["q"][:, :, 2] = case["q"][:, :, 50]
    diffs = []
    for fn in (run_kernel, run_plain):
        a, b = fn(case), fn(warm)
        diffs.append(float((a[:, :, 50] - b[:, :, 2]).abs().max()))
    print(f"prefix split order: the query at 1010, cold row 50 vs warm row "
          f"2: kernel max |diff| {diffs[0]:.3e}, plain {diffs[1]:.3e}")
    check(diffs[1] == 0.0, "split order: the plain version moved a row")
    return diffs


def migrate_drill(dev, smi, cfg, params):
    """MIGRATE_SLOTS greedy and MIGRATE_TEMPS temperature slots, after
    MIGRATE_TICKS decode ticks, exported as frames and imported into a
    second engine that already serves a sequence: each continues
    bitwise what the exporter goes on to emit. -> timings and bytes."""
    rs = np.random.RandomState(3)
    n = MIGRATE_SLOTS + MIGRATE_TEMPS
    temps = [0.0] * MIGRATE_SLOTS + [0.8] * MIGRATE_TEMPS
    prompts = [rs.randint(0, cfg.vocab, size=(int(rs.randint(32, 1025)),))
               .astype(np.int32) for _ in range(n + 1)]
    ec = dict(kv_block_len=16, max_prefill_chunk=64, prefix_cache=True)
    a = Engine(params, cfg, EngineConfig(slots=n, **ec), device=dev)
    b = Engine(params, cfg, EngineConfig(slots=n + 1, **ec), device=dev)

    def fill(eng, slot, p, temp):
        eng.admit(slot, len(p) + 64, prompt=p)
        for c0 in range(0, len(p), 64):
            last = eng.prefill_chunk(slot, p[c0:c0 + 64], c0)
        eng.register_prefix(slot, p)
        return [eng.activate(slot, last, len(p), seed=slot, temperature=temp)]

    toks = {i: fill(a, i, prompts[i], temps[i]) for i in range(n)}
    for _ in range(MIGRATE_TICKS):
        out = a.decode().cpu()
        for i in range(n):
            toks[i].append(int(out[i]))
    fill(b, 0, prompts[n], 0.0)        # the importer is serving already
    frames, export_ms = [], []
    for i in range(n):
        req = Request(rid=i, prompt=prompts[i], max_new_tokens=64,
                      temperature=temps[i], seed=i)
        req.tokens = list(toks[i])
        t0 = time.perf_counter()
        frames.append(tmigrate.serialize(
            tmigrate.export_sequence(a, req, i)))
        export_ms.append((time.perf_counter() - t0) * 1e3)
    import_ms = []
    for i, frame in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tmigrate.import_sequence(b, i + 1, tmigrate.deserialize(frame))
        torch.cuda.synchronize()
        import_ms.append((time.perf_counter() - t0) * 1e3)
    want, got = {i: list(toks[i]) for i in range(n)}, \
        {i: list(toks[i]) for i in range(n)}
    for _ in range(64 - 1 - MIGRATE_TICKS):
        oa, ob = a.decode().cpu(), b.decode().cpu()
        for i in range(n):
            want[i].append(int(oa[i]))
            got[i].append(int(ob[i + 1]))
    same = [got[i] == want[i] for i in range(n)]
    rec = {
        "slots": n, "temperature_slots": MIGRATE_TEMPS,
        "continued_bitwise": sum(same),
        "export_ms_mean": float(np.mean(export_ms)),
        "import_ms_mean": float(np.mean(import_ms)),
        "frame_bytes_mean": float(np.mean([len(f) for f in frames])),
        "kv_blocks_mean": float(np.mean([a.pool.blocks_for(len(p) + 64)
                                         for p in prompts[:n]])),
    }
    print("prefix migrate", json.dumps(rec), f"[{smi}]")
    check(all(same), f"migrate: slots {[i for i in range(n) if not same[i]]}"
          " did not continue bitwise")
    return rec


def rebind_flip(self):
    """The planted fault: flip_params by rebinding ``self.params``, as the
    JAX engine may (its programs take params per call); the captured
    graphs go on reading the old tensors."""
    version, tree = self._staged
    self._prev = (self.params_version, self.params)
    self.params, self.params_version, self._staged = tree, version, None
    return {"version": version, "prev_version": self._prev[0],
            "purged_blocks": self.allocator.purge_cache()}


FLIP_PARAMS = Engine.flip_params


def stage_drill(dev, smi, cfg, params):
    """stage -> flip -> rollback on an engine whose graphs are captured:
    the streams after each equal a fresh engine's on that weight set;
    the rebinding flip (rebind_flip) must break that. -> times and
    memory."""
    new = init_lm(torch.Generator().manual_seed(1), cfg, dev)
    prompts = shared_prefix_prompts(cfg, 4)
    want_old = streams_of(prefix_engine(dev, params, cfg), prompts, 32)[1]
    want_new = streams_of(prefix_engine(dev, new, cfg), prompts, 32)[1]
    check(want_old != want_new, "stage: both weight sets give one stream")
    rec = {}
    for flip in (FLIP_PARAMS, rebind_flip):
        eng = prefix_engine(dev, params, cfg, prefix_cache=True)
        check(streams_of(eng, prompts, 32)[1] == want_old,
              "stage: the live weights' streams")
        check(eng._decode_graph.captured and eng._prefill_graph.captured,
              "stage: graphs not captured before the flip")
        Engine.flip_params = flip
        try:
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            nbytes = eng.stage_params(new, 1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mem1 = torch.cuda.memory_allocated(dev)
            flipped = eng.flip_params()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            mem2 = torch.cuda.memory_allocated(dev)
        finally:
            Engine.flip_params = FLIP_PARAMS
        ok_new = streams_of(eng, prompts, 32)[1] == want_new
        if flip is rebind_flip:
            print(f"stage planted fault (flip by rebinding self.params): "
                  f"streams equal the new weights' fresh engine: {ok_new}")
            check(not ok_new, "stage: the rebinding flip passes the check")
            continue
        check(ok_new, "stage: streams after flip_params != a fresh engine's "
              "on the new weights")
        t3 = time.perf_counter()
        rolled = eng.rollback_params()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        check(streams_of(eng, prompts, 32)[1] == want_old,
              "stage: streams after rollback_params != the old weights'")
        rec = {
            "staged_bytes": nbytes, "stage_ms": (t1 - t0) * 1e3,
            "flip_ms": (t2 - t1) * 1e3, "rollback_ms": (t4 - t3) * 1e3,
            "mem_added_by_stage": mem1 - mem0,
            "mem_added_by_flip": mem2 - mem1,
            "purged_at_flip": flipped["purged_blocks"],
            "purged_at_rollback": rolled["purged_blocks"],
        }
    print("prefix stage", json.dumps(rec), f"[{smi}]")
    return rec


def prefix_phase(dev, smi, cfg, params):
    """The serve path with the prefix cache on: shared_prefix cold and
    warm in turns through the kernel, streams equal to each other and to
    the reference path's, launches = layers x (prefill chunks + decode
    ticks), prefill chunks down at least 2x; then the drills, migration
    and weight staging. -> the warm runs' kernel launches."""
    prompts = shared_prefix_prompts(cfg, PREFIX_REQUESTS)
    print(f"prefix: {PREFIX_REQUESTS} requests, {PREFIX_LEN - PREFIX_TAIL} "
          f"shared + {PREFIX_TAIL} tail tokens, 64 new [{smi}]")
    _, _, _, ref = serve(dev, params, cfg, prompts, impl="reference")
    runs = in_turns(dev, params, cfg, prompts, {"impl": "fused"},
                    {"impl": "fused", "prefix_cache": True})
    cold = {r.rid: r.tokens for r in runs[0][1].finished}
    check(cold == ref, "prefix: fused streams != the reference path's")
    for tag, sched, _, launches in runs:
        want = cfg.n_layers * (sched.prefill_chunks + sched.decode_ticks)
        check(launches["paged_attention"] == want > 0,
              f"prefix {tag}: launches != layers x (chunks + ticks)")
        if tag == "b":
            check(sched.prefix_hits == PREFIX_REQUESTS,
                  "prefix: not every warm admission hit")
    chunks = {tag: sched.prefill_chunks for tag, sched, _, _ in runs}
    ratio = chunks["a"] / chunks["b"]
    print(f"prefix prefill chunks cold {chunks['a']} warm {chunks['b']} "
          f"({ratio:.1f}x); warm launches {runs[1][3]['paged_attention']} "
          f"= layers {cfg.n_layers} x (chunks {runs[1][1].prefill_chunks} + "
          f"ticks {runs[1][1].decode_ticks})")
    check(ratio >= 2.0, f"prefix: prefill chunks fell {ratio:.2f}x < 2x")
    prefix_drills(dev, cfg, params, prompts, cold)
    warm_bytes(dev, cfg, params, prompts)
    split_order(dev, np.random.RandomState(4))
    migrate_drill(dev, smi, cfg, params)
    stage_drill(dev, smi, cfg, params)
    release()
    return runs[2][3]["paged_attention"]


# ---------------------------------------------------------------------------
# fleet phase
# ---------------------------------------------------------------------------


def serve_prompts(cfg):
    """The serve phase's workload: 16 ragged prompts of 32-1024 tokens."""
    rs = np.random.RandomState(1)
    return [
        rs.randint(0, cfg.vocab, size=(int(rs.randint(32, 1025)),)).astype(
            np.int32)
        for _ in range(16)
    ]


def fleet_args(**kw):
    return SimpleNamespace(**{**FLEET_ARGS, **kw})


def prompt_chunks(prompts) -> int:
    """The prefill chunks the prompts' own prefill takes (no prefix
    cache, chunk 64): what a prefill host runs for them."""
    return sum(-(-len(p) // FLEET_ARGS["prefill_chunk"]) for p in prompts)


def fleet_run(dev, params, cfg, prompts, fleet):
    """serve_bench's fleet loop on a built, warmed ``fleet`` (hosts,
    router), its counters zeroed first. -> (seconds, {rid: tokens},
    TTFT ms sorted, per-host paged-attention launches)."""
    torch.cuda.synchronize()
    pa.paged_attention.launches = pa.paged_attention_overlay.launches = 0
    launches = {}
    hosts, _, seconds, streams, _, _, _ = serve_bench.run_fleet(
        params, cfg, prompts, fleet_args(), dev, fleet=fleet,
        launches=launches)
    check(pa.paged_attention.launches + pa.paged_attention_overlay.launches
          == sum(launches.values()), "fleet: per-host launches do not add "
          "up")
    # the first token as the decode host has it: sampled on the prefill
    # host, landed with the migrated sequence
    ttft = sorted((r.first_token_mono - r.enqueue_mono) * 1e3
                  for h in hosts for r in h.sched.finished if r.rid >= 0)
    return seconds, streams, ttft, launches


class MigrationTimer:
    """Wraps the migrate module's four steps while active: export
    (export_sequence + serialize, on the prefill host), transport
    (deserialize at the receiver; an in-process send is a deque append)
    and import (import_sequence), each closed by a device sync; frame
    bytes from serialize."""

    STEPS = {"export_sequence": "export", "serialize": "export",
             "deserialize": "transport", "import_sequence": "import"}

    def __enter__(self):
        self.ms = {"export": [], "transport": [], "import": []}
        self.frame_bytes = []
        self._orig = {}
        for fn, part in self.STEPS.items():
            self._orig[fn] = getattr(tmigrate, fn)
            setattr(tmigrate, fn, self._wrap(self._orig[fn], fn, part))
        return self

    def _wrap(self, f, fn, part):
        def timed_step(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if fn == "serialize":
                self.ms["export"][-1] += ms
                self.frame_bytes.append(len(out))
            else:
                self.ms[part].append(ms)
            return out
        return timed_step

    def __exit__(self, *exc):
        for fn, f in self._orig.items():
            setattr(tmigrate, fn, f)

    def summary(self):
        n = len(self.frame_bytes)
        return {"sequences": n,
                **{f"{k}_ms_mean": float(np.mean(v)) for k, v in
                   self.ms.items()},
                "frame_bytes_mean": float(np.mean(self.frame_bytes)),
                "frame_bytes_max": max(self.frame_bytes)}


def fleet_inprocess(dev, smi, cfg, params, prompts, uni):
    """A prefill and a decode host on the card over LocalTransport: an
    untimed run with the migration steps timed, then fleet against the
    unified engine in turns (unified, fleet, fleet, unified). ->
    ((hosts, router), per-host launches of the last fleet run)."""
    hosts, router, _ = serve_bench.build_fleet(params, cfg, fleet_args(),
                                               dev)
    fleet = (hosts, router)
    serve_bench.warm_fleet(hosts, router, prompts[0][:40])
    with MigrationTimer() as mt:
        streams = fleet_run(dev, params, cfg, prompts, fleet)[1]
    check(streams == uni, "fleet: in-process streams != the unified "
          "engine's")
    rec = mt.summary()
    print("fleet migrate", json.dumps(rec), f"[{smi}]")
    check(rec["sequences"] == len(prompts), "fleet: not every sequence "
          "migrated once")
    out = {}
    for k, tag in enumerate(("unified", "fleet", "fleet", "unified")):
        if tag == "unified":
            sched, seconds, _, got = serve(dev, params, cfg, prompts,
                                           impl="fused")
            r = report(f"fleet_{tag}", sched, seconds)
        else:
            seconds, got, ttft, launches = fleet_run(dev, params, cfg,
                                                     prompts, fleet)
            p0, d0 = hosts
            tokens = sum(len(v) for v in got.values())
            r = {"run": "fleet_local", "tokens": tokens,
                 "seconds": seconds, "tokens_per_s": tokens / seconds,
                 "ttft_p50_ms": _percentile(ttft, 0.50),
                 "ttft_p99_ms": _percentile(ttft, 0.99),
                 "launches": launches,
                 "prefill_chunks": p0.sched.prefill_chunks,
                 "decode_ticks": d0.sched.decode_ticks}
            print("serve", json.dumps(r))
            check(d0.sched.prefill_chunks == 0 and p0.sched.decode_ticks
                  == 0, "fleet: a host ran the other role's program")
            check(p0.sched.prefill_chunks == prompt_chunks(prompts),
                  "fleet: the prefill host's chunks != the prompts' own")
            check(launches == {
                p0.name: cfg.n_layers * p0.sched.prefill_chunks,
                d0.name: cfg.n_layers * d0.sched.decode_ticks},
                "fleet: launches != layers x (chunks | ticks) per host")
            check(d0.migrate_in == p0.migrate_out == len(prompts),
                  "fleet: not every sequence migrated")
            out = launches
        check(got == uni, f"fleet {tag}: streams differ")
    return fleet, out


FLEET_CONF = """
name: "fleet-smoke"
neuralnet {{
  layer {{ name: "embed" type: "kEmbedding"
    embedding_param {{ vocab_size: {vocab} embedding_dim: {d}
                       max_len: {max_len} }} }}
  layer {{ name: "attn1" type: "kAttention" srclayers: "embed"
    attention_param {{ num_heads: {heads} }} }}
  layer {{ name: "attn2" type: "kAttention" srclayers: "attn1"
    attention_param {{ num_heads: {heads} }} }}
}}
serving {{ slots: 8 kv_block_len: 16 max_prefill_chunk: 64 }}
kernels {{ paged_attention: "fused" }}
fleet {{ {fleet} }}
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fleet_conf(tmp, cfg, fleet: str) -> str:
    check(cfg.n_layers == 2 and cfg.d_ff == 4 * cfg.d_model,
          "fleet: the conf form needs 2 layers and d_ff = 4 d_model")
    path = os.path.join(tmp, "fleet.conf")
    with open(path, "w") as f:
        f.write(FLEET_CONF.format(vocab=cfg.vocab, d=cfg.d_model,
                                  max_len=cfg.max_len, heads=cfg.n_heads,
                                  fleet=fleet))
    cluster = os.path.join(tmp, "cluster.conf")
    with open(cluster, "w") as f:
        f.write(f'nworkers: 2\nworkspace: "{tmp}/ws"\n')
    return path, cluster


def launch_hosts(conf, cluster, n=2):
    """``python -m singa_tpu_torch.main -procsID k`` for k < n, the
    port's launch line (seed 0: the phase's params; the card)."""
    cmd = [sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
           conf, "-cluster_conf", cluster]
    return [subprocess.Popen(cmd + ["-procsID", str(k)], cwd=REPO,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for k in range(n)]


def collect(door, n, got, procs):
    """Read results from the front door until ``n`` are in ``got``."""
    deadline = time.monotonic() + FLEET_TIMEOUT_S
    while len(got) < n:
        check(time.monotonic() < deadline and all(
            p.poll() is None for p in procs),
            f"fleet: {len(got)} of {n} results; hosts "
            f"{[p.poll() for p in procs]}")
        for msg in door.recv("frontdoor"):
            if msg.kind == "result":
                d = json.loads(msg.payload)
                got[d["rid"]] = (d, time.perf_counter())
        time.sleep(0.001)


def check_host(cfg, out: str, what: str) -> dict:
    """The FLEET HOST line a host process logs at exit (its counts from
    its first request or migration past the warm-up): it ran on the
    card, and its paged-attention launches are layers x (chunks +
    ticks). -> the account."""
    line = next(x for x in out.splitlines() if x.startswith("FLEET HOST: "))
    r = json.loads(line[len("FLEET HOST: "):])
    check("device cuda" in out and r["device"] == "cuda",
          f"{what}: did not report cuda")
    check(r["paged_launches"]
          == cfg.n_layers * (r["prefill_chunks"] + r["decode_ticks"]) > 0,
          f"{what}: launches != layers x (chunks + ticks): {r}")
    return r


def finish_hosts(procs, door, names, expect):
    """Shut the hosts down (a shutdown message to each of ``names``),
    wait for every process with a timeout -> their outputs; each must
    exit with ``expect[k]``."""
    for name in names:
        door.send(name, "shutdown", b"", src="frontdoor")
    outs = []
    for k, p in enumerate(procs):
        try:
            out = p.communicate(timeout=FLEET_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
            check(False, f"fleet: host {k} did not exit:\n{out[-2000:]}")
        outs.append(out)
        check(p.returncode == expect[k],
              f"fleet: host {k} exit {p.returncode} != {expect[k]}:\n"
              f"{out[-3000:]}")
    return outs


def stop_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def fleet_processes(smi, cfg, prompts, uni, transport):
    """Two host processes (prefill, decode) over the Mailbox or the
    socket wire, this process the front door: a warm-up request first
    (each host builds its graphs before anything is counted), then the
    16 requests. Streams equal the unified engine's, every one finishes
    on the decode host, both hosts report cuda, and each host's counts
    of the measured run are its own: the prefill host's chunks are the
    prompts', its launches layers x chunks, the decode host's layers x
    ticks."""
    with tempfile.TemporaryDirectory() as tmp:
        if transport == "mailbox":
            conf, cluster = fleet_conf(tmp, cfg,
                                       'role: "auto" prefill_hosts: 1')
        else:
            ports = [free_port() for _ in range(3)]
            conf, cluster = fleet_conf(tmp, cfg, (
                'transport: socket '
                f'peers {{ name: "host0" role: "prefill" address: '
                f'"127.0.0.1:{ports[0]}" }} '
                f'peers {{ name: "host1" role: "decode" address: '
                f'"127.0.0.1:{ports[1]}" }} '
                f'wire {{ frontdoor_address: "127.0.0.1:{ports[2]}" }}'))
        procs = launch_hosts(conf, cluster)
        door = None
        try:
            if transport == "mailbox":
                door = Mailbox(os.path.join(tmp, "ws", "fleet"))
            else:
                door = SocketTransport({
                    "host0": f"127.0.0.1:{ports[0]}",
                    "host1": f"127.0.0.1:{ports[1]}",
                    "frontdoor": f"127.0.0.1:{ports[2]}"},
                    connect_timeout_s=2.0, send_timeout_s=30.0,
                    max_retries=20, backoff_s=0.1, backoff_cap_s=1.0)
            door.register("frontdoor")
            t_start = time.perf_counter()
            got = {}
            door.send("host0", "request", encode_request(Request(
                rid=-1, prompt=WARM_PROMPT(cfg), max_new_tokens=4)),
                src="frontdoor")
            collect(door, 1, got, procs)
            warm_s = time.perf_counter() - t_start
            got.clear()
            t0 = time.perf_counter()
            sent = {}
            for i, p in enumerate(prompts):
                sent[i] = time.perf_counter()
                door.send("host0", "request", encode_request(Request(
                    rid=i, prompt=p, max_new_tokens=64, seed=i)),
                    src="frontdoor")
            collect(door, len(prompts), got, procs)
            seconds = time.perf_counter() - t0
            outs = finish_hosts(procs, door, ("host0", "host1"), (0, 0))
        finally:
            stop_all(procs)
            if door is not None and transport == "socket":
                door.close()
    streams = {i: d["tokens"] for i, (d, _) in got.items()}
    check(streams == uni, f"fleet {transport}: streams != unified")
    check({d["host"] for d, _ in got.values()} == {"host1"},
          f"fleet {transport}: a stream finished off the decode host")
    reports = [check_host(cfg, o, f"fleet {transport}: host {k}")
               for k, o in enumerate(outs)]
    check(reports[0]["prefill_chunks"] == prompt_chunks(prompts)
          and reports[0]["migrate_out"] == reports[1]["migrate_in"]
          == len(prompts),
          f"fleet {transport}: the hosts' counts are not the measured "
          f"run's: {reports}")
    check(reports[1]["prefill_chunks"] == 0
          and reports[0]["decode_ticks"] == 0,
          f"fleet {transport}: a host ran the other role's program")
    lat = sorted((t - sent[i]) * 1e3 for i, (_, t) in got.items())
    tokens = sum(len(v) for v in streams.values())
    rec = {"run": f"fleet_{transport}", "tokens": tokens,
           "seconds": seconds, "tokens_per_s": tokens / seconds,
           "p50_ms": _percentile(lat, 0.50),
           "p99_ms": _percentile(lat, 0.99), "warm_s": warm_s,
           "launches": {r["host"]: r["paged_launches"] for r in reports},
           "hosts": reports}
    print("serve", json.dumps(rec), f"[{smi}]")
    return rec


def fleet_drain(smi, cfg, prompts, uni, role0):
    """Two host processes over the Mailbox, host0 of ``role0`` and host1
    unified, every request sent to host0, which gets a SIGTERM mid-run:
    a prefill host0 once the first sequence has landed on host1 (it
    forwards its prefilling and queued requests), a unified host0 once
    it has finished its first stream (its other slots then hold
    sequences mid-decode, which it must migrate to host1 at the tick
    boundary, at least one, and mid-prefill; requests queue). host0
    exits 75; every stream is at full parity, and each one host0 had
    not finished finishes on host1."""
    with tempfile.TemporaryDirectory() as tmp:
        conf, cluster = fleet_conf(tmp, cfg, (
            f'peers {{ name: "host0" role: "{role0}" }} '
            'peers { name: "host1" role: "unified" }'))
        procs = launch_hosts(conf, cluster)
        try:
            door = Mailbox(os.path.join(tmp, "ws", "fleet"))
            door.register("frontdoor")
            got = {}
            for k, name in enumerate(("host0", "host1")):
                door.send(name, "request", encode_request(Request(
                    rid=-1 - k, prompt=WARM_PROMPT(cfg), max_new_tokens=4)),
                    src="frontdoor")
            collect(door, 2, got, procs)
            got.clear()
            for i, p in enumerate(prompts):
                door.send("host0", "request", encode_request(Request(
                    rid=i, prompt=p, max_new_tokens=64, seed=i)),
                    src="frontdoor")
            deadline = time.monotonic() + FLEET_TIMEOUT_S
            while role0 == "prefill" and door.statuses().get(
                    "host1", {}).get("live", 0) < 1:
                check(time.monotonic() < deadline, "fleet drain: no "
                      "sequence ever reached host1")
                time.sleep(0.001)
            if role0 == "unified":
                collect(door, 1, got, procs)
            t_sig = time.perf_counter()
            procs[0].send_signal(signal.SIGTERM)
            try:
                out0 = procs[0].communicate(timeout=FLEET_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                check(False, "fleet drain: host0 hung after SIGTERM")
            drain_ms = (time.perf_counter() - t_sig) * 1e3
            check(procs[0].returncode == 75,
                  f"fleet drain: host0 exit {procs[0].returncode} != 75:\n"
                  f"{out0[-3000:]}")
            collect(door, len(prompts), got, procs[1:])
            out1 = finish_hosts(procs[1:], door, ("host1",), (0,))[0]
        finally:
            stop_all(procs)
    line = next(x for x in out0.splitlines()
                if x.startswith("FLEET DRAIN: "))
    acct = json.loads(line[len("FLEET DRAIN: "):])
    streams = {i: d["tokens"] for i, (d, _) in got.items()}
    check(streams == uni, f"fleet drain ({role0}): streams != unified")
    early = {rid for rid in acct["finished"] if rid >= 0}
    check({i for i, (d, _) in got.items() if d["host"] == "host0"} == early
          and all(d["host"] == "host1" for i, (d, _) in got.items()
                  if i not in early),
          f"fleet drain ({role0}): a stream host0 had not finished "
          "finished off host1")
    check(len(acct["migrated"]) >= (role0 == "unified")
          and len(acct["forwarded"]) >= 1 and not acct["handed_back"],
          f"fleet drain ({role0}): no sequence migrated mid-decode, none "
          f"forwarded, or some handed back: {acct}")
    h0 = check_host(cfg, out0, f"fleet drain ({role0}): host0")
    h1 = check_host(cfg, out1, f"fleet drain ({role0}): host1")
    rec = {"host0": role0, "drain_ms": drain_ms,
           "finished_before": len(early),
           "migrated": len(acct["migrated"]),
           "migrated_tokens_done": [m["tokens_done"]
                                    for m in acct["migrated"]],
           "forwarded": len(acct["forwarded"]), "hosts": [h0, h1]}
    print("fleet drain", json.dumps(rec), f"[{smi}]")
    return rec


def fleet_prefix(dev, smi, cfg, params):
    """Two unified hosts with the prefix cache: h1 serves a shared-prefix
    prompt, then h0 gets another prompt of that prefix, fetches h1's
    blocks (cache_fetch -> cache_ship), installs them and hits. Its
    stream equals a local hit's on h1 and a cold engine's."""
    prompts = shared_prefix_prompts(cfg, 2)
    hosts, _, _ = serve_bench.build_fleet(
        params, cfg, fleet_args(fleet_hosts="unified,unified",
                                prefix_cache=True), dev)
    h0, h1 = hosts
    for k, h in enumerate(hosts):     # capture every host's graphs first
        h.submit(Request(rid=-1 - k, prompt=WARM_PROMPT(cfg),
                         max_new_tokens=4))
    serve_bench.pump_fleet(hosts)
    h1.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=64))
    serve_bench.pump_fleet(hosts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h0.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=64))
    serve_bench.pump_fleet(hosts)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    h1.submit(Request(rid=2, prompt=prompts[1], max_new_tokens=64))
    serve_bench.pump_fleet(hosts)
    _, cold = streams_of(prefix_engine(dev, params, cfg), prompts[1:], 64)
    got = serve_bench.fleet_streams(hosts)
    rec = {"cache_fetches": h0.cache_fetches,
           "fetch_timeouts": h0.cache_fetch_timeouts,
           "ships_in": h0.cache_ships_in, "ships_out": h1.cache_ships_out,
           "ship_blocks": h0.ship_blocks_in, "ship_bytes": h0.ship_bytes_in,
           "prefix_hits": h0.sched.prefix_hits, "request_ms": ms}
    print("fleet prefix", json.dumps(rec), f"[{smi}]")
    check(got[1] == got[2] == cold[0],
          "fleet prefix: the shipped hit's stream != a local hit's / cold")
    check(h0.cache_fetches == h0.cache_ships_in == h1.cache_ships_out == 1
          and h0.cache_fetch_timeouts == 0 and h0.sched.prefix_hits == 1
          and h0.ship_blocks_in == (PREFIX_LEN - PREFIX_TAIL) // 16,
          f"fleet prefix: ship counters {rec}")
    return rec


def fleet_rollout(dev, smi, cfg, params, fleet, prompts, uni):
    """On the in-process prefill + decode pair (graphs captured): a
    rollout whose every weight_ship to the second host is torn
    (torn_weights@1..3) is quarantined and the canary rolled back,
    streams equal to v0's; then a clean one promotes v1 on both hosts,
    streams equal to a fresh v1 engine's."""
    new = init_lm(torch.Generator().manual_seed(1), cfg, dev)
    hosts = fleet[0]
    peers = {h.name: h.role for h in hosts}

    def rollout(**kw):
        ctl = RolloutController(
            hosts[0].transport, peers, params=new, version=1, cfg=cfg,
            serving=hosts[0].engine.serving, probes=2, probe_tokens=4,
            stage_timeout_s=FLEET_TIMEOUT_S, device=dev,
            tick=lambda: [h.tick() for h in hosts], **kw)
        t0 = time.perf_counter()
        res = ctl.run()
        return res, (time.perf_counter() - t0) * 1e3

    hosts[0]._fault_plan = FaultPlan.parse(
        "torn_weights@1,torn_weights@2,torn_weights@3")
    torn, torn_ms = rollout()
    hosts[0]._fault_plan = None
    check(torn["verdict"] == "quarantined" and torn["torn_ships"] == 3
          and torn["rollbacks"] == 1,
          f"fleet rollout: the torn ships were not caught: {torn}")
    check(all(h.engine.params_version == 0 for h in hosts),
          "fleet rollout: a host left v0 after the quarantine")
    got = fleet_run(dev, params, cfg, prompts, fleet)[1]
    check(got == uni, "fleet rollout: streams after the rollback != v0's")
    res, ms = rollout()
    check(res["verdict"] == "promoted"
          and all(h.engine.params_version == 1 for h in hosts),
          f"fleet rollout: not promoted: {res}")
    got = fleet_run(dev, new, cfg, prompts, fleet)[1]
    _, _, _, want = serve(dev, new, cfg, prompts, impl="fused")
    check(got == want, "fleet rollout: v1 streams != a fresh v1 engine's")
    rec = {"torn": torn["verdict"], "torn_ms": torn_ms,
           "promote": res["verdict"], "promote_ms": ms,
           "canary": res["canary"]}
    print("fleet rollout", json.dumps(rec), f"[{smi}]")
    return rec


def fleet_wire(dev, smi, cfg, params, prompts, uni):
    """serve_bench's socket fleet in this process (real TCP frames,
    acks) with a dropped send and a delayed one planted past the
    warm-up's sends: both faults fire, the streams are unchanged, the
    drop is retried."""
    args = fleet_args(
        transport="socket",
        wire_faults=f"wire_drop@{WIRE_DROP_AT},"
                    f"wire_delay@{WIRE_DELAY_AT}:ms={WIRE_DELAY_MS}")
    _, _, seconds, streams, _, _, wire = serve_bench.run_fleet(
        params, cfg, prompts, args, dev)
    stats = wire["stats"]
    rec = {k: v for k, v in stats.items() if k != "send_ms"}
    rec.update(seconds=seconds, unfired=wire["unfired"],
               slowest_send_ms=max(max(v) for v in
                                   stats["send_ms"].values()))
    print("fleet wire", json.dumps(rec), f"[{smi}]")
    check(wire["unfired"] == [], f"fleet wire: a planted fault never "
          f"fired: {wire['unfired']}")
    check(streams == uni, "fleet wire: streams changed under wire faults")
    check(stats["retries"] >= 1 and stats["timeouts"] == 0,
          f"fleet wire: the dropped send was not retried: {rec}")
    return rec


def fleet_phase(dev, smi, cfg, params):
    """The serving fleet on the card (see the module docstring). ->
    paged-attention launches a run per host, by run."""
    prompts = serve_prompts(cfg)
    _, _, _, uni = serve(dev, params, cfg, prompts, impl="fused")
    _, _, _, ref = serve(dev, params, cfg, prompts, impl="reference")
    check(uni == ref, "fleet: the unified engine's fused streams != the "
          "reference path's")
    fleet, local = fleet_inprocess(dev, smi, cfg, params, prompts, uni)
    fleet_rollout(dev, smi, cfg, params, fleet, prompts, uni)
    del fleet
    fleet_prefix(dev, smi, cfg, params)
    fleet_wire(dev, smi, cfg, params, prompts, uni)
    release()
    runs = {"local": local}
    for transport in ("mailbox", "socket"):
        runs[transport] = fleet_processes(smi, cfg, prompts, uni,
                                          transport)["launches"]
    for role0 in ("prefill", "unified"):
        fleet_drain(smi, cfg, prompts, uni, role0)
    return runs


# ---------------------------------------------------------------------------
# flash kernel phase
# ---------------------------------------------------------------------------


def flash_case(bh, s, d, causal, dtype, dev, gen):
    """Random (BH, S, D) q, k, v, dO and the plain versions' out, lse,
    delta = rowsum(dO * O) (what the backward kernels are fed)."""
    q, k, v, do = [torch.randn(bh, s, d, device=dev, generator=gen).to(dtype)
                   for _ in range(4)]
    out, lse = ta.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1)
    return {"q": q, "k": k, "v": v, "do": do, "out": out, "lse": lse,
            "delta": delta, "causal": causal}


def flash_calls(c):
    """name -> (kernel call, plain call) on one case, for the kernels of
    its type (FLASH_ROUTES)."""
    args = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
            c["causal"])
    calls = {
        "flash_fwd": (lambda: ta.flash_fwd(c["q"], c["k"], c["v"],
                                           c["causal"]),
                      lambda: ta.flash_fwd_plain(c["q"], c["k"], c["v"],
                                                 c["causal"])),
        "flash_bwd_dq": (lambda: ta.flash_bwd_dq(*args),
                         lambda: ta.flash_bwd_dq_plain(*args)),
        "flash_bwd_dkv": (lambda: ta.flash_bwd_dkv(*args),
                          lambda: ta.flash_bwd_dkv_plain(*args)),
        "flash_bwd": (lambda: ta.flash_bwd(*args),
                      lambda: ta.flash_bwd_plain(*args)),
    }
    return {name: calls[name] for name in FLASH_ROUTES[c["q"].dtype]}


def flash_ops(name, c):
    """Operations of one kernel call: its products (FLASH) x 2*D per
    visible (q, k) pair."""
    bh, s, d = c["q"].shape
    pairs = bh * s * (s + 1) // 2 if c["causal"] else bh * s * s
    return FLASH[name][2] * 2 * d * pairs


def flash_bound(name, c):
    """(bound_ms, bound_by) for one kernel call: the larger of its bytes
    (each input read once, each output written once) over HBM bandwidth
    and its operations (2*D per product per visible (q, k) pair) over the
    bf16 or f32 rate of the inputs' type."""
    bh, s, d = c["q"].shape
    item = c["q"].element_size()
    rows, vecs = bh * s * d * item, bh * s * 4
    nbytes = {"flash_fwd": 4 * rows + vecs,            # q k v in; out, lse
              "flash_bwd_dq": 5 * rows + 2 * vecs,     # q k v dO lse delta; dq
              "flash_bwd_dkv": 6 * rows + 2 * vecs,    # ...; dk dv
              "flash_bwd": 7 * rows + 2 * vecs}[name]  # ...; dq dk dv
    ops = flash_ops(name, c)
    rate = BF16_FLOPS_PER_S if c["q"].dtype == torch.bfloat16 \
        else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_timings(c, flush):
    """Times at one timed case ``c``: each kernel (after two launches on
    the same inputs, which must be bitwise equal), its plain version and,
    as yardsticks the port never calls, SDPA's forward and its autograd
    backward on the same inputs. -> timing rows by kernel."""
    bh, s, d = c["q"].shape
    dtype = str(c["q"].dtype)[6:]
    rows = {}
    for name, (kernel, plain) in flash_calls(c).items():
        # deterministic: each block owns its output rows, and the fused
        # backward sums dQ across blocks in a fixed order
        first, again = kernel(), kernel()
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        again = again if isinstance(again, tuple) else (again,)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"{name} {dtype}: two launches on the same inputs differ")
        print(f"flash {name} {dtype}: two launches bitwise equal")
        b_ms, b_by = flash_bound(name, c)
        ms = time_ms(kernel, flush, iters=10)
        rows[name] = {"ms": ms,
                      "plain_ms": time_ms(plain, flush, iters=10),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None,
                      "tflops": flash_ops(name, c) / ms / 1e9}
    # yardstick only: SDPA forward, and its autograd backward (which
    # computes dQ, dK and dV in one call: the fused backward's function,
    # and neither pair kernel's alone); float32 runs with TF32 off
    # (device.py)
    q, k, v = (c[n].reshape(1, bh, s, d).detach().requires_grad_(True)
               for n in ("q", "k", "v"))
    do = c["do"].reshape(1, bh, s, d)
    rows["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        flush, iters=10)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    sdpa_bwd = time_ms(
        lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True),
        flush, iters=10)
    extra = {}
    if "flash_bwd" in rows:
        rows["flash_bwd"]["library_ms"] = sdpa_bwd
        backward_ms = rows["flash_bwd"]["ms"]
        extra = flash_bwd_polling(c, backward_ms)
    else:
        backward_ms = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    for name, row in rows.items():
        print("flash_timing", json.dumps({"kernel": name, "dtype": dtype,
                                          **row, "shape": [1, bh, s, d]}))
    print("flash_timing", json.dumps({
        "dtype": dtype,
        "library_backward_dq_dk_dv_ms": sdpa_bwd,
        "backward_kernels": [n for n in rows if n != "flash_fwd"],
        "backward_ms": backward_ms,
        "backward_over_library": backward_ms / sdpa_bwd,
        "forward_over_library":
            rows["flash_fwd"]["ms"] / rows["flash_fwd"]["library_ms"],
        **extra}))
    return rows


def flash_fwd_blocks_per_sm(d: int) -> int:
    """The float32 forward's resident blocks an SM at head width ``d``
    (causal), from the occupancy query on its shared memory and threads
    (``singa_flash_fwd_blocks_per_sm``); minus a CUDA error."""
    fn = _build.load("flash_attention").singa_flash_fwd_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(d, 1)


def flash_bwd_polling(c, ms):
    """The fused backward's own statistics from one launch on case ``c``
    (``ms`` its time): the share of its blocks' cycles that thread 0
    spent polling a dQ counter (the other threads wait at the barrier
    meanwhile), that share of ``ms``, and the blocks it ran."""
    args = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
            c["causal"])
    scratch = ta.launch_flash_bwd(*args)[3]
    torch.cuda.synchronize()
    polled, cycles, blocks = (
        scratch[:6].view(torch.int64).tolist())
    share = polled / cycles
    return {"poll_share": share, "poll_ms": share * ms, "blocks": blocks,
            "poll_cycles": polled, "block_cycles": cycles}


def flash_phase(dev):
    """Each flash kernel against its plain version at every listed shape
    (the fused backward twice, bitwise equal); timings at the training
    shape in bf16 (the main path's route) and in float32 (the CUDA-core
    route). -> (max_abs_err by dtype and kernel, timing rows by dtype and
    kernel)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {dt: {name: 0.0 for name in names}
            for dt, names in FLASH_ROUTES.items()}
    lse_worst = 0.0
    for bh, s, d, causal, dtype in FLASH_SHAPES:
        c = flash_case(bh, s, d, causal, dtype, dev, gen)
        worst = []
        for name, (kernel, plain) in flash_calls(c).items():
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                check(g.dtype == w.dtype and g.shape == w.shape
                      and bool(torch.isfinite(g).all()),
                      f"{name} {(bh, s, d, causal, dtype)}: bad output")
                err = float((g.float() - w.float()).abs().max())
                rel = err / max(float(w.float().abs().max()), 1e-30)
                errs[dtype][name] = max(errs[dtype][name], err)
                worst.append(rel)
                check(rel <= FLASH_TOL[dtype],
                      f"{name} {(bh, s, d, causal, dtype)}: error {rel} > "
                      f"{FLASH_TOL[dtype]} of the output's scale")
            if dtype == torch.float32:
                again = kernel()
                again = again if isinstance(again, tuple) else (again,)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{name} {(bh, s, d, causal, dtype)}: two launches "
                      "on the same inputs differ")
            if name == "flash_fwd":
                lse_err = float(((got[1] - want[1]).abs()
                                 / want[1].abs().clamp(min=1.0)).max())
                lse_worst = max(lse_worst, lse_err)
                check(lse_err <= LSE_TOL,
                      f"flash_fwd {(bh, s, d, causal, dtype)}: lse error "
                      f"{lse_err} > {LSE_TOL}")
        print(f"flash BH {bh} S {s:5d} D {d:3d} causal {int(causal)} "
              f"{str(dtype)[6:]:8s} worst relative error {max(worst):.2e} "
              f"(tol {FLASH_TOL[dtype]:g})")
        del c
    print(f"flash_fwd lse: worst relative error {lse_worst:.2e} over all "
          f"shapes (tol {LSE_TOL:g}); float32 kernels: two launches "
          "bitwise equal at every float32 shape")
    for d in ta.KERNEL_HEAD_DIMS:
        n = flash_fwd_blocks_per_sm(d)
        check(n >= 1, f"flash_fwd float32 D {d}: occupancy query gave {n}")
        print(f"flash_fwd float32 D {d}: {n} resident block(s) an SM")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for shape in (FLASH_TIMED, FLASH_TIMED_F32):
        c = flash_case(*shape, dev, gen)
        rows[shape[4]] = flash_timings(c, flush)
        del c
    return errs, rows


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------


def write_shard(tmp: str) -> str:
    """The conf's kSequenceData shard: 32 synthetic 8192-token sequences
    from seed 0 (the port's synthetic_token_arrays)."""
    shard = os.path.join(tmp, "shard")
    write_records(shard, *synthetic_token_arrays(32, seq_len=8192,
                                                 vocab=256, seed=0))
    return shard


def profile(tr, step0, nsteps):
    """``nsteps`` train steps under torch.profiler -> wall ms and device
    ms per step, both from this window, its idle share 1 - device / wall,
    and the 10 largest device-side rows per step. The profiler slows the
    host, so the idle share is an upper estimate of an unprofiled step's."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for step in range(step0, step0 + nsteps):
            tr.train_one_batch(step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / nsteps
    tr.perf.reset()
    # device-side rows only: an operator's row also carries the device
    # time of the kernels it launched, which the kernels' rows hold
    rows = [(e.key, e.self_device_time_total / 1e3 / nsteps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(ms for _, ms in rows)
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "top": sorted(rows, key=lambda kv: -kv[1])[:10]}


def train_run(dev, shard, *, steps, dtype, dense, tag, profile_steps=0):
    """``steps`` steps of the port's Trainer on the conf (read by the
    port's load_model_config) over ``shard`` at compute ``dtype``, fresh
    params from seed 0. ``dense`` sets SINGA_TPU_DENSE_ATTN_MB (read at
    every attention call) above the conf's 1,074 MB of scores, else to
    its default 512, where the conf takes the flash kernels. Each step is
    timed on the host clock to a device sync; the flash launch counts are
    set to 0 just before the steps and read just after; then
    ``profile_steps`` more under torch.profiler. Checked: finite losses,
    launches = attention layers x steps of each kernel of the type's
    route on the flash path (FLASH_ROUTES), 0 of every other flash
    kernel and 0 on the dense path. -> the run's record."""
    cfg = load_model_config(TRAIN_CONF)
    cfg.compute_dtype = dtype
    for layer in cfg.neuralnet.layer:
        if layer.type == "kSequenceData":
            layer.data_param.path = shard
    os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "1e12" if dense else "512"
    tr = Trainer(cfg, seed=0, log=lambda s: None, device=dev)
    for fn, _, _ in FLASH.values():
        fn.launches = 0
    ms, losses = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        tr.train_one_batch(step)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    launches = {name: fn.launches for name, (fn, _, _) in FLASH.items()}
    median = sorted(ms)[len(ms) // 2]
    out = {"run": tag, "compute_dtype": dtype, "steps": steps,
           "step_ms_median": median, "step_ms_min": min(ms),
           "tokens_per_s": tr.tokens_per_step / median * 1e3,
           "losses": losses, "launches": launches}
    if profile_steps:
        out["profile"] = profile(tr, steps, profile_steps)
    print("train", json.dumps(out))
    layers = sum(l.type == "kAttention" for l in cfg.neuralnet.layer)
    check(all(np.isfinite(losses)), f"train {tag}: non-finite loss")
    want = flash_launches(getattr(torch, dtype), 0 if dense
                          else layers * steps)
    check(launches == want,
          f"train {tag}: flash launches {launches} != {want}")
    return out


def flash_launches(dtype, n):
    """The flash launch counts of ``n`` forward and backward calls of
    ``dtype``: n for each kernel of its route, 0 for the others."""
    return {name: n if name in FLASH_ROUTES[dtype] else 0 for name in FLASH}


def train_phase(dev):
    """-> (flash launches of the bf16 run, of the first float32 flash
    run)."""
    with tempfile.TemporaryDirectory() as tmp:
        shard = write_shard(tmp)
        recs = [train_run(dev, shard, steps=8, dtype="float32", dense=dense,
                          tag=f"{tag}_f32")
                for tag, dense in (("flash", False), ("dense", True),
                                   ("dense", True), ("flash", False))]
        runs = [r["losses"] for r in recs]
        diff = max(abs(a - b) for f, d_ in ((runs[0], runs[1]),
                                            (runs[3], runs[2]))
                   for a, b in zip(f, d_))
        print(f"train float32 flash vs dense: max loss difference "
              f"{diff:.3e} over 8 steps (tol {TRAIN_TOL:g}); equal to the "
              f"bit: {diff == 0.0}")
        check(diff <= TRAIN_TOL, "train: flash and dense losses differ")
        # the same comparison must fail on a planted gradient fault
        backward = ta._FlashAttention.backward
        for fault, change in FAULTS.items():
            def planted(ctx, g, change=change):
                dq, dk, dv, _ = backward(ctx, g)
                return (*change(dq, dk, dv), None)
            ta._FlashAttention.backward = staticmethod(planted)
            try:
                losses = train_run(dev, shard, steps=8, dtype="float32",
                                   dense=False, tag="fault_f32")["losses"]
            finally:
                ta._FlashAttention.backward = staticmethod(backward)
            moved = [abs(a - b) for a, b in zip(losses, runs[1])]
            print(f"train float32 {fault} vs dense: loss difference by "
                  f"step {' '.join(f'{m:.3e}' for m in moved)}")
            check(max(moved) > TRAIN_TOL,
                  f"train: {fault} passes the flash vs dense check")
        out = train_run(dev, shard, steps=30, dtype="bfloat16", dense=False,
                        tag="flash_bf16", profile_steps=3)
    check(out["losses"][-1] < out["losses"][0],
          "train bf16: loss did not fall")
    return out["launches"], recs[0]["launches"]


# ---------------------------------------------------------------------------
# ring phase
# ---------------------------------------------------------------------------


def quant_acc_case(m, dev, gen):
    q = torch.randint(-127, 128, (m,), device=dev, generator=gen,
                      dtype=torch.int8)
    local = torch.randn(m, device=dev, generator=gen)
    scale = torch.rand((), device=dev, generator=gen) * 1e-2
    return q, scale, local


def same_bits(got, want) -> bool:
    """Bitwise equal, a NaN matching any NaN (its payload is the
    hardware's)."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def quant_acc_parity(q, scale, local, what):
    """quant_acc (out, amax) and out alone against quant_acc_plain,
    bitwise. -> max |out - plain| over the non-NaN elements."""
    want, want_max = qc.quant_acc_plain(q, scale, local, amax=True)
    got, got_max = qc.quant_acc(q, scale, local, amax=True)
    bare = qc.quant_acc(q, scale, local)
    torch.cuda.synchronize()
    ok = (same_bits(got, want) and same_bits(got_max, want_max)
          and same_bits(bare, want))
    live = ~torch.isnan(want)
    err = (float((got[live] - want[live]).abs().max())
           if bool(live.any()) else 0.0)
    print(f"quant_acc {what}: out and amax bitwise {ok}")
    check(ok, f"quant_acc {what}: differs from plain")
    return err


def quant_acc_phase(dev):
    """quant_acc against quant_acc_plain, out and amax bitwise: at every
    RING_SIZES, on an unaligned row of a flat (4, 1001) bucket tensor,
    with a NaN partial and with a NaN scale; then times at RING_TIMED
    with and without amax. -> (max_abs_err, rows by m)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    for m in RING_SIZES:
        q, scale, local = quant_acc_case(m, dev, gen)
        err = max(err, quant_acc_parity(q, scale, local, f"m {m}"))
        nan = torch.full((), float("nan"), device=dev)
        out, mx = qc.quant_acc(q, nan, local, amax=True)
        check(bool(out.isnan().all()) and bool(mx.isnan()),
              f"quant_acc m {m}: a NaN scale does not give NaN everywhere")
    # a ragged flat bucket tensor: row 1 starts 1001 bytes / 4004 bytes in
    q, scale, local = quant_acc_case(4 * 1001, dev, gen)
    err = max(err, quant_acc_parity(q.view(4, 1001)[1],
                                    scale, local.view(4, 1001)[1],
                                    "row 1 of (4, 1001)"))
    # a NaN partial: NaN in its place and in amax
    q, scale, local = quant_acc_case(RING_BUCKETS[0], dev, gen)
    local[12345] = float("nan")
    err = max(err, quant_acc_parity(q, scale, local, "NaN partial"))
    check(bool(qc.quant_acc(q, scale, local, amax=True)[1].isnan()),
          "quant_acc: a NaN partial does not give a NaN amax")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for m in RING_TIMED:
        q, scale, local = quant_acc_case(m, dev, gen)
        t_bytes, t_ops = (9 * m + 4) / HBM_BYTES_PER_S, 2 * m / F32_FLOPS_PER_S
        rows[m] = {
            "ms": time_ms(lambda: qc.quant_acc(q, scale, local), flush),
            "amax_ms": time_ms(
                lambda: qc.quant_acc(q, scale, local, amax=True), flush),
            "plain_ms": time_ms(lambda: qc.quant_acc_plain(q, scale, local),
                                flush),
            "amax_plain_ms": time_ms(
                lambda: qc.quant_acc_plain(q, scale, local, amax=True),
                flush),
            "library_ms": time_ms(lambda: torch.addcmul(local, q, scale),
                                  flush),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            # amax adds one 4-byte write
            "amax_bound_ms": max(t_bytes + 4 / HBM_BYTES_PER_S, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print("quant_acc_timing", json.dumps({"m": m, **rows[m]}))
    return err, rows


def write_ring_shard(tmp: str) -> str:
    """256 synthetic 128-token sequences from seed 0, as bench.py's
    tinylm rows make them."""
    shard = os.path.join(tmp, "ring_shard")
    write_records(shard, *synthetic_token_arrays(256, seq_len=128,
                                                 vocab=256, seed=0))
    return shard


def ring_trainer(dev, shard, tag, dtype=None):
    """The port's Trainer on tinylm_d128.conf with grad_comm tag ``tag``
    and 4 buckets, on RING_RANKS ranks of ``dev``."""
    cfg = load_model_config(RING_CONF)
    if dtype is not None:
        cfg.compute_dtype = dtype
    for layer in cfg.neuralnet.layer:
        if layer.type == "kSequenceData":
            layer.data_param.path = shard
    if tag != "exact":
        apply_grad_comm_tag(cfg, tag)
        cfg.grad_comm.buckets = 4
    mesh = build_mesh(RING_RANKS, 1, [dev] * RING_RANKS)
    return Trainer(cfg, mesh=mesh, seed=0, log=lambda s: None)


def global_grads(tr):
    """The gradient of one real step: the whole batch through one
    forward and backward."""
    batch = tr._next_batch(tr.train_net)
    leaves = {n: p.detach().requires_grad_(True)
              for n, p in tr.params.items()}
    loss, _ = tr.train_net.forward(leaves, batch, training=True)
    loss.backward()
    return {n: leaves[n].grad.detach() for n in leaves}


def probe(tr, grads):
    """_ring_reduce_probe on ``grads`` with zero residuals -> (per-rank
    reduced grads, new residuals, worst error in bucket scales, worst
    residual in bucket scales)."""
    res = {f"__gradres__/{n}": torch.zeros_like(g) for n, g in grads.items()}
    outs, new_res = tr._ring_reduce_probe(grads, res)
    worst = worst_res = 0.0
    for bucket in tr._buckets(grads):
        scale = max(float(grads[n].abs().max()) for n in bucket) / 127.0
        for n in bucket:
            for out in outs:
                worst = max(worst, float((out[n].to(grads[n].device)
                                          - grads[n]).abs().max()) / scale)
            worst_res = max(worst_res, float(
                new_res[f"__gradres__/{n}"].abs().max()) / scale)
    return outs, new_res, worst, worst_res


def _allgather_wrong_index(*args):
    """A planted fault: every chunk row written one index off."""
    return [torch.roll(full, 1, 0) for full in RING_ALLGATHER(*args)]


def _hop_fault(change):
    """A planted quant_acc fault: ``change(q, s, x)`` for the sum, its
    max-abs taken from that sum."""
    def planted(q, s, x, *, amax=False):
        out = change(q, s, x)
        return (out, out.abs().max()) if amax else out
    return planted


def _amax_halved(q, s, x, *, amax=False):
    """A planted fault: the fused max-abs reads half the max (the kernel
    launched directly: a planted run counts no launches)."""
    got = qc._launch(q, s, x, amax)
    return (got[0], got[1] / 2) if amax else got


RING_ALLGATHER = qc._allgather
#: planted ring faults, each of which the probe's bar must catch
RING_FAULTS = {
    "hop drops its scale": ("quant_acc",
                            _hop_fault(lambda q, s, x: q.float() + x)),
    "hop skips its local add": ("quant_acc",
                                _hop_fault(lambda q, s, x: q.float() * s)),
    "allgather writes the wrong index": ("_allgather",
                                         _allgather_wrong_index),
    "the fused amax reads half the max": ("quant_acc", _amax_halved),
}


def ring_probe_phase(dev, shard):
    tr = ring_trainer(dev, shard, "q8wire", "float32")
    grads = global_grads(tr)
    outs, new_res, worst, worst_res = probe(tr, grads)
    torch.cuda.synchronize()
    same = all(torch.equal(o[n], outs[0][n]) for o in outs for n in grads)
    print(f"ring probe: worst error {worst:.3f} bucket scales (bar "
          f"{PROBE_BAR}), worst residual {worst_res:.3f} scales, ranks "
          f"bitwise equal {same}")
    check(worst <= PROBE_BAR, "ring probe: reduced grads off the bar")
    check(worst_res <= 1.0, "ring probe: residual above one scale")
    check(same, "ring probe: reduced grads differ between ranks")
    # the same probe on the CPU from the same inputs
    cpu = ring_trainer(torch.device("cpu"), shard, "q8wire", "float32")
    host = {n: g.cpu() for n, g in grads.items()}
    c_outs, c_res, _, _ = probe(cpu, host)
    diff = max(float((a.cpu() - b).abs().max())
               for a, b in [(outs[0][n], c_outs[0][n]) for n in grads]
               + [(new_res[k], c_res[k]) for k in c_res])
    print(f"ring probe: card vs CPU max difference {diff:.3e}")
    for fault, (name, fn) in RING_FAULTS.items():
        real = getattr(qc, name)
        setattr(qc, name, fn)
        try:
            bad = probe(tr, grads)[2]
        finally:
            setattr(qc, name, real)
        print(f"ring probe with fault '{fault}': worst error {bad:.3f} "
              f"bucket scales")
        check(bad > PROBE_BAR, f"ring probe: fault '{fault}' passes")
    return diff


def ring_run(dev, shard, tag, *, steps, dtype, profile_steps=0):
    """``steps`` steps of one form on 4 ranks; the quant_acc count set to
    0 just before the steps and read just after; then ``profile_steps``
    more under torch.profiler. -> the run's record."""
    tr = ring_trainer(dev, shard, tag, dtype)
    qc.quant_acc.launches = 0
    ms, losses = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        tr.train_one_batch(step)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    launches = qc.quant_acc.launches
    median = sorted(ms)[len(ms) // 2]
    out = {"run": tag, "compute_dtype": dtype, "ranks": RING_RANKS,
           "steps": steps, "step_ms_median": median, "step_ms_min": min(ms),
           "tokens_per_s": tr.tokens_per_step / median * 1e3,
           "losses": losses, "quant_acc_launches": launches}
    if profile_steps:
        out["profile"] = profile(tr, steps, profile_steps)
    print("ring_train", json.dumps(out))
    buckets = len(tr._buckets(tr.params)) if tag != "exact" else 0
    want = RING_RANKS * buckets * RING_FORMS.get(tag, 0) * steps
    check(all(np.isfinite(losses)), f"ring {tag}: non-finite loss")
    check(launches == want, f"ring {tag}: quant_acc launches {launches} "
          f"!= {want}")
    out["trainer"] = tr
    return out


def reduce_ms(tr, reps=10) -> float:
    """The ring's reduction alone (_ring_reduce_probe on random grads and
    zero residuals) on the host clock to a device sync: ms per call, the
    mean of ``reps`` after one warm-up call."""
    grads = {n: torch.randn_like(p) * 1e-3 for n, p in tr.params.items()}
    res = {k: torch.zeros_like(v) for k, v in tr.buffers.items()}
    tr._ring_reduce_probe(grads, res)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tr._ring_reduce_probe(grads, res)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


RING_HOP = qc._hop


def _unfused_hop(*args, **kw):
    """The ring's hop without the fused max-abs: every next scale from a
    pass of its own over the row (symmetric_scale)."""
    return RING_HOP(*args, **{**kw, "fused": False})


def ring_fusion(dev, shard, pairs=10):
    """The bf16 flat ring with the next hop's max-abs fused into quant_acc
    and without it, on one trainer: the probe's reduced grads and
    residuals must be equal to the bit (the two give the same scales);
    then ``pairs`` pairs, the order alternating (fused first in even
    pairs), each side the probe's host ms (reduce_ms) and the median ms
    of 5 synced train steps."""
    tr = ring_trainer(dev, shard, "q8wire")
    grads = {n: torch.randn_like(p) * 1e-3 for n, p in tr.params.items()}
    res = {k: torch.zeros_like(v) for k, v in tr.buffers.items()}
    times = {form: {"reduce_ms": [], "step_ms": []}
             for form in ("fused", "unfused")}
    got, step = {}, 0
    for i in range(pairs):
        for form in ("fused", "unfused")[::1 if i % 2 == 0 else -1]:
            qc._hop = RING_HOP if form == "fused" else _unfused_hop
            try:
                got[form] = tr._ring_reduce_probe(grads, res)
                times[form]["reduce_ms"].append(reduce_ms(tr))
                ms = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    tr.train_one_batch(step)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    tr.perf.reset()
                    step += 1
                times[form]["step_ms"].append(sorted(ms)[2])
            finally:
                qc._hop = RING_HOP
    (outs, new_res), (u_outs, u_res) = got["fused"], got["unfused"]
    check(all(torch.equal(a[n], b[n]) for a, b in zip(outs, u_outs)
              for n in a)
          and all(torch.equal(new_res[k], u_res[k]) for k in new_res),
          "ring: fused and unfused max-abs reduce differently")
    print("ring_fusion", json.dumps({"pairs": pairs, **{
        f"{form}_{key}": v for form, t in times.items()
        for key, v in t.items()}}))


def ring_phase(dev):
    """-> (max_abs_err, the timing row at the largest bucket chunk,
    launches of the bf16 flat ring)."""
    err, rows = quant_acc_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        shard = write_ring_shard(tmp)
        ring_probe_phase(dev, shard)
        runs = [ring_run(dev, shard, tag, steps=8, dtype="float32")
                for tag in ("q8wire", "q8", "q8", "q8wire")]
        diff = max(abs(a - b) for ring, ref in ((runs[0], runs[1]),
                                                (runs[3], runs[2]))
                   for a, b in zip(ring["losses"], ref["losses"]))
        print(f"ring float32 ring vs reference q8: max loss difference "
              f"{diff:.3e} over 8 steps (tol {RING_TOL:g})")
        check(diff <= RING_TOL, "ring: ring and reference q8 losses differ")
        bf16 = {tag: ring_run(dev, shard, tag, steps=30, dtype=None,
                              profile_steps=3 if tag == "q8wire" else 0)
                for tag in ("q8wire", "q8hier", "exact")}
        for tag, run in bf16.items():
            check(run["losses"][-1] < run["losses"][0],
                  f"ring bf16 {tag}: loss did not fall")
        # the reduction alone on the host clock, as a share of the step
        ms = reduce_ms(bf16["q8wire"]["trainer"])
        print("ring_reduce", json.dumps({
            "reduce_ms": ms,
            "ring_step_ms": bf16["q8wire"]["step_ms_median"],
            "share": ms / bf16["q8wire"]["step_ms_median"]}))
        ring_fusion(dev, shard)
    return err, rows[RING_TIMED[0]], bf16["q8wire"]["quant_acc_launches"]


# ---------------------------------------------------------------------------
# nets phase
# ---------------------------------------------------------------------------


def write_net_shards(tmp: str) -> dict:
    """MNIST-shaped train and test shards (synthetic_arrays, templates
    from seed 0, the test split's noise from seed 1), a CIFAR-shaped
    train shard (structured_rgb, seed 0), its test split and the train
    shard's mean file (compute_mean)."""
    out = {k: os.path.join(tmp, k) for k in
           ("mnist", "mnist_test", "cifar", "cifar_test")}
    write_records(out["mnist"], *synthetic_arrays(2000, seed=0))
    write_records(out["mnist_test"],
                  *synthetic_arrays(1000, seed=0, noise_seed=1))
    write_records(out["cifar"], *structured_rgb(1000, seed=0))
    write_records(out["cifar_test"],
                  *structured_rgb(200, seed=0, noise_seed=1))
    out["mean"] = os.path.join(tmp, "mean.npy")
    compute_mean(out["cifar"], out["mean"])
    return out


def net_config(name: str, shards: dict):
    """The conf as written (widths, batch, updater), read by the port's
    load_model_config, on the synthetic shards. The autoencoder's
    kPretrained params come from ``shards["ae_init"]``, the rbm phase's
    unrolled RBM stack (the real job's ae_init.npz)."""
    conf, data, _ = NETS[name]
    cfg = load_model_config(os.path.join(REPO, conf))
    cfg.checkpoint = shards["ae_init"] if name == "autoencoder" else None
    for layer in cfg.neuralnet.layer:
        if layer.type == "kShardData":
            test = "kTrain" in (layer.exclude or [])
            layer.data_param.path = shards[data + ("_test" if test else "")]
        if layer.rgbimage_param is not None:
            layer.rgbimage_param.meanfile = shards["mean"]
    return cfg


def check_unrolled_init(tr, ae_init, tag):
    """The autoencoder's params before its first step are the unrolled
    checkpoint's arrays, every one of them."""
    with np.load(ae_init) as z:
        same = all(np.array_equal(v.cpu().numpy(), z["p|" + n])
                   for n, v in tr.params.items())
    print(f"{tag} autoencoder: params at step 0 are the unrolled RBM "
          f"stack's ({ae_init}): {same}")
    check(same, f"{tag} autoencoder: does not start from the unrolled "
          "RBM stack")


def net_steps(tr, step0, nsteps, timed=False):
    """-> (losses, host ms per step synced to the device)."""
    losses, ms = [], []
    for step in range(step0, step0 + nsteps):
        t0 = time.perf_counter()
        tr.train_one_batch(step)
        if timed:
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    return losses, ms


def mlp_bound(tr):
    """(operations of one mlp step, ms at F32_FLOPS_PER_S): each FC
    layer's forward, dW and dX products, 2·vdim·hdim·batch each, less
    the first layer's dX (its input is data)."""
    fcs = [l for l in tr.train_net.layers if l.TYPE == "kInnerProduct"]
    batch = tr.train_net.batchsize
    ops = sum(3 * 2 * l.vdim * l.hdim * batch for l in fcs)
    ops -= 2 * fcs[0].vdim * fcs[0].hdim * batch
    return ops, ops / F32_FLOPS_PER_S * 1e3


def net_run(dev, name, shards, smi):
    """One conf at full width: NETS_PARITY_STEPS float32 steps on the card
    and on the CPU from the same seed-0 params and batches (losses within
    NETS_TOL relative), NETS_STEPS more timed steps on the card (finite,
    the last below the first), one test batch, then a 3-step profile."""
    batch = NETS[name][2]
    card = Trainer(net_config(name, shards), seed=0, log=lambda s: None,
                   device=dev)
    host = Trainer(net_config(name, shards), seed=0, log=lambda s: None,
                   device="cpu")
    check(card.train_net.batchsize == batch,
          f"nets {name}: batch {card.train_net.batchsize} != {batch}")
    if name == "autoencoder":
        check_unrolled_init(card, shards["ae_init"], "nets")
    ours, _ = net_steps(card, 0, NETS_PARITY_STEPS)
    ref, _ = net_steps(host, 0, NETS_PARITY_STEPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(ours, ref))
    print(f"nets {name}: card vs CPU over {NETS_PARITY_STEPS} float32 "
          f"steps, max relative loss difference {rel:.3e} (tol "
          f"{NETS_TOL:g}); card {' '.join(f'{x:.6f}' for x in ours)} "
          f"[{smi}]")
    check(rel <= NETS_TOL, f"nets {name}: card and CPU losses differ")
    losses, ms = net_steps(card, NETS_PARITY_STEPS, NETS_STEPS, timed=True)
    check(all(np.isfinite(losses)), f"nets {name}: non-finite loss")
    check(losses[-1] < losses[0], f"nets {name}: loss did not fall")
    test = card.evaluate(card.test_net, 1, "test", NETS_STEPS)["loss"]
    check(all(np.isfinite(list(test.values()))),
          f"nets {name}: non-finite test metric")
    median = sorted(ms)[len(ms) // 2]
    prof = profile(card, NETS_PARITY_STEPS + NETS_STEPS, 3)
    out = {"net": name, "conf": NETS[name][0], "batch": batch,
           "params": sum(p.numel() for p in card.params.values()),
           "steps": NETS_STEPS, "first_loss": losses[0],
           "last_loss": losses[-1], "test": test,
           "step_ms_median": median, "step_ms_min": min(ms),
           "images_per_s": batch / median * 1e3,
           "device_ms_per_step": prof["device_ms_per_step"],
           "profiled_wall_ms_per_step": prof["wall_ms_per_step"],
           "idle_share": prof["idle_share"], "top5": prof["top"][:5],
           "card": smi}
    if name == "mlp":
        out["bound_ops"], out["bound_ms"] = mlp_bound(card)
    print("nets", json.dumps(out))
    return out


def pool_check(dev, smi):
    """The tie-sharing max-pool backward and the k² average at AlexNet's
    pool1 shape (100, 32, 28, 28), k 3, s 2 (the last window overhangs),
    on integer inputs full of ties: card vs CPU, forward and backward.
    Each planted fault (PyTorch's single-winner backward; PyTorch's
    ceil_mode average, which divides an overhanging window by its
    in-bounds count) must fail the same comparison."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 3, (100, 32, 28, 28), generator=gen).float()
    dy = torch.randn(100, 32, 14, 14, generator=gen)

    def run(fn, device):
        xd = x.to(device).clone().requires_grad_(True)
        y = fn(xd)
        y.backward(dy.to(device))
        return y.detach().cpu(), xd.grad.cpu()

    def err(a, b):
        return max(float((u - v).abs().max()) for u, v in zip(a, b))

    single = lambda t: F.max_pool2d(  # noqa: E731
        F.pad(t, (0, 1, 0, 1), value=float("-inf")), 3, 2)
    in_bounds = lambda t: F.avg_pool2d(t, 3, 2, ceil_mode=True)  # noqa
    for kind, ours, fault in (
            ("max", lambda t: tnn.max_pool2d(t, 3, 2), single),
            ("avg", lambda t: tnn.avg_pool2d(t, 3, 2), in_bounds)):
        want = run(ours, "cpu")
        got, planted = err(run(ours, dev), want), err(run(fault, dev), want)
        print(f"nets pool {kind}: card vs CPU max abs {got:.3e}, planted "
              f"fault vs CPU {planted:.3e} (tol {POOL_TOL:g}) [{smi}]")
        check(got <= POOL_TOL, f"nets pool {kind}: card and CPU differ")
        check(planted > POOL_TOL,
              f"nets pool {kind}: the planted fault passes the check")


def nets_phase(dev, smi, shards):
    """-> {net: record} for the four confs on ``shards``
    (write_net_shards, with the rbm phase's ``ae_init``)."""
    pool_check(dev, smi)
    return {name: net_run(dev, name, shards, smi) for name in NETS}


# ---------------------------------------------------------------------------
# rbm phase
# ---------------------------------------------------------------------------


def rbm_config(shards: dict):
    """examples/mnist/rbm.conf as written (784-1000-500-250-30, CD-1,
    batch 100), read by the port's load_model_config, on the MNIST-shaped
    shards of the nets phase."""
    cfg = load_model_config(os.path.join(REPO, RBM_CONF))
    for layer in cfg.neuralnet.layer:
        if layer.type == "kShardData":
            test = "kTrain" in (layer.exclude or [])
            layer.data_param.path = shards["mnist_test" if test else "mnist"]
    return cfg


def uniform_table(shape) -> np.ndarray:
    """The parity check's uniforms for a draw of ``shape`` (float32 in
    [0, 1), from a seed made of the shape)."""
    shape = tuple(int(d) for d in shape)
    seed = 7919 * sum(shape) + len(shape)
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def table_bernoulli(generator, p):
    """``layers.rbm.bernoulli`` over ``uniform_table``: the same draws on
    the card and on the CPU."""
    return torch.from_numpy(uniform_table(p.shape)).to(p.device) < p


def rbm_steps(tr, step0, nsteps, timed=False):
    """-> ({rbm: [recon error per step]}, host ms per step synced to the
    device when ``timed``)."""
    errs, ms = {}, []
    for step in range(step0, step0 + nsteps):
        t0 = time.perf_counter()
        tr.train_one_batch(step)
        if timed:
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        for name, m in tr.perf.avg().items():
            errs.setdefault(name, []).append(m["loss"])
        tr.perf.reset()
    return errs, ms


def rbm_phase(dev, smi, shards, tmp):
    """rbm.conf as written through make_trainer (the CDTrainer): with one
    injected table of uniforms, NETS_PARITY_STEPS float32 CD steps on the
    card and on the CPU from the same seed-0 params, every RBM's
    reconstruction error within NETS_TOL relative; then the real device
    draws: two card runs from one seed give the same bits over their first
    NETS_PARITY_STEPS steps, RBM_STEPS more timed steps (finite; each
    RBM's mean error of the last 5 below that of those first steps), one
    test batch and a 3-step profile; last the stack's checkpoint,
    unrolled into autoencoder.conf's init. -> (record, ae_init path)."""
    trbm.bernoulli = table_bernoulli
    try:
        card = make_trainer(rbm_config(shards), seed=0, log=lambda s: None,
                            device=dev)
        host = make_trainer(rbm_config(shards), seed=0, log=lambda s: None,
                            device="cpu")
        ours, _ = rbm_steps(card, 0, NETS_PARITY_STEPS)
        ref, _ = rbm_steps(host, 0, NETS_PARITY_STEPS)
    finally:
        trbm.bernoulli = RBM_DRAW
    rbms = [r for r, _ in RBM_PAIRS]
    check(sorted(ours) == rbms, f"rbm: metrics {sorted(ours)} != {rbms}")
    rel = max(abs(a - b) / abs(b) for r in rbms
              for a, b in zip(ours[r], ref[r]))
    print(f"rbm: card vs CPU, {NETS_PARITY_STEPS} float32 CD steps on one "
          f"table of uniforms, max relative recon-error difference "
          f"{rel:.3e} (tol {NETS_TOL:g}); card "
          + "; ".join(f"{r} " + " ".join(f"{x:.6f}" for x in ours[r])
                      for r in rbms) + f" [{smi}]")
    check(rel <= NETS_TOL, "rbm: card and CPU recon errors differ")

    runs = [make_trainer(rbm_config(shards), seed=0, log=lambda s: None,
                         device=dev) for _ in range(2)]
    first = [rbm_steps(tr, 0, NETS_PARITY_STEPS)[0] for tr in runs]
    same = first[0] == first[1] and all(
        torch.equal(v, runs[1].params[n]) for n, v in runs[0].params.items())
    print(f"rbm: two card runs from seed 0, {NETS_PARITY_STEPS} steps on "
          f"the device's draws: the same bits {same}")
    check(same, "rbm: two runs from one seed differ")
    tr = runs[0]
    check(tr.dispatch_mode == "eager", "rbm: the CD step is not eager")
    errs, ms = rbm_steps(tr, NETS_PARITY_STEPS, RBM_STEPS, timed=True)
    for r in rbms:
        # the upper RBMs train on their lower RBMs' moving features: an
        # error may rise for a while after its first fall
        e = errs[r]
        check(all(np.isfinite(e)), f"rbm {r}: non-finite recon error")
        check(np.mean(e[-5:]) < np.mean(first[0][r]),
              f"rbm {r}: recon error did not fall")
    steps = NETS_PARITY_STEPS + RBM_STEPS
    test = {r: m["loss"] for r, m in
            tr.evaluate(tr.test_net, 1, "test", steps).items()}
    check(all(np.isfinite(list(test.values()))),
          "rbm: non-finite test recon error")
    median = sorted(ms)[len(ms) // 2]
    batch = tr.train_net.batchsize
    prof = profile(tr, steps, 3)
    steps += 3
    rec = {"conf": RBM_CONF, "batch": batch,
           "dispatch": tr.dispatch_mode, "rule": tr.dispatch_reason,
           "steps": RBM_STEPS,
           "first": {r: first[0][r][0] for r in rbms},
           "last": {r: errs[r][-1] for r in rbms}, "test": test,
           "step_ms_median": median, "step_ms_min": min(ms),
           "images_per_s": batch / median * 1e3,
           "device_ms_per_step": prof["device_ms_per_step"],
           "profiled_wall_ms_per_step": prof["wall_ms_per_step"],
           "idle_share": prof["idle_share"], "top5": prof["top"][:5],
           "card": smi}
    print("rbm", json.dumps(rec))
    stack = save_checkpoint(os.path.join(tmp, "rbm_stack.npz"), steps,
                            tr.params, tr.state)
    ae_init = unroll_autoencoder(stack, os.path.join(tmp, "ae_init.npz"),
                                 RBM_PAIRS)
    print(f"rbm: unrolled the card's stack at step {steps} into {ae_init}")
    return rec, ae_init


# ---------------------------------------------------------------------------
# dispatch phase
# ---------------------------------------------------------------------------


def window_losses(tr, step0=0):
    """DISPATCH_STEPS steps from ``step0`` in windows of DISPATCH_WINDOW
    (``train_chunk``: replays of the captured step, or eager steps) ->
    each window's mean loss."""
    out = []
    for s in range(step0, step0 + DISPATCH_STEPS, DISPATCH_WINDOW):
        tr.train_chunk(s, DISPATCH_WINDOW)
        out.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    return out


def rel_diff(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def chunk_ms(tr, step0, n):
    """Host ms per step of one ``n``-step chunk, synced at its end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_chunk(step0, n)
    torch.cuda.synchronize()
    tr.perf.reset()
    return (time.perf_counter() - t0) * 1e3 / n


def chunk_device_ms(tr, step0, n):
    """Device ms per step of an unprofiled ``n``-step graphed chunk, by
    CUDA events: a ~10 ms device sleep before the start event keeps the
    card busy while the host uploads the chunk's args and enqueues its
    replays, so the events time the device's work alone."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    t0 = time.perf_counter()
    tr.train_chunk(step0, n)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    tr.perf.reset()
    return start.elapsed_time(end) / n, enqueue_ms


def dispatch_times(tr, eager, step0, units_per_step):
    """Step ms of the graphed and the eager trainer (a 30-step chunk
    each, synced at its end), the graphed chunk's unprofiled device ms
    and idle share, and its largest device rows (10 profiled steps)."""
    from singa_tpu_torch.tools.dispatch_turns import profiled_device_ms

    g_ms = chunk_ms(tr, step0, DISPATCH_STEPS)
    e_ms = chunk_ms(eager, step0, DISPATCH_STEPS)
    dev_ms, enqueue_ms = chunk_device_ms(tr, step0 + DISPATCH_STEPS,
                                         DISPATCH_STEPS)
    prof_ms, top = profiled_device_ms(
        lambda: tr.train_chunk(step0 + 2 * DISPATCH_STEPS, 10), 10)
    tr.perf.reset()
    return {"step_ms": g_ms, "eager_step_ms": e_ms,
            "per_s": units_per_step / g_ms * 1e3,
            "eager_per_s": units_per_step / e_ms * 1e3,
            "device_ms_per_step": dev_ms, "idle_share": 1.0 - dev_ms / g_ms,
            "chunk_enqueue_ms": enqueue_ms,
            "profiled_device_ms_per_step": prof_ms, "top5": top}


def dispatch_pair(dev, make_cfg, units, tag, smi):
    """A graphed and an eager trainer (the eager one on host batches,
    the per-step path of the slices before) from the same seed-0 params:
    DISPATCH_STEPS steps each, window losses within DISPATCH_TOL, then
    their times (``units`` per step: images, or None for the LM's
    tokens). -> (record, the eager run's window losses)."""
    graph = Trainer(make_cfg(), seed=0, log=lambda s: None, device=dev)
    units = units or graph.tokens_per_step
    eager = Trainer(make_cfg(), seed=0, log=lambda s: None, device=dev,
                    graphs=False, device_cache=False, prefetch=False)
    check(graph.dispatch_mode == "graph" and graph.feeder_mode == "cached",
          f"dispatch {tag}: not a graphed step on the cached dataset "
          f"({graph.dispatch_mode}, {graph.feeder_mode})")
    if tag == "autoencoder":
        check_unrolled_init(graph, graph.cfg.checkpoint, "dispatch")
    for fn, _, _ in FLASH.values():
        fn.launches = 0
    g_losses = window_losses(graph)
    launches = {name: fn.launches for name, (fn, _, _) in FLASH.items()}
    e_losses = window_losses(eager)
    rel = rel_diff(g_losses, e_losses)
    print(f"dispatch {tag}: graphed vs eager, {DISPATCH_STEPS} steps in "
          f"windows of {DISPATCH_WINDOW}, max relative loss difference "
          f"{rel:.3e} (tol {DISPATCH_TOL:g}); graphed "
          f"{' '.join(f'{x:.7f}' for x in g_losses)}, eager "
          f"{' '.join(f'{x:.7f}' for x in e_losses)} [{smi}]")
    if rel:
        # the same kernels in the same order: a difference comes from a
        # kernel that is not deterministic, and shows between two eager
        # runs as well
        again = window_losses(Trainer(
            make_cfg(), seed=0, log=lambda s: None, device=dev,
            graphs=False, device_cache=False, prefetch=False))
        print(f"dispatch {tag}: eager vs eager, the same steps: max "
              f"relative loss difference {rel_diff(again, e_losses):.3e}")
    check(all(np.isfinite(g_losses)), f"dispatch {tag}: non-finite loss")
    check(rel <= DISPATCH_TOL, f"dispatch {tag}: graphed and eager "
          "losses differ")
    check(graph._g.run.captured, f"dispatch {tag}: the step was never "
          "captured")
    rec = {"run": tag, "graphed_losses": g_losses, "eager_losses": e_losses,
           "rel_diff": rel, "flash_launches": launches,
           **dispatch_times(graph, eager, DISPATCH_STEPS, units),
           "card": smi}
    print("dispatch", json.dumps(rec))
    return rec, e_losses


def _slots_only(self, new_p, new_s, res, ok=None):
    """The planted copy-back fault: the update's slots and residuals land
    in the static tensors, its params do not."""
    STORE_UPDATE(self, {}, new_s, res, ok)


STORE_UPDATE = Trainer._store_update
#: the two classic faults of a replayed step, planted in the step body:
#: name -> (net, Trainer attribute, its faulty value)
DISPATCH_FAULTS = {
    "step counter frozen": ("lenet", "_advance_step", lambda self: None),
    "update not copied back": ("mlp", "_store_update", _slots_only),
}


def dispatch_shards(tmp: str) -> dict:
    """Full-size synthetic shards (tools/dispatch_turns.write_shards):
    60000 MNIST-shaped records, the real training set's size, 50000
    CIFAR-shaped (CIFAR-10's), their test splits, the mean file and the
    LM's token shard."""
    from singa_tpu_torch.tools.dispatch_turns import write_shards

    return write_shards(tmp)


def dispatch_phase(dev, smi, cfg, params, ae_init):
    """-> {run: record}: the four nets and train_longctx graphed vs eager,
    the two planted faults, the engine call's split and serve with and
    without graphs in turns. The autoencoder starts from ``ae_init``."""
    import functools

    from singa_tpu_torch.data.pipeline import load_shard_arrays
    from singa_tpu_torch.layers.data import ShardDataLayer
    from singa_tpu_torch.tools.dispatch_turns import engine_split

    out = {}
    # every Trainer of this phase reads the same shards: decode each once
    ShardDataLayer.LOADER = staticmethod(
        functools.lru_cache(maxsize=None)(load_shard_arrays))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            shards = dispatch_shards(tmp)
            shards["ae_init"] = ae_init
            eager_losses = {}
            for name in NETS:
                out[name], eager_losses[name] = dispatch_pair(
                    dev, functools.partial(net_config, name, shards),
                    NETS[name][2], name, smi)
            for fault, (name, attr, value) in DISPATCH_FAULTS.items():
                real = getattr(Trainer, attr)
                setattr(Trainer, attr, value)
                try:
                    tr = Trainer(net_config(name, shards), seed=0,
                                 log=lambda s: None, device=dev)
                    losses = window_losses(tr)
                finally:
                    setattr(Trainer, attr, real)
                moved = rel_diff(losses, eager_losses[name])
                print(f"dispatch fault {fault!r} on {name}: graphed vs "
                      f"eager relative loss difference {moved:.3e}, "
                      f"{moved / DISPATCH_TOL:.0f}x DISPATCH_TOL")
                check(moved >= DISPATCH_FAULT_FACTOR * DISPATCH_TOL,
                      f"dispatch: the planted fault {fault!r} passes the "
                      "graphed vs eager check")

            def lm_cfg():
                c = load_model_config(TRAIN_CONF)
                for layer in c.neuralnet.layer:
                    if layer.type == "kSequenceData":
                        layer.data_param.path = shards["tokens"]
                return c

            os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "512"
            out["train_longctx"], _ = dispatch_pair(
                dev, lm_cfg, None, "train_longctx", smi)
            layers = sum(l.type == "kAttention"
                         for l in lm_cfg().neuralnet.layer)
            launches = out["train_longctx"]["flash_launches"]
            print(f"dispatch train_longctx: flash launches under graphs "
                  f"{launches}, want layers {layers} x steps "
                  f"{DISPATCH_STEPS}")
            check(launches == flash_launches(torch.bfloat16,
                                             layers * DISPATCH_STEPS),
                  "dispatch train_longctx: flash launches under graphs "
                  "!= layers x steps")
    finally:
        ShardDataLayer.LOADER = staticmethod(load_shard_arrays)
    for graphs in (False, True):
        split = engine_split(Engine(params, cfg, EngineConfig(
            slots=8, kv_block_len=16, max_prefill_chunk=64), device=dev,
            graphs=graphs))
        out[f"engine_split_{'graph' if graphs else 'eager'}"] = split
        print("dispatch engine call", "graph" if graphs else "eager",
              json.dumps(split), f"[{smi}]")
    rs = np.random.RandomState(1)
    prompts = [
        rs.randint(0, cfg.vocab, size=(int(rs.randint(32, 1025)),)).astype(
            np.int32)
        for _ in range(16)
    ]
    runs = in_turns(dev, params, cfg, prompts, {"impl": "fused"},
                    {"impl": "fused", "graphs": False})
    out["serve"] = [
        {"graphs": tag == "a", "tokens_per_s":
         (sched.tokens_emitted + len(sched.finished)) / seconds}
        for tag, sched, seconds, _ in runs]
    return out


# ---------------------------------------------------------------------------
# resnet phase
# ---------------------------------------------------------------------------


def write_resnet_shards(tmp: str) -> dict:
    """ImageNet-shaped train and test shards (imagenet_shaped_arrays: each
    record made from the seeds; the test split's noise from seed 1)."""
    out = {k: os.path.join(tmp, k) for k in ("train", "test")}
    write_records(out["train"], *imagenet_shaped_arrays(RESNET_RECORDS[0]))
    write_records(out["test"], *imagenet_shaped_arrays(
        RESNET_RECORDS[1], noise_seed=1))
    return out


def resnet_config(shards: dict, batch=None, dtype=None):
    """examples/imagenet/resnet50.conf as written (bottleneck [3, 4, 6,
    3], batch 256, crop 224, bf16, SGD with momentum and weight decay),
    read by the port's load_model_config, on the synthetic shards; the
    parity run cuts the batch and the dtype."""
    cfg = load_model_config(os.path.join(REPO, RESNET_CONF))
    if dtype is not None:
        cfg.compute_dtype = dtype
    for layer in cfg.neuralnet.layer:
        if layer.type == "kShardData":
            test = "kTrain" in (layer.exclude or [])
            layer.data_param.path = shards["test" if test else "train"]
            if batch is not None:
                layer.data_param.batchsize = batch
    return cfg


def running_stats(tr) -> dict:
    """A host copy of the BatchNorm buffers."""
    return {k: v.detach().cpu().clone() for k, v in tr.buffers.items()
            if k.endswith(("/running_mean", "/running_var"))}


def stats_diff(got: dict, want: dict) -> float:
    """max |got - want| / max(1, |want|) over every running stat."""
    check(got.keys() == want.keys(), "resnet: running stats differ in name")
    return max(float(((got[k] - want[k]).abs()
                      / want[k].abs().clamp_min(1)).max()) for k in want)


def resnet_parity(dev, smi, shards):
    """resnet50.conf at float32 with the batch cut to 8: RESNET_PARITY_STEPS
    steps on the card, each also taken on the CPU from the card's state
    (params, updater slots and running stats copied across first, so the
    check holds one step's work, not the growth of rounding over steps):
    losses within NETS_TOL relative, running stats within
    RESNET_STATS_TOL."""
    cfg = resnet_config(shards, RESNET_PARITY_BATCH, "float32")
    card = Trainer(cfg, seed=0, log=lambda s: None, device=dev)
    host = Trainer(resnet_config(shards, RESNET_PARITY_BATCH, "float32"),
                   seed=0, log=lambda s: None, device="cpu")
    rows = []
    for step in range(RESNET_PARITY_STEPS):
        host.params = {k: v.cpu() for k, v in card.params.items()}
        host.state = {n: {k: v.cpu() for k, v in slots.items()}
                      for n, slots in card.state.items()}
        host._store_buffers(running_stats(card))
        (a,), _ = net_steps(card, step, 1)
        (b,), _ = net_steps(host, step, 1)
        rows.append((a, b, abs(a - b) / abs(b),
                     stats_diff(running_stats(card), running_stats(host))))
    loss_rel = max(r[2] for r in rows)
    stats_rel = max(r[3] for r in rows)
    print(f"resnet: card vs CPU, float32, batch {RESNET_PARITY_BATCH}, "
          f"{RESNET_PARITY_STEPS} steps each from the card's state: max "
          f"relative loss difference {loss_rel:.3e} (tol {NETS_TOL:g}), "
          f"running stats {stats_rel:.3e} (tol {RESNET_STATS_TOL:g}); card "
          f"losses {' '.join(f'{r[0]:.6f}' for r in rows)}, per step loss "
          f"{' '.join(f'{r[2]:.2e}' for r in rows)}, stats "
          f"{' '.join(f'{r[3]:.2e}' for r in rows)} [{smi}]")
    check(all(np.isfinite([r[0] for r in rows])), "resnet: non-finite loss")
    check(loss_rel <= NETS_TOL, "resnet: card and CPU losses differ")
    check(stats_rel <= RESNET_STATS_TOL,
          "resnet: card and CPU running stats differ")
    return {"loss_rel": loss_rel, "stats_rel": stats_rel,
            "losses": [r[0] for r in rows]}


def bn_device_ms(dev, tr, flush) -> dict:
    """BatchNorm's device ms per step at the trainer's shapes and dtype:
    each kBatchNorm layer's training op, forward and backward, on random
    inputs of its input's shape, timed with CUDA events (time_ms), with
    the cancellation rescue and without it (ops/norm.py ``RESCUE``), in
    turns (with, without, without, with), summed over the layers."""
    dt = tr._compute_dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {True: [], False: []}
    for rescue in (True, False, False, True):
        total = 0.0
        for layer in tr.train_net.layers:
            if layer.TYPE != "kBatchNorm":
                continue
            shape = tr.train_net.name2layer[layer.srclayers[0]].out_shape
            c = shape[1]
            x = torch.randn(shape, device=dev, generator=gen).to(dt)
            x.requires_grad_(True)
            dy = torch.randn(shape, device=dev, generator=gen).to(dt)
            g = torch.ones(c, device=dev, dtype=dt, requires_grad=True)
            b = torch.zeros(c, device=dev, dtype=dt, requires_grad=True)
            shift = torch.zeros(c, device=dev)

            def run():
                y, _, _ = tnorm.batch_norm_train(x, g, b, layer.eps,
                                                 shift=shift)
                torch.autograd.grad(y, (x, g, b), dy)

            tnorm.RESCUE = rescue
            try:
                total += time_ms(run, flush, iters=5)
            finally:
                tnorm.RESCUE = True
        sums[rescue].append(total)
    with_, without = np.mean(sums[True]), np.mean(sums[False])
    return {"bn_ms": with_, "bn_ms_without_rescue": without,
            "rescue_ms": with_ - without, "runs": sums}


def _stats_not_copied(self, new_p, new_s, res, ok=None):
    """The planted fault: the graphed step copies the params, slots and
    residuals back, not the running stats."""
    STORE_UPDATE(self, new_p, new_s,
                 {k: v for k, v in res.items() if k.startswith("__")}, ok)


def release():
    """Return the memory of dropped trainers and their graphs' pools."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def resnet_phase(dev, smi):
    """resnet50.conf as written on ImageNet-shaped records: the parity
    run, then at full width (bf16, batch 256) DISPATCH_STEPS steps as
    graphed chunks on the cached dataset against DISPATCH_STEPS eager
    steps from the same params (window losses and the final running
    stats within DISPATCH_TOL), the planted stats fault (must move the
    stats by DISPATCH_FAULT_FACTOR x DISPATCH_TOL), step ms and images/s
    of both, the graphed chunk's device ms and idle share, its 5 largest
    kernels, BatchNorm's device ms with and without the rescue, peak
    memory, and one eval batch from the running stats."""
    import functools

    from singa_tpu_torch.data.pipeline import load_shard_arrays
    from singa_tpu_torch.layers.data import ShardDataLayer
    from singa_tpu_torch.tools.dispatch_turns import profiled_device_ms

    ShardDataLayer.LOADER = staticmethod(
        functools.lru_cache(maxsize=None)(load_shard_arrays))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            shards = write_resnet_shards(tmp)
            print(f"resnet: wrote {RESNET_RECORDS} ImageNet-shaped records "
                  f"in {time.perf_counter() - t0:.1f} s")
            rec = {"parity": resnet_parity(dev, smi, shards)}
            batch = resnet_config(shards).neuralnet.layer[0] \
                .data_param.batchsize

            torch.cuda.reset_peak_memory_stats(dev)
            graph = Trainer(resnet_config(shards), seed=0,
                            log=lambda s: None, device=dev,
                            device_cache=True)
            check(graph.dispatch_mode == "graph"
                  and graph.feeder_mode == "cached",
                  f"resnet: not a graphed step on the cached dataset "
                  f"({graph.dispatch_mode}, {graph.feeder_mode})")
            g_losses = window_losses(graph)
            g_stats = running_stats(graph)
            check(graph._g.run.captured, "resnet: the step was never "
                  "captured")
            s0 = DISPATCH_STEPS
            rec["step_ms"] = chunk_ms(graph, s0, DISPATCH_STEPS)
            dev_ms, enqueue_ms = chunk_device_ms(graph, 2 * s0,
                                                 DISPATCH_STEPS)
            prof_ms, top = profiled_device_ms(
                lambda: graph.train_chunk(3 * s0, 3), 3)
            graph.perf.reset()
            test = graph.evaluate(graph.test_net, 1, "test",
                                  3 * s0 + 3)["loss"]
            check(all(np.isfinite(list(test.values()))),
                  "resnet: non-finite eval metric")
            flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
            bn = bn_device_ms(dev, graph, flush)
            rec.update({
                "conf": RESNET_CONF, "batch": batch,
                "images_per_s": batch / rec["step_ms"] * 1e3,
                "device_ms_per_step": dev_ms,
                "idle_share": 1.0 - dev_ms / rec["step_ms"],
                "chunk_enqueue_ms": enqueue_ms,
                "profiled_device_ms_per_step": prof_ms, "top5": top,
                "test": test, **bn,
                "bn_share_of_device_ms": bn["bn_ms"] / dev_ms,
                "peak_memory_gb_graphed":
                    torch.cuda.max_memory_allocated(dev) / 1e9})
            del graph
            release()

            torch.cuda.reset_peak_memory_stats(dev)
            eager = Trainer(resnet_config(shards), seed=0,
                            log=lambda s: None, device=dev, graphs=False,
                            device_cache=False, prefetch=False)
            e_losses = window_losses(eager)
            e_stats = running_stats(eager)
            rec["eager_step_ms"] = chunk_ms(eager, s0, 10)
            rec["eager_images_per_s"] = batch / rec["eager_step_ms"] * 1e3
            rec["peak_memory_gb_eager"] = (
                torch.cuda.max_memory_allocated(dev) / 1e9)
            del eager
            release()
            rel = rel_diff(g_losses, e_losses)
            srel = stats_diff(g_stats, e_stats)
            print(f"resnet: graphed vs eager, {DISPATCH_STEPS} bf16 steps "
                  f"at batch {batch} in windows of {DISPATCH_WINDOW}: max "
                  f"relative loss difference {rel:.3e}, running stats "
                  f"{srel:.3e} (tol {DISPATCH_TOL:g}); graphed "
                  f"{' '.join(f'{x:.7f}' for x in g_losses)}, eager "
                  f"{' '.join(f'{x:.7f}' for x in e_losses)} [{smi}]")
            check(all(np.isfinite(g_losses)), "resnet: non-finite loss")
            check(g_losses[-1] < g_losses[0], "resnet: loss did not fall")
            check(rel <= DISPATCH_TOL and srel <= DISPATCH_TOL,
                  "resnet: graphed and eager steps differ")

            Trainer._store_update = _stats_not_copied
            try:
                faulty = Trainer(resnet_config(shards), seed=0,
                                 log=lambda s: None, device=dev,
                                 device_cache=True)
                window_losses(faulty)
                moved = stats_diff(running_stats(faulty), e_stats)
            finally:
                Trainer._store_update = STORE_UPDATE
            del faulty
            release()
            print(f"resnet fault 'running stats not copied back': graphed "
                  f"vs eager running stats {moved:.3e}, "
                  f"{moved / DISPATCH_TOL:.0f}x DISPATCH_TOL")
            check(moved >= DISPATCH_FAULT_FACTOR * DISPATCH_TOL,
                  "resnet: the planted stats fault passes the check")
            rec.update({"graphed_losses": g_losses, "eager_losses": e_losses,
                        "rel_diff": rel, "stats_diff": srel,
                        "fault_stats_diff": moved, "card": smi})
            print("resnet", json.dumps(rec))
            return rec
    finally:
        ShardDataLayer.LOADER = staticmethod(load_shard_arrays)


# ---------------------------------------------------------------------------
# lmdb phase
# ---------------------------------------------------------------------------


def timed(fn):
    """-> (fn(), host ms)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def same_arrays(a, b) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def lmdb_config(path: str, layer_type: str):
    """examples/mnist/mlp.conf as written, its data layers (train and
    test) of ``layer_type`` on ``path``."""
    cfg = load_model_config(os.path.join(REPO, LMDB_CONF))
    cfg.checkpoint = None
    for layer in cfg.neuralnet.layer:
        if layer.type == "kShardData":
            layer.type = layer_type
            layer.data_param.path = path
    return cfg


def lmdb_losses(dev, path, layer_type, graphed):
    """LMDB_STEPS float32 steps from the seed-0 params: eager per-step
    steps on host batches, or one-step graphed chunks on the cached
    dataset (replays after the capture) -> per-step losses."""
    kw = {} if graphed else dict(graphs=False, device_cache=False,
                                 prefetch=False)
    tr = Trainer(lmdb_config(path, layer_type), seed=0, log=lambda s: None,
                 device=dev, **kw)
    check(tr.dispatch_mode == ("graph" if graphed else "eager"),
          f"lmdb {layer_type}: dispatch {tr.dispatch_mode}")
    losses = []
    for step in range(LMDB_STEPS):
        if graphed:
            tr.train_chunk(step, 1)
        else:
            tr.train_one_batch(step)
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    if graphed:
        check(tr._g.run.captured, f"lmdb {layer_type}: never captured")
    return losses


def lmdb_phase(dev, smi):
    """The native codecs, LMDB and kLMDBData. No kernel of csrc/ lies on
    this path: the codecs run on the host (g++ builds them into
    singa_tpu_torch/_build/); training runs PyTorch's own kernels."""
    from singa_tpu_torch.data import pipeline as tp
    from singa_tpu_torch.data.loader import lmdb_to_shard, shard_to_lmdb

    rec = {"records": LMDB_RECORDS, "card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        shard, db, back = (os.path.join(tmp, k)
                           for k in ("mnist", "mnist_lmdb", "roundtrip"))
        write_records(shard, *synthetic_arrays(LMDB_RECORDS, seed=0))
        served = dict(tp.served)
        shard_arr, rec["shard_native_ms"] = timed(
            lambda: tp.load_shard_arrays(shard))
        shard_py, rec["shard_python_ms"] = timed(
            lambda: tp.python_shard_arrays(shard))
        check(same_arrays(shard_arr, shard_py),
              "lmdb: native and Python shard codecs decode differently")
        _, rec["shard2lmdb_ms"] = timed(lambda: shard_to_lmdb(shard, db))
        lmdb_arr, rec["lmdb_native_ms"] = timed(
            lambda: tp.load_lmdb_arrays(db))
        lmdb_py, rec["lmdb_python_ms"] = timed(
            lambda: tp.python_lmdb_arrays(db))
        check(same_arrays(lmdb_arr, lmdb_py),
              "lmdb: native walker and LMDBReader decode differently")
        check(lmdb_arr[0].shape == (LMDB_RECORDS, 1, 28, 28)
              and np.array_equal(lmdb_arr[0][:, 0], shard_arr[0])
              and np.array_equal(lmdb_arr[1], shard_arr[1]),
              "lmdb: the database's arrays differ from the shard's")
        _, rec["lmdb2shard_ms"] = timed(lambda: lmdb_to_shard(db, back))
        check(same_arrays(tp.load_shard_arrays(back), lmdb_arr),
              "lmdb: lmdb2shard's records differ from the database's")
        runs = {}
        for layer_type, path in (("kShardData", shard), ("kLMDBData", db)):
            for graphed in (False, True):
                tag = f"{layer_type}_{'graphed' if graphed else 'eager'}"
                runs[tag] = lmdb_losses(dev, path, layer_type, graphed)
                check(all(np.isfinite(runs[tag])),
                      f"lmdb {tag}: non-finite loss")
        for mode in ("eager", "graphed"):
            check(runs[f"kLMDBData_{mode}"] == runs[f"kShardData_{mode}"],
                  f"lmdb: kLMDBData losses ({mode}) differ from "
                  "kShardData's")
        rec["losses"] = runs
        rec["served"] = {k: tp.served[k] - served.get(k, 0)
                         for k in tp.served}
    check(rec["served"].get("shard/python", 0) == 1
          and rec["served"].get("lmdb/python", 0) == 1,
          "lmdb: the Python codecs served a load other than the "
          f"comparison's: {rec['served']}")
    check(rec["served"].get("shard/native", 0) >= 3
          and rec["served"].get("lmdb/native", 0) >= 2,
          f"lmdb: the native codecs did not serve: {rec['served']}")
    print("lmdb", json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# moe phase
# ---------------------------------------------------------------------------


def moe_config(shard: str, dtype=None):
    """examples/lm/tinylm_moe.conf as written (``dtype`` overrides its
    compute_dtype) on ``shard``."""
    cfg = load_model_config(os.path.join(REPO, MOE_CONF))
    if dtype:
        cfg.compute_dtype = dtype
    for layer in cfg.neuralnet.layer:
        if layer.type == "kSequenceData":
            layer.data_param.path = shard
    return cfg


def moe_train_run(dev, shard, smi, flash: bool):
    """The conf as written (bf16) from the seed-0 params, graphed
    (DISPATCH_STEPS steps as chunks of DISPATCH_WINDOW on the cached
    dataset) and eager (host batches): finite, falling window losses,
    graphed within DISPATCH_TOL of eager, the bf16 flash kernels'
    launches = attention layers x steps on the flash route (the score
    switch at 0) and 0 on the dense one (its default); then the times
    (dispatch_times) and the peak memory above what was allocated
    before."""
    tag = "flash" if flash else "dense"
    os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "0" if flash else "512"
    release()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    graph = Trainer(moe_config(shard), seed=0, log=lambda s: None,
                    device=dev)
    eager = Trainer(moe_config(shard), seed=0, log=lambda s: None,
                    device=dev, graphs=False, device_cache=False,
                    prefetch=False)
    check(graph.dispatch_mode == "graph" and graph.feeder_mode == "cached",
          f"moe {tag}: not a graphed step on the cached dataset")
    layers = sum(l.type == "kAttention" for l in graph.cfg.neuralnet.layer)
    want = flash_launches(torch.bfloat16,
                          layers * DISPATCH_STEPS if flash else 0)
    windows, launches = {}, {}
    for name, tr in (("graphed", graph), ("eager", eager)):
        for fn, _, _ in FLASH.values():
            fn.launches = 0
        windows[name] = window_losses(tr)
        launches[name] = {n: fn.launches for n, (fn, _, _) in FLASH.items()}
        check(launches[name] == want, f"moe {tag} {name}: flash launches "
              f"{launches[name]} != {want}")
        check(all(np.isfinite(windows[name])),
              f"moe {tag} {name}: non-finite loss")
        check(windows[name][-1] < windows[name][0],
              f"moe {tag} {name}: loss did not fall")
    rel = rel_diff(windows["graphed"], windows["eager"])
    check(rel <= DISPATCH_TOL, f"moe {tag}: graphed and eager losses differ")
    check(graph._g.run.captured, f"moe {tag}: the step was never captured")
    out = {"run": tag, "conf": MOE_CONF, "steps": DISPATCH_STEPS,
           "windows": windows, "rel_diff": rel, "launches": launches,
           **dispatch_times(graph, eager, DISPATCH_STEPS,
                            graph.tokens_per_step),
           # both trainers' params, states and datasets, the graph's
           # pool, over what earlier phases left allocated
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
           "card": smi}
    print("moe train", json.dumps(out))
    del graph, eager
    release()
    os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "512"
    return out


def moe_parity(dev, shard, smi):
    """MOE_PARITY_STEPS float32 steps of the conf on the card and on the
    CPU from the same seed-0 params: losses within NETS_TOL relative."""
    os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "512"
    card = Trainer(moe_config(shard, "float32"), seed=0, log=lambda s: None,
                   device=dev)
    host = Trainer(moe_config(shard, "float32"), seed=0, log=lambda s: None,
                   device="cpu")
    ours, _ = net_steps(card, 0, MOE_PARITY_STEPS)
    ref, _ = net_steps(host, 0, MOE_PARITY_STEPS)
    rel = rel_diff(ours, ref)
    print(f"moe: card vs CPU over {MOE_PARITY_STEPS} float32 steps, max "
          f"relative loss difference {rel:.3e} (tol {NETS_TOL:g}); card "
          f"{' '.join(f'{x:.7f}' for x in ours)} [{smi}]")
    check(rel <= NETS_TOL, "moe: card and CPU losses differ")
    del card, host
    release()
    return rel


def moe_forms(dev, dtype):
    """The index form (the main path) and the dense plain form (the JAX
    form) at the conf's width (MOE_WIDTH: N = 64 x 256 tokens, D 256, E
    8, F 1024; cf 1.25) on the same seeded inputs -> (y, aux and, at float32, the
    grads of sum(y * dy) + aux) of each."""
    rs = np.random.RandomState(0)
    b, s, d, n_exp, f = MOE_WIDTH
    # x's mean shifts each expert's logit by its own amount: the load is
    # uneven and the fullest queues drop tokens at cf 1.25
    x = torch.from_numpy(rs.randn(b, s, d).astype(np.float32) + 0.5)
    p = {"gate": rs.randn(d, n_exp) / np.sqrt(d),
         "up": rs.randn(n_exp, d, f) / np.sqrt(d),
         "down": rs.randn(n_exp, f, d) / np.sqrt(f)}
    dy = torch.from_numpy(rs.randn(b, s, d).astype(np.float32)).to(dev)
    out = {}
    for form, fn in (("index", tmoe.moe_ffn_dense),
                     ("plain", tmoe.moe_ffn_dense_plain)):
        tx = x.to(dev, dtype).requires_grad_(dtype == torch.float32)
        tp = {k: torch.from_numpy(v.astype(np.float32)).to(dev, dtype)
              .requires_grad_(dtype == torch.float32) for k, v in p.items()}
        y, aux = fn(tx, tp, 1.25)
        grads = {}
        if dtype == torch.float32:
            ((y * dy).sum() + aux).backward()
            grads = {"x": tx.grad, **{k: v.grad for k, v in tp.items()}}
        out[form] = (y.detach(), aux.detach(), grads)
    x2d = x.reshape(-1, d).to(dev)
    *_, pos = tmoe._probs_and_choice(x2d, torch.from_numpy(
        p["gate"].astype(np.float32)).to(dev))
    out["drops"] = int((pos >= tmoe.capacity_of(len(x2d), n_exp, 1.25))
                       .sum())
    return out


def moe_index_check(dev, smi):
    """Index form vs plain at full width on the card: the forward
    (float32 and bf16) to the bit, every grad within MOE_GRAD_TOL of its
    largest entry (printed: 0.0 where equal to the bit); then
    a planted fault (the capacity mask dropped: over-capacity tokens
    spill into the next expert's places) must break the forward's
    equality. Times of both forms' forward + backward."""
    rec = {"card": smi}
    for dtype in (torch.float32, torch.bfloat16):
        o = moe_forms(dev, dtype)
        (y, aux, g), (y0, aux0, g0) = o["index"], o["plain"]
        name = str(dtype).split(".")[-1]
        rec["dropped_tokens"] = o["drops"]
        check(o["drops"] > 0, "moe: no token dropped; the capacity path "
              "is not exercised")
        rec[f"forward_bitwise_{name}"] = bool(torch.equal(y, y0)
                                               and torch.equal(aux, aux0))
        check(rec[f"forward_bitwise_{name}"],
              f"moe: index and plain forms differ ({name})")
        for k in g:
            diff = float((g[k] - g0[k]).abs().max() / g0[k].abs().max())
            rec[f"grad_{k}_rel"] = diff
            check(diff <= MOE_GRAD_TOL, f"moe: grad of {k} differs by "
                  f"{diff}")
    slots = tmoe._slots
    tmoe._slots = lambda expert, pos, c, e: (
        expert * c + pos.long()).clamp(max=e * c)
    try:
        o = moe_forms(dev, torch.float32)
    finally:
        tmoe._slots = slots
    rec["fault_max_abs"] = float((o["index"][0] - o["plain"][0]).abs().max())
    check(rec["fault_max_abs"] > 0,
          "moe: the capacity-mask fault passes the index vs plain check")
    # times, forward + backward of each form at float32
    rs = np.random.RandomState(1)
    b, s, d, n_exp, f = MOE_WIDTH
    x = torch.from_numpy(rs.randn(b, s, d).astype(np.float32)).to(dev)
    p = {k: torch.from_numpy(rs.randn(*shape).astype(np.float32) * 0.05)
         .to(dev) for k, shape in (("gate", (d, n_exp)),
                                   ("up", (n_exp, d, f)),
                                   ("down", (n_exp, f, d)))}
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    for form, fn in (("index", tmoe.moe_ffn_dense),
                     ("plain", tmoe.moe_ffn_dense_plain)):
        def call(fn=fn):
            xg = x.detach().requires_grad_(True)
            y, aux = fn(xg, {k: v.detach().requires_grad_(True)
                             for k, v in p.items()}, 1.25)
            (y.sum() + aux).backward()
        rec[f"{form}_fwd_bwd_ms"] = time_ms(call, flush, iters=5)
    print("moe forms", json.dumps(rec))
    release()
    return rec


def moe_engine_split(dev, smi, cfg, params):
    """One graphed decode call of the MoE LM and of the same LM with its
    dense FFN (the serve phase's model), split by where the time goes
    (dispatch_turns.engine_split)."""
    import dataclasses

    from singa_tpu_torch.tools.dispatch_turns import engine_split

    dense = dataclasses.replace(cfg, moe_experts=0)
    for tag, c, p in (("moe", cfg, params), ("dense", dense, init_lm(
            torch.Generator().manual_seed(0), dense, dev))):
        split = engine_split(Engine(p, c, EngineConfig(
            slots=8, kv_block_len=16, max_prefill_chunk=64), device=dev))
        print(f"moe serve engine call {tag}", json.dumps(split), f"[{smi}]")


def moe_phase(dev, smi):
    """kMoE's dense path: tinylm_moe.conf trained as written through the
    bf16 flash kernels and through dense attention, card vs CPU, the
    index form vs its plain version, and the serve phase's d128 LM with 8
    experts behind the Engine (the paged-attention kernel). -> the
    kernels' launch counts on the moe train (flash) and serve paths."""
    with tempfile.TemporaryDirectory() as tmp:
        shard = os.path.join(tmp, "tokens")
        write_records(shard, *synthetic_token_arrays(
            MOE_SEQS[0], seq_len=MOE_SEQS[1], vocab=256, seed=0))
        runs = {flash: moe_train_run(dev, shard, smi, flash)
                for flash in (True, False)}
        moe_parity(dev, shard, smi)
    moe_index_check(dev, smi)
    cfg = TransformerConfig(vocab=256, d_model=256, n_heads=2, n_layers=2,
                            d_ff=1024, max_len=2048, moe_experts=8)
    params = init_lm(torch.Generator().manual_seed(0), cfg, dev)
    print(f"moe serve: the serve phase's LM with moe_experts "
          f"{cfg.moe_experts}, d_ff {cfg.d_ff} [{smi}]")
    serve_launches = serve_phase(dev, cfg, params)
    moe_engine_split(dev, smi, cfg, params)
    del params
    release()
    return {**runs[True]["launches"]["graphed"],
            "paged_attention": serve_launches}


# ---------------------------------------------------------------------------
# decode phase: the conf-net KV-cache decode and tools/generate.py
# ---------------------------------------------------------------------------


def tinylm_conf_text(shard: str, extra: str = "") -> str:
    """examples/lm/tinylm.conf as written (bf16, d 256, 4 heads, 2
    blocks, vocab 256, batch 64) over ``shard``, plus ``extra``."""
    with open(os.path.join(REPO, TINYLM_CONF)) as f:
        txt = f.read()
    check("examples/lm/train_shard" in txt, "tinylm.conf: no data path")
    return txt.replace("examples/lm/train_shard", shard) + "\n" + extra


def generate_cli(conf: str, ckpt: str, dev) -> tuple[list[int], str]:
    """``python -m singa_tpu_torch.tools.generate -raw`` on ``dev`` in a
    process of its own -> (its tokens, its stderr)."""
    cmd = [sys.executable, "-m", "singa_tpu_torch.tools.generate",
           "-model_conf", conf, "-checkpoint", ckpt, "-prompt",
           DECODE_PROMPT, "-n", str(DECODE_NEW), "-raw",
           "-device", dev.type]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=DECODE_TIMEOUT_S)
    check(res.returncode == 0,
          f"decode: generate exited {res.returncode}: {res.stderr[-2000:]}")
    return [int(t) for t in res.stdout.split()], res.stderr


def recorded_decode(net, params, prompt, chunk):
    """Untimed greedy runs of both paths with the last logits of each
    emitted token recorded as the path computed them (they also warm
    the kernels and cuBLAS shapes of the timed runs) -> {path: (tokens,
    (DECODE_NEW, vocab) logits)}."""
    from singa_tpu_torch.tools.generate import rolling_generate_from_net

    dec, kv = NetDecoder(net, max_prefill_chunk=chunk), []
    step = dec._step_impl

    def kv_step(*a):
        kv.append(step(*a))
        return kv[-1]

    dec._step_impl = kv_step
    toks = dec.generate(params, prompt, DECODE_NEW, 0.0, 0)
    rows, forward = [], net.forward

    def rolling_forward(*a, **kw):
        out = forward(*a, **kw)
        # the rolling path reads the last live position of its window
        rows.append(out[2][dec.head][0, len(prompt) - 1 + len(rows)])
        return out

    net.forward = rolling_forward
    try:
        rolling = rolling_generate_from_net(net, params, prompt,
                                            DECODE_NEW, 0.0, 0)
    finally:
        del net.forward
    # the last prefill chunk's logits, then one (1, 1) step a token
    return {"kv_cache": (toks, torch.stack(kv[-DECODE_NEW:])),
            "rolling": (rolling, torch.stack(rows))}


def _decode_step_late(self, params, x, cache, pos):
    """Planted fault: K/V written and attended one position late, so
    every query also attends a never-written (zero) slot 0."""
    return DECODE_STEP(self, params, x, cache, pos + 1)


DECODE_STEP = AttentionLayer.decode_step


def decode_paths(net, params, prompt, dev, serving):
    """The KV-cache and the rolling decode of ``prompt`` on ``dev``:
    recorded untimed, then each timed to a device sync, the rolling
    run's flash launches counted -> ({path: (tokens, tokens/s)},
    {path: (tokens, logits)}, the rolling run's flash launches)."""
    from singa_tpu_torch.tools.generate import (
        generate_from_net,
        rolling_generate_from_net,
    )

    recorded = recorded_decode(
        net, params, prompt, EngineConfig.from_conf(serving).max_prefill_chunk)
    out = {}
    for path in ("kv_cache", "rolling"):
        info = {}
        for fn, _, _ in FLASH.values():
            fn.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        if path == "kv_cache":
            toks = generate_from_net(net, params, prompt, DECODE_NEW, 0.0,
                                     0, serving=serving, info=info)
            check(info["path"] == "kv_cache",
                  f"decode: generate_from_net took {info} on {dev}")
        else:
            toks = rolling_generate_from_net(net, params, prompt,
                                             DECODE_NEW, 0.0, 0)
        sync(dev)
        out[path] = (toks, DECODE_NEW / (time.perf_counter() - t0))
    rolling = {n: fn.launches for n, (fn, _, _) in FLASH.items()}
    return out, recorded, rolling


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_phase(dev, smi, shard):
    """tinylm.conf as written: DECODE_STEPS graphed steps through the
    bf16 flash kernels, an npz save, then greedy decode of DECODE_NEW
    tokens: the generate CLI on the card (it must report the KV-cache
    path), the KV-cache and rolling paths in this process on the card
    (tokens/s of each) and the KV-cache path on the CPU, all four
    streams equal; on the card the last logits of every emitted token
    of the two paths within DECODE_LOGIT_TOL, and a planted cache fault
    (K/V one position late) that must break that bound. (The rolling
    path runs a (1, S) forward per token: on the card its attention is
    the float32 flash forward, layers x DECODE_NEW launches.) -> (the
    flash launches of the training run, of the rolling decode)."""
    from singa_tpu_torch.graph.builder import build_net
    from singa_tpu_torch.trainer.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        conf = os.path.join(tmp, "tinylm.conf")
        with open(conf, "w") as f:
            f.write(tinylm_conf_text(shard))
        cfg = load_model_config(conf)
        tr = Trainer(cfg, seed=0, log=lambda s: None, device=dev)
        layers = sum(l.type == "kAttention" for l in cfg.neuralnet.layer)
        for fn, _, _ in FLASH.values():
            fn.launches = 0
        losses = []
        for step in range(DECODE_STEPS):
            tr.train_one_batch(step)
            losses.append(tr.perf.avg()["loss"]["loss"])
            tr.perf.reset()
        launches = {n: fn.launches for n, (fn, _, _) in FLASH.items()}
        want = flash_launches(torch.bfloat16, layers * DECODE_STEPS)
        check(launches == want,
              f"decode: training flash launches {launches} != {want}")
        check(all(np.isfinite(losses)), "decode: non-finite training loss")
        ckpt = os.path.join(tmp, "tinylm.npz")
        save_checkpoint(ckpt, DECODE_STEPS, tr.params, tr.state, tr.buffers)
        del tr
        release()
        cli, err = generate_cli(conf, ckpt, dev)
        check(f"path kv_cache, device {dev.type}" in err,
              f"decode: the CLI did not report the KV-cache path on "
              f"{dev.type}: {err[-500:]}")
        net = build_net(cfg, "kTest")
        arrays = load_checkpoint(ckpt)[1]
        prompt = [b % 256 for b in DECODE_PROMPT.encode()]
        params = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        on_card, logits, rolling_launches = decode_paths(
            net, params, prompt, dev, cfg.serving)
        chunk = EngineConfig.from_conf(cfg.serving).max_prefill_chunk
        AttentionLayer.decode_step = _decode_step_late
        try:
            late = recorded_decode(net, params, prompt, chunk)["kv_cache"]
        finally:
            AttentionLayer.decode_step = DECODE_STEP
        cpu_params = {k: torch.from_numpy(v) for k, v in arrays.items()}
        (cpu_kv, cpu_ms) = timed(lambda: NetDecoder(
            net, max_prefill_chunk=chunk).generate(
                cpu_params, prompt, DECODE_NEW, 0.0, 0))
    kv, rolling = on_card["kv_cache"], on_card["rolling"]
    want_rolling = {n: layers * DECODE_NEW if n == "flash_fwd" else 0
                    for n in FLASH}
    ref = logits["rolling"][1]
    logit_err = (logits["kv_cache"][1] - ref).abs().max().item()
    late_err = (late[1] - ref).abs().max().item()
    out = {"conf": TINYLM_CONF, "train_steps": DECODE_STEPS,
           "losses": losses, "flash_launches": launches,
           "prompt_tokens": len(prompt), "new_tokens": DECODE_NEW,
           "max_positions": net.datalayers[0].out_shape[1],
           "kv_tokens_per_s": kv[1], "rolling_tokens_per_s": rolling[1],
           "kv_speedup": kv[1] / rolling[1],
           "cpu_kv_tokens_per_s": DECODE_NEW / cpu_ms * 1e3,
           "rolling_flash_launches": rolling_launches,
           "logits_max_abs": ref.abs().max().item(),
           "kv_vs_rolling_logit_err": logit_err,
           "planted_late_kv_logit_err": late_err,
           "planted_late_kv_stream_differs": late[0] != logits["rolling"][0],
           "cli_stderr": err.strip().splitlines()[-1], "card": smi}
    print("decode", json.dumps(out))
    check(rolling_launches == want_rolling,
          f"decode: rolling flash launches {rolling_launches} != "
          f"{want_rolling}")
    check(logit_err <= DECODE_LOGIT_TOL,
          f"decode: KV-cache logits {logit_err} from the rolling path's "
          f"(> {DECODE_LOGIT_TOL})")
    check(late_err > DECODE_LOGIT_TOL,
          "decode: K/V written one position late passed the logits check")
    check(all(logits[path][0] == on_card[path][0] for path in logits),
          "decode: the recorded runs' streams differ from the timed runs'")
    check(kv[0] == rolling[0],
          "decode: the KV-cache stream differs from the rolling stream")
    check(kv[0] == cpu_kv, "decode: the card's stream differs from the "
          "CPU's")
    check(cli == kv[0], "decode: the CLI's stream differs from the "
          "in-process KV-cache stream")
    return launches, rolling_launches["flash_fwd"]


# ---------------------------------------------------------------------------
# zero phase: zero_update, the ring, sharded saves and resharding
# ---------------------------------------------------------------------------


def zero_trainer(dev, shard, ranks, *, zero, ring, workspace=None,
                 checkpoint=None):
    """tinylm.conf as written with ``kernels { paged_attention: fused }``
    (the serving knob, trained unchanged), on ``ranks`` ranks of ``dev``;
    ``ring``: the q8wire tag (the int8 ring, 4 buckets); sharded saves
    into ``workspace``."""
    from singa_tpu_torch.config import parse_cluster_config, parse_model_config

    extra = ("kernels { paged_attention: fused }\n"
             'checkpoint_format: "sharded"\n'
             f"zero_update: {'true' if zero else 'false'}\n")
    cfg = parse_model_config(tinylm_conf_text(shard, extra))
    if ring:
        apply_grad_comm_tag(cfg, "q8wire")
        cfg.grad_comm.buckets = 4
    if checkpoint:
        cfg.checkpoint = checkpoint
    cl = (parse_cluster_config(f'workspace: "{workspace}"')
          if workspace else None)
    return Trainer(cfg, cl, mesh=build_mesh(ranks, 1, [dev] * ranks),
                   seed=0, log=lambda s: None)


def zero_losses(tr, steps):
    """``steps`` steps -> (losses, step ms median to a device sync)."""
    losses, ms = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        tr.train_one_batch(step)
        sync(tr.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    return losses, sorted(ms)[len(ms) // 2]


def bitwise(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _stitch_shifted(self, fresh):
    """Planted fault: rank r's fresh shard written at rank r+1's offset."""
    return STITCH_ZERO(self, fresh[1:] + fresh[:1])


STITCH_ZERO = Trainer._stitch_zero


def zero_pair(dev, shard, ring, smi, workspace=None):
    """Zero against replicated (``ring``: both through the int8 ring) on
    ZERO_RANKS ranks, ZERO_STEPS steps each from the seed-0 params:
    losses, params and slots equal to the bit; the flash and quant_acc
    launches of each run; slot bytes per rank. -> (the record, the zero
    trainer, which saves into ``workspace``)."""
    runs = {}
    for zero in (True, False):
        tr = zero_trainer(dev, shard, ZERO_RANKS, zero=zero, ring=ring,
                          workspace=workspace if zero else None)
        qc.quant_acc.launches = 0
        for fn, _, _ in FLASH.values():
            fn.launches = 0
        losses, ms = zero_losses(tr, ZERO_STEPS)
        runs[zero] = (tr, losses, ms, qc.quant_acc.launches,
                      {n: fn.launches for n, (fn, _, _) in FLASH.items()})
    (tz, lz, mz, qz, fz), (tr, lr, mr, qr, fr) = runs[True], runs[False]
    tag = "zero+ring vs ring" if ring else "zero vs replicated"
    out = {"pair": tag, "ranks": ZERO_RANKS, "steps": ZERO_STEPS,
           "zero_losses": lz, "losses": lr, "zero_step_ms": mz,
           "step_ms": mr, "zero_quant_acc_launches": qz,
           "quant_acc_launches": qr,
           "zero_slot_bytes_per_rank": tz.opt_state_bytes_per_device(),
           "slot_bytes_per_rank": tr.opt_state_bytes_per_device(),
           "card": smi}
    print("zero", json.dumps(out))
    check(tz.update_mode == "zero" and tr.update_mode == "replicated",
          f"zero {tag}: update modes {tz.update_mode}, {tr.update_mode}")
    check(lz == lr, f"zero {tag}: losses differ")
    check(bitwise(tz.params, tr.params), f"zero {tag}: params differ")
    check(all(bitwise(tz.state[n], tr.state[n]) for n in tr.state),
          f"zero {tag}: slots differ")
    check(tz.opt_state_bytes_per_device() * ZERO_RANKS
          == tr.opt_state_bytes_per_device(),
          f"zero {tag}: slot bytes per rank not 1/{ZERO_RANKS}")
    layers = sum(l.type == "kAttention" for l in tz.cfg.neuralnet.layer)
    want = flash_launches(torch.bfloat16, layers * ZERO_RANKS * ZERO_STEPS)
    check(fz == fr == want, f"zero {tag}: flash launches {fz}, {fr} != {want}")
    # ranks x buckets x reduce hops (the allgather launches none); the
    # conf's 8192-row positional table leaves 2 of the 4 buckets
    per_step = (ZERO_RANKS * len(tz._buckets(list(tz.params)))
                * (ZERO_RANKS - 1) if ring else 0)
    check(qz == qr == per_step * ZERO_STEPS,
          f"zero {tag}: quant_acc launches {qz}, {qr} != "
          f"{per_step * ZERO_STEPS}")
    del tr
    return out, tz


def zero_phase(dev, smi, shard):
    """zero_update on ZERO_RANKS ranks sharing the card: against the
    replicated update and, through the int8 ring, against the ring alone
    (bitwise both), with a planted stitch fault that must break the
    first; the zero + ring trainer's sharded save restored on 2 ranks
    (arrays bitwise), a missing commit marker that must make the save
    unresumable, and an Engine booted through load_serving_params from
    the sharded save streaming as one booted from the npz save, through
    the paged kernel. -> (the quant_acc launches of the zero + ring run,
    its digest and losses, for the procs phase)."""
    from singa_tpu_torch.resilience import retention
    from singa_tpu_torch.resilience.reshard import load_serving_params
    from singa_tpu_torch.trainer.sharded_ckpt import ShardedCheckpoint

    plain, tz = zero_pair(dev, shard, False, smi)
    del tz
    release()
    Trainer._stitch_zero = _stitch_shifted
    try:
        tf = zero_trainer(dev, shard, ZERO_RANKS, zero=True, ring=False)
        fault_losses, _ = zero_losses(tf, 2)
    finally:
        Trainer._stitch_zero = STITCH_ZERO
    print(f"zero planted stitch fault: losses {fault_losses} against "
          f"{plain['losses'][:2]}")
    check(fault_losses != plain["losses"][:2],
          "zero: a shard stitched at the wrong offset passed the check")
    del tf
    release()
    with tempfile.TemporaryDirectory() as tmp:
        ring, tz = zero_pair(dev, shard, True, smi, workspace=tmp)
        folder = os.path.join(tmp, "checkpoints")
        sharded, save_ms = timed(lambda: tz.save(ZERO_STEPS))
        npz = save_checkpoint(os.path.join(tmp, "step.npz"), ZERO_STEPS,
                              tz.params, tz.state, tz.buffers)
        with ShardedCheckpoint(sharded) as ck:
            saved = {k: ck.assemble(k) for k in ck.keys()}
        (t2, restore_ms) = timed(lambda: zero_trainer(
            dev, shard, 2, zero=True, ring=True, checkpoint=sharded))
        got = {f"p|{n}": v for n, v in t2.params.items()}
        got.update({f"s|{n}|{s}": v for n, sl in t2.state.items()
                    for s, v in sl.items()})
        got.update({f"b|{n}": v for n, v in t2.buffers.items()})
        check(got.keys() == saved.keys()
              and all(np.array_equal(got[k].cpu().numpy(), saved[k])
                      for k in saved),
              "zero: the 4-rank sharded save restored on 2 ranks differs")
        del t2
        release()
        check(retention.resolve_latest(folder) == sharded,
              "zero: the sharded save does not resolve as the latest")
        # the planted fault: the save's commit marker is lost
        marker = os.path.join(sharded, "commit_0.json")
        kept = open(marker, "rb").read()
        os.remove(marker)
        torn_caught = (not retention.validate_checkpoint(sharded)
                       and retention.resolve_latest(folder) is None)
        with open(marker, "wb") as f:
            f.write(kept)
        check(torn_caught, "zero: a save without its commit marker "
              "still validates")
        lm = TransformerConfig(vocab=256, d_model=256, n_heads=4,
                               n_layers=2, d_ff=1024,
                               max_len=tz.train_net.datalayers[0]
                               .out_shape[1])
        init = init_lm(torch.Generator().manual_seed(0), lm, dev)
        serving = EngineConfig.from_conf(tz.cfg.serving, tz.cfg.kernels)
        check(serving.attend_impl == "fused",
              "zero: the conf's engine does not take the paged kernel")
        a, ia = load_serving_params(npz, init)
        b, ib = load_serving_params(folder, init)
        # the names the conf net shares with the serving LM: embed/tok,
        # embed/pos, ln_f/scale, ln_f/bias
        check(ib["format"] == "sharded" and ib["restored"]
              == ia["restored"] == 4 and bitwise(a, b),
              f"zero: serving restore {ib} differs from the npz's {ia}")
        rs = np.random.RandomState(0)
        prompts = [rs.randint(1, lm.vocab, size=(16 + 16 * rid,))
                   .astype(np.int32) for rid in range(ZERO_REQUESTS)]
        streams, paged = [], []
        for p in (a, b):
            before = pa.paged_attention.launches
            streams.append(streams_of(Engine(p, lm, serving, device=dev),
                                      prompts, 32)[1])
            paged.append(pa.paged_attention.launches - before)
        (sa, sb), (la, lb) = streams, paged
    out = {"sharded_save_ms": save_ms, "restore_on_2_ms": restore_ms,
           "saved_arrays": len(saved), "serving_restored": ib["restored"],
           "paged_launches": [la, lb], "card": smi}
    print("zero save", json.dumps(out))
    check(sa == sb, "zero: the engine booted from the sharded save "
          "streams differently from the npz-booted one")
    check(la == lb > 0, f"zero: paged kernel launches {la}, {lb}")
    digest = tz.digest()
    del tz
    release()
    return ring["zero_quant_acc_launches"], {
        "digest": digest, "losses": ring["zero_losses"]}


# ---------------------------------------------------------------------------
# procs phase: one process per rank group (torch.distributed over gloo)
# ---------------------------------------------------------------------------


def write_hostfile(path: str, n: int = 2) -> str:
    """``n`` lines on this host, line 0 with a free port: the
    rendezvous."""
    with open(path, "w") as f:
        f.write(f"127.0.0.1:{free_port()}\n" + "127.0.0.1\n" * (n - 1))
    return path


def run_children(cmds, tmp, name):
    """One process per command, output to files (a child blocked on a
    full pipe would stall its peer at the next collective), every wait
    within PROCS_TIMEOUT_S, all stopped at the end -> their outputs;
    each must exit 0."""
    procs, logs, outs = [], [], []
    try:
        for k, cmd in enumerate(cmds):
            logs.append(open(os.path.join(tmp, f"{name}{k}.log"), "w+"))
            procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + PROCS_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        stop_all(procs)
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for k, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"procs {name}: process {k} exited "
              f"{p.returncode}:\n{out[-3000:]}")
    return outs


def child_report(out: str, tag: str) -> dict:
    line = next((x for x in out.splitlines() if x.startswith(tag)), None)
    check(line is not None, f"procs: no {tag!r} line:\n{out[-3000:]}")
    return json.loads(line[len(tag):])


def procs_lm_conf(tmp, shard) -> str:
    """tinylm_d128.conf with the ring phase's q8wire settings (the int8
    ring, 4 buckets), float32, PROCS_LM_STEPS steps, over ``shard`` ->
    the conf's path."""
    with open(RING_CONF) as f:
        txt = f.read()
    for old, new in (("examples/lm/train_shard", shard),
                     ('compute_dtype: "bfloat16"\n', ""),
                     ("train_steps: 2000", f"train_steps: {PROCS_LM_STEPS}")):
        check(old in txt, f"procs: {RING_CONF} has no {old!r}")
        txt = txt.replace(old, new)
    path = os.path.join(tmp, "procs_lm.conf")
    with open(path, "w") as f:
        f.write(txt + "\ngrad_comm { mode: quantized buckets: 4 }\n"
                "kernels { grad_allreduce: quantized_ring }\n")
    return path


def lm_cluster(tmp, run) -> str:
    path = os.path.join(tmp, f"procs_cluster_{run}.conf")
    with open(path, "w") as f:
        f.write(f'nworkers: 2\nworkspace: "{tmp}/procs_ws_{run}"\n')
    return path


def lm_save(tmp, run) -> str:
    return os.path.join(tmp, f"procs_ws_{run}", "checkpoints",
                        f"step_{PROCS_LM_STEPS}.npz")


def procs_lm_cli(dev, conf, tmp, run):
    """The LM as two processes of one rank through ``python -m
    singa_tpu_torch.main -procsID k -hostfile hf`` -> their TRAIN
    PROCESS reports."""
    cmd = [sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
           conf, "-cluster_conf", lm_cluster(tmp, run), "-hostfile",
           write_hostfile(os.path.join(tmp, f"procs_hf_{run}"))]
    if dev.type != "cuda":
        cmd += ["-device", str(dev)]
    outs = run_children([cmd + ["-procsID", str(k)] for k in range(2)],
                        tmp, f"procs_lm_{run}_")
    return [child_report(o, "TRAIN PROCESS: ") for o in outs]


def procs_lm_one(dev, conf, tmp, run):
    """The LM as one process of two ranks on ``dev``, its Trainer's run()
    timed as main times it -> (trainer, its record)."""
    from singa_tpu_torch.config import load_cluster_config

    tr = Trainer(load_model_config(conf), load_cluster_config(
        lm_cluster(tmp, run)), mesh=build_mesh(2, 1, [dev] * 2), seed=0,
        log=lambda s: None)
    qc.quant_acc.launches = 0
    qc.ppermute.sent_bytes.clear()
    t0 = time.perf_counter()
    tr.run()
    sync(dev)
    return tr, {"run_s": time.perf_counter() - t0,
                "steps_s": tr.timers.total("data") + tr.timers.total("train"),
                "quant_acc_launches": qc.quant_acc.launches,
                "ring_sent_bytes": sum(qc.ppermute.sent_bytes.values()),
                "digest": tr.digest()}


def procs_bn_trainer(dev, shard, bn, ranks):
    """resnet_conf(depth=18, compute_dtype="float32") at batch
    ``bn["batch"]`` and crop ``bn["size"]`` (1000 classes) over
    ``shard``, on ``ranks`` ranks of ``dev``."""
    from singa_tpu_torch.config import parse_model_config
    from singa_tpu_torch.models.resnet import resnet_conf

    text = resnet_conf(18, batchsize=bn["batch"], size=bn["size"],
                       train_shard=shard, test_shard=shard,
                       train_steps=bn["steps"], compute_dtype="float32")
    return Trainer(parse_model_config(text.replace("random_skip: 5000",
                                                   "random_skip: 0")),
                   mesh=build_mesh(ranks, 1, [dev] * ranks), seed=0,
                   log=lambda s: None)


class bn_runs:
    """The sync BatchNorm runs' settings: kRGBImage takes the centre crop
    and no mirror in training too, so that 4 ranks see the rows 1 rank
    sees (their draws differ), and cuDNN takes its deterministic
    algorithms (its default float32 weight gradients add with atomics,
    ``singa_tpu_torch/device.py``), so that two runs can agree to the
    bit."""

    def __enter__(self):
        from singa_tpu_torch.layers.data import RGBImageLayer

        self.orig = orig = RGBImageLayer.apply
        RGBImageLayer.apply = (
            lambda self, p, i, *, training, generator=None: orig(
                self, p, i, training=training, generator=None))
        self.deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        from singa_tpu_torch.layers.data import RGBImageLayer

        RGBImageLayer.apply = self.orig
        torch.backends.cudnn.deterministic = self.deterministic


def step_losses(tr, step0, steps) -> list:
    out = []
    for step in range(step0, step0 + steps):
        tr.train_one_batch(step)
        out.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    return out


def stats_digest(tr) -> str:
    """SHA-256 of the running stats' bytes, by name."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(running_stats(tr).items()):
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def _ppermute_wrong_peer(xs, perm, level="data"):
    """Planted fault: every pair delivered one rank past its
    destination."""
    return PPERMUTE(xs, [(s, (d + 1) % len(xs)) for s, d in perm], level)


PPERMUTE = qc.ppermute
# the module's ppermute counts through its global name
_ppermute_wrong_peer.sent_bytes = PPERMUTE.sent_bytes


def _process_sum(sync_mesh, parts, device):
    """Planted fault: BatchNorm's sums over this process's ranks alone,
    scaled to the global count: each process normalises by its own
    rows."""
    import functools

    return functools.reduce(torch.add, (p.to(device) for p in parts)) \
        * sync_mesh.nprocs


RANK_SUM = tnorm._rank_sum


def procs_child_jobs(spec, dev) -> dict:
    """This process's share of the API jobs: zero + ring (the zero
    phase's run, saved sharded), the same with the wrong-peer fault,
    ResNet-18 with synchronised BatchNorm, and the same with each
    process's sums its own."""
    from singa_tpu_torch.parallel import launch
    from singa_tpu_torch.parallel.mesh import EXCHANGE

    out = {"backend": launch.backend(), "device": str(dev)}
    qc.quant_acc.launches = 0
    qc.ppermute.sent_bytes.clear()
    EXCHANGE.seconds = 0.0
    tr = zero_trainer(dev, spec["shard"], ZERO_RANKS, zero=True, ring=True,
                      workspace=spec["zero_ws"])
    losses, ms = zero_losses(tr, ZERO_STEPS)
    path, save_ms = timed(lambda: tr.save(ZERO_STEPS))
    out["zero"] = {"ranks": list(tr.mesh.local_ranks), "losses": losses,
                   "step_ms": ms, "digest": tr.digest(), "save": path,
                   "save_ms": save_ms,
                   "quant_acc_launches": qc.quant_acc.launches,
                   "ring_sent_bytes": sum(qc.ppermute.sent_bytes.values()),
                   "exchange_s": EXCHANGE.seconds}
    del tr
    release()
    qc.ppermute = _ppermute_wrong_peer
    try:
        tr = zero_trainer(dev, spec["shard"], ZERO_RANKS, zero=True,
                          ring=True)
        out["wrong_peer"] = {"losses": zero_losses(tr, PROCS_FAULT_STEPS)[0],
                             "digest": tr.digest()}
    finally:
        qc.ppermute = PPERMUTE
    del tr
    release()
    bn = spec["bn"]
    with bn_runs():
        tr = procs_bn_trainer(dev, spec["bn_shard"], bn, ZERO_RANKS)
        out["bn"] = {"losses": step_losses(tr, 0, bn["steps"]),
                     "digest": tr.digest(), "stats": stats_digest(tr)}
        del tr
        tnorm._rank_sum = _process_sum
        try:
            tr = procs_bn_trainer(dev, spec["bn_shard"], bn, ZERO_RANKS)
            out["bn_fault"] = {"losses": step_losses(tr, 0, bn["steps"])}
            stats = running_stats(tr)
            np.savez(spec["bn_fault_stats"].format(proc=tr.mesh.proc),
                     **{k: v.numpy() for k, v in stats.items()})
        finally:
            tnorm._rank_sum = RANK_SUM
    del tr
    release()
    return out


def procs_child(argv) -> int:
    """A process of the procs phase's API jobs: ``python -c "import sys,
    chip_smoke; sys.exit(chip_smoke.procs_child(sys.argv[1:]))" k spec``,
    ``spec`` a JSON file (hostfile, device, shards, workspace). It joins
    the process group as process k (init_distributed), runs
    procs_child_jobs and prints ``PROCS CHILD: {json}``; a failure
    leaves at once with exit 1, without waiting on its peer."""
    import traceback

    from singa_tpu_torch.parallel import launch

    with open(argv[1]) as f:
        spec = json.load(f)
    try:
        check(launch.init_distributed(int(argv[0]), spec["hostfile"],
                                      device=spec["device"]),
              "procs: no process group")
        out = procs_child_jobs(spec, launch.process_device(spec["device"]))
        out["proc"] = int(argv[0])
        print("PROCS CHILD: " + json.dumps(out), flush=True)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    launch.shutdown()
    return 0


def procs_lm(dev, smi, tmp):
    """The LM over two processes through main and over one process of 2
    ranks, in turns (2 processes, 1, 1, 2): the processes' params and
    slots equal each other's and the one-process run's, bitwise; each
    process on the card; their quant_acc launches summing to the
    one-process run's. -> the record."""
    conf = procs_lm_conf(tmp, write_ring_shard(tmp))
    runs = {}
    for run in ("a", "b", "c", "d"):
        if run in "ad":
            runs[run] = procs_lm_cli(dev, conf, tmp, run)
        else:
            tr, runs[run] = procs_lm_one(dev, conf, tmp, run)
            if run == "c":
                one = tr
            del tr
        release()
    b, c = runs["b"], runs["c"]
    check(b["digest"] == c["digest"], "procs lm: two one-process runs differ")
    want = {k: v.cpu().numpy() for k, v in one.params.items()}
    want.update({f"{n}|{s}": v.cpu().numpy() for n, sl in one.state.items()
                 for s, v in sl.items()})
    launches = []
    for run in "ad":
        reps = runs[run]
        for k, r in enumerate(reps):
            check((r["proc"], r["nprocs"], r["backend"]) == (k, 2, "gloo")
                  and r["device"].startswith(dev.type)
                  and r["steps"] == PROCS_LM_STEPS,
                  f"procs lm: process {k} of run {run}: {r}")
            check(r["digest"] == c["digest"],
                  f"procs lm: process {k} of run {run} differs from the "
                  "one-process run")
        total = sum(r["quant_acc_launches"] for r in reps)
        check(total == c["quant_acc_launches"]
              and (total > 0) == (dev.type == "cuda"),
              f"procs lm: quant_acc launches {[r['quant_acc_launches'] for r in reps]}"
              f" against the one-process {c['quant_acc_launches']}")
        check(sum(r["ring_sent_bytes"] for r in reps)
              == c["ring_sent_bytes"], "procs lm: ring bytes differ")
        launches.append(total)
        with np.load(lm_save(tmp, run)) as z:
            got = {k[2:]: z[k] for k in z.files if k[:2] in ("p|", "s|")}
        check(got.keys() == want.keys() and all(
            np.array_equal(got[k], want[k]) for k in want),
            f"procs lm: process 0's save of run {run} differs")
    per_rank_step = c["ring_sent_bytes"] / 2 / PROCS_LM_STEPS
    check(per_rank_step == one.wire_bytes_model()["quantized_ring"],
          "procs lm: ring bytes a rank a step != the model")
    # the display at step 0 resets the Trainer's timers: steps 1-7
    timed = PROCS_LM_STEPS - 1
    out = {"conf": "tinylm_d128 q8wire float32", "ranks": 2,
           "steps": PROCS_LM_STEPS,
           "step_ms_in_turns": {
               "procs_a": max(r["steps_s"] for r in runs["a"]) * 1e3 / timed,
               "one_b": b["steps_s"] * 1e3 / timed,
               "one_c": c["steps_s"] * 1e3 / timed,
               "procs_d": max(r["steps_s"] for r in runs["d"]) * 1e3 / timed},
           "run_s_in_turns": [max(r["run_s"] for r in runs["a"]), b["run_s"],
                              c["run_s"], max(r["run_s"] for r in runs["d"])],
           "ring_bytes_per_rank_step": per_rank_step,
           "exchange_ms_per_step": [r["exchange_s"] * 1e3 / PROCS_LM_STEPS
                                    for r in runs["a"] + runs["d"]],
           "quant_acc_launches": {"procs": launches,
                                  "per_process": [r["quant_acc_launches"]
                                                  for r in runs["a"]],
                                  "one": c["quant_acc_launches"]},
           "devices": [r["device"] for r in runs["a"]],
           "backend": runs["a"][0]["backend"], "card": smi}
    print("procs lm", json.dumps(out))
    del one
    release()
    return out


def procs_api(dev, smi, shard, zero_ref, tmp):
    """zero + ring and ResNet-18 over 2 processes x 2 ranks through the
    Python API (procs_child), against this process's 1 x 4 runs. ->
    the record."""
    from singa_tpu_torch.trainer.sharded_ckpt import ShardedCheckpoint

    bn_shard = os.path.join(tmp, "procs_bn_shard")
    write_records(bn_shard, *imagenet_shaped_arrays(
        PROCS_BN["records"], size=PROCS_BN["size"]))
    spec = {"hostfile": write_hostfile(os.path.join(tmp, "procs_hf_api")),
            "device": str(dev), "shard": shard, "bn_shard": bn_shard,
            "zero_ws": os.path.join(tmp, "procs_zero_ws"), "bn": PROCS_BN,
            "bn_fault_stats": os.path.join(tmp, "procs_bn_fault_{proc}.npz")}
    spec_path = os.path.join(tmp, "procs_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    script = ("import sys, chip_smoke; "
              "sys.exit(chip_smoke.procs_child(sys.argv[1:]))")
    outs = run_children([[sys.executable, "-c", script, str(k), spec_path]
                         for k in range(2)], tmp, "procs_api_")
    reps = [child_report(o, "PROCS CHILD: ") for o in outs]
    for k, r in enumerate(reps):
        check(r["proc"] == k and r["backend"] == "gloo"
              and r["device"].startswith(dev.type),
              f"procs api: process {k}: {r['device']}, {r['backend']}")
    # zero + ring: the zero phase's 4-rank run, bitwise
    zero = [r["zero"] for r in reps]
    check(all(z["digest"] == zero_ref["digest"]
              and z["losses"] == zero_ref["losses"] for z in zero),
          f"procs zero: 2 x 2 differs from 1 x 4: {zero} {zero_ref}")
    tz = zero_trainer(dev, shard, ZERO_RANKS, zero=True, ring=True)
    per_step = ZERO_RANKS * len(tz._buckets(list(tz.params))) \
        * (ZERO_RANKS - 1)
    del tz
    launches = sum(z["quant_acc_launches"] for z in zero)
    check(launches == (per_step * ZERO_STEPS if dev.type == "cuda" else 0),
          f"procs zero: quant_acc launches {launches}")
    path = zero[0]["save"]
    names = set(os.listdir(path))
    with open(os.path.join(path, "manifest.json")) as f:
        nprocs = json.load(f)["nprocs"]
    check({"proc_0.npz", "proc_1.npz", "commit_0.json",
           "commit_1.json"} <= names and nprocs == 2,
          f"procs zero: the save holds {sorted(names)}, nprocs {nprocs}")
    with ShardedCheckpoint(path) as ck:
        saved = {k: ck.assemble(k) for k in ck.keys()}
    restore_ms = {}
    for n in (4, 2):
        back, restore_ms[n] = timed(lambda: zero_trainer(
            dev, shard, n, zero=True, ring=True, checkpoint=path))
        got = {f"p|{k}": v for k, v in back.params.items()}
        got.update({f"s|{k}|{s}": v for k, sl in back.state.items()
                    for s, v in sl.items()})
        got.update({f"b|{k}": v for k, v in back.buffers.items()})
        check(got.keys() == saved.keys() and all(
            np.array_equal(got[k].cpu().numpy(), saved[k]) for k in saved),
            f"procs zero: the 2-process save restored on {n} ranks differs")
        del back
        release()
    wrong = [r["wrong_peer"] for r in reps]
    check(all(w["digest"] != zero_ref["digest"] for w in wrong),
          "procs zero: a ppermute to the wrong peer passed the check")
    # synchronised BatchNorm: 1 x 4 here, twice, then 4 ranks against 1
    with bn_runs():
        runs = []
        for _ in range(2):
            t4 = procs_bn_trainer(dev, bn_shard, PROCS_BN, 4)
            losses = step_losses(t4, 0, PROCS_BN["steps"])
            runs.append((t4.digest(), stats_digest(t4)))
            want_stats = running_stats(t4)
            del t4
            release()
        check(runs[0] == runs[1], "procs bn: two 1 x 4 runs differ")
        digest, stats = runs[0]
        one, four = (procs_bn_trainer(dev, bn_shard, PROCS_BN, n)
                     for n in (1, 4))
        loss_err = stats_err = 0.0
        for step in range(PROCS_BN["steps"]):
            four.params = one.params
            four.state = one.state
            four._store_buffers(one.buffers)
            want, got = (step_losses(tr, step, 1)[0] for tr in (one, four))
            loss_err = max(loss_err, abs(got - want) / abs(want))
            stats_err = max(stats_err, stats_diff(running_stats(four),
                                                  running_stats(one)))
        del one, four
        release()
    bn = [r["bn"] for r in reps]
    # the fault's miss: its losses' and each process's running stats'
    fault_loss = max(abs(a - b) / abs(b) for r in reps
                     for a, b in zip(r["bn_fault"]["losses"], losses))
    fault_stats = []
    for k in range(2):
        with np.load(spec["bn_fault_stats"].format(proc=k)) as z:
            fault_stats.append(stats_diff(
                {n: torch.from_numpy(z[n]) for n in z.files}, want_stats))
    out = {"zero": {"ranks": [z["ranks"] for z in zero],
                    "losses": zero[0]["losses"],
                    "step_ms": [z["step_ms"] for z in zero],
                    "zero_phase_losses": zero_ref["losses"],
                    "save_ms": [z["save_ms"] for z in zero],
                    "restore_ms": restore_ms,
                    "quant_acc_launches": [z["quant_acc_launches"]
                                           for z in zero],
                    "ring_bytes_per_rank_step": sum(
                        z["ring_sent_bytes"] for z in zero)
                    / ZERO_RANKS / ZERO_STEPS,
                    "exchange_ms_per_step": [z["exchange_s"] * 1e3
                                             / ZERO_STEPS for z in zero],
                    "wrong_peer_losses": wrong[0]["losses"]},
           "bn": {"conf": "resnet18 float32", **PROCS_BN,
                  "losses_1x4": losses, "losses_2x2": bn[0]["losses"],
                  "four_vs_one_loss_rel": loss_err,
                  "four_vs_one_stats": stats_err,
                  "fault_losses": reps[0]["bn_fault"]["losses"],
                  "fault_loss_rel": fault_loss,
                  "fault_stats": fault_stats},
           "card": smi}
    print("procs api", json.dumps(out))
    check(all(x["digest"] == digest and x["stats"] == stats
              and x["losses"] == losses for x in bn),
          "procs bn: 2 x 2 differs from 1 x 4")
    check(loss_err <= NETS_TOL and stats_err <= RESNET_STATS_TOL,
          f"procs bn: 4 ranks against 1: losses {loss_err}, stats "
          f"{stats_err}")
    check(max(fault_loss, *fault_stats) > 100 * NETS_TOL,
          f"procs bn: per-process sums passed: losses {fault_loss}, "
          f"stats {fault_stats}")
    out["quant_acc_launches"] = launches
    return out


def procs_phase(dev, smi, shard, zero_ref, tmp) -> dict:
    """One process per rank group over torch.distributed (gloo, both
    processes on this card): the LM through main (procs_lm), zero + ring
    and synchronised BatchNorm through the API (procs_api). -> the
    quant_acc launches of the processes."""
    t0 = time.perf_counter()
    lm = procs_lm(dev, smi, tmp)
    api = procs_api(dev, smi, shard, zero_ref, tmp)
    print(f"procs phase {time.perf_counter() - t0:.1f} s")
    return {"lm": lm["quant_acc_launches"]["procs"][0],
            "zero_ring": api["quant_acc_launches"]}


# ---------------------------------------------------------------------------
# axes phase: the seq, expert, model and pipe axes and q8_hier's named axes
# ---------------------------------------------------------------------------

#: float32 steps of each path and its counterpart
AXES_STEPS = 5
#: bf16 steps timed of each path and its counterpart
AXES_TIMED = 10
AXES_TOL = 1e-4
AXES_FAULT_FACTOR = 100
#: the sp cell's shard: ring attention's per-hop fold keeps a (b, h,
#: s_local, s_local) float32 score block for the backward, 2.1 GB a hop at
#: S 8192 (about 200 GB for the 8 ranks' 4 hops in 2 layers), 134 MB at
#: S 2048: the sequence is cut to 2048
AXES_RING_SHARD = (64, 2048)
TP_CLUSTER = "nworkers: 4\nnprocs_per_group: 2"


def _visitor_one_off(my, i, n):
    return (my - i + 1) % n


def _reversed_concate(parts, dim):
    return torch.cat(parts[::-1], dim)


def _hop_late(sent, t):
    return sent[max(t - 2, 0)]


def _partition(cfg):
    cfg.neuralnet.partition_type = "kLayerPartition"


def _alltoall(cfg):
    for layer in cfg.neuralnet.layer:
        if layer.type == "kMoE":
            layer.moe_param.dispatch = "alltoall"


def _named_q8(cfg):
    apply_grad_comm_tag(cfg, "q8hier")
    cfg.grad_comm.buckets = 4
    cfg.ring.intra_degree = 0
    cfg.ring.intra_axis, cfg.ring.inter_axis = "model", "data"


def _path(conf, edit, cluster, ref, calls, fault=None, bar=AXES_TOL,
          step0_only=False):
    """One AXES_PATHS entry: the model conf and its edit, the cluster,
    the counterpart's cluster (its conf: the same, without q8's edit),
    the flash calls a step (``calls(attention layers, trainer)``), the
    planted fault (module, attribute, replacement), the loss bar, and
    whether only step 0's loss and no params are held to AXES_TOL
    (the rest to ``bar``)."""
    return SimpleNamespace(conf=conf, edit=edit, cluster=cluster, ref=ref,
                           calls=calls, fault=fault, bar=bar,
                           step0_only=step0_only)


def _per_rank(layers, tr):
    return layers * tr.mesh.width


def _per_data_rank(layers, tr):
    return layers * tr.mesh.widths["data"]


def _per_microbatch(layers, tr):
    return (layers * tr.train_net.pipeline_plan.nmicro
            * tr.mesh.widths["data"])


#: AXES_A2A_TOL: the all-to-all form's aux loss is the global batch's
#: (frac and mean_prob averaged over the 8 token shards before their
#: product, as in the JAX package), the dense path's on 8 data ranks the
#: mean of each rank's: the same forward at step 0 (the same token
#: shards and capacities), then gradients apart by the aux terms
#: (weight 0.01): 1.06e-4 over 5 steps on the CPU rehearsal
AXES_A2A_TOL = 1e-3
AXES_PATHS = {
    "sp": _path("examples/lm/tinylm_ring.conf", None,
                "examples/lm/cluster_sp.conf", "nworkers: 2",
                lambda layers, tr: 0,
                ("singa_tpu_torch.parallel.ring", "_visitor",
                 _visitor_one_off)),
    "ep_psum": _path("examples/lm/tinylm_moe.conf", None,
                     "examples/lm/cluster_ep.conf", "nworkers: 2",
                     _per_rank, ("singa_tpu_torch.parallel.moe",
                                 "_shard_of", lambda e, n: (e + 1) % n)),
    # the all-to-all form routes 8 token shards with a capacity each:
    # the dense path on 8 data ranks routes the same shards
    "ep_alltoall": _path("examples/lm/tinylm_moe.conf", _alltoall,
                         "examples/lm/cluster_ep.conf", "nworkers: 8",
                         _per_rank, bar=AXES_A2A_TOL, step0_only=True),
    "tp": _path("examples/lm/tinylm.conf", _partition, TP_CLUSTER,
                "nworkers: 2", _per_data_rank,
                ("singa_tpu_torch.layers.sequence", "concate",
                 _reversed_concate)),
    "q8": _path("examples/lm/tinylm.conf", _named_q8, TP_CLUSTER,
                "nworkers: 2", _per_rank, bar=RING_TOL, step0_only=True),
    "pp": _path("examples/lm/tinylm_pp.conf", None,
                "examples/lm/cluster_pp.conf", "nworkers: 4",
                _per_microbatch, ("singa_tpu_torch.parallel.pipeline",
                                  "_hop", _hop_late)),
    "3axis": _path("examples/lm/tinylm_pp.conf", None,
                   "examples/lm/cluster_3axis.conf",
                   "nworkers: 4\nnprocs_per_group: 2\nnpipes_per_group: 2",
                   _per_microbatch),
}


def axes_cluster(spec: str, tmp: str):
    """A cluster conf (a file of the repo, or conf text) with its
    workspace under ``tmp``."""
    from singa_tpu_torch.config import parse_cluster_config

    text = spec
    if spec.endswith(".conf"):
        with open(os.path.join(REPO, spec)) as f:
            text = "\n".join(l for l in f.read().splitlines()
                             if not l.startswith("workspace"))
    return parse_cluster_config(
        f'{text}\nworkspace: "{os.path.join(tmp, "ws_axes")}"\n')


def axes_config(conf: str, edit, shard: str, dtype: str):
    cfg = load_model_config(os.path.join(REPO, conf))
    cfg.compute_dtype = dtype
    for layer in cfg.neuralnet.layer:
        if layer.type == "kSequenceData":
            layer.data_param.path = shard
    if edit is not None:
        edit(cfg)
    return cfg


def axes_steps(tr, steps, step0=0):
    """-> (losses, host ms of each step to a device sync)."""
    losses, ms = [], []
    for step in range(step0, step0 + steps):
        t0 = time.perf_counter()
        tr.train_one_batch(step)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    return losses, ms


def axes_launches() -> dict:
    out = {n: fn.launches for n, (fn, _, _) in FLASH.items()}
    out["quant_acc"] = qc.quant_acc.launches
    return out


def zero_launches() -> None:
    for fn, _, _ in FLASH.values():
        fn.launches = 0
    qc.quant_acc.launches = 0


def axes_deviation(tr, ref, init) -> float:
    """The largest param difference after the steps, relative to how far
    the steps moved the counterpart's params."""
    moved = max(float((ref.params[n] - init[n]).abs().max())
                for n in init)
    return max(float((tr._unpad_one(n, tr.params[n])
                      - ref.params[n]).abs().max()) for n in init) / moved


def exchange_ms(tr, step0, steps=3) -> float:
    """Host ms a step of the ranks' gradient sums (``_axes_reduce``), to
    a device sync before and after, over ``steps`` steps."""
    spent = []
    inner = tr._axes_reduce

    def timed_reduce(ranks, leaves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(ranks, leaves)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    tr._axes_reduce = timed_reduce
    axes_steps(tr, steps, step0)
    del tr._axes_reduce
    return sum(spent) / len(spent)


def axes_path(dev, smi, name, shard, tmp) -> dict:
    """One path of AXES_PATHS: float32 parity with its counterpart, the
    launch counts, the planted fault, then the bf16 timings."""
    import importlib

    path = AXES_PATHS[name]
    q8 = name == "q8"

    def trainer(dtype, which):
        ref = which == "ref"
        cfg = axes_config(path.conf, None if ref and q8 else path.edit,
                          shard, dtype)
        return Trainer(cfg, axes_cluster(path.ref if ref else path.cluster,
                                         tmp),
                       seed=0, log=lambda s: None, device=dev)

    out = {"path": name, "conf": path.conf, "card": smi}
    ref = trainer("float32", "ref")
    init = {n: v.clone() for n, v in ref.params.items()}
    ref_losses, _ = axes_steps(ref, AXES_STEPS)
    tr = trainer("float32", "path")
    out["mesh"] = tr.mesh_shape
    layers = sum(l.type == "kAttention" for l in tr.cfg.neuralnet.layer)
    zero_launches()
    losses, _ = axes_steps(tr, AXES_STEPS)
    got = axes_launches()
    want = flash_launches(torch.float32,
                          path.calls(layers, tr) * AXES_STEPS)
    buckets = len(tr._buckets(tr.params)) if q8 else 0
    # q8_hier's named 2 x 2 ring: one int8 hop per rank and bucket
    want["quant_acc"] = tr.mesh.width * buckets * AXES_STEPS
    out.update(losses=losses, ref_losses=ref_losses, launches=got)
    check(got == want, f"axes {name}: launches {got} != {want}")
    check(all(np.isfinite(losses)), f"axes {name}: non-finite loss")
    diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
    out["loss_diff"] = max(diffs)
    check(max(diffs) <= path.bar and (not path.step0_only
                                      or diffs[0] <= AXES_TOL),
          f"axes {name}: losses differ from the counterpart's by {diffs} "
          f"(bar {path.bar:g})")
    if not path.step0_only:
        out["param_deviation"] = axes_deviation(tr, ref, init)
        check(out["param_deviation"] <= AXES_TOL,
              f"axes {name}: params differ from the counterpart's")
    del tr
    release()
    fault = path.fault
    if fault is not None:
        module, attr, bad = fault
        mod = importlib.import_module(module)
        good = getattr(mod, attr)
        setattr(mod, attr, bad)
        try:
            tf = trainer("float32", "path")
            fl, _ = axes_steps(tf, AXES_STEPS)
            dev_f = max(max(abs(a - b) for a, b in zip(fl, ref_losses)),
                        axes_deviation(tf, ref, init))
        finally:
            setattr(mod, attr, good)
        out["fault"] = {"planted": f"{module}.{attr}", "deviation": dev_f}
        check(dev_f > AXES_FAULT_FACTOR * AXES_TOL,
              f"axes {name}: the planted fault ({attr}) moved the run "
              f"only {dev_f:.3e}")
        del tf
    del ref
    release()
    for which in ("path", "ref"):
        tb = trainer("bfloat16", which)
        zero_launches()
        bl, ms = axes_steps(tb, AXES_TIMED)
        rec = {"step_ms_median": sorted(ms)[len(ms) // 2],
               "step_ms_min": min(ms), "losses": bl,
               "launches": axes_launches(),
               "tokens_per_s": tb.tokens_per_step
               / sorted(ms)[len(ms) // 2] * 1e3}
        check(all(np.isfinite(bl)), f"axes {name} bf16 {which}: "
              "non-finite loss")
        if which == "path":
            want = flash_launches(torch.bfloat16,
                                  path.calls(layers, tb) * AXES_TIMED)
            got = {n: v for n, v in rec["launches"].items()
                   if n != "quant_acc"}
            check(got == want, f"axes {name} bf16: flash launches {got} "
                  f"!= {want}")
            rec["exchange_ms"] = (reduce_ms(tb) if q8 else
                                  exchange_ms(tb, AXES_TIMED))
        out[f"bf16_{which}"] = rec
        del tb
        release()
    print("axes", json.dumps(out))
    return out


def write_axes_shards(tmp: str) -> dict:
    out = {}
    for key, (n, s) in (("ring", AXES_RING_SHARD), ("lm", MOE_SEQS)):
        out[key] = os.path.join(tmp, f"axes_{key}")
        write_records(out[key], *synthetic_token_arrays(n, seq_len=s,
                                                        vocab=256, seed=0))
    return out


def axes_phase(dev, smi, tmp) -> dict:
    """Every path of AXES_PATHS, with the flash kernels forced for the
    attention (SINGA_TPU_DENSE_ATTN_MB 0). -> {path: its launches over
    its float32 run}."""
    t0 = time.perf_counter()
    shards = write_axes_shards(tmp)
    os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "0"
    try:
        runs = {name: axes_path(dev, smi, name, shards[
            "ring" if name == "sp" else "lm"], tmp) for name in AXES_PATHS}
    finally:
        os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "512"
    print(f"axes phase {time.perf_counter() - t0:.1f} s")
    return {name: run["launches"] for name, run in runs.items()}


REPLICA_CONF = "examples/mnist/mlp.conf"
REPLICA_CLUSTER = "examples/mnist/cluster_elastic.conf"
#: the mlp run's replica ranks (worker groups), all on this card
REPLICA_RANKS = 4
REPLICA_STEPS = 100
#: a protocol round against its formula in float64, max |got - formula|
#: over the replicas, the center and the snapshots: float32 rounding of a
#: few adds and multiplies on values of at most ~0.1 (8 ulps at 0.1)
REPLICA_ROUND_TOL = 6e-8
REPLICA_FAULT_FACTOR = 100
#: RandomSync's pinned partial ratio
REPLICA_PARTIAL = 0.1
#: the LM's replicas, steps and protocol settings
REPLICA_LM_RANKS = 2
REPLICA_LM_STEPS = 10
REPLICA_LM_SHARD = (256, 256)
REPLICA_LM_SYNC = ('param_type: "Elastic" moving_rate: 0.5 '
                   "sync_frequency: 4 warmup_steps: 2")
#: the two-process runs: steps, warmup and cadence
REPLICA_PROCS = {"steps": 12, "warmup": 4, "freq": 4}
REPLICA_TIMED = 10


def replica_shards(tmp: str) -> dict:
    """The dispatch phase's full-size MNIST-shaped shards (60000 train
    records, the real training set's size, and the 10000 test)."""
    from singa_tpu_torch.tools.dispatch_turns import MNIST_RECORDS

    out = {k: os.path.join(tmp, k) for k in ("mnist", "mnist_test")}
    write_records(out["mnist"], *synthetic_arrays(MNIST_RECORDS[0], seed=0))
    write_records(out["mnist_test"], *synthetic_arrays(
        MNIST_RECORDS[1], seed=0, noise_seed=1))
    return out


def replica_mlp_text(shards, edits=()) -> str:
    """mlp.conf as written (widths, batch 1000, updater, Elastic with
    moving_rate 0.9, sync_frequency 8, warmup_steps 60) on the shards,
    with ``edits`` (old, new) applied."""
    with open(os.path.join(REPO, REPLICA_CONF)) as f:
        txt = f.read()
    for old, new in (('path: "train_shard"', f'path: "{shards["mnist"]}"'),
                     ('path: "test_shard"',
                      f'path: "{shards["mnist_test"]}"'), *edits):
        check(old in txt, f"replica: {REPLICA_CONF} lacks {old!r}")
        txt = txt.replace(old, new)
    return txt


def replica_cluster(tmp, name, nworkers=REPLICA_RANKS, extra="") -> str:
    """cluster_elastic.conf (nservers 1, asynchronous: the replica
    engine) with ``nworkers`` worker groups and a workspace of its own
    -> its path."""
    with open(os.path.join(REPO, REPLICA_CLUSTER)) as f:
        txt = f.read()
    for old, new in (("nworkers: 1", f"nworkers: {nworkers}"),
                     ('workspace: "examples/mnist/ws"',
                      f'workspace: "{os.path.join(tmp, "ws_" + name)}"')):
        check(old in txt, f"replica: {REPLICA_CLUSTER} lacks {old!r}")
        txt = txt.replace(old, new)
    path = os.path.join(tmp, f"cluster_{name}.conf")
    with open(path, "w") as f:
        f.write(txt + extra)
    return path


def replica_trainer(dev, text, cluster, init=None):
    """make_trainer on the conf and cluster files, its replicas on
    ``dev``; ``init`` (stacked numpy params) injected."""
    from singa_tpu_torch.config import load_cluster_config

    tr = make_trainer(parse_model_config(text), load_cluster_config(cluster),
                      seed=0, log=lambda s: None, device=dev)
    check(type(tr).__name__ == "ReplicaTrainer",
          f"replica: make_trainer gave {type(tr).__name__}")
    if init is not None:
        from singa_tpu_torch.trainer import params_from_numpy

        tr.params = params_from_numpy(tr.train_net, init,
                                      replicas=tr.nreplicas)
    return tr


def replica_init(tr, seed=0) -> dict:
    """Seeded stacked params, each replica its own draw: the conf's
    uniform(-0.05, 0.05) init, from numpy."""
    rs = np.random.RandomState(seed)
    return {n: rs.uniform(-0.05, 0.05, tuple(v.shape)).astype(np.float32)
            for n, v in sorted(tr.params.items())}


def host64(tree) -> dict:
    return {n: v.detach().double().cpu().numpy() for n, v in tree.items()}


def _elastic_reversed(reps, center, alpha):
    """A planted fault: the Elastic round in reversed replica order."""
    def flip(t):
        return {n: v.flip(0) for n, v in t.items()}

    new_r, c = ELASTIC_SYNC(flip(reps), center, alpha)
    return flip(new_r), c


ELASTIC_SYNC = trep.elastic_sync


class RoundCheck:
    """Holds a ReplicaTrainer's bootstrap and protocol rounds to the
    protocol: right after the bootstrap every replica equals the center
    to the bit; each round's replicas, center (and RandomSync's
    snapshots) are held to the protocol's formula in float64 on the
    host, from the replicas and center before the round and the
    snapshots the formula itself left (so a snapshot the trainer let
    drift shows). Records each round's max error and host ms (to a
    device sync). ``plant`` (a callable that installs a fault and
    returns its undo) runs one faulty round first, on the same state,
    records its error, and restores the state before the real round;
    ``scan_too`` runs the round through the dense prefix and again, from
    the same state and draws, through the serial loop, and records how
    far the two differ."""

    def __init__(self, tr, dev):
        self.tr, self.dev = tr, dev
        self.errs, self.ms, self.forms = [], [], []
        self.fault_errs, self.scan_diffs = [], []
        self.boot_equal = None
        self.ref_snap = None
        self.plant = None
        self.scan_too = False
        self._round, self._boot = tr._sync_round, tr._bootstrap
        tr._sync_round, tr._bootstrap = self.round, self.bootstrap

    def bootstrap(self):
        self._boot()
        tr = self.tr
        reps = tr.params
        self.boot_equal = all(torch.equal(reps[n][r], c)
                              for n, c in tr.center.items()
                              for r in range(tr.nreplicas))
        if tr.protocol == "RandomSync":
            self.ref_snap = host64(reps)

    def _device_state(self):
        tr = self.tr
        snap = tr.snapshot
        return (tr.params, {n: v.clone() for n, v in tr.center.items()},
                snap, copy.deepcopy(tr._sync_rng))

    def _restore(self, state):
        tr = self.tr
        params, center, snap, rng = state
        tr.params = params
        with torch.no_grad():
            for n, v in center.items():
                tr.center[n].copy_(v)
        if snap is not None:
            tr._assign_rows("snapshot", snap)
        tr._sync_rng = copy.deepcopy(rng)

    def formula(self, reps, center, rng):
        """The round in float64 on the host -> (replicas, center,
        snapshots or None)."""
        tr = self.tr
        reps = {n: v.copy() for n, v in reps.items()}
        center = {n: v.copy() for n, v in center.items()}
        if tr.protocol == "Elastic":
            a = tr.moving_rate if tr.moving_rate > 0 else tr.sample_ratio
            for n, c in center.items():
                for i in range(tr.nreplicas):
                    diff = a * (reps[n][i] - c)
                    c += diff
                    reps[n][i] -= diff
            return reps, center, None
        snaps = {n: v.copy() for n, v in self.ref_snap.items()}
        idx = None
        if tr.sample_ratio < 1.0:
            shapes = {n: reps[n].shape[1:] for n in sorted(reps)}
            idx = tcons.sample_sync_indices(rng, shapes, tr.nreplicas,
                                            tr.sample_ratio)
        for n, c in center.items():
            w = reps[n].reshape(tr.nreplicas, -1)
            s = snaps[n].reshape(tr.nreplicas, -1)
            cf = c.reshape(-1)
            for i in range(tr.nreplicas):
                j = slice(None) if idx is None else idx[n][i]
                delta = w[i, j] - s[i, j]
                cf[j] = cf[j] + delta
                w[i, j] = cf[j]
                s[i, j] = cf[j]
        return reps, center, snaps

    def _error(self, want) -> float:
        tr = self.tr
        reps, center, snaps = want
        got = [(host64(tr.params), reps), (host64(tr.center), center)]
        if snaps is not None:
            got.append((host64(tr.snapshot), snaps))
        return max(float(np.abs(g[n] - w[n]).max())
                   for g, w in got for n in w)

    def _timed_round(self):
        sync(self.dev)
        t0 = time.perf_counter()
        self._round()
        sync(self.dev)
        return (time.perf_counter() - t0) * 1e3

    def round(self):
        tr = self.tr
        state = self._device_state()
        want = self.formula(host64(state[0]), host64(state[1]),
                            copy.deepcopy(state[3]))
        if self.plant is not None:
            undo = self.plant()
            try:
                self._round()
            finally:
                undo()
            self.fault_errs.append(self._error(want))
            self._restore(state)
            self.plant = None
        form = ("elastic" if tr.protocol == "Elastic" else
                "full" if tr.sample_ratio >= 1.0 else
                "scan" if tcons.DENSE_PREFIX_MAX_ELEMS == 0 else "dense")
        self.ms.append((form, self._timed_round()))
        if self.scan_too:
            dense = (tr.params, tr.center, tr.snapshot)
            self._restore(state)
            keep = tcons.DENSE_PREFIX_MAX_ELEMS
            tcons.DENSE_PREFIX_MAX_ELEMS = 0
            try:
                self.ms.append(("scan", self._timed_round()))
            finally:
                tcons.DENSE_PREFIX_MAX_ELEMS = keep
            scan = (tr.params, tr.center, tr.snapshot)
            self.scan_diffs.append(max(
                float((a[n] - b[n]).abs().max())
                for a, b in zip(dense, scan) for n in a))
            self.scan_too = False
        self.forms.append(form)
        self.errs.append(self._error(want))
        if want[2] is not None:
            self.ref_snap = want[2]


def replica_steps(tr, dev, step0, nsteps):
    """train_one_batch over [step0, step0 + nsteps) -> (losses, host ms
    of each step to a device sync, whether a round ran in it)."""
    losses, ms, rounds = [], [], []
    for step in range(step0, step0 + nsteps):
        sync(dev)
        t0 = time.perf_counter()
        tr.train_one_batch(step)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        rounds.append(tcons.sync_now(step, tr.sync_frequency,
                                     tr.warmup_steps))
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    return losses, ms, rounds


def median(xs):
    return sorted(xs)[len(xs) // 2]


def replica_mlp(dev, smi, shards, tmp) -> dict:
    """mlp.conf as written on REPLICA_RANKS replicas: REPLICA_STEPS
    per-step steps with every round held to its formula and the
    reversed-order fault planted at the first; run() from the same
    params to the same bits; the sync Trainer's step at the same
    per-rank batch; the profile."""
    text = replica_mlp_text(shards)
    cluster = replica_cluster(tmp, "mlp")
    a = replica_trainer(dev, text, cluster)
    init = replica_init(a)
    a.params = {n: torch.from_numpy(v) for n, v in init.items()}
    check(all(float((v[0] - v[1]).abs().max()) > 0
              for v in a.params.values()), "replica mlp: replicas not distinct")
    rc = RoundCheck(a, dev)

    def reversed_order():
        trep.elastic_sync = _elastic_reversed
        return lambda: setattr(trep, "elastic_sync", ELASTIC_SYNC)

    rc.plant = reversed_order
    losses, ms, rounds = replica_steps(a, dev, 0, REPLICA_STEPS)
    check(rc.boot_equal, "replica mlp: replicas != center after bootstrap")
    check(all(np.isfinite(losses)), "replica mlp: non-finite loss")
    check(np.mean(losses[-10:]) < np.mean(losses[:10]),
          f"replica mlp: loss did not fall: {losses[:10]} ... {losses[-10:]}")
    n_rounds = sum(rounds)
    check(len(rc.errs) == n_rounds and n_rounds > 0,
          f"replica mlp: {len(rc.errs)} rounds checked, {n_rounds} due")
    check(max(rc.errs) <= REPLICA_ROUND_TOL,
          f"replica mlp: a round is off its formula by {max(rc.errs):.3e}")
    check(rc.fault_errs and min(rc.fault_errs) >= REPLICA_FAULT_FACTOR
          * REPLICA_ROUND_TOL,
          f"replica mlp: the reversed-order round moved the center by "
          f"only {rc.fault_errs}")
    # run(): windows ending at the rounds, from the same params
    cfg_b = replica_mlp_text(shards, (("train_steps: 60000",
                                       f"train_steps: {REPLICA_STEPS}"),))
    b = replica_trainer(dev, cfg_b, replica_cluster(tmp, "mlp_run"),
                        init=init)
    windows = []
    chunk = b.train_chunk
    b.train_chunk = lambda s0, n: (windows.append(n), chunk(s0, n))
    sync(dev)
    t0 = time.perf_counter()
    b.run()
    sync(dev)
    run_s = time.perf_counter() - t0
    same = all(torch.equal(v, b.params[n]) for n, v in a.params.items()) \
        and all(torch.equal(v, b.center[n]) for n, v in a.center.items())
    check(same, "replica mlp: run()'s chunked trajectory differs from the "
          "per-step one")
    check(windows and max(windows) > 1, "replica mlp: run() never chunked")
    test = b.evaluate(b.test_net, 1, "test", REPLICA_STEPS)["loss"]
    check(all(np.isfinite(list(test.values()))),
          "replica mlp: non-finite test metric")
    prof = profile(a, REPLICA_STEPS, 3)
    # the sync Trainer on the same ranks, each taking the same batch
    sync_tr = Trainer(parse_model_config(replica_mlp_text(
        shards, (("batchsize: 1000", f"batchsize: {1000 * REPLICA_RANKS}"),
                 ))), mesh=build_mesh(REPLICA_RANKS, 1, [dev] * REPLICA_RANKS),
        seed=0, log=lambda s: None)
    _, sync_ms = axes_steps(sync_tr, REPLICA_TIMED + 2)
    post = [m for m, r, s in zip(ms, rounds, range(REPLICA_STEPS))
            if not r and s > a.warmup_steps]
    batch = a.train_net.batchsize
    out = {"conf": REPLICA_CONF, "replicas": REPLICA_RANKS,
           "batch_per_replica": batch, "steps": REPLICA_STEPS,
           "params_per_replica": sum(int(np.prod(v.shape[1:]))
                                     for v in init.values()),
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses_every_10": losses[::10], "test": test,
           "rounds": n_rounds, "round_errs": rc.errs,
           "round_tol": REPLICA_ROUND_TOL,
           "reversed_order_fault_err": rc.fault_errs,
           "elastic_round_ms": [m for _, m in rc.ms],
           "run_windows": windows, "run_s": run_s,
           "step_ms_median": median(post), "step_ms_min": min(post),
           "samples_per_s": REPLICA_RANKS * batch / median(post) * 1e3,
           "warmup_step_ms_median": median(ms[1:a.warmup_steps]),
           "sync_trainer_step_ms_median": median(sync_ms[2:]),
           "sync_trainer_samples_per_s": REPLICA_RANKS * batch
           / median(sync_ms[2:]) * 1e3,
           "device_ms_per_step": prof["device_ms_per_step"],
           "profiled_wall_ms_per_step": prof["wall_ms_per_step"],
           "idle_share": prof["idle_share"], "top5": prof["top"][:5],
           "card": smi}
    print("replica mlp", json.dumps(out))
    del a, b, sync_tr
    release()
    return out


def replica_random(dev, smi, shards, tmp) -> dict:
    """RandomSync on the mlp net (warmup 2, a round every 8 steps): four
    rounds, two at full coverage, at REPLICA_PARTIAL through the dense prefix
    (and again from the same state and draws through the serial loop:
    the two within float32 rounding) and through the serial loop, each
    held to its formula; then the snapshot aliased to the params (a
    planted fault), whose first round must miss the formula by
    REPLICA_FAULT_FACTOR x the bar."""
    edits = (('param_type: "Elastic"', 'param_type: "RandomSync"'),
             ("moving_rate: 0.9", "moving_rate: 0"),
             ("warmup_steps: 60", "warmup_steps: 2"))
    text = replica_mlp_text(shards, edits)
    cluster = replica_cluster(tmp, "random", extra="bandwidth: 1e9\n")
    tr = replica_trainer(dev, text, cluster)
    tr.params = {n: torch.from_numpy(v)
                 for n, v in replica_init(tr, 1).items()}
    rc = RoundCheck(tr, dev)
    freq = tr.sync_frequency
    # two rounds at full coverage (the first pays the process's first
    # launches of its kernels)
    losses, _, _ = replica_steps(tr, dev, 0, 2 * freq)
    check(tr.sample_ratio == 1.0, f"replica random: ratio {tr.sample_ratio}")
    tr.sample_ratio = REPLICA_PARTIAL
    rc.scan_too = True
    more, _, _ = replica_steps(tr, dev, 2 * freq, freq)  # dense, then scan
    keep = tcons.DENSE_PREFIX_MAX_ELEMS
    tcons.DENSE_PREFIX_MAX_ELEMS = 0
    try:
        last, _, _ = replica_steps(tr, dev, 3 * freq, freq)  # scan
    finally:
        tcons.DENSE_PREFIX_MAX_ELEMS = keep
    losses += more + last
    check(rc.boot_equal, "replica random: replicas != center after bootstrap")
    check(rc.forms == ["full", "full", "dense", "scan"],
          f"replica random: rounds {rc.forms}")
    check(max(rc.errs) <= REPLICA_ROUND_TOL,
          f"replica random: a round is off its formula: {rc.errs}")
    check(rc.scan_diffs[0] <= REPLICA_ROUND_TOL,
          f"replica random: dense and scan differ by {rc.scan_diffs}")
    check(all(np.isfinite(losses)), "replica random: non-finite loss")
    del tr
    release()
    alias = replica_trainer(dev, text, cluster)
    alias.params = {n: torch.from_numpy(v)
                    for n, v in replica_init(alias, 1).items()}
    alias._take_snapshot = lambda params: params
    arc = RoundCheck(alias, dev)
    replica_steps(alias, dev, 0, freq)
    check(len(arc.errs) == 1 and arc.errs[0] >= REPLICA_FAULT_FACTOR
          * REPLICA_ROUND_TOL, "replica random: the aliased snapshot's "
          f"round is off its formula by only {arc.errs}")
    out = {"conf": REPLICA_CONF + " RandomSync", "replicas": REPLICA_RANKS,
           "ratios": [1.0, 1.0, REPLICA_PARTIAL, REPLICA_PARTIAL],
           "forms": rc.forms, "round_errs": rc.errs,
           "dense_vs_scan": rc.scan_diffs, "round_ms": rc.ms,
           "aliased_snapshot_fault_err": arc.errs,
           "round_tol": REPLICA_ROUND_TOL, "losses": losses, "card": smi}
    print("replica random", json.dumps(out))
    del alias
    release()
    return out


def replica_lm(dev, smi, tmp) -> dict:
    """tinylm.conf at full width under Elastic on REPLICA_LM_RANKS
    replicas over a 256 x 256-token shard, the flash kernels forced
    (SINGA_TPU_DENSE_ATTN_MB 0): REPLICA_LM_STEPS steps in float32 and in
    bf16 (the conf's), each across at least one round; each kernel of the
    type's route launched replicas x attention layers x steps times,
    counted from 0 just before the run. -> {dtype: launches}."""
    shard = os.path.join(tmp, "replica_lm")
    write_records(shard, *synthetic_token_arrays(
        REPLICA_LM_SHARD[0], seq_len=REPLICA_LM_SHARD[1], vocab=256, seed=0))
    base = tinylm_conf_text(shard)
    check('param_type: "Param"' in base, "replica lm: tinylm.conf's updater")
    base = base.replace('param_type: "Param"', REPLICA_LM_SYNC)
    cluster = replica_cluster(tmp, "lm", REPLICA_LM_RANKS,
                              "bandwidth: 1e9\n")
    out, launches = {}, {}
    os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "0"
    try:
        for dtype in ("float32", "bfloat16"):
            text = base
            if dtype == "float32":
                check('compute_dtype: "bfloat16"' in text,
                      "replica lm: tinylm.conf's dtype")
                text = text.replace('compute_dtype: "bfloat16"', "")
            tr = replica_trainer(dev, text, cluster)
            layers = sum(l.TYPE == "kAttention" for l in tr.train_net.layers)
            zero_launches()
            losses, ms, rounds = replica_steps(tr, dev, 0, REPLICA_LM_STEPS)
            got = axes_launches()
            got.pop("quant_acc")
            want = flash_launches(getattr(torch, dtype), REPLICA_LM_RANKS
                                  * layers * REPLICA_LM_STEPS)
            check(got == want, f"replica lm {dtype}: flash launches {got} "
                  f"!= {want}")
            check(sum(rounds) >= 1, f"replica lm {dtype}: no round")
            check(all(np.isfinite(losses)), f"replica lm {dtype}: loss")
            launches[dtype] = got
            out[dtype] = {"losses": losses, "rounds": sum(rounds),
                          "step_ms_median": median(ms[3:]),
                          "launches": got}
            del tr
            release()
    finally:
        os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "512"
    print("replica lm", json.dumps({"conf": TINYLM_CONF + " Elastic",
                                    "replicas": REPLICA_LM_RANKS,
                                    "shard": REPLICA_LM_SHARD, **out,
                                    "card": smi}))
    return launches


def replica_procs(dev, smi, shards, tmp) -> dict:
    """mlp.conf (full width, REPLICA_PROCS' schedule) as two processes
    through ``python -m singa_tpu_torch.main -procsID k -hostfile hf``
    (gloo, this card), one replica each, under Elastic and RandomSync
    at full coverage (bandwidth 1e9), against one process on the same
    2-rank mesh: every process's digest (replicas, slots, center,
    snapshots) equal to it, to the bit, and process 0's npz and sidecar
    holding its arrays."""
    p = REPLICA_PROCS
    out = {}
    for protocol in ("Elastic", "RandomSync"):
        edits = [("train_steps: 60000", f"train_steps: {p['steps']}"),
                 ("warmup_steps: 60", f"warmup_steps: {p['warmup']}"),
                 ("sync_frequency: 8", f"sync_frequency: {p['freq']}")]
        if protocol == "RandomSync":
            edits += [('param_type: "Elastic"', 'param_type: "RandomSync"'),
                      ("moving_rate: 0.9", "moving_rate: 0")]
        conf = os.path.join(tmp, f"replica_procs_{protocol}.conf")
        with open(conf, "w") as f:
            f.write(replica_mlp_text(shards, edits))
        two = replica_cluster(tmp, f"procs_{protocol}", 2, "bandwidth: 1e9\n")
        cmd = [sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
               conf, "-cluster_conf", two, "-hostfile", write_hostfile(
                   os.path.join(tmp, f"replica_hf_{protocol}"))]
        if dev.type != "cuda":
            cmd += ["-device", str(dev)]
        t0 = time.perf_counter()
        outs = run_children([cmd + ["-procsID", str(k)] for k in range(2)],
                            tmp, f"replica_procs_{protocol}_")
        procs_s = time.perf_counter() - t0
        reps = [child_report(o, "TRAIN PROCESS: ") for o in outs]
        with open(conf) as f:
            one = replica_trainer(dev, f.read(), replica_cluster(
                tmp, f"one_{protocol}", 2, "bandwidth: 1e9\n"))
        t0 = time.perf_counter()
        one.run()
        sync(dev)
        one_s = time.perf_counter() - t0
        digest = one.digest()
        for k, r in enumerate(reps):
            check((r["proc"], r["nprocs"], r["backend"], r["ranks"],
                   r["steps"]) == (k, 2, "gloo", [k], p["steps"])
                  and r["device"].startswith(dev.type),
                  f"replica procs {protocol}: process {k}: {r}")
            check(r["digest"] == digest, f"replica procs {protocol}: "
                  f"process {k} differs from the one-process run")
        ck = os.path.join(tmp, f"ws_procs_{protocol}", "checkpoints",
                          f"step_{p['steps']}.npz")
        with np.load(ck) as z, np.load(ck + ".server") as s:
            same = all(np.array_equal(z["p|" + n], v.cpu().numpy())
                       for n, v in one.params.items()) and all(
                np.array_equal(s["p|" + n], v.cpu().numpy())
                for n, v in one.center.items())
        check(same, f"replica procs {protocol}: process 0's save differs")
        out[protocol] = {"digest_equal": True, "procs_s": procs_s,
                         "one_process_run_s": one_s,
                         "exchange_ms_per_step": [
                             r["exchange_s"] * 1e3 / p["steps"]
                             for r in reps],
                         "steps_s": [r["steps_s"] for r in reps],
                         "devices": [r["device"] for r in reps]}
        del one
        release()
    print("replica procs", json.dumps({**out, **p, "card": smi}))
    return out


def replica_phase(dev, smi, tmp) -> dict:
    """The replica engine: the mlp run, RandomSync's three forms, the LM
    through the flash kernels and the two-process runs. -> the LM's
    flash launches by dtype."""
    t0 = time.perf_counter()
    took = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[name] = time.perf_counter() - t
        return out

    shards = part("shards", replica_shards, tmp)
    part("mlp", replica_mlp, dev, smi, shards, tmp)
    part("random", replica_random, dev, smi, shards, tmp)
    launches = part("lm", replica_lm, dev, smi, tmp)
    part("procs", replica_procs, dev, smi, shards, tmp)
    print(f"replica phase {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in took.items())})")
    return launches


# ---------------------------------------------------------------------------
# 21. resilience: the supervisor, the guard inside the graph, async saves
# ---------------------------------------------------------------------------

RES_CONFS = {"resilient": "examples/mnist/mlp_resilient.conf",
             "async": "examples/mnist/mlp_async.conf"}
#: the guard's LM: tinylm_d128.conf (bf16) over RES_LM_SHARD token rows,
#: the flash kernels forced; the poison token is read by step RES_LM_BAD
#: only, and row RES_POISON of the token table is NaN
RES_LM_CONF = "examples/lm/tinylm_d128.conf"
RES_LM_SHARD = (2048, 128)
RES_LM_STEPS = 30
RES_LM_BAD = 12
RES_POISON = 255
#: the ring drill: RES_RING_STEPS steps on 4 ranks, the poison in rank
#: RES_RING_RANK's slice of step RES_RING_BAD's batch
RES_RING_STEPS = 5
RES_RING_BAD = 3
RES_RING_RANK = 2
#: the rollback drill on mlp_resilient.conf (kRollback after 3, backoff
#: 0.5): the counter is read every 3 steps from step 1, so bad steps 19,
#: 20 and 21 trip it at step 22, back to step_20
RES_ROLLBACK_FAULTS = "nanloss@19,nanloss@20,nanloss@21"
RES_REPLICA_BAD = 5
RES_CD_BAD = 3
#: resnet50.conf's saves: RES_RESNET_STEPS steps, a save every
#: RES_RESNET_EVERY, over RES_RESNET_RECORDS records
RES_RESNET_STEPS = 20
RES_RESNET_EVERY = 5
RES_RESNET_RECORDS = (512, 256)
RES_PROCS_STEPS = 12
RES_TIMEOUT_S = 300


def res_conf(tmp, shards, name, src, edits=()) -> str:
    """``src`` (a shipped conf) on the MNIST-shaped shards, with
    ``edits`` (old, new) applied -> the copy's path."""
    with open(os.path.join(REPO, src)) as f:
        txt = f.read()
    for old, new in (('path: "train_shard"', f'path: "{shards["mnist"]}"'),
                     ('path: "test_shard"',
                      f'path: "{shards["mnist_test"]}"'), *edits):
        check(old in txt, f"resilience: {src} lacks {old!r}")
        txt = txt.replace(old, new)
    path = os.path.join(tmp, f"res_{name}.conf")
    with open(path, "w") as f:
        f.write(txt)
    return path


def res_cluster(tmp, name, nworkers=1) -> str:
    """examples/mnist/cluster.conf with ``nworkers`` and a workspace of its
    own -> its path."""
    with open(os.path.join(REPO, "examples/mnist/cluster.conf")) as f:
        txt = f.read()
    ws = os.path.join(tmp, "ws_res_" + name)
    for old, new in (("nworkers: 1", f"nworkers: {nworkers}"),
                     ('workspace: "examples/mnist/ws"', f'workspace: "{ws}"')):
        check(old in txt, f"resilience: cluster.conf lacks {old!r}")
        txt = txt.replace(old, new)
    path = os.path.join(tmp, f"res_cluster_{name}.conf")
    with open(path, "w") as f:
        f.write(txt)
    return path


def res_ckpts(tmp, name) -> str:
    return os.path.join(tmp, "ws_res_" + name, "checkpoints")


def res_start(dev, tmp, runs) -> list:
    """Start every run of ``runs`` ({name: (conf, cluster, faults,
    nprocs)}) as ``python -m singa_tpu_torch.main`` children at once
    (output to files) -> [(name, process k, Popen, log file)]."""
    started = []
    for name, (conf, cluster, faults, nprocs) in runs.items():
        cmd = [sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
               conf, "-cluster_conf", cluster]
        if faults:
            cmd += ["-faults", faults]
        if dev.type != "cuda":
            cmd += ["-device", str(dev)]
        if nprocs > 1:
            cmd += ["-hostfile", write_hostfile(
                os.path.join(tmp, f"res_hf_{name}"), nprocs)]
        for k in range(nprocs):
            log = open(os.path.join(tmp, f"res_{name}_{k}.log"), "w+")
            started.append((name, k, subprocess.Popen(
                cmd + (["-procsID", str(k)] if nprocs > 1 else []),
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log))
    return started


def res_wait(started) -> dict:
    """Wait for every child within RES_TIMEOUT_S, stop them all ->
    {name: [(exit code, output) per process]}."""
    try:
        deadline = time.monotonic() + RES_TIMEOUT_S
        for _, _, p, _ in started:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        stop_all([p for _, _, p, _ in started])
    out: dict = {}
    for name, _, p, log in started:
        log.seek(0)
        out.setdefault(name, []).append((p.returncode, log.read()))
        log.close()
    return out


def npz_digest(path: str) -> str:
    """SHA-256 of a save's params and slots by name, Trainer.digest's
    recipe: equal digests are equal arrays to the bit."""
    import hashlib

    h = hashlib.sha256()
    with np.load(path) as z:
        names = sorted(k[2:] for k in z.files if k.startswith("p|"))
        for nm in names:
            h.update(nm.encode())
            h.update(z["p|" + nm].tobytes())
            for k in sorted(f for f in z.files
                            if f.startswith(f"s|{nm}|")):
                h.update(f"{nm}|{k.rsplit('|', 1)[1]}".encode())
                h.update(z[k].tobytes())
    return h.hexdigest()


def res_drills(dev, tmp, shards) -> tuple:
    """The shipped confs' drills and the two-process drills, wave 1
    (uninterrupted, crash, sigterm, torn async write) -> (started, the
    run table)."""
    runs = {}
    for tag, src in RES_CONFS.items():
        conf = res_conf(tmp, shards, tag, src)
        for kind, faults in (("clean", ""), ("crash", "crash@7"),
                             ("term", "sigterm@12")):
            runs[f"{tag}_{kind}"] = (conf, res_cluster(
                tmp, f"{tag}_{kind}"), faults, 1)
    runs["async_torn"] = (runs["async_clean"][0], res_cluster(
        tmp, "async_torn"), "async_torn_write@2", 1)
    two = res_conf(tmp, shards, "procs", RES_CONFS["resilient"], [
        ("train_steps: 60", f"train_steps: {RES_PROCS_STEPS}"),
        ("watchdog_timeout: 300.0",
         "watchdog_timeout: 300.0\n  heartbeat_timeout_s: 10.0")])
    for kind, faults in (("clean", ""), ("term", "sigterm@6:rank=1"),
                         ("crash", "crash@6:rank=0")):
        runs[f"procs_{kind}"] = (two, res_cluster(tmp, f"procs_{kind}", 2),
                                 faults, 2)
    # the crash once more with async sharded saves: each process's writer
    # thread writes its shard beside a step loop issuing collectives
    two_async = res_conf(tmp, shards, "procs_async", RES_CONFS["resilient"], [
        ("train_steps: 60", f"train_steps: {RES_PROCS_STEPS}"),
        ("watchdog_timeout: 300.0",
         "watchdog_timeout: 300.0\n  heartbeat_timeout_s: 10.0\n"
         "  async_checkpoint: true"),
        ('name: "mlp-resilient-smoke"',
         'checkpoint_format: "sharded"\nname: "mlp-resilient-smoke"')])
    runs["procs_async_crash"] = (two_async, res_cluster(
        tmp, "procs_async_crash", 2), "crash@6:rank=0", 2)
    return res_start(dev, tmp, runs), runs


def res_drills_check(dev, tmp, wave1, runs) -> tuple:
    """Wave 1's verdicts (the drains exit 75 at the planted step, the torn
    async write never became LATEST, the mlp's step is graphed), then
    wave 2 started: the relaunches after the drains and the two-process
    crashes -> (the verdicts so far, wave 1's results, wave 2)."""
    t0 = time.perf_counter()
    got = res_wait(wave1)
    out = {"wave1_wait_s": time.perf_counter() - t0}
    for name, results in got.items():
        want = (75 if name.endswith("term") or name.startswith("procs_")
                and name.endswith("crash") else 0)
        for k, (rc, text) in enumerate(results):
            check(rc == want, f"resilience {name} process {k}: exit {rc} "
                  f"(want {want}):\n{text[-3000:]}")
    for tag in RES_CONFS:
        clean = got[f"{tag}_clean"][0][1]
        mode = re.search(r"^dispatch: (\w+)", clean, re.M)
        check(mode is not None and mode.group(1) == "graph",
              f"resilience {tag}: dispatch {mode and mode.group(1)}")
        out[f"{tag}_dispatch"] = mode.group(1)
        check("PREEMPTION: injected sigterm@12 — drained at step 12"
              in got[f"{tag}_term"][0][1], f"resilience {tag}: no drain")
        check("attempt 2" in got[f"{tag}_crash"][0][1],
              f"resilience {tag}: crash@7 was not restarted")
    torn = got["async_torn"][0][1]
    check("FAULT: async_torn_write@2" in torn, "resilience: no torn write")
    ck = res_ckpts(tmp, "async_torn")
    with open(os.path.join(ck, "LATEST")) as f:
        latest = f.read().strip()
    from singa_tpu_torch.resilience import retention

    check(latest == "step_60.npz" and retention.validate_checkpoint(
        os.path.join(ck, latest)), f"resilience: torn LATEST {latest}")
    terms = [re.search(r"drained at step (\d+)", t).group(1)
             for _, t in got["procs_term"]]
    check(terms == ["6", "6"], f"resilience procs: drained at {terms}")
    for name in ("procs_crash", "procs_async_crash"):
        check("FAULT: crash@6" in got[name][0][1],
              f"resilience {name}: no crash")
    # wave 2: the relaunches, fault-free, from the newest complete save
    wave2 = res_start(dev, tmp, {
        f"{name}_again": (runs[name][0], runs[name][1], "", runs[name][3])
        for name in ("resilient_term", "async_term", "procs_term",
                     "procs_crash", "procs_async_crash")})
    return out, got, wave2


def res_relaunch_check(smi, tmp, out, got, wave2) -> dict:
    """Wave 2's verdicts: every run ends with its uninterrupted run's
    digest."""
    t0 = time.perf_counter()
    again = res_wait(wave2)
    out["wave2_wait_s"] = time.perf_counter() - t0
    for name, results in again.items():
        for k, (rc, text) in enumerate(results):
            check(rc == 0, f"resilience {name} process {k}: exit {rc}:\n"
                  f"{text[-3000:]}")
    for tag in RES_CONFS:
        ref = npz_digest(os.path.join(res_ckpts(tmp, f"{tag}_clean"),
                                      "step_60.npz"))
        for kind in ("crash", "term", "torn"):
            if kind == "torn" and tag != "async":
                continue
            d = npz_digest(os.path.join(res_ckpts(tmp, f"{tag}_{kind}"),
                                        "step_60.npz"))
            check(d == ref, f"resilience {tag} {kind}: the final save's "
                  "digest differs from the uninterrupted run's")
        out[f"{tag}_digest"] = ref[:16]
    ref = [child_report(t, "TRAIN PROCESS: ")["digest"]
           for _, t in got["procs_clean"]]
    for name in ("procs_term_again", "procs_crash_again",
                 "procs_async_crash_again"):
        d = [child_report(t, "TRAIN PROCESS: ")["digest"]
             for _, t in again[name]]
        check(d == ref and ref[0] == ref[1],
              f"resilience {name}: digests differ from the clean run's")
    check(all("resumed sharded from" in t
              for _, t in again["procs_async_crash_again"]),
          "resilience procs_async_crash: the relaunch did not resume")
    out["procs_digest"] = ref[0][:16]
    print("resilience drills", json.dumps({**out, "card": smi}))
    return out


class ResLog:
    """A trainer log that keeps its lines and parses the window losses."""

    def __init__(self):
        self.lines = []

    def __call__(self, s):
        self.lines.extend(str(s).splitlines())

    def losses(self) -> list:
        return [float(m.group(1)) for m in (re.match(
            r"^step \d+: train loss : ([^,\s]+)", s) for s in self.lines)
            if m]


def res_guarded(dev, cfg, faults="", cluster=None, log=None, **kw):
    """The Trainer on ``cfg`` under a ResilienceContext with ``faults``
    bound (not run) -> (trainer, context)."""
    from singa_tpu_torch.resilience import ResilienceContext

    tr = make_trainer(cfg, cluster, seed=0, log=log or (lambda s: None),
                      device=dev, **kw)
    ctx = ResilienceContext(cfg.resilience, FaultPlan.parse(faults),
                            log=log or (lambda s: None))
    ctx.bind(tr)
    return tr, ctx


def state_bytes(tr) -> dict:
    """Every param, slot and buffer's bytes on the host (NaN compares)."""
    from singa_tpu_torch.resilience.guard import GUARD_KEYS

    out = {("p", n): v.detach().cpu().numpy().tobytes()
           for n, v in tr.params.items()}
    out.update({("s", n, s): v.detach().cpu().numpy().tobytes()
                for n, slots in tr.state.items() for s, v in slots.items()})
    out.update({("b", n): v.detach().cpu().numpy().tobytes()
                for n, v in tr.buffers.items() if n not in GUARD_KEYS})
    return out


def res_lm_shard(tmp, rows, bad_row) -> str:
    """Token rows below RES_POISON, with the poison token in ``bad_row``."""
    toks, labels = synthetic_token_arrays(rows, seq_len=RES_LM_SHARD[1],
                                          vocab=RES_POISON, seed=0)
    toks[bad_row, 7] = RES_POISON
    shard = os.path.join(tmp, f"res_lm_{bad_row}")
    write_records(shard, toks, labels)
    return shard


def res_lm_cfg(shard, policy, dtype=None):
    cfg = load_model_config(os.path.join(REPO, RES_LM_CONF))
    for layer in cfg.neuralnet.layer:
        if layer.type == "kSequenceData":
            layer.data_param.path = shard
    if dtype is not None:
        cfg.compute_dtype = dtype
    cfg.display_frequency = 0
    if policy:
        from singa_tpu_torch.config.schema import ResilienceConfig

        cfg.resilience = ResilienceConfig()
        cfg.resilience.guard_policy = policy
    return cfg


def poison_table(tr) -> None:
    with torch.no_grad():
        tr.params["embed/tok"][RES_POISON] = float("nan")


def _apply_anyway(ok, new, stored):
    """A planted fault: the verdict ignored, the update always applied."""
    del ok
    stored.copy_(new.to(stored.dtype))


def res_guard_graph(dev, smi, tmp) -> dict:
    """tinylm_d128.conf (bf16, flash forced) under kSkip: the poisoned
    step inside the graph drops bitwise, graphed equals eager, the flash
    launches; the planted always-apply verdict is caught."""
    bs = 64
    shard = res_lm_shard(tmp, RES_LM_SHARD[0], RES_LM_BAD * bs + 5)
    os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "0"
    out = {}

    def run(graphs, fault=False):
        tr = Trainer(res_lm_cfg(shard, "kSkip"), seed=0, log=lambda s: None,
                     device=dev, graphs=graphs)
        poison_table(tr)
        layers = sum(l.TYPE == "kAttention" for l in tr.train_net.layers)
        zero_launches()
        snaps = {}
        for step in range(RES_LM_STEPS):
            tr.train_one_batch(step)
            if step in (RES_LM_BAD - 1, RES_LM_BAD):
                snaps[step] = state_bytes(tr)
        sync(dev)
        got = axes_launches()
        got.pop("quant_acc")
        return tr, snaps, got, layers

    def dropped(tr, snaps) -> str:
        """'' when step RES_LM_BAD left every byte as step
        RES_LM_BAD - 1 did, bad_steps is 1 and only the poison row of the
        table is non-finite, else what is wrong."""
        g = tr.guard_counters()
        if g["bad_steps"] != 1:
            return f"bad_steps {g['bad_steps']}"
        if snaps[RES_LM_BAD] != snaps[RES_LM_BAD - 1]:
            return "the bad step changed the state"
        for n, v in tr.params.items():
            v = v.detach().float().cpu()
            if n == "embed/tok":
                v = torch.cat([v[:RES_POISON], v[RES_POISON + 1:]])
            if not torch.isfinite(v).all():
                return f"non-finite {n}"
        return ""

    try:
        tg, sg, launches, layers = run(None)
        check(tg.dispatch_mode == "graph", "resilience guard: not graphed")
        check(tg._g.run.captured or dev.type != "cuda",
              "resilience guard: no graph captured")
        why = dropped(tg, sg)
        check(why == "", f"resilience guard: graphed: {why}")
        want = flash_launches(torch.bfloat16, layers * RES_LM_STEPS)
        check(launches == want,
              f"resilience guard: flash launches {launches} != {want}")
        te, se, _, _ = run(False)
        check(se == sg and state_bytes(te) == state_bytes(tg),
              "resilience guard: graphed differs from eager")
        del te
        orig = ttr.apply_verdict
        ttr.apply_verdict = _apply_anyway
        try:
            tf, sf, _, _ = run(None)
        finally:
            ttr.apply_verdict = orig
        caught = dropped(tf, sf)
        check(caught != "", "resilience guard: the planted always-apply "
              "verdict passed the check")
        del tf
        out = {"bad_steps": 1, "graph_equals_eager": True,
               "launches": launches, "planted_caught": caught}
        del tg
        release()
    finally:
        os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "512"
    print("resilience guard", json.dumps({**out, "card": smi}))
    return launches


def res_guard_timing(dev, smi, tmp) -> dict:
    """Guard on and off, no bad step, RES_LM_STEPS graphed steps each
    from the same seed, in turns (on, off, off, on): the same bits, the
    step ms (host clock to a device sync), and 3 steps of each under
    torch.profiler (idle share)."""
    shard = os.path.join(tmp, "res_lm_clean")
    write_records(shard, *synthetic_token_arrays(
        RES_LM_SHARD[0], seq_len=RES_LM_SHARD[1], vocab=256, seed=0))
    os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "0"
    runs = []
    try:
        for policy in ("kSkip", "", "", "kSkip"):
            tr = Trainer(res_lm_cfg(shard, policy), seed=0,
                         log=lambda s: None, device=dev)
            ms = []
            for step in range(RES_LM_STEPS):
                t0 = time.perf_counter()
                tr.train_one_batch(step)
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            prof = (profile(tr, RES_LM_STEPS, 3) if dev.type == "cuda"
                    else {})
            runs.append({"guard": policy or "off", "bytes": state_bytes(tr),
                         "step_ms_median": median(ms[3:]),
                         "idle_share": prof.get("idle_share")})
            del tr
            release()
    finally:
        os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "512"
    check(all(r["bytes"] == runs[0]["bytes"] for r in runs),
          "resilience timing: guard on differs from guard off")
    out = {"runs": [{k: v for k, v in r.items() if k != "bytes"}
                    for r in runs]}
    on = median([runs[0]["step_ms_median"], runs[3]["step_ms_median"]])
    off = median([runs[1]["step_ms_median"], runs[2]["step_ms_median"]])
    out["guarded_over_unguarded"] = on / off
    print("resilience guard timing", json.dumps({**out, "card": smi}))
    return out


def res_rollback(dev, smi, shards) -> dict:
    """mlp_resilient.conf (display every step) under RES_ROLLBACK_FAULTS:
    one rollback to step_20, LR scale 0.5, the losses within NETS_TOL of
    the same drill on the CPU, the step after the rollback replaying the
    graph on the restored tensors (same addresses), graphed equal to
    eager."""
    from singa_tpu_torch.config import load_cluster_config

    out = {}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        conf = res_conf(tmp, shards, "rollback", RES_CONFS["resilient"],
                        [("display_frequency: 20", "display_frequency: 1")])
        for where, graphs in ((dev, None), (dev, False),
                              (torch.device("cpu"), None)):
            tag = f"{where.type}_{'eager' if graphs is False else 'graph'}"
            log = ResLog()
            cl = load_cluster_config(res_cluster(tmp, "rb_" + tag))
            tr, ctx = res_guarded(where, load_model_config(conf),
                                  RES_ROLLBACK_FAULTS, cl, log, graphs=graphs)
            ptrs = {}
            orig = tr.rollback_to

            def rollback_to(path, tr=tr, orig=orig, ptrs=ptrs):
                ptrs["before"] = [v.data_ptr() for v in
                                  list(tr.params.values())
                                  + list(tr.buffers.values())]
                ptrs["calls"] = graph_calls(tr)
                step = orig(path)
                ptrs["after"] = [v.data_ptr() for v in
                                 list(tr.params.values())
                                 + list(tr.buffers.values())]
                return step

            tr.rollback_to = rollback_to
            try:
                tr.run()
            finally:
                ctx.stop()
            g = tr.guard_counters()
            check(ctx.rollbacks == 1 and g["lr_scale"] == 0.5,
                  f"resilience rollback {tag}: {ctx.rollbacks} rollbacks, "
                  f"{g}")
            check(any("rolling back to" in s and "step_20.npz" in s
                      for s in log.lines),
                  f"resilience rollback {tag}: not back to step_20")
            check(ptrs["before"] == ptrs["after"],
                  f"resilience rollback {tag}: the restore moved tensors")
            if graphs is None:
                check(graph_calls(tr) > ptrs["calls"],
                      f"resilience rollback {tag}: no graph step after it")
            runs[tag] = (log.losses(), state_bytes(tr))
            del tr
            release()
    (cl_, cb), (el, eb), (hl, _) = (runs[f"{dev.type}_graph"],
                                    runs[f"{dev.type}_eager"],
                                    runs["cpu_graph"])
    check(cb == eb, "resilience rollback: graphed differs from eager")
    diff = float(np.max(np.abs(np.asarray(cl_) - np.asarray(hl))))
    check(len(cl_) == len(hl) and diff <= NETS_TOL,
          f"resilience rollback: losses {diff} from the CPU's")
    out = {"rollbacks": 1, "lr_scale": 0.5, "max_loss_diff_vs_cpu": diff,
           "graph_equals_eager": True}
    print("resilience rollback", json.dumps({**out, "card": smi}))
    return out


def graph_calls(tr) -> int:
    """The train graph's replays and eager body calls so far."""
    g = tr._g
    return 0 if g is None else g.run.replays + g.run.eager_calls


def res_ring(dev, smi, tmp) -> dict:
    """tinylm_d128.conf with the q8wire ring on 4 ranks of the card, kSkip,
    the poison token in rank RES_RING_RANK's slice of step RES_RING_BAD:
    every rank skips (params, slots, the ring's residuals bitwise as
    before the step) -> the quant_acc launches."""
    bs = 64
    shard = res_lm_shard(tmp, 256, RES_RING_BAD * bs
                         + RES_RING_RANK * bs // RING_RANKS + 3)
    cfg = load_model_config(RING_CONF)
    for layer in cfg.neuralnet.layer:
        if layer.type == "kSequenceData":
            layer.data_param.path = shard
    apply_grad_comm_tag(cfg, "q8wire")
    cfg.grad_comm.buckets = 4
    from singa_tpu_torch.config.schema import ResilienceConfig

    cfg.resilience = ResilienceConfig()
    cfg.resilience.guard_policy = "kSkip"
    tr = Trainer(cfg, mesh=build_mesh(RING_RANKS, 1, [dev] * RING_RANKS),
                 seed=0, log=lambda s: None)
    poison_table(tr)
    zero_launches()
    for step in range(RES_RING_STEPS):
        if step == RES_RING_BAD:
            before = state_bytes(tr)
        tr.train_one_batch(step)
        if step == RES_RING_BAD:
            after = state_bytes(tr)
    sync(dev)
    launches = qc.quant_acc.launches
    res = [k for k in before if k[0] == "b" and "__gradres__" in k[1]]
    check(res and all(before[k] == after[k] for k in res),
          "resilience ring: the residuals moved on the dropped step")
    check(before == after, "resilience ring: the dropped step moved state")
    check(tr.guard_counters()["bad_steps"] == 1,
          f"resilience ring: {tr.guard_counters()}")
    out = {"ranks": RING_RANKS, "bad_rank": RES_RING_RANK,
           "residuals": len(res), "quant_acc_launches": launches,
           "per_step": launches / RES_RING_STEPS}
    del tr
    release()
    print("resilience ring", json.dumps({**out, "card": smi}))
    return launches


def res_engines(dev, smi, shards, tmp) -> dict:
    """mlp.conf on cluster_elastic.conf at 4 replicas (warmup cut to 2)
    under kSkip with nanloss@RES_REPLICA_BAD: every replica and the
    center unchanged through that step; rbm.conf under kSkip with
    nanloss@RES_CD_BAD: the step dropped."""
    from singa_tpu_torch.config import load_cluster_config
    from singa_tpu_torch.config.schema import ResilienceConfig

    out = {}
    text = replica_mlp_text(shards, [("warmup_steps: 60", "warmup_steps: 2")])
    cfg = parse_model_config(text)
    cfg.resilience = ResilienceConfig()
    cfg.resilience.guard_policy = "kSkip"
    tr, ctx = res_guarded(dev, cfg, f"nanloss@{RES_REPLICA_BAD}",
                          load_cluster_config(replica_cluster(tmp, "res")))
    check(type(tr).__name__ == "ReplicaTrainer", "resilience: no replicas")
    for step in range(RES_REPLICA_BAD + 2):
        if step == RES_REPLICA_BAD:
            before = (state_bytes(tr), host64(tr.center))
        tr.train_one_batch(step)
        if step == RES_REPLICA_BAD:
            after = (state_bytes(tr), host64(tr.center))
    ctx.stop()
    same_center = all(np.array_equal(before[1][n], after[1][n])
                      for n in before[1])
    check(before[0] == after[0] and same_center,
          "resilience replica: the bad step moved a replica or the center")
    check(tr.guard_counters()["bad_steps"] == 1, "resilience replica: "
          f"{tr.guard_counters()}")
    out["replica"] = {"replicas": tr.nreplicas, "bad_step": RES_REPLICA_BAD}
    del tr
    release()
    cfg = rbm_config(shards)
    cfg.resilience = ResilienceConfig()
    cfg.resilience.guard_policy = "kSkip"
    tr, ctx = res_guarded(dev, cfg, f"nanloss@{RES_CD_BAD}")
    for step in range(RES_CD_BAD + 2):
        if step == RES_CD_BAD:
            before = state_bytes(tr)
        tr.train_one_batch(step)
        if step == RES_CD_BAD:
            after = state_bytes(tr)
    ctx.stop()
    check(before == after and tr.guard_counters()["bad_steps"] == 1,
          "resilience cd: the bad step was not dropped")
    out["cd"] = {"bad_step": RES_CD_BAD}
    del tr
    release()
    print("resilience engines", json.dumps({**out, "card": smi}))
    return out


def res_watchdog(dev, smi, shards) -> dict:
    """mlp_resilient.conf with watchdog_timeout 2 and slowstep@3=2.6: the
    watchdog dumps the thread stacks, the train loop's frame among
    them."""
    with tempfile.TemporaryDirectory() as tmp:
        conf = res_conf(tmp, shards, "watchdog", RES_CONFS["resilient"], [
            ("watchdog_timeout: 300.0", "watchdog_timeout: 2.0"),
            ("train_steps: 60", "train_steps: 5")])
        log = ResLog()
        tr, ctx = res_guarded(dev, load_model_config(conf), "slowstep@3=2.6",
                              None, log)
        try:
            tr.run()
        finally:
            ctx.stop()
    dump = "\n".join(log.lines)
    check("WATCHDOG: step 3" in dump and ctx.watchdog.stalls == 1,
          "resilience watchdog: no stall dump")
    check('trainer.py", line' in dump and "in run" in dump,
          "resilience watchdog: the dump lacks the train loop's frame")
    out = {"stalls": ctx.watchdog.stalls}
    del tr
    release()
    print("resilience watchdog", json.dumps({**out, "card": smi}))
    return out


def res_saves(dev, smi, tmp) -> dict:
    """resnet50.conf as written (bf16, batch 256, graphed) for
    RES_RESNET_STEPS steps with no saves, no saves under the kSkip guard,
    sync saves and async saves every RES_RESNET_EVERY, in that order,
    cuDNN deterministic (the saves compared across runs): each run's step
    ms (wall / steps to a device sync) and the host ms each save holds
    the step loop (Trainer.save's call); the guarded run's params and
    slots equal the unguarded run's to the bit, with no bad step; the
    async saves' arrays equal the sync saves' to the bit."""
    from singa_tpu_torch.config import load_cluster_config
    from singa_tpu_torch.config.schema import ResilienceConfig

    out = {}
    shards_dir = os.path.join(tmp, "res_resnet")
    os.makedirs(shards_dir, exist_ok=True)
    shards = {k: os.path.join(shards_dir, k) for k in ("train", "test")}
    write_records(shards["train"], *imagenet_shaped_arrays(
        RES_RESNET_RECORDS[0]))
    write_records(shards["test"], *imagenet_shaped_arrays(
        RES_RESNET_RECORDS[1], noise_seed=1))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("none", "guard", "sync", "async"):
            cfg = resnet_config(shards)
            cfg.train_steps = RES_RESNET_STEPS
            saving = mode in ("sync", "async")
            cfg.checkpoint_frequency = RES_RESNET_EVERY if saving else 0
            cfg.display_frequency = 0
            cfg.resilience = ResilienceConfig()
            cfg.resilience.async_checkpoint = mode == "async"
            cfg.resilience.keep_last = 0
            if mode == "guard":
                cfg.resilience.guard_policy = "kSkip"
            # no workspace, no saves at all
            cl = (load_cluster_config(res_cluster(tmp, "resnet_" + mode))
                  if saving else None)
            tr, ctx = res_guarded(dev, cfg, "", cl)
            saves, end = [], []
            save = tr.save

            def timed_save(step, save=save, saves=saves, end=end):
                if step == RES_RESNET_STEPS:
                    # the end-of-run save: the timed steps end here
                    sync(dev)
                    end.append(time.perf_counter())
                t0 = time.perf_counter()
                path = save(step)
                saves.append((time.perf_counter() - t0) * 1e3)
                return path

            tr.save = timed_save
            tr.train_one_batch(0)  # the eager first step and the capture
            tr.train_one_batch(1)
            tr.start_step = tr.completed_steps = 2
            sync(dev)
            t0 = time.perf_counter()
            try:
                tr.run()
                sync(dev)
                end.append(time.perf_counter())
                ctx.flush_async()
            finally:
                ctx.stop()
            wall = (end[0] - t0) * 1e3
            out[mode] = {"step_ms": wall / (RES_RESNET_STEPS - 2),
                         # the last is the end-of-run save, outside
                         "save_ms": saves[:-1], "saves": len(saves),
                         "dispatch": tr.dispatch_mode}
            check(tr.dispatch_mode == "graph",
                  f"resilience saves {mode}: not graphed")
            if mode in ("none", "guard"):
                out[mode]["digest"] = tr.digest()
            if mode == "guard":
                bad = tr.guard_counters()["bad_steps"]
                check(bad == 0 and out["guard"]["digest"]
                      == out["none"]["digest"],
                      f"resilience saves: the guarded ResNet step ({bad} "
                      "bad) differs from the unguarded one")
            del tr
            release()
    finally:
        torch.backends.cudnn.deterministic = det
    n = 0
    for step in range(RES_RESNET_EVERY, RES_RESNET_STEPS + 1,
                      RES_RESNET_EVERY):
        a = os.path.join(res_ckpts(tmp, "resnet_sync"), f"step_{step}.npz")
        b = os.path.join(res_ckpts(tmp, "resnet_async"), f"step_{step}.npz")
        with np.load(a) as za, np.load(b) as zb:
            check(sorted(za.files) == sorted(zb.files) and all(
                np.array_equal(za[k], zb[k]) for k in za.files),
                f"resilience saves: step_{step} async differs from sync")
            n += 1
            if step == RES_RESNET_EVERY:
                out["save_mb"] = sum(za[k].nbytes for k in za.files) / 1e6
    out["saves_compared"] = n
    print("resilience saves", json.dumps({**out, "card": smi}))
    return out


def resilience_phase(dev, smi, tmp) -> dict:
    """Phase 21 (see the module docstring) -> the guarded LM's flash
    launches and the ring drill's quant_acc launches."""
    t0 = time.perf_counter()
    took = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[name] = time.perf_counter() - t
        return out

    shards = part("shards", replica_shards, tmp)
    # the drills' children run while this process checks the guard in
    # its own runs (wave 1 beside the guard and the rollback, wave 2, the
    # relaunches, beside the ring, the engines and the watchdog); the
    # timed parts wait for them all
    wave1, runs = part("start", res_drills, dev, tmp, shards)
    wave2 = []
    try:
        launches = part("guard", res_guard_graph, dev, smi, tmp)
        part("rollback", res_rollback, dev, smi, shards)
        out, got, wave2 = part("drills", res_drills_check, dev, tmp, wave1,
                               runs)
        ring = part("ring", res_ring, dev, smi, tmp)
        part("engines", res_engines, dev, smi, shards, tmp)
        part("watchdog", res_watchdog, dev, smi, shards)
    except BaseException:
        stop_all([p for _, _, p, _ in wave1 + wave2])
        raise
    part("relaunches", res_relaunch_check, smi, tmp, out, got, wave2)
    part("timing", res_guard_timing, dev, smi, tmp)
    part("saves", res_saves, dev, smi, tmp)
    print(f"resilience phase {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in took.items())})")
    return {"flash": launches, "quant_acc": ring}


def short_kernel_name(mangled: str) -> str:
    """'_ZN12_GLOBAL__N_124flash_bwd_dq_bf16_kernelILi128ELb1EEEv...' ->
    'flash_bwd_dq_bf16_kernel<128,1>' (the last name of the nested name,
    its type argument, then its integer and bool arguments)."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group()
        i += len(n)
        name = mangled[i:i + int(n)]
        i += int(n)
    tmpl = mangled[i:]
    if not tmpl.startswith("I"):
        return name
    args = re.findall(r"L[ib](\d+)E", tmpl.split("EE")[0] + "E")
    kind = ("bf16," if tmpl.startswith("I13__nv_bfloat16")
            else "f32," if tmpl.startswith("If") else "")
    return f"{name}<{kind}{','.join(args)}>"


def ptxas_report(logs):
    """Print each kernel's register and spill lines from the nvcc logs
    (``-Xptxas -v``) -> {library: [kernels that spill]}."""
    spills = {}
    for lib, log in logs.items():
        spills[lib], kernel = [], "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                kernel = short_kernel_name(entry.group(1))
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib} {kernel}: {line.strip()}")
            stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
            if stores and (int(stores.group(1)) or int(stores.group(2))):
                spills[lib].append(kernel)
    return spills


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'already built'})")
    spills = ptxas_report(logs)
    t0 = time.perf_counter()
    libs = [os.path.basename(native.build(n))
            for n in ("shardcodec", "lmdbcodec")]
    print(f"native codec build (g++) {time.perf_counter() - t0:.1f} s: "
          f"{', '.join(libs)}")
    for lib in SPILL_FREE:
        check(lib in logs, f"{lib}: no ptxas report (not built by this "
              "run)")
        check(not spills[lib],
              f"{lib}: ptxas reports spills in {spills[lib]}")

    errs, rows = kernel_phase(dev, np.random.RandomState(0))

    cfg = TransformerConfig(vocab=256, d_model=256, n_heads=2, n_layers=2,
                            d_ff=1024, max_len=2048)
    params = init_lm(torch.Generator().manual_seed(0), cfg, dev)
    launches = {
        "paged_attention": serve_phase(dev, cfg, params),
        "paged_attention_overlay": spec_phase(dev, cfg, params),
    }
    prefix_launches = prefix_phase(dev, smi, cfg, params)
    fleet_launches = fleet_phase(dev, smi, cfg, params)
    flash_errs, flash_rows = flash_phase(dev)
    bf16_launches, f32_launches = train_phase(dev)
    launches.update(bf16_launches)
    ring_err, ring_row, launches["quant_acc"] = ring_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        shards = write_net_shards(tmp)
        _, shards["ae_init"] = rbm_phase(dev, smi, shards, tmp)
        nets_phase(dev, smi, shards)
        dispatch_phase(dev, smi, cfg, params, shards["ae_init"])
    resnet_phase(dev, smi)
    lmdb_phase(dev, smi)
    moe_launches = moe_phase(dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        shard = write_shard(tmp)
        decode_launches, rolling_launches = decode_phase(dev, smi, shard)
        zero_ring_launches, zero_ref = zero_phase(dev, smi, shard)
        procs_launches = procs_phase(dev, smi, shard, zero_ref, tmp)
        axes_launches_by_path = axes_phase(dev, smi, tmp)
        replica_launches = replica_phase(dev, smi, tmp)
        res_launches = resilience_phase(dev, smi, tmp)

    kernels = []
    for name, case in (("paged_attention", "decode"),
                       ("paged_attention_overlay", "overlay")):
        row = rows[case]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
        if name == "paged_attention":
            kernels[-1]["moe_serve_launches"] = moe_launches[name]
            kernels[-1]["prefix_launches"] = prefix_launches
            kernels[-1]["fleet_launches"] = fleet_launches
    # the bf16 route (the main path's), then the float32 route, whose
    # launches are those of the train phase's first float32 flash run
    for dtype, suffix, counts in ((torch.bfloat16, "", launches),
                                  (torch.float32, "_f32", f32_launches)):
        for name in FLASH_ROUTES[dtype]:
            row = flash_rows[dtype][name]
            kernels.append({
                "name": name + suffix, "route": "cuda",
                "source": FLASH_SOURCES[name, dtype],
                "replaces": FLASH[name][1], "launches": counts[name],
                "max_abs_err": flash_errs[dtype][name], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
            })
            if name == "flash_bwd":
                kernels[-1]["replaces_also"] = (
                    "singa_tpu/ops/attention.py:451")
            if dtype == torch.bfloat16:
                kernels[-1]["moe_train_launches"] = moe_launches[name]
                kernels[-1]["decode_train_launches"] = decode_launches[name]
                # the resilience phase's guarded graphed LM run
                kernels[-1]["resilience_launches"] = res_launches["flash"][
                    name]
            else:
                if name == "flash_fwd":
                    kernels[-1]["decode_rolling_launches"] = (
                        rolling_launches)
                # the axes phase's float32 runs, by path
                kernels[-1]["axes_launches"] = {
                    path: got[name]
                    for path, got in axes_launches_by_path.items()}
            # the replica phase's LM run of this type
            kernels[-1]["replica_launches"] = replica_launches[
                "bfloat16" if dtype == torch.bfloat16 else "float32"][name]
    kernels.append({
        "name": "quant_acc", "route": "cuda", "source": RING_SOURCE,
        "replaces": RING_REPLACES, "launches": launches["quant_acc"],
        "max_abs_err": ring_err, "ms": ring_row["ms"],
        "plain_ms": ring_row["plain_ms"], "bound_ms": ring_row["bound_ms"],
        "bound_by": ring_row["bound_by"],
        "library_ms": ring_row["library_ms"],
        "m": RING_TIMED[0], "amax_ms": ring_row["amax_ms"],
        "amax_bound_ms": ring_row["amax_bound_ms"],
        "zero_ring_launches": zero_ring_launches,
        "procs_launches": procs_launches["lm"],
        "procs_zero_ring_launches": procs_launches["zero_ring"],
        "axes_launches": axes_launches_by_path["q8"]["quant_acc"],
        "resilience_launches": res_launches["quant_acc"],
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
