#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-timing [ROOT]   # flash alone, ROOT's port
    python3 chip_smoke.py --mlp-losses            # phase 5's losses per routed-kernel path
    python3 chip_smoke.py --routed-paged-timing [ROOT]  # routed_attention, paged, dispatch, ragged attn
    python3 chip_smoke.py --train-runs [ROOT]     # phases 5 and 9c training alone, ROOT's port
    python3 chip_smoke.py --ssm-losses            # phase 9c's losses per SSD path and SiLU
    python3 chip_smoke.py --moe                   # phase 12 (the MoE family) alone
    python3 chip_smoke.py --overload              # phase 13 (overload and faults) alone
    python3 chip_smoke.py --configs               # phase 14 (dense configs, hybrid) alone
    python3 chip_smoke.py --encdec-vlm            # phase 15 (whisper-tiny, qwen2-vl-7b) alone
    python3 chip_smoke.py --mesh                  # phase 16 (data_shards, the mesh engine) alone
    python3 chip_smoke.py --mesh-train            # phase 17 (the mesh trainer) alone
    python3 chip_smoke.py --hybrid-remat          # phase 18 (narrow hybrid, remat, packing) alone
    python3 chip_smoke.py --tp-families           # phase 19 (TP of every family) alone

Imports nothing of JAX or of the JAX package. Builds the port's CUDA
kernels from ``src/repro_torch/kernels/csrc`` and runs, in order (any
failure raises and exits non-zero):

1. the device line: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, kernel build time;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the ``mod-paper-1b`` serving and training paths give it, with
   timings (CUDA-graph replay; torch.profiler only for a plain version
   named as not capturing, said on its line) of the kernel, the plain version and, where
   one exists, one PyTorch library call as a yardstick (never called by
   the port); the MoD dispatch (gather, gated scatter-add and gather's VJP,
   the scatter's zero target) bitwise at a served prompt's shapes and at
   the mod-paper-1b and mamba2-1.3b training shapes, f32 and bf16, with
   each call's plan, and one scatter, one gather backward and one ragged
   scatter listed by torch.profiler as one launch each (no memset, fill or
   copy), and ragged paged flash attention listed as one launch in one
   key chunk and as its kernel and merge past it; flash attention at six bf16 shapes (prefill S=1000 and
   2048, decode B=8 ctx 1056, the training call with its lse, the routed
   layers' prefill and one-launch decode) against SDPA, and at cases that
   reach every plan (both wgmma key-split halves, a wrapped ring, a
   window, rows with no valid key, head dims 64 and 256, decode in one
   chunk and in many), with its lse within 1e-4, a row's bits equal
   whatever Skv and B, HGMMA asserted in its wgmma tile kernels' SASS
   and HMMA in its mma.sync tile and decode kernels; routed_attention and
   routed_mlp_scatter with HGMMA (wgmma) asserted in their bf16 GEMM
   kernels' SASS and HMMA in routed_attention's bf16 attention core, the
   GEMM path each launch recorded per row, and for the MLP a library
   figure (rms_norm, three cuBLAS products and index_copy_: not one call);
   the three paged-pool kernels (page gather, decode-row scatter, ragged
   write-back) at the shapes of phase 6c and odd tails, bitwise, with the
   in-place scatters held to their target rows and the flat grids' plans
   (vector width, blocks) of all three on their lines (both scatters also
   with rows 4 bytes off an aligned base; the decode-row scatter also with
   positions and table entries out of range, which it clamps);
   the dequantizing page gather (int8/page and fp8/head pages widened to
   bf16 at phase 7b's shapes) and the ragged MoD gather/scatter (phase
   8b's flat streams), bitwise, after the card's int8/e4m3 casts and pow2
   scales are held to the CPU's; then the gradients of the five
   differentiable kernel wrappers (their ``autograd.Function``) against
   autograd through the plain versions;
3. the port against itself across devices, ``mod-paper-60m`` at full width
   and depth in f32, the same weights on the CPU (plain versions) and on
   the card (kernels): with backend ``pallas`` a 256-token prefill and 16
   teacher-forced decode steps; with backend ``pallas_fused`` one train
   step (B=2, S=256): loss, gradient norm, post-AdamW parameters and the
   routed masks of every MoD layer;
4. the serving path: ``mod-paper-1b`` in bf16 through the port's
   ``ServingEngine`` (8 slots, 16 greedy requests, prompts of 128-1024
   tokens, 32 new tokens each), with every kernel's launch count read
   from this phase alone;
5. the training path: ``mod-paper-1b`` in bf16, backend ``pallas_fused``,
   B=4 at S=2048, 5 steps through the port's ``Trainer``: per-step loss,
   wall time, device-busy time and idle share, and every kernel's launch
   count read from this phase alone (routed_attention's and
   routed_mlp_scatter's by GEMM path, every one on the wgmma GEMM);
6. paged serving: ``mod-paper-60m`` f32 through the paged engine with the
   prefix cache and through the ragged engine, CPU against the card
   (identical greedy streams; run after phase 3), then ``mod-paper-1b``
   bf16, 8 requests sharing a 512-token prefix, through the contiguous,
   paged, prefix-cached and ragged engines: identical streams, the prefix
   cache's saving, 3 paged gathers and scatters a full layer per decode step, the
   ragged write-back's launches, and one profiled paged decode step;
7. quantized paged-KV serving: ``mod-paper-60m`` f32 through the quantized
   paged + prefix and ragged engines (int8/page, fp8/head) and with int8
   weights, CPU against the card (identical streams and kv_bytes), then
   ``mod-paper-1b`` bf16 on phase 6c's workload and weights through four
   quantized engines: throughput, pool and KV bytes against phase 6c's
   unquantized pool (at least 1.9x less), tokens equal to the unquantized
   streams, each request's first-token top-1/top-2 gap beside the change
   quantization made to those logits, launches, one profiled decode step
   (2 dequantizing gathers and 1 plain one a full layer) and the cost of widening
   int8 weights;
8. the flat ragged forward (``model_forward_ragged``): ``mod-paper-60m``
   f32 on unequal segments, CPU against the card (equal routed masks,
   logits within 1e-4), then ``mod-paper-1b`` on 4 equal segments of 1024
   against the padded forward (f32 with the same weights, and bf16), the
   bf16 flat forward routed as the f32 one against it (logits and router
   scores within BF16_FLAT_LOGITS / BF16_FLAT_SCORES), and on 8 unequal
   segments on T=4096, timed, with one ragged gather and one ragged
   scatter a routed layer per forward;
9. the Mamba2 family (``mamba2-1.3b``): (a) the SSD intra-chunk kernel
   against its plain version at the training forward's shapes (full
   blocks NC=16, routed blocks NC=2, in the model's strided layout) and two
   odd small ones, f32 and bf16 inputs, mamba2's A and dt (the decay's
   overflow region present), each on the path ``ssd_plan`` picks (bf16
   with widths in multiples of 16 on tensor cores, HMMA asserted in its
   SASS; the rest on CUDA cores), with times and bound, an A/B of the two
   paths at the full shape in bf16, its gradient at the routed shape and
   its backward's time at the full shape; (b) the port against itself
   across devices at full width and 2 layers in f32: forward (B=2,
   S=256), one Trainer step, 16 decode steps and the stepped engine's
   streams; (c) training at full width and 6 of the 48 layers (depth cut
   for the script's time limit), bf16, B=4, S=2048, remat "full", 5 Trainer
   steps, profiled, with
   the SSD, gather and scatter launches of this phase alone; (d) stepped
   serving at full width and 2 of the 48 layers (depth cut for the
   script's time limit), 8 slots, 16 greedy requests, prompts of 32-128
   tokens, 16 new tokens each;
10. the op entry point (``repro_torch.kernels.ops``; run after phase 8b,
   while mod-paper-1b's weights are on the card): its counted run calls
   ``ragged_attention_op`` on three live pools and ``swiglu_op`` at two
   sizes, bf16, with launches read from that run alone (phases 4-9 must
   launch neither kernel); then (a) ragged paged flash attention on layer
   0's pages, positions and table of phase 6c's paged + prefix pool after
   its prefills: a decode step (one row per slot, seg_cap 1) and a mixed
   step (the decode rows, a 256-row prefill segment of slot 0 and a flat
   tail, seg_cap 256), the kernel against its plain version in bf16 and
   f32 and its rows against the gather + flash path, timed beside its
   bound; (b) the same on phase 7b's int8/page and fp8/head pools (their
   scales expanded to (N, p, nkv)) against the dequantizing gather +
   flash; every call's plan (``ragged.ragged_attention_plan``: the mma
   path for bf16 queries, f32 for f32) printed (phase 2 asserts by
   torch.profiler that a one-chunk call is one kernel and a split call the
   kernel and its merge, nothing else); (c) SwiGLU at mod-paper-1b's MLP (layer 0's weights), M = 1024
   and 8192, bf16 and f32, and two odd shapes: the kernel against its plain
   version, the plain version against an f64 product rounded at JAX's
   points, timed beside its bound and the library's products, with HGMMA
   asserted in its bf16 GEMM kernels' SASS and the GEMM path per row; (d)
   the ragged kernel's edge cases at small shapes;
11. self-speculative serving (``EngineConfig.speculate``): (a)
   ``mod-paper-60m`` f32, the same weights on the CPU and the card, the
   paged engine drafting 3 tokens a round at draft ratio 0.0 (two passes)
   and 0.125 (the model's ratio: one fused chain): identical streams on both
   devices, equal to the card's non-speculative paged engine's; (b)
   ``mod-paper-1b`` bf16 on phase 6c's workload and weights, ``speculate=3``,
   through the paged engine at draft ratios 0.0 and 0.125, the prefix-cached
   and the ragged engine at 0.0 and the int8/page prefix engine at 0.0:
   streams equal phase 6c's (7b's for int8), the fused run above 3 tokens a
   round; rounds, accept rate, tokens a round, wall and device-busy ms a
   round and an accepted token (one profiled round with every slot
   generating), peak memory and each kernel's launches a round, where only
   the paged gathers, flash attention and the ragged write-back may launch
   (by launch counter, and by torch.profiler against the ``__global__``
   functions of ``csrc``);
12. the MoE family (``[moe]`` lines; run after phase 9, phases 4-11's
   weights freed): (a) ``olmoe-1b-7b`` (staged MoDE) and ``phi3.5-moe-imode``
   (integrated MoDE) at smoke size, f32, the same weights on the CPU and
   the card under the backends xla, pallas and pallas_fused: logits within
   1e-5, the dropped and no-op fractions equal and the other aux within
   1e-5, the launches of each backend's kernels; greedy streams of the
   paged engine equal on both devices and in a second card run (the
   deterministic combine); (b) ``olmoe-1b-7b`` bf16 at full width and
   MOE_SERVE_LAYERS of its 16 layers (64 experts top-8, random weights from seed 0) on phase 6c's
   workload through the paged + prefix, ragged and fused speculative
   engines (``speculate=3``, draft ratio 0.125, the first 16 new tokens):
   streams equal; tok/s, prefill ms a prompt, decode wall and (one
   profiled step or round with every slot generating) busy ms and idle
   share, peak memory, ``kv_bytes``, the mean ``moe/drop_frac`` of the
   prefill and decode MoE calls; the profiled step's launches held to its
   layers by counter and to torch.profiler's ``__global__`` names; (c)
   ``phi3.5-moe-imode`` bf16 at full width, 4 of its 32 layers: a padded
   prefill of 4 prompts and 16 decode steps, ``moe/noop_frac`` and the
   busy time a step; (d) ``olmoe-1b-7b`` bf16 at full width, 4 of its 16
   layers (depth cut: the whole model's f32 AdamW moments do not fit),
   pallas_fused, B=2, S=2048, 3 steps: finite losses, busy ms a step by
   kernel group and of the MoE's own forward ops, peak memory;
13. overload control and fault injection (``[overload]`` lines; run last,
   on mod-paper-1b weights made anew from seed 0): (a) ``mod-paper-60m`` f32, the
   same weights on the CPU and the card: the adaptive paged + prefix
   engine under an explicit controller and a step clock (latency and batch
   tiers, a deadline that expires queued and one mid-decode, a
   cancellation, a ``max_queue`` rejection), and
   ``FaultInjector.seeded(0, n_faults=6, horizon=30)`` on the paged, ragged
   and speculative engines and on ``mod-paper-60m-vanilla``: levels,
   streams, finish reasons, fired logs and counters equal on both devices,
   the pool's books recounted after every step, the vanilla survivors'
   streams equal a fault-free run's; (b) ``mod-paper-1b`` bf16, the paged
   + prefix engine with 32 slots on ``PAGED_1B``'s prompt shape, 48
   requests of 16 tokens at once: under ``OVERLOAD_CTRL_1B`` the walk
   reaches level 2 and ends at 0, the routed layers' decode flash calls
   run at kb = 4 / 2 / 1 as often as the steps at levels 0 / 1 / 2 by the
   wrapper's counter, a profiled decode-only step at each level shows
   torch.profiler as many flash kernels as the counter (its busy ms
   printed); all latency-tier under the same controller, no step degrades
   and the streams equal an uncontrolled run's bitwise; (c) the same
   engine under the seeded matrix plus a hold of every page at step 4:
   JAX's fault contract, and a preemption while the pages are held.
14. the further dense configs and the Zamba2 hybrid (``[configs]`` lines;
   run after phase 12, before phase 13; each model freed before the next
   is made): (a) reduced configs that keep what sets each model apart
   (granite-8b GQA 8/2, granite-20b MQA 48/1, mistral-nemo d_model 160
   against nq*hd 128, qwen2 group 7 with non-zero q/k/v biases, zamba2 at
   head dims 32 and 80) in f32, the same weights on the CPU and the card:
   logits within 1e-4 of their largest, routed masks equal, the card's
   launches, greedy streams equal on both devices (paged + prefix and
   ragged engines; the hybrid's stepped engine on both pools); (b) flash
   attention at head dim 80 (f32 and bf16 prefill S=1000, bf16 S=2048,
   decode B=8 over 9 chunks and in one) and at granite-20b's and qwen2's
   decode shapes (B=8 ctx 1056; qwen2's 4-token window), routed_attention
   and routed_mlp_scatter at mistral-nemo's, qwen2's and granite-20b's
   widths (k=128 of S=1024), ssd_intra_chunk at zamba2's forward shape:
   each against its plain version, its plan held, timed (CUDA-graph
   replay) beside its bound and (flash) SDPA; (c) granite-8b, granite-20b,
   mistral-nemo-12b and qwen2-7b at full width and CONFIGS_DENSE_LAYERS (8)
   of their layers, bf16, seed 0, backend pallas, on phase 6c's workload
   through the paged + prefix and ragged engines: streams equal, the prefix cache's saving, tok/s,
   prefill ms a prompt, decode wall and (a profiled step) busy ms, idle
   share, peak memory, ``kv_bytes`` and the launches (a step's held to its
   layers by counter and torch.profiler); (d) zamba2-2.7b at full width
   and HYBRID_LAYERS (6) of its 54 layers, bf16: phase 9d's 16 prompts
   (35-124 tokens), 32 new tokens, 8 slots (policy fcfs), on the
   contiguous and the paged pool (streams
   equal, a profiled step's launches held), then one teacher-forced
   forward at B=1, S=2048 (its loss finite, flash on mma.sync tiles at head
   dim 80 once per segment, the SSD kernel on tensor cores at d_state 64).
15. the enc-dec family and the VLM backbone (``[encdec-vlm]`` lines; after
   phase 14, before phase 13): (a) whisper-tiny's and qwen2-vl-7b's smoke
   configs in f32, the same weights on the CPU and the card: the forward's
   logits (the VLM over embeddings with an image's M-RoPE layout) within
   1e-4 of their largest, routed masks equal, one train step's loss and
   gradient norm, 8 decode steps, greedy streams on the contiguous and the
   paged pool; then flash attention at the shapes (b) and (c) give it
   (non-causal over whisper's 1500 frames, cross-attention decode over 12
   chunks + the merge, the decoder's training calls; qwen2-vl's S=2048
   forward) and gather_rows / scatter_add_rows at whisper's B=8 S=448
   D=384, each against its plain version and timed beside its bound and
   library call; (b) whisper-tiny at full size, bf16, seed 0: 3 training
   steps (B=8, decoder S=448, 1500 frames), then 8 slots serving 16
   requests (4-token prompts, 64 new tokens, frames of their own encoded
   once at admission) on both pools, streams equal, a profiled step's
   launches held; (c) qwen2-vl-7b at full width and depth, bf16: one B=1
   S=2048 forward over embeddings laid out as text, a 24 x 40 image and
   text (loss finite, flash on the t stream, the routed blocks by
   gather/scatter under pallas_fused), then 8 slots serving 8 text
   requests of 16-48 tokens, 16 new, on both pools, streams equal.
16. partitioned routing and the mesh engine (``[mesh]`` lines; after phase
   15, before phase 13): (a) ``mod-paper-1b`` at SERVE_1B_LAYERS, bf16,
   phase 4's 16 requests on 8 slots through the contiguous engine at
   ``data_shards`` 1, 2 and 4 and the paged + prefix and int8/page engines
   at 2: the global kb, every decode decision of every routed layer held to
   ``kb_local`` rows in each slot group (live rows first), a profiled decode
   step's wall and busy ms and idle share, tokens equal to ``data_shards=1``
   (a different function: reported, not held); (b) the contiguous engine
   over a one-rank NCCL mesh ``(1, 1)``: streams bitwise equal to (a)'s
   ``data_shards=1``, its launches counted (the kernels line's ``mesh``
   path); (c) two processes on the card over gloo (NCCL refuses two ranks
   on one device), ``mod-paper-60m`` f32 at PARITY_60M_LAYERS, meshes
   ``(2, 1)``, ``(1, 2)`` and ``("pod", "data", "model") = (2, 1, 1)``:
   streams equal to the single-process ``data_shards`` runs at the data
   degree (2, 1, 2), every decode step's logits within MESH_LOGITS_TOL.
17. the mesh trainer (``[mesh-train]`` lines; after phase 16, before phase
   13): (a) ``mod-paper-1b`` at SERVE_1B_LAYERS, bf16, ``pallas_fused``,
   B=4, S=2048, 3 steps of the Trainer over a one-rank NCCL mesh ``(1,
   1)``: pure DP's losses bitwise the single-process Trainer's on the same
   weights and batches with the fused kernels launched, FSDP's (the
   gather/scatter fallback) bitwise the single-process ``pallas`` run's; a
   profiled step's wall and busy ms and idle share beside one process's;
   the two mesh runs' launches are the kernels line's ``mesh_train`` path;
   (b) two gloo processes on the card, ``mod-paper-60m`` f32 at
   PARITY_60M_LAYERS, ``pallas_fused``, remat ``full``, B=8, S=128, 3
   steps on each of the meshes ``(2, 1)``, ``(1, 2)`` and ``(2, 1)+fsdp``
   in one spawn: losses within MESH_TRAIN_LOSS_RTOL and parameters within
   the AdamW-aware tolerance of the single-process run (made by this
   process while the ranks start), each rank's state bytes equal to its
   placement, each run's peak device memory beside one process's; one ``compressed_all_reduce`` of CUDA gradients bitwise the
   same call on CPU tensors; a two-stage ``pipeline_forward`` on CUDA
   tensors within MESH_TRAIN_PIPE_TOL of the sequential stages.
18. the hybrid from narrow pages and int8 weights, remat "selective", packed
   documents (``[hybrid-remat]`` lines; after phase 17, before phase 13):
   (a) ``zamba2-2.7b`` at full width and HYBRID_QUANT_LAYERS (18) of its 54
   layers, bf16, seed 0, 14d's paged engine (8 slots, page 16, fcfs) over 14d's
   first 2 requests in bf16 and under int8/page KV, fp8/head KV and int8
   weights: every request done with its tokens, tokens equal to the bf16
   run's and each first token's top-1/top-2 gap beside the logit change
   (reported), ``kv_bytes`` and its ratio to the bf16 pool's, wall a step,
   a profiled step's busy ms with its launches held to the sites by
   counter (2 dequantizing gathers, 1 plain gather and 3 + 2/3 scatters a
   site) and the dequantizing gathers torch.profiler lists (printed), the
   run's launches held to its steps, the cost of widening the int8
   weights; then bf16 on the int8 tree widened once, whose streams and
   first-token logits must be the int8-weights run's bits; then the
   kernels at phase 18's shapes against their plain versions, timed beside
   bound and library call: the dequantizing gather on every site's K and V
   ring of those pools as their profiled step left them (bitwise), the paged
   gather and decode-row scatter at those pools' rows, flash attention's
   training call at the shared block (32 heads of 80, B=2, S=2048), the
   MoD dispatch of the routed Mamba2 layers (B=2, S=2048, D=2560, k=256)
   and the SSD kernel at their full and routed shapes; (b) remat on the
   card: ``zamba2-2.7b`` at all 54 layers, bf16, B=2, S=2048, 3 Trainer
   steps under "selective" and then "full" ("none" does not fit), and
   ``mod-paper-1b`` at SERVE_1B_LAYERS, pallas_fused, B=4, S=2048, 2 steps
   under "none", "selective" and "full", from the same weights and
   batches: losses of steps 1-2 within REMAT_LOSS_RTOL across modes, busy
   and wall ms a step, the state's bytes, peak allocated and reserved
   memory, each run's launches; (c) one Trainer step of ``mod-paper-60m``
   (f32, PARITY_60M_LAYERS) with two microbatches on rows packed from
   documents (``data.packing.pack_documents``, its ``loss_mask``), CPU
   against the card within PACKED_TOL.
19. tensor parallelism of every family (``[tp-families]`` lines; after
   phase 18, before phase 13): granite-20b (MQA: its one kv head on both
   ranks) at full width and 2 of its 52 layers, f32, 3 Trainer steps
   (B=2, S=256) in this process first (its ~26 GB state freed before the
   ranks start); then two gloo processes on the card, mesh ``(1, 2)``,
   while this process makes the single-process runs: ``mamba2-1.3b`` at 4
   of 48 layers, ``zamba2-2.7b`` at 6 of 54 and ``whisper-tiny`` whole,
   f32, 3 Trainer steps each (losses within MESH_TRAIN_LOSS_RTOL) and 4
   greedy requests through the mesh engine (streams equal to one
   process), granite-20b's 3 steps, then one bf16 step of mamba2 and
   zamba2 (B=2, S=1024); each run's wall and busy ms of its last step,
   state bytes, peak and reserved memory beside one process's; the ranks'
   launches are the kernels line's ``tp_families`` and ``tp_train_kv``
   paths; then the kernels at the ranks' local shapes, each held to its
   plain version and timed beside its bound and library call: the SSD
   kernel on tensor cores at 32 (mamba2) and 40 (zamba2) heads, full and
   routed; flash at the shared block's 16 heads of 80 (bf16) and at
   granite-20b's 24 query heads over its one kv head (f32); gather /
   scatter at the bf16 steps' routed rows.

To keep the script inside its 1200 s, depth is cut where an earlier
phase does not need it: phases 4, 6c-11 and 13 serve ``mod-paper-1b`` at
full width and SERVE_1B_LAYERS (8) of its 24 layers (phase 5 trains all
24); phases 6b, 7a, 8a, 11a and 13a hold the CPU against the card on
``mod-paper-60m`` at PARITY_60M_LAYERS (4) of its 8 (phase 3 keeps all 8);
12b serves ``olmoe-1b-7b`` at MOE_SERVE_LAYERS (4) of its 16; 14d runs
``zamba2-2.7b`` at HYBRID_LAYERS (6) of its 54 (18a at 18, 18b trains
all 54); 14c serves the four dense models at CONFIGS_DENSE_LAYERS (8) of
theirs. Phase 15
runs its models whole. Each phase's wall time is printed on a ``[time]``
line.

``--flash-timing [ROOT]`` only times the flash kernel of the port under
ROOT (default: this checkout) at phase 2's six FLASH_TIMED bf16 shapes
beside SDPA, three readings each: run it on a parent tree and this one in
turns (parent, this, this, parent) in one call to compare two kernels.
``--routed-paged-timing [ROOT]`` only times routed_attention (bf16, the
1b training shape; with torch.profiler's split of one call by kernel),
paged_scatter_rows and paged_gather (phase 2's shapes on phase 6c's
tables) and the MoD dispatch (gather and scatter at a served prompt's and
both training shapes, gather's VJP at the training shapes, phase 8b's
ragged pair; ``dispatch_timing``) and ragged paged flash attention
(phase 10's decode and mixed steps, bf16 queries, on a bf16 and an int8
pool of ``PAGED_1B``'s layout made from a seed, no engine run;
``ragged_attention_timing``) of the port under ROOT beside their
plain versions or library calls, three readings each in turns: run it on
a parent tree and this one in one call to compare two versions of the
kernels.
``--train-runs [ROOT]`` only runs phase 5's and phase 9c's training on the
port under ROOT (default: this checkout), with their losses, busy time and
kernel groups per step: run it on a parent tree and this one in one call
to compare them on one card.
``--ssm-losses`` only runs phase 9c's training four times: as the port
runs it, with the SSD kernel forced onto its CUDA-core path, as its plain
version, and on the CUDA-core path with ``F.silu`` in the SSM blocks, and
prints the four loss trajectories.
``--moe`` builds the kernels and runs phase 12 alone; ``--overload``
phase 13 alone; ``--configs`` phase 14 alone; ``--encdec-vlm`` phase 15
alone; ``--mesh`` phase 16 alone; ``--mesh-train`` phase 17 alone;
``--hybrid-remat`` phase 18 alone; ``--tp-families`` phase 19 alone.
``--mlp-losses`` only runs phase 5's training four times, with
routed_mlp_scatter on the wgmma GEMM, on the CUDA-core GEMM and as its
plain version, and with routed_attention as its plain version, and prints
the four loss trajectories.

It prints a ``{"kernels": [...]}`` line, then the card's ``nvidia-smi`` line,
then as the last line ``{"ok": true, "device": {...}}``. Without a CUDA
device it prints no result and exits 2.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 CUDA cores
SOURCES = {
    "gather_rows": ("src/repro_torch/kernels/csrc/routing.cu",
                    "src/repro/kernels/routing.py:81"),
    "scatter_add_rows": ("src/repro_torch/kernels/csrc/routing.cu",
                         "src/repro/kernels/routing.py:118"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:146"),
    "routed_attention": ("src/repro_torch/kernels/csrc/routed_attention.cu",
                         "src/repro/kernels/flash_attention.py:348"),
    "routed_mlp_scatter": ("src/repro_torch/kernels/csrc/routed_mlp.cu",
                           "src/repro/kernels/swiglu.py:195"),
    "paged_gather": ("src/repro_torch/kernels/csrc/paged.cu",
                     "src/repro/kernels/paged.py:100"),
    "paged_scatter_rows": ("src/repro_torch/kernels/csrc/paged.cu",
                           "src/repro/kernels/paged.py:185"),
    "ragged_paged_scatter_rows": ("src/repro_torch/kernels/csrc/paged.cu",
                                  "src/repro/kernels/ragged.py:478"),
    "paged_gather_dequant": ("src/repro_torch/kernels/csrc/paged.cu",
                             "src/repro/kernels/paged.py:138"),
    "ragged_gather_rows": ("src/repro_torch/kernels/csrc/routing.cu",
                           "src/repro/kernels/ragged.py:344"),
    "ragged_scatter_add_rows": ("src/repro_torch/kernels/csrc/routing.cu",
                                "src/repro/kernels/ragged.py:395"),
    "ssd_intra_chunk": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:67"),
    "ragged_paged_flash_attention": ("src/repro_torch/kernels/csrc/ragged_attention.cu",
                                     "src/repro/kernels/ragged.py:290"),
    "swiglu": ("src/repro_torch/kernels/csrc/swiglu.cu", "src/repro/kernels/swiglu.py:72"),
}
OPS_KERNELS = ("ragged_paged_flash_attention", "swiglu")
PAGED_KERNELS = ("paged_gather", "paged_scatter_rows", "ragged_paged_scatter_rows")
RAGGED_KERNELS = ("ragged_gather_rows", "ragged_scatter_add_rows")
SERVE_KERNELS = ("gather_rows", "scatter_add_rows", "flash_attention")
TRAIN_KERNELS = ("routed_attention", "routed_mlp_scatter", "flash_attention")
# f32: the kernel's online softmax sums in another order than the plain
# version's dense softmax. bf16: both round p to bf16 before p@V, but
# against different running maxima, and round the output to bf16, so the
# two may differ by one bf16 ulp of the output (at most 2^-7 of its value,
# hence rtol 8e-3) plus the p rounding on small outputs (atol 8e-3, twice
# the largest difference seen on an H100, 2^-8)
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0), torch.bfloat16: dict(atol=8e-3, rtol=8e-3)}
# the fused routed kernels round where their plain versions round but sum
# their products in another order than cuBLAS: f32 within 1e-4; in bf16 a
# sum on the other side of a rounding boundary moves a value by one bf16
# ulp (2^-8 relative), which the following products carry
ROUTED_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
              torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


def timed_parts(phase: str, parts) -> list:
    """Runs each (label, function, *args) of ``parts`` in order and logs
    their wall seconds on one ``[time]`` line; returns their results."""
    out, times = [], []
    for label, fn, *args in parts:
        t = time.perf_counter()
        out.append(fn(*args))
        times.append(f"{phase}{label} {time.perf_counter() - t:.1f}s")
    log(f"[time] {', '.join(times)}")
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def smi_clocks() -> str:
    """The card's SM clock, its maximum, temperature and power draw now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median time of one call between CUDA events recorded around it. For a
    short kernel this is the host's launch cost (the card waits for the
    host), so kernel times come from :func:`profile_call` instead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_SIDE: list = []


def side_stream():
    """The script's one side stream. cuBLAS keeps a 32 MiB workspace for
    every stream it has run on for the life of the process: a new stream
    per call (one of the 32 of PyTorch's pool, in turns) left 1.00 GiB of
    them allocated by phase 14."""
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    return _SIDE[0]


def graph_ms(fn, reps: int = 20, iters: int = 5) -> float:
    """Device time of one call from CUDA events around replays of a CUDA
    graph holding ``reps`` back-to-back calls: no host gap counts, and no
    profiler record can be lost (torch.profiler drops some of this port's
    kernel records). Raises where the calls cannot be captured. The warm-up
    runs on one side stream for the whole script (:func:`side_stream`)."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def replay_ms(fn, how: dict, key: str, reps: int = 20, iters: int = 5,
              uncapturable: str = "") -> float:
    """Device time of one call by CUDA-graph replay (:func:`graph_ms`); a
    call that does not capture raises. Only a plain or library call named
    as not capturing (``uncapturable`` says why) falls back to
    torch.profiler's device time; ``how[key]`` records the method ("graph"
    or "profiler") so that every row says how it was timed."""
    if uncapturable and key == "ms":
        raise ValueError("a kernel's own time is always a graph replay")
    try:
        ms = graph_ms(fn, reps, iters)
        how[key] = "graph"
    except RuntimeError as err:
        if not uncapturable:
            raise
        torch.cuda.synchronize()
        ms = time_ms(fn, iters=5)
        how[key] = "profiler"
        log(f"[timing] {key}: the call does not capture ({uncapturable}: "
            f"{str(err).splitlines()[0][:100]}); torch.profiler reads {ms:.4f} ms")
    return ms


def timed_note(how: dict) -> str:
    """' (profiler: ...)' for a row with a time that is not a graph replay."""
    prof = [k for k, v in how.items() if v != "graph"]
    return f" (timed by torch.profiler: {', '.join(prof)})" if prof else ""


class NoDeviceTime(RuntimeError):
    """torch.profiler recorded no device activity for a profiled call."""


def device_spans(prof) -> list:
    """(name, start µs, end µs) of every device record (kernel, memset,
    copy, a range's annotation) of a finished torch.profiler ``prof``, read
    from its raw CUPTI records: ``prof.events()`` builds a Python event for
    every host op and runtime call as well, seconds of host time for a
    model step. Names are demangled as ``prof.events()`` gives them."""
    from torch.autograd import DeviceType

    names: dict = {}
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = names.get(e.name())
        if name is None:
            name = names[e.name()] = torch._C._demangle(e.name())
        out.append((name, e.start_ns() / 1e3, e.end_ns() / 1e3))
    return out


def device_records(prof, skip=()) -> list:
    """(name, µs) of every device record of :func:`device_spans` whose name
    is not in ``skip`` (a range's device annotation)."""
    return [(name, end - start) for name, start, end in device_spans(prof) if name not in skip]


def profile_call(fn, iters: int = 10, warmup: int = 2, tries: int = 3, top_n: int = 6):
    """(wall ms per call, device-busy ms per call, top kernels) from
    torch.profiler's CUDA activity (CUPTI): device time is the sum of the
    durations of every kernel and copy the calls ran on the card. CUPTI
    now and then hands back no device events for a whole profile; such a
    profile is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
        by_name: dict = {}
        for name, us in device_records(prof):
            by_name[name] = by_name.get(name, 0.0) + us / 1e3 / iters
        busy = sum(by_name.values())
        if busy > 0.0:
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
            return wall, busy, top
    raise NoDeviceTime(f"torch.profiler recorded no device time in {tries} profiles")


def profiler_diagnostic(label: str, fn, ms: float) -> None:
    """Logs torch.profiler's reading of ``fn`` beside its reported CUDA-graph
    time ``ms``: a diagnostic only, since the profiler loses records of this
    port's kernels (PERF.md §7)."""
    log(f"[timing] {label}: torch.profiler reads {time_ms(fn, iters=5):.4f} ms, "
        f"CUDA graph replay {ms:.4f} ms")


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call (kernels and copies only, no host gaps).
    Where the profiler records nothing, the time between CUDA events
    around ``iters`` back-to-back calls, divided by ``iters``: host gaps
    between launches count there, so it is an upper bound, and the line
    says so."""
    try:
        return profile_call(fn, iters)[1]
    except NoDeviceTime:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        log(f"[timing] torch.profiler recorded no device time; CUDA events instead: "
            f"{ms:.4f} ms per call (an upper bound)")
        return ms


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype] if flops else 0.0
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def dispatch_shapes():
    """(label, B, S, D, k) of the padded dispatch kernels on the main paths:
    a served mod-paper-1b prompt of 2048 and 1000 tokens (B=1, 12 calls of
    each kernel a prefill), mod-paper-1b's training step under backend
    ``pallas`` and mamba2-1.3b's (phase 9c: 3 calls of each a routed layer
    and step)."""
    from repro_torch.config import get_config

    c1, cm = get_config("mod-paper-1b"), get_config("mamba2-1.3b")
    return [(f"B={B} S={S} D={c.d_model}", B, S, c.d_model, c.mod.capacity(S))
            for B, S, c in ((1, 2048, c1), (1, 1000, c1), (4, 2048, c1), (4, 2048, cm))]


def dispatch_inputs(g, dev, dtype, B, S, D, k):
    """x, sorted unique idx, delta, gate, and idx flattened over (B*S) rows."""
    x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
    idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                       for _ in range(B)])
    delta = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    gate = torch.randn(B, k, generator=g, device=dev)
    return x, idx, delta, gate, (idx + S * torch.arange(B, device=dev)[:, None]).flatten()


def device_kernels(fn, tries: int = 10) -> list:
    """The device activities (kernels, memsets, copies) torch.profiler lists
    for one call of ``fn`` after a warm-up. CUPTI now and then hands back no
    device record for a whole profile (:func:`profile_call`); such a
    profile is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [name for name, _ in device_records(prof)]
        if names:
            return names
    raise NoDeviceTime(f"torch.profiler recorded no device activity in {tries} profiles")


def check_one_launch(label: str, fn, kernel: str) -> None:
    """Asserts that one call of ``fn`` is one launch of ``kernel`` on the
    card and nothing else (no memset, fill or copy), by torch.profiler."""
    names = device_kernels(fn)
    if len(names) != 1 or kernel not in names[0]:
        raise AssertionError(f"{label}: want one {kernel} launch, torch.profiler lists {names}")
    log(f"[kernels] {label}: one launch, nothing else on the card (torch.profiler: "
        f"{names[0][:90]})")


def plan_note(plan: dict) -> str:
    """A dispatch plan (``routing.DispatchPlan._asdict()``) as logged."""
    grid = "x".join(str(n) for n in plan["grid"])
    return f"plan=vec{plan['vec']} {plan['threads']} threads x{plan['unroll']} grid {grid}"


def check_routing(cfg, dev, results):
    """The padded dispatch kernels at :func:`dispatch_shapes`, bf16 and f32:
    gather, gated scatter-add and, at the B=4 training shapes, gather's VJP
    (the scatter's zero target), each bitwise against its plain version and
    then timed beside it, one library call (``take_along_dim`` and, beside
    it, ``index_select`` on the flattened rows for the gather; ``index_add``
    of the precomputed gated update for the scatter; ``zeros`` +
    ``index_add_`` for the zero target, two calls) and its byte bound; then
    torch.profiler's device list of one scatter, one gather backward and
    one scatter on phase 8b's flat stream: one kernel each, no memset, fill
    or copy."""
    from repro_torch.kernels import routing

    g = torch.Generator(device=dev).manual_seed(0)
    for label, B, S, D, k in dispatch_shapes():
        for dtype in (torch.bfloat16, torch.float32):
            x, idx, delta, gate, flat = dispatch_inputs(g, dev, dtype, B, S, D, k)
            es = x.element_size()
            out = routing.gather_rows(x, idx)
            want = routing.gather_rows_plain(x, idx)
            if not torch.equal(out, want):
                raise AssertionError(f"gather_rows differs from its plain version at {label} {dtype}")
            out2 = routing.scatter_add_rows(x, idx, delta, gate)
            want2 = routing.scatter_add_rows_plain(x, idx, delta, gate)
            if not torch.equal(out2, want2):
                raise AssertionError(f"scatter_add_rows differs from its plain version at {label} "
                                     f"{dtype}")
            xf = x.view(B * S, D)
            upd = (gate[..., None] * delta.float()).to(dtype).view(B * k, D)
            hg, hs = {}, {}
            rows = {
                "gather_rows": dict(
                    call_ms=event_ms(lambda: routing.gather_rows(x, idx)),
                    ms=replay_ms(lambda: routing.gather_rows(x, idx), hg, "ms"),
                    plain_ms=replay_ms(lambda: routing.gather_rows_plain(x, idx), hg, "plain_ms"),
                    library_ms=replay_ms(lambda: torch.take_along_dim(x, idx[..., None], dim=1),
                                         hg, "library_ms"),
                    index_select_ms=replay_ms(lambda: xf.index_select(0, flat), hg,
                                              "index_select_ms"),
                    bound=bound_ms(2 * B * k * D * es + 8 * B * k, 0, dtype),
                    plan=routing.dispatch_plan("gather", B, S, k, D * es, es, 8,
                                               (x.data_ptr(), out.data_ptr()))._asdict(),
                    max_abs_err=(out.float() - want.float()).abs().max().item(), timed_by=hg,
                ),
                "scatter_add_rows": dict(
                    call_ms=event_ms(lambda: routing.scatter_add_rows(x, idx, delta, gate)),
                    ms=replay_ms(lambda: routing.scatter_add_rows(x, idx, delta, gate), hs, "ms"),
                    plain_ms=replay_ms(lambda: routing.scatter_add_rows_plain(x, idx, delta, gate),
                                       hs, "plain_ms"),
                    # index_add of the precomputed gated update (one call)
                    library_ms=replay_ms(lambda: xf.index_add(0, flat, upd), hs, "library_ms"),
                    bound=bound_ms(2 * B * S * D * es + B * k * D * es + 12 * B * k,
                                   2 * B * k * D, dtype),
                    plan=routing.dispatch_plan(
                        "scatter", B, S, k, D * es, es, 8,
                        (x.data_ptr(), delta.data_ptr(), out2.data_ptr()))._asdict(),
                    max_abs_err=(out2.float() - want2.float()).abs().max().item(), timed_by=hs,
                ),
            }
            del out, want, out2, want2
            if B > 1:  # the zero target (gather's VJP) at the training shapes
                ones = torch.ones(B, k, device=dev)
                z = routing.gather_rows_vjp(idx, delta, x.shape)
                wz = routing.scatter_add_rows_plain(torch.zeros_like(x), idx, delta, ones)
                if not torch.equal(z, wz):
                    raise AssertionError(f"gather_rows_vjp (the zero target) differs from the "
                                         f"plain scatter into zeros at {label} {dtype}")
                hz: dict = {}
                rows["scatter_add_rows zero"] = dict(
                    call_ms=event_ms(lambda: routing.gather_rows_vjp(idx, delta, x.shape)),
                    ms=replay_ms(lambda: routing.gather_rows_vjp(idx, delta, x.shape), hz, "ms"),
                    plain_ms=replay_ms(lambda: routing.scatter_add_rows_plain(
                        torch.zeros_like(x), idx, delta, ones), hz, "plain_ms"),
                    library_ms=replay_ms(lambda: torch.zeros_like(xf).index_add_(
                        0, flat, delta.view(B * k, D)), hz, "library_ms"),
                    library="zeros + index_add_ (two calls)",
                    bound=bound_ms(B * S * D * es + B * k * D * es + 8 * B * k, 2 * B * k * D,
                                   dtype),
                    plan=routing.dispatch_plan("scatter_zero", B, S, k, D * es, es, 8,
                                               (delta.data_ptr(), z.data_ptr()))._asdict(),
                    max_abs_err=(z.float() - wz.float()).abs().max().item(), timed_by=hz,
                )
                del z, wz
            for name, r in rows.items():
                shape = f"{label} k={k} {str(dtype)[6:]}"
                extra = (f" index_select_ms={r['index_select_ms']:.4f}"
                         if "index_select_ms" in r else "")
                log(f"[kernels] {name:22s} {shape:32s} bitwise-equal ms={r['ms']:.4f} "
                    f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                    f"library_ms={r['library_ms']:.4f}{extra} bound_ms={r['bound'][0]:.4f} "
                    f"({r['bound'][1]}, {r['bound'][0] / r['ms']:.0%} of it) "
                    f"{plan_note(r['plan'])}{timed_note(r['timed_by'])}")
                kernel, _, zero = name.partition(" ")
                kind = ("gather" if kernel == "gather_rows"
                        else "scatter_zero" if zero else "scatter")
                key = (f"{zero} {label}" if zero else label, dtype)
                results.setdefault(kernel, {})[key] = dict(r, shape=f"{zero} {shape}".strip(),
                                                           call=(kind, B, S, k, D * es))
    # one launch a call, and nothing else: a scatter, gather's backward (the
    # zero target: no zero tensor is made, filled or copied) and a scatter
    # on phase 8b's flat stream (int32 indices). Here, first in phase 2:
    # later in the run torch.profiler has been seen to record no device
    # activity at all for such a call, ten profiles running
    label, B, S, D, k = dispatch_shapes()[-1]
    x, idx, delta, gate, _ = dispatch_inputs(g, dev, torch.bfloat16, B, S, D, k)
    check_one_launch(f"scatter_add_rows {label} bf16",
                     lambda: routing.scatter_add_rows(x, idx, delta, gate), "scatter_add_rows_kernel")
    xr = x.detach().requires_grad_(True)
    out = routing.gather_rows(xr, idx)
    g_out = torch.randn(out.shape, generator=g, device=dev).to(out.dtype)
    check_one_launch(f"gather_rows backward {label} bf16",
                     lambda: torch.autograd.grad(out, xr, g_out, retain_graph=True),
                     "scatter_add_rows_kernel")
    from repro_torch.kernels import ragged as KRG

    T, lens = RAGGED_1B["T"], RAGGED_1B["equal"]
    k = cfg.mod.capacity(RAGGED_1B["seg_cap"])
    xs = torch.randn(T, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    ridx = _ragged_selection(g, dev, lens, k, T)
    rdelta = torch.randn(len(lens), k, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    rgate = torch.randn(ridx.shape, generator=g, device=dev)
    check_one_launch(f"ragged_scatter_add_rows T={T} n_seg={len(lens)} k={k} bf16",
                     lambda: KRG.ragged_scatter_add_rows(xs, ridx, rdelta, rgate),
                     "scatter_add_rows_kernel")


def _flash_bytes(q, k, q_pos, kv_pos, es, lse=False):
    """Bytes the function must move: q rows and k/v rows whose position is
    valid (a padded row cannot change a valid output), the whole output,
    both position arrays and, when asked for, the f32 row lse."""
    (B, Sq, nq, hd), nkv = q.shape, k.shape[2]
    n_q = int((q_pos >= 0).sum().item())
    n_kv = int((kv_pos >= 0).sum().item())
    return (n_q * nq * hd + 2 * n_kv * nkv * hd + B * Sq * nq * hd) * es \
        + 4 * (q_pos.numel() + kv_pos.numel()) + (4 * B * nq * Sq if lse else 0)


# the bf16 shapes of the flash kernel that phase 2 times by CUDA-graph
# replay against SDPA and the plain version, and `--flash-timing` times on
# another source tree: a whole-prompt prefill at S=1000 and S=2048 (24
# padded positions), a decode step of 8 slots against a 1056-slot cache,
# the training call (B=4, S=2048) with the lse its backward reads, and the
# routed layers' prefill and decode calls
FLASH_TIMED = ("prefill S=1000", "prefill S=2048", "decode B=8 ctx=1056", "train B=4 S=2048 lse",
               "prefill routed S=128", "decode routed B=1 ctx=128")


class FlashCase(NamedTuple):
    label: str
    B: int
    Sq: int
    Skv: int
    nq: int
    nkv: int
    hd: int
    q_pos: torch.Tensor
    kv_pos: torch.Tensor
    dtypes: tuple
    lse: bool = False
    window: int = 0
    causal: bool = True


def _ring_pos(Skv: int, n: int, dev) -> torch.Tensor:
    """Key positions of a ring of Skv slots after n writes: slot i holds the
    newest position congruent to i, so positions wrap (not monotone)."""
    idx = torch.arange(Skv, dtype=torch.int32, device=dev)
    return idx + Skv * ((n - 1 - idx) // Skv)


def flash_cases(cfg, dev):
    """Phase 2's flash cases: FLASH_TIMED (the routed calls among them) and a
    GQA prefill at mod-paper-1b's shapes, the full layers' serving shapes in
    f32 too; then bf16 cases that reach every plan of the kernel: the
    wgmma warpgroups' key split with the last valid key in an even and in
    an odd key tile, a wrapped ring with Sq and Skv that divide no tile, a
    sliding window, rows with no valid key, head dims 64 (wgmma) and 256
    (mma.sync tiles), and the decode path at those head dims in one chunk
    and over many."""
    from repro_torch.core.routing import batch_capacity_k

    g = torch.Generator(device=dev).manual_seed(1)
    nq, hd = cfg.attn.n_heads, cfg.head_dim
    both, bf = (torch.bfloat16, torch.float32), (torch.bfloat16,)
    i32 = dict(dtype=torch.int32, device=dev)
    cases = []
    for S in (1000, 2048):
        pos = torch.arange(S, **i32)[None].clone()
        pos[:, S - 24:] = -1  # padded tail
        cases.append(FlashCase(f"prefill S={S}", 1, S, S, nq, nq, hd, pos, pos, both))
    B, ctx = 8, 1056
    lens = torch.randint(128, ctx + 1, (B,), generator=g, device=dev)
    kv_pos = torch.arange(ctx, **i32)[None].repeat(B, 1)
    kv_pos = torch.where(kv_pos < lens[:, None], kv_pos, torch.full_like(kv_pos, -1))
    q_pos = (lens - 1)[:, None].int()
    cases.append(FlashCase(f"decode B=8 ctx={ctx}", B, 1, ctx, nq, nq, hd, q_pos, kv_pos, both))
    # the routed layers' calls: a prefill over the k = capacity(ctx) routed
    # rows of a 1000-token prompt (positions with gaps), and a decode step
    # of the kb routed slots against their routed caches of k slots (a
    # ring: positions with gaps, wrapped, not monotone in the slot)
    k = cfg.mod.capacity(ctx)
    pos = torch.randperm(1000, generator=g, device=dev)[:k].sort().values.int()[None]
    cases.append(FlashCase(f"prefill routed S={k}", 1, k, k, nq, nq, hd, pos, pos, bf))
    kb = batch_capacity_k(cfg, B)
    kv_pos = torch.stack([torch.randperm(1000, generator=g, device=dev)[:k].sort().values
                          .roll(37 * i + 5) for i in range(kb)]).int()
    cases.append(FlashCase(f"decode routed B={kb} ctx={k}", kb, 1, k, nq, nq, hd,
                           torch.full((kb, 1), 1000, **i32), kv_pos, bf))
    pos = torch.arange(2048, **i32)[None].repeat(4, 1)
    cases.append(FlashCase("train B=4 S=2048 lse", 4, 2048, 2048, nq, nq, hd, pos, pos, bf, True))
    pos = torch.arange(1000, **i32)[None]
    cases.append(FlashCase("gqa S=1000 nkv=2", 1, 1000, 1000, nq, 2, hd, pos, pos, both))
    # every plan: the last valid key in an even (S=300: tile 2) and an odd
    # (S=200: tile 1) wgmma key tile, with their lse
    for S in (300, 200):
        pos = torch.arange(S, **i32)[None].repeat(2, 1)
        cases.append(FlashCase(f"split S={S}", 2, S, S, nq, nq, hd, pos, pos, bf, True))
    ring = _ring_pos(333, 333 + 150, dev)[None].repeat(2, 1)
    qr = torch.arange(333 + 150 - 77, 333 + 150, **i32)[None].repeat(2, 1)
    cases.append(FlashCase("ring Sq=77 Skv=333", 2, 77, 333, nq, nq, hd, qr, ring, bf, True))
    pos = torch.arange(1000, **i32)[None]
    cases.append(FlashCase("window=256 S=1000", 1, 1000, 1000, nq, nq, hd, pos, pos, bf,
                           window=256))
    kv = torch.arange(5, 305, **i32)[None].repeat(2, 1)
    ql = torch.arange(305 - 77, 305, **i32)[None].repeat(2, 1)
    ql[:, :3] = torch.tensor([2, 0, 4], **i32)  # rows before every key: no valid key
    cases.append(FlashCase("masked rows Sq=77 Skv=300", 2, 77, 300, nq, nq, hd, ql, kv, bf, True))
    for h in (64, 256):
        pos = torch.arange(300, **i32)[None].repeat(2, 1)
        cases.append(FlashCase(f"hd={h} S=300 gqa", 2, 300, 300, 8, 2, h, pos, pos, bf, True))
        for ctx_ in (50, 700):
            kvp = _ring_pos(ctx_, ctx_ + 21, dev)[None].repeat(3, 1)
            cases.append(FlashCase(f"hd={h} decode ctx={ctx_}", 3, 1, ctx_, 8, 2, h,
                                   torch.full((3, 1), ctx_ + 20, **i32), kvp, bf, True))
    return cases, g


def flash_call(FA, q, k, v, q_pos, kv_pos, window=0, causal=True):
    """(out, lse) through the port's public flash wrapper. Where the inputs
    need a gradient (as in training), the wrapper's autograd Function has
    the kernel write the f32 row lse its backward reads, and lse is read
    from the Function's saved tensors; else lse is None."""
    out = FA.flash_attention(q, k, v, q_pos, kv_pos, window=window, causal=causal)
    return out, (out.grad_fn.saved_tensors[-1] if out.requires_grad else None)


def flash_rows(FA, cfg, dev, labels=None, reads=1):
    """Phase 2's flash cases (or, with ``labels``, those cases in bf16) on
    the port of module ``FA``: each held to the plain version within TOL
    (its lse within 1e-4 where the call needs a gradient), then the kernel
    (``reads`` readings, the best kept), the plain version and SDPA timed
    by CUDA-graph replay. Yields (label, dtype, row)."""
    cases, g = flash_cases(cfg, dev)
    for c in cases:
        dtypes = c.dtypes
        if labels is not None:
            if c.label not in labels:
                continue
            dtypes = (torch.bfloat16,)
        for dtype in dtypes:
            yield c.label, dtype, flash_row(FA, c, dtype, g, reads)


def flash_row(FA, c: FlashCase, dtype, g, reads=1) -> dict:
    """One flash case in one dtype on the port of module ``FA``: held to the
    plain version within TOL (its lse within 1e-4 where the call needs a
    gradient), then the kernel (``reads`` readings, the best kept), the
    plain version and SDPA timed by CUDA-graph replay."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = c.hd ** -0.5
    q = torch.randn(c.B, c.Sq, c.nq, c.hd, generator=g, device=g.device).to(dtype)
    k = torch.randn(c.B, c.Skv, c.nkv, c.hd, generator=g, device=g.device).to(dtype)
    v = torch.randn(c.B, c.Skv, c.nkv, c.hd, generator=g, device=g.device).to(dtype)
    qg, kg, vg = (t.detach().requires_grad_(c.lse) for t in (q, k, v))
    call = lambda: flash_call(FA, qg, kg, vg, c.q_pos, c.kv_pos, c.window,  # noqa: E731
                              c.causal)
    out, lse = call()
    want, want_l = FA._flash_plain(q, k, v, c.q_pos, c.kv_pos, c.causal, c.window, scale)
    torch.testing.assert_close(out.detach().float(), want.float(), **TOL[dtype])
    lse_err = None
    if c.lse:
        torch.testing.assert_close(lse, want_l, atol=1e-4, rtol=0.0)
        lse_err = (lse - want_l).abs().max().item()
    mask = FA.valid_mask(c.q_pos, c.kv_pos, c.causal, c.window)[:, None]  # (B, 1, Sq, Skv)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if c.nkv != c.nq:
        kh = kh.repeat_interleave(c.nq // c.nkv, dim=1)
        vh = vh.repeat_interleave(c.nq // c.nkv, dim=1)
    nbytes = _flash_bytes(q, k, c.q_pos, c.kv_pos, q.element_size(), c.lse)
    flops = 4.0 * c.hd * c.nq * int(mask.sum().item())
    how: dict = {}
    readings = [replay_ms(call, how, "ms") for _ in range(reads)]
    return dict(
        call_ms=event_ms(call), ms=min(readings), readings=readings,
        plain_ms=replay_ms(lambda: FA._flash_plain(q, k, v, c.q_pos, c.kv_pos, c.causal,
                                                   c.window, scale), how, "plain_ms", reps=5),
        library_ms=replay_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask), how, "library_ms"),
        bound=bound_ms(nbytes, flops, dtype),
        max_abs_err=(out.detach().float() - want.float()).abs().max().item(),
        lse_err=lse_err, timed_by=how, call=(c.B, c.Sq, c.Skv, c.nq, c.nkv, c.hd),
        shape=f"{c.label} {c.nq}x{c.hd} {str(dtype)[6:]}",
    )


_SASS: dict = {}


def sass_counts(stem: str, kernel: str, opcode: str) -> dict:
    """Instructions of one opcode (HMMA: mma.sync; HGMMA: wgmma) per kernel
    whose name holds ``kernel``, in the SASS of the library built from
    ``csrc/<stem>.cu`` (``cuobjdump -sass``)."""
    import shutil

    from repro_torch.kernels import build

    path = str(build.build_all()[stem]["path"])
    if path not in _SASS:  # one disassembly a library
        tool = shutil.which("cuobjdump") or str(
            Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
        _SASS[path] = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                                     check=True, timeout=300).stdout
    sass = _SASS[path]
    counts: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if kernel in name:
                counts.setdefault(name, 0)
        elif name and kernel in name and any(t.split(".")[0] == opcode for t in line.split()):
            counts[name] += 1
    return counts


def check_sass(stem: str, kernel: str, opcode: str, want: int) -> dict:
    """Asserts ``want`` kernels named ``kernel`` in ``stem``'s library, each
    with ``opcode`` in its SASS; logs the counts."""
    counts = sass_counts(stem, kernel, opcode)
    if len(counts) < want or min(counts.values()) <= 0:
        raise AssertionError(f"{stem}: want {want} kernels {kernel} with {opcode} in their SASS, "
                             f"got {counts}")
    log(f"[kernels] {stem} SASS: {len(counts)} {kernel} kernels, "
        f"{min(counts.values())}-{max(counts.values())} {opcode} instructions each "
        f"(cuobjdump -sass)")
    return counts


def check_flash_invariance(FA, dev) -> None:
    """A row's bf16 bits do not depend on Skv or B: each case's rows equal
    their bits after 333 empty (-1) key slots are appended (more key tiles
    for the wgmma warpgroups' parity split and the mma.sync tiles; more
    chunks on the decode path, a one-launch call turning into chunks and the
    merge launch, out and lse bitwise) and when a batch row runs alone."""
    g = torch.Generator(device=dev).manual_seed(5)
    cases = (("wgmma", 2, 300, 300, 14, 14, 128), ("wgmma gqa hd=64", 2, 77, 333, 8, 2, 64),
             ("mma_sync hd=256", 2, 77, 333, 8, 2, 256), ("decode 1 chunk", 3, 1, 128, 14, 14, 128),
             ("decode 9 chunks", 3, 1, 1056, 14, 14, 128), ("decode gqa", 3, 2, 100, 14, 2, 128),
             ("mma_sync hd=80", 2, 77, 333, 8, 2, 80),
             ("decode hd=80 1 chunk", 3, 1, 128, 8, 8, 80),
             ("decode hd=80 9 chunks", 3, 1, 1056, 8, 8, 80))
    for label, B, Sq, Skv, nq, nkv, hd in cases:
        q = torch.randn(B, Sq, nq, hd, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, Skv, nkv, hd, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, Skv, nkv, hd, generator=g, device=dev).to(torch.bfloat16)
        kv_pos = _ring_pos(Skv, Skv + 37, dev)[None].repeat(B, 1)
        q_pos = torch.arange(Skv + 37 - Sq, Skv + 37, dtype=torch.int32, device=dev)[None]
        q_pos = q_pos.repeat(B, 1)
        scale = hd ** -0.5
        base, base_l = FA._flash_launch(q, k, v, q_pos, kv_pos, True, 0, scale, True)
        pad = lambda t, val: torch.cat(  # noqa: E731
            [t, torch.full((B, 333) + t.shape[2:], val, dtype=t.dtype, device=dev)], dim=1)
        longer, longer_l = FA._flash_launch(q, pad(k, 0), pad(v, 0), q_pos, pad(kv_pos, -1), True,
                                            0, scale, True)
        if not (torch.equal(longer, base) and torch.equal(longer_l, base_l)):
            raise AssertionError(f"flash {label}: a row's bits change with Skv")
        for b in (0, B - 1):
            alone, _ = FA._flash_launch(q[b:b + 1], k[b:b + 1], v[b:b + 1], q_pos[b:b + 1],
                                        kv_pos[b:b + 1], True, 0, scale, True)
            if not torch.equal(alone[0], base[b]):
                raise AssertionError(f"flash {label}: a row's bits change with B")
        plan = FA.flash_plan(B, Sq, Skv, nq, nkv, hd, torch.bfloat16)
        padded = FA.flash_plan(B, Sq, Skv + 333, nq, nkv, hd, torch.bfloat16)
        merged = ("; one launch == chunks + merge launch, out and lse bitwise"
                  if plan.path == "decode" and not plan.merge and padded.merge else "")
        log(f"[kernels] flash_attention  {label} ({plan.path}, B={B} Sq={Sq} Skv={Skv} "
            f"{nq}x{hd} nkv={nkv}): bits equal with 333 empty key slots appended and per batch "
            f"row alone{merged}")


def check_flash(cfg, dev, results):
    from repro_torch.kernels import flash_attention as FA

    check_sass("flash_attention", "flash_fwd_wg_kernel", "HGMMA", 2)  # head dims 64, 128
    check_sass("flash_attention", "flash_fwd_tc_kernel", "HMMA", 3)  # head dims 32, 80, 256
    check_sass("flash_attention", "flash_fwd_decode_kernel", "HMMA", 5)  # every head dim
    for label, dtype, r in flash_rows(FA, cfg, dev):
        plan = FA.flash_plan(*r["call"], dtype)
        r["path"], r["kernels"] = plan.path, plan.kernels
        r["plan"] = dict(path=plan.path, key_tile=plan.key_tile, key_split=plan.key_split,
                         chunk=plan.chunk, n_splits=plan.n_splits, merge=plan.merge)
        extra = "" if r["lse_err"] is None else f" lse_err={r['lse_err']:.3g}"
        log(f"[kernels] flash_attention  {r['shape']:38s} {plan.path:8s} kernels={plan.kernels} "
            f"max_abs_err={r['max_abs_err']:.3g}{extra} ms={r['ms']:.4f} "
            f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} ({r['bound'][1]})")
        results.setdefault("flash_attention", {})[(label, dtype)] = r
    check_flash_invariance(FA, dev)


def flash_timing(root: Path, reads: int = 3) -> None:
    """``--flash-timing [ROOT]``: phase 2's FLASH_TIMED rows (:func:`flash_rows`)
    on the port under ``ROOT/src`` (default: this checkout), the kernel
    read ``reads`` times (the best and every reading printed). Run on a
    parent tree and this one in one call, in turns (parent, this, this,
    parent), to compare two versions of the kernel."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.config import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA

    build.build_all()
    for label, _, r in flash_rows(FA, get_config("mod-paper-1b"), torch.device("cuda", 0),
                                  FLASH_TIMED, reads):
        log(f"[flash-timing] {root.name or root}: {r['shape']}: kernel {r['ms']:.4f} ms "
            f"({', '.join(f'{x:.4f}' for x in r['readings'])}), SDPA {r['library_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms (CUDA graph replay; "
            f"{smi_line()})")


def _w(g, dev, dtype, *shape):
    return (torch.randn(*shape, generator=g, device=dev) / shape[0] ** 0.5).to(dtype)


def routed_paged_timing(root: Path, reads: int = 3) -> None:
    """``--routed-paged-timing [ROOT]``: routed_attention in bf16 at phase
    2's mod-paper-1b training shape, paged_scatter_rows (B=8) and
    paged_gather (B=8, then B=1) at phase 2's shapes on phase 6c's tables
    (the same seeds as check_fused and check_paged: K/V and int32 position
    pages), and the MoD dispatch rows of :func:`dispatch_timing`, of the
    port under ``ROOT/src`` (default: this checkout), each beside its plain
    version or library calls: ``reads`` CUDA-graph
    replays of each, in turns. Run on a parent tree and this one in one
    call (parent, this, this, parent) to compare two versions of the
    kernels on one card."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.config import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged as KP

    build.build_all()
    cfg, dev = get_config("mod-paper-1b"), torch.device("cuda", 0)
    name = root.name or str(root)

    def readings(fns, reps=20):
        got = {key: [] for key in fns}
        for _ in range(reads):
            for key, fn in fns.items():
                got[key].append(graph_ms(fn, reps))
        return "; ".join(f"{key} {min(v):.5f} ({', '.join(f'{x:.5f}' for x in v)})"
                         for key, v in got.items())

    g = torch.Generator(device=dev).manual_seed(2)
    B, S, D = 4, 2048, cfg.d_model
    k, nq, nkv, hd = cfg.mod.capacity(S), cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.head_dim
    dtype = torch.bfloat16
    spec = FA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, 0, cfg.attn.rope_theta, "rope",
                             cfg.norm_eps)
    x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
    idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                       for _ in range(B)])
    pos = idx.to(torch.int32)
    ap = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
          "wq": _w(g, dev, dtype, D, nq * hd), "wk": _w(g, dev, dtype, D, nkv * hd),
          "wv": _w(g, dev, dtype, D, nkv * hd), "wo": _w(g, dev, dtype, nq * hd, D)}
    log(f"[routed-paged-timing] {name}: routed_attention B={B} S={S} k={k} D={D} bf16: " + readings(
        {"kernel": lambda: FA.routed_attention(x, idx, pos, ap, spec),
         "plain": lambda: FA.routed_attention_plain(x, idx, pos, ap, spec)}, reps=5))
    try:
        _, busy, top = profile_call(lambda: FA.routed_attention(x, idx, pos, ap, spec), top_n=12)
        split = f"busy {busy:.4f}): " + "; ".join(f"{n[:70]} {t:.4f}" for n, t in top)
    except NoDeviceTime as err:
        split = f"not measured: {err})"
    log(f"[routed-paged-timing] {name}: routed_attention by kernel (torch.profiler, ms per call, "
        f"a diagnostic; {split}")
    suffix, ctx, _ = paged_1b_plan()
    w = PAGED_1B
    lens = [w["prefix"] + int(n) for n in suffix]
    g = torch.Generator(device=dev).manual_seed(7)
    for label, dt, F in (("kv", torch.bfloat16, cfg.attn.n_kv_heads * cfg.head_dim),
                         ("pos", torch.int32, 1)):
        pages, table, rows, pos, _ = _paged_inputs(g, dev, dt, F, lens, w["gen"],
                                                   ctx // w["page"], w["page"], w["chunk"])
        p_, N, B = w["page"], pages.shape[0], table.shape[0]
        fi = (table.long()[torch.arange(B, device=dev), pos.long() // p_] * p_
              + pos.long() % p_)
        flat = pages.view(N * p_, F)
        log(f"[routed-paged-timing] {name}: paged_scatter_rows {label} B={B}: " + readings(
            {"kernel": lambda: KP.paged_scatter_rows(pages, table, rows, pos),
             "index_copy_": lambda: flat.index_copy_(0, fi, rows)}))
        for Bg in (table.shape[0], 1):
            t = table[:Bg].contiguous()
            if not torch.equal(KP.paged_gather(pages, t), KP.paged_gather_plain(pages, t)):
                raise AssertionError(f"paged_gather differs from its plain version ({label})")
            log(f"[routed-paged-timing] {name}: paged_gather {label} B={Bg}: " + readings(
                {"kernel": lambda: KP.paged_gather(pages, t),
                 "index_select": lambda: torch.index_select(pages, 0, t.flatten().long())}))
    dispatch_timing(name, readings, dev)
    ragged_attention_timing(name, readings, cfg, dev)
    log(f"[routed-paged-timing] {name}: {smi_line()}")


def dispatch_timing(name: str, readings, dev) -> None:
    """``--routed-paged-timing``'s dispatch rows, through the public wrappers
    of the port on ``sys.path`` (so a parent tree runs them unchanged), each
    checked bitwise against its plain version first: gather_rows and
    scatter_add_rows at :func:`dispatch_shapes` (bf16) beside
    take_along_dim / index_select / index_add; gather's VJP at the B=4
    training shapes (``routing.gather_rows_vjp``, the scatter's zero target,
    where the port has it, else what its backward runs: ``new_zeros`` and
    the scatter with a unit gate) beside zeros + index_add_; and phase 8b's
    ragged pair (8 unequal segments on T=4096) beside index_select /
    index_add of the valid rows."""
    from repro_torch.config import get_config
    from repro_torch.kernels import ragged as KRG
    from repro_torch.kernels import routing as KR

    g = torch.Generator(device=dev).manual_seed(11)
    dt = torch.bfloat16
    for label, B, S, D, k in dispatch_shapes():
        x, idx, delta, gate, flat = dispatch_inputs(g, dev, dt, B, S, D, k)
        xf, upd = x.view(B * S, D), (gate[..., None] * delta.float()).to(dt).view(B * k, D)
        if not (torch.equal(KR.gather_rows(x, idx), KR.gather_rows_plain(x, idx)) and torch.equal(
                KR.scatter_add_rows(x, idx, delta, gate),
                KR.scatter_add_rows_plain(x, idx, delta, gate))):
            raise AssertionError(f"the dispatch differs from its plain versions at {label}")
        log(f"[routed-paged-timing] {name}: gather_rows {label} k={k}: " + readings(
            {"kernel": lambda: KR.gather_rows(x, idx),
             "take_along_dim": lambda: torch.take_along_dim(x, idx[..., None], dim=1),
             "index_select": lambda: xf.index_select(0, flat)}))
        log(f"[routed-paged-timing] {name}: scatter_add_rows {label} k={k}: " + readings(
            {"kernel": lambda: KR.scatter_add_rows(x, idx, delta, gate),
             "index_add": lambda: xf.index_add(0, flat, upd)}))
        if B == 1:
            continue
        ones = torch.ones(B, k, device=dev)
        vjp = getattr(KR, "gather_rows_vjp", None)
        zero = ((lambda: vjp(idx, delta, x.shape)) if vjp else
                (lambda: KR.scatter_add_rows(delta.new_zeros(x.shape), idx, delta, ones)))
        if not torch.equal(zero(), KR.scatter_add_rows_plain(torch.zeros_like(x), idx, delta,
                                                              ones)):
            raise AssertionError(f"gather's VJP differs from its plain version at {label}")
        log(f"[routed-paged-timing] {name}: gather VJP {label} k={k} "
            f"({'zero target' if vjp else 'new_zeros + scatter'}): " + readings(
                {"kernel": zero,
                 "zeros+index_add_": lambda: torch.zeros_like(xf).index_add_(
                     0, flat, delta.view(B * k, D))}))
    T, D = RAGGED_1B["T"], get_config("mod-paper-1b").d_model
    lens = RAGGED_1B["unequal"]
    k = get_config("mod-paper-1b").mod.capacity(RAGGED_1B["seg_cap"])
    x = torch.randn(T, D, generator=g, device=dev).to(dt)
    idx = _ragged_selection(g, dev, lens, k, T)
    delta = torch.randn(len(lens), k, D, generator=g, device=dev).to(dt)
    gate = torch.where(idx >= 0, torch.randn(idx.shape, generator=g, device=dev), 0.0)
    valid = idx[idx >= 0].long()
    upd = (gate[idx >= 0][:, None] * delta[idx >= 0].float()).to(dt)
    if not (torch.equal(KRG.ragged_gather_rows(x, idx), KRG.ragged_gather_rows_plain(x, idx))
            and torch.equal(KRG.ragged_scatter_add_rows(x, idx, delta, gate),
                            KRG.ragged_scatter_add_rows_plain(x, idx, delta, gate))):
        raise AssertionError("the ragged dispatch differs from its plain versions")
    shape = f"T={T} D={D} n_seg={len(lens)} k={k}"
    log(f"[routed-paged-timing] {name}: ragged_gather_rows {shape}: " + readings(
        {"kernel": lambda: KRG.ragged_gather_rows(x, idx),
         "index_select": lambda: x.index_select(0, valid)}))
    log(f"[routed-paged-timing] {name}: ragged_scatter_add_rows {shape}: " + readings(
        {"kernel": lambda: KRG.ragged_scatter_add_rows(x, idx, delta, gate),
         "index_add": lambda: x.index_add(0, valid, upd)}))


def _causal_pairs(pos):
    """(query, key) pairs of the routed rows that the causal make_mask keeps."""
    return int(((pos[:, None, :] >= 0) & (pos[:, None, :] <= pos[:, :, None])).sum().item())


def routed_mlp_library(x, h, a, idx, gate, mp, spec):
    """The routed MLP and the Eq. 1 combine from library calls, at the
    kernel's rounding points: torch's rms_norm of the routed rows, one
    cuBLAS call per product (bf16 operands summed in f32 through
    ``out_dtype``, each rounded to x's dtype; f32 by torch.mm), the
    activation and the GLU product, ``a + m``, the f32 gate product, and
    ``index_copy_`` into a copy of x. Not one call: a yardstick the port
    never calls."""
    B, S, D = x.shape
    dt = x.dtype
    if dt == torch.bfloat16:
        def mm(p, q):
            return torch.mm(p, q, out_dtype=torch.float32).to(dt)
    else:
        mm = torch.mm
    act = (torch.nn.functional.silu if spec.act == "silu"
           else lambda t: torch.nn.functional.gelu(t, approximate="tanh"))
    hn = torch.nn.functional.rms_norm(h.reshape(-1, D), (D,), mp["ln"], spec.eps)
    up = mm(hn, mp["w_up"])
    hid = act(mm(hn, mp["w_gate"])) * up if "w_gate" in mp else act(up)
    delta = a.reshape(-1, D) + mm(hid, mp["w_down"])
    upd = (gate.reshape(-1, 1).float() * delta.float()).to(dt)
    flat = (idx + S * torch.arange(B, device=x.device)[:, None]).reshape(-1)
    out = x.reshape(B * S, D).clone()
    out.index_copy_(0, flat, out.index_select(0, flat) + upd)
    return out.view(B, S, D)


# what the library figures of phase 2 (routed_mlp_library) and 10c
# (swiglu_library) call, by dtype
ROUTED_MLP_LIBRARY = {
    torch.bfloat16: "rms_norm + torch.mm x3 (cuBLAS, bf16 operands, out_dtype=float32) + silu "
                    "+ index_copy_; not one call",
    torch.float32: "rms_norm + torch.mm x3 (cuBLAS, f32) + silu + index_copy_; not one call"}
SWIGLU_LIBRARY = {torch.bfloat16: "torch.mm x3 (cuBLAS, bf16 operands, out_dtype=float32) + silu",
                  torch.float32: "torch.mm x3 (cuBLAS, f32) + silu"}


def check_fused(cfg, dev, results):
    """routed_attention and routed_mlp_scatter at the mod-paper-1b training
    shape: B=4, S=2048, k = capacity(2048) = 256 routed rows per sequence.
    Both kernels' bf16 GEMMs are the wgmma GEMM: HGMMA in the SASS of their
    bf16 GEMM kernels, and the path their launches recorded by call;
    routed_attention's bf16 attention core is on tensor cores: HMMA in the
    SASS of its kernel at every head dim."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import swiglu as SW

    check_sass("routed_mlp", "gemm_wgmma_kernel", "HGMMA", 3)  # EpiGlu, EpiAct, EpiScatter
    check_sass("routed_attention", "gemm_wgmma_kernel", "HGMMA", 3)  # EpiAttnStore, KV, Out
    check_sass("routed_attention", "routed_attn_tc_kernel", "HMMA", 4)  # head dims 32-256
    g = torch.Generator(device=dev).manual_seed(2)
    B, S, D, F = 4, 2048, cfg.d_model, cfg.d_ff
    k = cfg.mod.capacity(S)
    nq, nkv, hd = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.head_dim
    spec = FA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, 0, cfg.attn.rope_theta, "rope",
                             cfg.norm_eps)
    mspec = SW.RoutedMlpSpec(cfg.act, cfg.norm_eps)
    for dtype in (torch.bfloat16, torch.float32):
        es = 2 if dtype == torch.bfloat16 else 4
        x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
        idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                           for _ in range(B)])
        pos = idx.to(torch.int32)
        ap = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
              "wq": _w(g, dev, dtype, D, nq * hd), "wk": _w(g, dev, dtype, D, nkv * hd),
              "wv": _w(g, dev, dtype, D, nkv * hd), "wo": _w(g, dev, dtype, nq * hd, D)}
        build.reset_counters()
        a, h = FA.routed_attention(x, idx, pos, ap, spec)
        attn_path = FA.routed_attention_path(dtype, B, k, D, nq, nkv, hd, True)
        if build.COUNTERS["routed_attention"].by_call != {(attn_path, B, S, k, D, nq, nkv, hd): 1}:
            raise AssertionError(f"routed_attention {dtype} launched "
                                 f"{build.COUNTERS['routed_attention'].by_call}, want {attn_path}")
        wa, wh = FA.routed_attention_plain(x, idx, pos, ap, spec)
        for got, want in ((a, wa), (h, wh)):
            torch.testing.assert_close(got.float(), want.float(), **ROUTED_TOL[dtype])
        err_a = max((a.float() - wa.float()).abs().max().item(),
                    (h.float() - wh.float()).abs().max().item())
        M = B * k
        attn_flops = 2.0 * M * D * (nq + 2 * nkv) * hd + 2.0 * M * nq * hd * D \
            + 4.0 * hd * nq * _causal_pairs(pos)
        attn_bytes = (M * D + 2 * M * D + (2 * nq + 2 * nkv) * hd * D + D) * es + 12 * M
        mp = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
              "w_up": _w(g, dev, dtype, D, F), "w_down": _w(g, dev, dtype, F, D)}
        if cfg.glu:
            mp["w_gate"] = _w(g, dev, dtype, D, F)
        gate = torch.randn(B, k, generator=g, device=dev)
        build.reset_counters()
        out = SW.routed_mlp_scatter(x, h, a, idx, gate, mp, mspec)
        path = SW.gemm_path(dtype, B * k, F, D, True)
        if build.COUNTERS["routed_mlp_scatter"].by_call != {(path, B, S, k, D, F): 1}:
            raise AssertionError(f"routed_mlp_scatter {dtype} launched "
                                 f"{build.COUNTERS['routed_mlp_scatter'].by_call}, want {path}")
        want = SW.routed_mlp_scatter_plain(x, h, a, idx, gate, mp, mspec)
        torch.testing.assert_close(out.float(), want.float(), **ROUTED_TOL[dtype])
        err_m = (out.float() - want.float()).abs().max().item()
        lib = routed_mlp_library(x, h, a, idx, gate, mp, mspec)
        torch.testing.assert_close(lib.float(), want.float(), **ROUTED_TOL[dtype])
        err_lib = (lib.float() - want.float()).abs().max().item()
        n_w = 3 if cfg.glu else 2
        mlp_flops = 2.0 * M * D * F * n_w
        mlp_bytes = (2 * B * S * D + 2 * M * D + n_w * D * F + D) * es + 12 * M
        shape = f"B={B} S={S} k={k} D={D} {str(dtype)[6:]}"
        ha, hm = {}, {}
        rows = {
            "routed_attention": dict(
                ms=replay_ms(lambda: FA.routed_attention(x, idx, pos, ap, spec), ha, "ms", reps=5),
                plain_ms=replay_ms(lambda: FA.routed_attention_plain(x, idx, pos, ap, spec), ha,
                                   "plain_ms", reps=5),
                library_ms=None, bound=bound_ms(attn_bytes, attn_flops, dtype),
                max_abs_err=err_a, shape=f"{shape} {nq}x{hd}", timed_by=ha, gemm_path=attn_path),
            "routed_mlp_scatter": dict(
                ms=replay_ms(lambda: SW.routed_mlp_scatter(x, h, a, idx, gate, mp, mspec), hm, "ms",
                             reps=5),
                plain_ms=replay_ms(lambda: SW.routed_mlp_scatter_plain(x, h, a, idx, gate, mp,
                                                                     mspec), hm, "plain_ms",
                                reps=5),
                library_ms=replay_ms(lambda: routed_mlp_library(x, h, a, idx, gate, mp, mspec),
                                     hm, "library_ms", reps=5),
                bound=bound_ms(mlp_bytes, mlp_flops, dtype), max_abs_err=err_m,
                shape=f"{shape} F={F}", timed_by=hm, gemm_path=path),
        }
        for name, r in rows.items():
            r["tflops"] = (attn_flops if name == "routed_attention" else mlp_flops) / r["ms"] / 1e9
            lib = ("none" if r["library_ms"] is None else
                   f"{r['library_ms']:.4f} ({ROUTED_MLP_LIBRARY[dtype]}; within {err_lib:.3g} of "
                   f"the plain version)")
            gemm = f" gemm={r['gemm_path']}" if "gemm_path" in r else ""
            log(f"[kernels] {name:18s} {r['shape']:44s}{gemm} max_abs_err={r['max_abs_err']:.3g} "
                f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={lib} "
                f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}) achieved {r['tflops']:.2f} TFLOP/s"
                f"{timed_note(r['timed_by'])}")
            results.setdefault(name, {})[dtype] = r


# phase 6c's workload (mod-paper-1b, bf16): 8 requests sharing a 512-token
# prefix, suffixes of 64-448 tokens, 32 new tokens each, page 16, prefill
# chunk 256. Phase 2 checks and times the paged kernels at the shapes this
# workload gives them.
PAGED_1B = dict(B=8, gen=32, prefix=512, max_suffix=448, page=16, chunk=256)
# phases 4, 6c-11 and 13 serve mod-paper-1b at full width and this many of
# its 24 layers, to keep the script inside its 1200 s (phase 5 trains all
# 24 against its recorded losses; phase 14 serves its models whole)
SERVE_1B_LAYERS = 8


# phases 6b, 7a, 8a, 11a and 13a hold the CPU against the card on
# mod-paper-60m in f32 at full width and this many of its 8 layers (the
# CPU half runs the whole model on the host; phase 3 keeps all 8)
PARITY_60M_LAYERS = 4


def parity_60m_config():
    """mod-paper-60m as phases 6b-13a compare it across devices: f32,
    backend pallas, PARITY_60M_LAYERS of its layers."""
    from repro_torch.config import get_config, with_mod_backend

    return with_mod_backend(dataclasses.replace(get_config("mod-paper-60m"), dtype="float32",
                                                n_layers=PARITY_60M_LAYERS), "pallas")


def serve_1b_config():
    """mod-paper-1b as phases 4, 6c-11 and 13 serve it: backend pallas,
    SERVE_1B_LAYERS of its layers."""
    from repro_torch.config import get_config, with_mod_backend

    return with_mod_backend(dataclasses.replace(get_config("mod-paper-1b"),
                                                n_layers=SERVE_1B_LAYERS), "pallas")


def paged_1b_plan():
    """(suffix lengths, ctx, prompt chunks) of phase 6c's workload."""
    w = PAGED_1B
    suffix = np.random.default_rng(1).integers(64, w["max_suffix"] + 1, w["B"])
    ctx = w["prefix"] + w["max_suffix"] + w["gen"]
    n_chunks = int(sum(-(-(w["prefix"] + int(n)) // w["chunk"]) for n in suffix))
    return suffix, ctx, n_chunks


def synthetic_pool(cfg, dev, kind: str, seed: int = 23) -> dict:
    """Layer 0 of a pool of ``PAGED_1B``'s layout as phase 10 finds it after
    the prefills, made from a seed with no engine run: B*P + 2 pages of 16
    rows (NULL and scratch first), each slot holding positions [0, n_b)
    with n_b = 512 + suffix_b + 1 (``paged_1b_plan``'s suffixes), its 32
    prefix pages one shared run, its own pages shuffled, NULL past its
    length; random bf16 K/V, or (``kind`` "int8") int8 K/V with pow2
    per-row scales. A :func:`snapshot_pool` dict (without ``cols``)."""
    w = PAGED_1B
    suffix, ctx, _ = paged_1b_plan()
    B, p, P = w["B"], w["page"], ctx // w["page"]
    N, shared = B * P + 2, w["prefix"] // w["page"]
    nkv, hd = cfg.attn.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = dict(dtype=torch.int32, device=dev)
    n = torch.tensor([w["prefix"] + int(x) + 1 for x in suffix], **i32)
    free = (2 + torch.randperm(N - 2, generator=g, device=dev)).to(torch.int32)
    table = torch.zeros(B, P, **i32)  # NULL
    table[:, :shared] = free[:shared]
    at = shared
    pos = torch.full((N, p), -1, **i32)
    for b in range(B):
        used = -(-int(n[b]) // p)
        table[b, shared:used] = free[at:at + used - shared]
        at += used - shared
        ids = torch.arange(int(n[b]), **i32)
        pos[table[b, ids // p].long(), (ids % p).long()] = ids
    snap = dict(pos=pos, table=table, n=n, cols=None, scales=None)
    kv = [torch.randn(N, p, nkv, hd, generator=g, device=dev) for _ in range(2)]
    if kind == "int8":
        snap["k"], snap["v"] = ((t * 127 / 3).clamp(-127, 127).round().to(torch.int8) for t in kv)
        snap["scales"] = tuple(
            (2.0 ** torch.randint(-9, -5, (N, p, 1), generator=g, device=dev).float())
            .expand(N, p, nkv).contiguous() for _ in range(2))
    else:
        snap["k"], snap["v"] = (t.to(torch.bfloat16) for t in kv)
    return snap


def ragged_attention_timing(name: str, readings, cfg, dev) -> None:
    """``--routed-paged-timing``'s ragged attention rows: phase 10's decode
    and mixed steps (bf16 queries) on a bf16 and an int8 :func:`synthetic_pool`,
    through the public wrapper, each checked against the plain version
    first."""
    from repro_torch.kernels import ragged as KRG

    g = torch.Generator(device=dev).manual_seed(11)
    for kind in ("bf16", "int8"):
        snap = synthetic_pool(cfg, dev, kind)
        for step, st in _ragged_steps(snap, g, cfg.attn.n_heads, torch.bfloat16).items():
            args, kw = _ragged_args(snap, st, torch.bfloat16)
            out = KRG.ragged_paged_flash_attention(*args, **kw)
            want = KRG.ragged_paged_flash_attention_plain(*args, **kw)
            torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])
            log(f"[routed-paged-timing] {name}: ragged_paged_flash_attention {kind} pool {step} "
                f"T={args[0].shape[0]} seg_cap={st['cap']}: " + readings(
                    {"kernel": lambda: KRG.ragged_paged_flash_attention(*args, **kw)}))


def _changed_rows(pages, before):
    """Flat (page, offset) row indices where two page tensors differ."""
    N, p = pages.shape[:2]
    return set((pages != before).reshape(N * p, -1).any(-1).nonzero().flatten().tolist())


def _paged_inputs(g, dev, dtype, F, lens, gen, P, p, C):
    """Inputs of the three paged kernels as an engine step over prompts of
    ``lens`` tokens gives them: the engine's default pool of B·P + 2 pages,
    each slot's table mapping the pages its sequence reaches (the rest
    NULL), one decode position per slot, and the ragged write-backs of the
    two kinds of step: the first (every prompt chunk as a segment, no slot
    decoding) and a decode-only one (the B decode rows). Returns (pages,
    table, rows, pos, {W: (pid, off, rows, valid rows)})."""
    from repro_torch.kernels import ragged as KRG
    from repro_torch.serve.cache import NULL_PAGE, SCRATCH_PAGE

    B, N = len(lens), len(lens) * P + 2
    pages = (torch.randn(N, p, F, generator=g, device=dev) * 8).to(dtype)
    table = (torch.randperm(N - 2, generator=g, device=dev)[: B * P] + 2).to(torch.int32)
    table = table.reshape(B, P)
    mapped = torch.as_tensor([-(-(L + gen) // p) for L in lens], device=dev)
    table[torch.arange(P, device=dev)[None] >= mapped[:, None]] = NULL_PAGE
    pos_np = np.asarray([L + gen // 2 for L in lens])
    pos = torch.as_tensor(pos_np, dtype=torch.int32, device=dev)
    rows = (torch.randn(B, F, generator=g, device=dev) * 8).to(dtype)
    segs = [(i, st, min(C, L - st)) for i, L in enumerate(lens) for st in range(0, L, C)]
    ragged = {}
    for seg_list, decoding in ((segs, False), ([], True)):
        slot = np.concatenate([np.arange(B)] + [np.full(C, i) for i, _, _ in seg_list])
        wpos = np.concatenate([pos_np] + [st + np.arange(C) for _, st, _ in seg_list])
        valid = np.concatenate([np.full(B, decoding)]
                               + [np.arange(C) < nv for _, _, nv in seg_list])
        pid, off = KRG.ragged_page_targets(
            table, torch.as_tensor(slot, device=dev),
            torch.as_tensor(wpos.astype(np.int32), device=dev),
            torch.as_tensor(valid, device=dev), p, SCRATCH_PAGE)
        W = len(slot)
        wrows = (torch.randn(W, F, generator=g, device=dev) * 8).to(dtype)
        ragged[W] = (pid, off, wrows, int(valid.sum()))
    return pages, table, rows, pos, ragged


def check_paged(cfg, dev, results):
    """The three paged-pool kernels at the shapes phase 6c's mod-paper-1b
    workload gives them, and at odd tails. That workload (ctx 992, page 16:
    P=62 logical pages per slot, the default pool of N=8·62+2=498 pages)
    pages K/V leaves of F=n_kv·head_dim=1792 bf16 and position leaves of
    F=1 int32; it gathers (8, P) tables in decode and ragged steps and
    (1, P) in each chunked prefill, scatters 8 decode rows, and writes back
    W=8+29·256 rows in the ragged run's first step and W=8 in each later
    one. All three are copies: the kernel must equal its plain version
    exactly, and the in-place scatters must leave every row outside their
    targets untouched (checked against a saved copy of the pool). Timed
    per leaf kind and shape, the write-back's K/V leaf at W=7432 also from
    rows 4 bytes off a 16-byte base (4-byte vectors); the gather's and the
    write-back's launches must carry the plan the pure planner gives for
    the shape; main() pairs each shape with its launches."""
    from repro_torch.kernels import build
    from repro_torch.kernels import paged as KP
    from repro_torch.kernels import ragged as KRG
    from repro_torch.serve.cache import SCRATCH_PAGE

    suffix, ctx, _ = paged_1b_plan()
    w = PAGED_1B
    p, C, gen = w["page"], w["chunk"], w["gen"]
    lens = [w["prefix"] + int(n) for n in suffix]
    F_kv = cfg.attn.n_kv_heads * cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [("kv", torch.bfloat16, F_kv, lens, gen, ctx // p, p, C),
             ("pos", torch.int32, 1, lens, gen, ctx // p, p, C),
             ("kv f32", torch.float32, F_kv, lens, gen, ctx // p, p, C),
             ("tail", torch.bfloat16, 13, [9, 20, 4], 3, 5, 7, 5),
             ("tail", torch.int32, 13, [9, 20, 4], 3, 5, 7, 5)]
    for label, dtype, F, lens_, gen_, P, p_, C_ in cases:
        pages, table, rows, pos, ragged = _paged_inputs(g, dev, dtype, F, lens_, gen_, P, p_, C_)
        N, B = pages.shape[0], table.shape[0]
        es = pages.element_size()
        build.reset_counters()
        for t in (table, table[:1]):
            if not torch.equal(KP.paged_gather(pages, t), KP.paged_gather_plain(pages, t)):
                raise AssertionError(f"paged_gather differs from its plain version ({label} "
                                     f"B={t.shape[0]} {dtype})")
        before = pages.clone()
        want = KP.paged_scatter_rows_plain(before.clone(), table, rows, pos)
        KP.paged_scatter_rows(pages, table, rows, pos)
        tgt = table.long()[torch.arange(B, device=dev), pos.long() // p_] * p_ + pos.long() % p_
        if not torch.equal(pages, want) or not _changed_rows(pages, before) <= set(tgt.tolist()):
            raise AssertionError(f"paged_scatter_rows wrong or wrote outside its rows ({label})")
        # the clamps, at B and at one slot: positions below 0 and past P·p,
        # table entries below 0 and past N (the clamped targets: page 0 at
        # offset 0, page N-1 at offset p-1); rows 4 bytes off a 16-byte base
        row_bytes = F * es
        for Bc in (B, 1):
            t, ps, rw = table[:Bc].clone(), pos[:Bc].clone(), rows[:Bc]
            ps[0] = -5
            t[0, 0] = -3
            if Bc > 1:
                ps[-1], t[-1, -1] = P * p_ + 7, N + 9
                tt = ps.long().clamp(0, P * p_ - 1)
                hit = (t.long()[torch.arange(Bc, device=dev), tt // p_].clamp(0, N - 1) * p_
                       + tt % p_).tolist()
                if len(set(hit)) < Bc:  # page N-1's last row is another slot's target:
                    t[-1, -1] = -3  # page 0's last row instead, which no table maps
            variants = [("", rw)]
            if row_bytes % 16 == 0:
                variants.append((" rows 4 bytes off 16", torch.cat(
                    [rw.new_zeros(4 // es), rw.flatten()])[4 // es:].view(Bc, F)))
            for suffix, r_ in variants:
                want = KP.paged_scatter_rows_plain(pages.clone(), t, r_, ps)
                KP.paged_scatter_rows(pages, t, r_, ps)
                plan = KP.scatter_rows_plan(N, Bc, P, p_, row_bytes, pages.data_ptr(),
                                            r_.data_ptr())
                calls = build.COUNTERS["paged_scatter_rows"].by_call
                if not torch.equal(pages, want) or (plan.vec, Bc, row_bytes) not in calls:
                    raise AssertionError(f"paged_scatter_rows with out-of-range positions and "
                                         f"table entries differs from its plain version or "
                                         f"missed its plan {plan} ({label} B={Bc}{suffix})")
        keep = torch.ones(N, dtype=torch.bool, device=dev)
        keep[SCRATCH_PAGE] = False  # rows colliding on the scratch page are garbage by contract
        for W, (pid, off, wrows, _) in ragged.items():
            before = pages.clone()
            want = KRG.ragged_paged_scatter_rows_plain(before.clone(), pid, off, wrows)
            KRG.ragged_paged_scatter_rows(pages, pid, off, wrows)
            hit = set((pid.long() * p_ + off.long()).tolist())
            if not torch.equal(pages[keep], want[keep]) or not _changed_rows(pages, before) <= hit:
                raise AssertionError(f"ragged_paged_scatter_rows wrong or wrote outside ({label} "
                                     f"W={W})")
        shape = f"N={N} p={p_} F={F} P={P} {str(dtype)[6:]}"
        if label not in ("kv", "pos"):
            vecs = sorted({key[0] for key in build.COUNTERS["paged_gather"].by_call})
            log(f"[kernels] paged kernels {label} {shape} B={B} W={sorted(ragged)}: all three "
                f"bitwise equal to their plain versions, no row outside the targets written "
                f"(gather vectors of {vecs} bytes)")
            continue
        flat = pages.view(N * p_, F)
        fi = tgt.contiguous()
        timed = {}
        for Bg in (B, 1):
            t = table[:Bg].contiguous()
            # the gather reads each distinct page it maps once and writes
            # every logical page
            reads = torch.unique(t).numel()
            gplan = KP.gather_plan(N, Bg, P, p_ * F * es, pages.data_ptr())
            if (gplan.vec, Bg, P, p_ * F * es) not in build.COUNTERS["paged_gather"].by_call:
                raise AssertionError(f"paged_gather {label} B={Bg} launched "
                                     f"{build.COUNTERS['paged_gather'].by_call}, not {gplan}")
            timed[("paged_gather", f"{label} B={Bg}")] = dict(
                fn=lambda t=t: KP.paged_gather(pages, t),
                plain=lambda t=t: KP.paged_gather_plain(pages, t),
                library=lambda t=t.flatten().long(): torch.index_select(pages, 0, t),
                nbytes=(Bg * P + reads) * p_ * F * es + 4 * Bg * P, shape=f"{shape} B={Bg}",
                plan=gplan)
        # the rows read and written, the B positions and the B table
        # entries the kernel loads; K/V also from rows 4 bytes off a 16-byte
        # base (4-byte vectors; phase 6c's rows are aligned)
        svariants = [("", rows)]
        if label == "kv":
            svariants.append((" rows 4 bytes off 16",
                              torch.cat([rows.new_zeros(2), rows.flatten()])[2:].view(B, F)))
        for suffix, rw in svariants:
            timed[("paged_scatter_rows", f"{label} B={B}{suffix}")] = dict(
                fn=lambda rw=rw: KP.paged_scatter_rows(pages, table, rw, pos),
                plain=lambda rw=rw: KP.paged_scatter_rows_plain(pages, table, rw, pos),
                library=lambda rw=rw: flat.index_copy_(0, fi, rw),
                nbytes=2 * B * F * es + 4 * B + 4 * B, shape=f"{shape} B={B}{suffix}",
                plan=KP.scatter_rows_plan(N, B, P, p_, F * es, pages.data_ptr(), rw.data_ptr()),
                off_path=bool(suffix))
        for W, (pid, off, wrows, n_valid) in ragged.items():
            wfi = (pid.long() * p_ + off.long()).contiguous()
            variants = [("", wrows)]
            if label == "kv" and W > B:  # the same rows 4 bytes off a 16-byte aligned base
                shifted = torch.cat([wrows.new_zeros(2), wrows.flatten()])[2:].view(W, F)
                variants.append((" rows 4 bytes off 16", shifted))
            for suffix, rw in variants:
                splan = KRG.scatter_plan(N, W, p_, F * es, pages.data_ptr(), rw.data_ptr())
                if suffix:  # checked here; the aligned rows were checked above
                    before = pages.clone()
                    want = KRG.ragged_paged_scatter_rows_plain(before.clone(), pid, off, rw)
                    KRG.ragged_paged_scatter_rows(pages, pid, off, rw)
                    hit = set((pid.long() * p_ + off.long()).tolist())
                    if not torch.equal(pages[keep], want[keep]) or \
                            not _changed_rows(pages, before) <= hit:
                        raise AssertionError(f"ragged_paged_scatter_rows wrong or wrote outside "
                                             f"({label} W={W}{suffix})")
                calls = build.COUNTERS["ragged_paged_scatter_rows"].by_call
                if (splan.vec, W, F * es) not in calls:
                    raise AssertionError(f"ragged_paged_scatter_rows {label} W={W}{suffix} "
                                         f"launched {calls}, not {splan}")
                # the valid rows read and written (rows routed to the
                # scratch page are garbage by contract) and every row's
                # target pair
                timed[("ragged_paged_scatter_rows", f"{label} W={W}{suffix}")] = dict(
                    fn=lambda pid=pid, off=off, rw=rw:
                        KRG.ragged_paged_scatter_rows(pages, pid, off, rw),
                    plain=lambda pid=pid, off=off, rw=rw:
                        KRG.ragged_paged_scatter_rows_plain(pages, pid, off, rw),
                    library=lambda wfi=wfi, rw=rw: flat.index_copy_(0, wfi, rw),
                    nbytes=2 * n_valid * F * es + 8 * W,
                    shape=f"{shape} W={W}{suffix} ({n_valid} valid)", plan=splan,
                    off_path=bool(suffix))  # phase 6c never writes unaligned rows
        for (name, key), c in timed.items():
            how: dict = {}
            r = dict(call_ms=event_ms(c["fn"]), ms=replay_ms(c["fn"], how, "ms"),
                     plain_ms=replay_ms(c["plain"], how, "plain_ms"),
                     library_ms=replay_ms(c["library"], how, "library_ms"),
                     bound=bound_ms(c["nbytes"], 0, dtype), timed_by=how,
                     max_abs_err=0.0, shape=c["shape"],  # equality was checked above
                     off_path=c.get("off_path", False))
            plan = ""
            if "plan" in c:  # the flat grid's vector bytes, vectors a thread and blocks
                r["plan"] = c["plan"]._asdict()
                plan = (f" plan=vec{c['plan'].vec} unroll{c['plan'].unroll} x "
                        f"{c['plan'].blocks} blocks")
            log(f"[kernels] {name:26s} {r['shape']:44s}{plan} bitwise-equal ms={r['ms']:.4f} "
                f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.6f} ({r['bound'][1]})"
                f"{timed_note(how)}")
            results.setdefault(name, {})[key] = r


# phase 7b's quantized engines: (name, engine settings, QuantConfig fields),
# all on PAGED_1B's workload
QUANT_1B = (
    ("prefix int8/page", dict(prefix_cache=True), dict(kv="int8", granularity="page")),
    ("prefix fp8/head", dict(prefix_cache=True), dict(kv="fp8", granularity="head")),
    ("ragged int8/page", dict(ragged=True), dict(kv="int8", granularity="page")),
    ("prefix int8/page + int8 weights", dict(prefix_cache=True),
     dict(kv="int8", granularity="page", weights="int8")),
)


def check_quant_casts(dev):
    """The card's int8 / e4m3 casts and pow2 scales against the CPU's, on
    values that hit every rounding case: quantize_rows and pow2_scale on
    the same inputs on both devices, bit for bit."""
    from repro_torch.serve.quant import QuantConfig, pow2_scale, quantize_rows

    g = torch.Generator().manual_seed(8)
    x = torch.randn(4096, 1792, generator=g) * torch.rand(4096, 1, generator=g) * 60
    x[:64] = torch.round(x[:64] * 2) / 2  # int8 midpoints after a pow2 scale
    x[64:128] = x[64:128] * 1e-30  # tiny rows
    # scale 2^-126 with subnormal elements beside it: both devices flush
    # them to a zero of their sign before dividing, as XLA does
    x[128:130] = 0.0
    x[128, 0], x[129, 0] = 127.0 * 2.0 ** -126, 448.0 * 2.0 ** -126
    x[128:130, 1], x[128:130, 2], x[128:130, 3] = 1.1e-38, -6e-39, -1e-45
    ratios = torch.cat([torch.tensor([0.0, 1e-42, 1e-40, 3e-38, float("inf"), 448.0, 127.0]),
                        torch.rand(4096, generator=g) * 1e4])
    for qmax in (127.0, 448.0):
        a, b = pow2_scale(ratios, qmax), pow2_scale(ratios.to(dev), qmax).cpu()
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"pow2_scale differs between the CPU and the card (qmax {qmax})")
    for kv, gran, G in (("int8", "page", 1), ("fp8", "head", 14)):
        qc = QuantConfig(kv=kv, granularity=gran)
        qa, sa = quantize_rows(x, G, qc)
        qb, sb = quantize_rows(x.to(dev), G, qc)
        n = int((qa.view(torch.uint8) != qb.cpu().view(torch.uint8)).sum())
        if n or not torch.equal(sa, sb.cpu()):
            raise AssertionError(f"{kv}/{gran}: {n} narrow bytes or the scales differ between the "
                                 "CPU and the card")
        if qb[128:130, 1:4].float().any():
            raise AssertionError(f"{kv}/{gran}: a subnormal element quantized to a nonzero value")
    log(f"[kernels] quantize casts: int8/page and fp8/head bytes and scales of {x.numel()} values "
        f"(subnormal elements flushed to 0), and pow2_scale of {ratios.numel()} ratios "
        f"(subnormal, inf), identical on the CPU and the card")


def check_dequant(cfg, dev, results):
    """The dequantizing gather at phase 7b's shapes: PAGED_1B's pool (N=498,
    p=16, ctx 992: P=62) of int8 pages with one scale per page row (a
    (N, p, 1) tensor all 12 full layers share) and of e4m3 pages with one
    scale per kv head (layer 0's 14 columns of the (N, p, 12·14) tensor),
    widened to bf16 through (8, 62) decode tables and (1, 62) prefill
    tables, mapped up to each sequence's length and NULL after. Bitwise
    against the plain version; timed per shape. No single PyTorch call
    computes the function, so there is no library time. The bound counts
    the narrow bytes and scales of each distinct page read, the table, and
    the bf16 output."""
    from repro_torch.kernels import paged as KP
    from repro_torch.serve.quant import QuantConfig, quantize_rows

    suffix, ctx, _ = paged_1b_plan()
    w = PAGED_1B
    p, gen = w["page"], w["gen"]
    lens = [w["prefix"] + int(n) for n in suffix]
    F, nkv = cfg.attn.n_kv_heads * cfg.head_dim, cfg.attn.n_kv_heads
    n_full = cfg.n_layers // 2
    g = torch.Generator(device=dev).manual_seed(9)
    P = ctx // p
    for label, kv, gran, G_all in (("int8/page", "int8", "page", 1),
                                   ("fp8/head", "fp8", "head", n_full * nkv)):
        pages_w, table, _, _, _ = _paged_inputs(g, dev, torch.bfloat16, F, lens, gen, P, p,
                                                w["chunk"])
        N = pages_w.shape[0]
        q, _ = quantize_rows(pages_w, 1 if gran == "page" else nkv, QuantConfig(kv=kv))
        scales = 2.0 ** torch.randint(-8, 4, (N, p, G_all), generator=g, device=dev).float()
        sc = scales[:, :, :1] if gran == "page" else scales[:, :, :nkv]
        for t in (table, table[:1]):
            got = KP.paged_gather_dequant(q, sc, t, torch.bfloat16)
            if not torch.equal(got, KP.paged_gather_dequant_plain(q, sc, t, torch.bfloat16)):
                raise AssertionError(f"paged_gather_dequant differs from its plain version "
                                     f"({label} B={t.shape[0]})")
        for Bg in (len(lens), 1):
            t = table[:Bg].contiguous()
            reads = torch.unique(t).numel()
            G = sc.shape[2]
            nbytes = reads * p * (F + 4 * G) + 4 * Bg * P + Bg * P * p * F * 2
            fn = (lambda t=t: KP.paged_gather_dequant(q, sc, t, torch.bfloat16))
            how: dict = {}
            r = dict(call_ms=event_ms(fn), ms=replay_ms(fn, how, "ms"),
                     plain_ms=replay_ms(lambda t=t: KP.paged_gather_dequant_plain(
                         q, sc, t, torch.bfloat16), how, "plain_ms"),
                     library_ms=None, bound=bound_ms(nbytes, 0, torch.bfloat16), max_abs_err=0.0,
                     shape=f"{label} N={N} p={p} F={F} G={G} B={Bg} P={P} -> bf16", timed_by=how)
            log(f"[kernels] paged_gather_dequant {r['shape']:52s} bitwise-equal ms={r['ms']:.4f} "
                f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms=none "
                f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]}){timed_note(how)}")
            results.setdefault("paged_gather_dequant", {})[f"{label} B={Bg}"] = r
    # odd widths and a scale block that is not a multiple of 16 elements
    # (the kernel's element-wise path), both narrow types, f32 output
    for narrow, F_, G_ in ((torch.int8, 13, 1), (torch.float8_e4m3fn, 24, 3)):
        q = (torch.randn(9, 3, F_, generator=g, device=dev) * 50).clamp(-127, 127).round()
        q = q.to(torch.int8) if narrow == torch.int8 else (q * 3).to(narrow)
        sc = 2.0 ** torch.randint(-8, 4, (9, 3, G_), generator=g, device=dev).float()
        t = torch.tensor([[2, 0, 5], [5, 8, 1]], dtype=torch.int32, device=dev)
        for odt in (torch.float32, torch.bfloat16):
            if not torch.equal(KP.paged_gather_dequant(q, sc, t, odt),
                               KP.paged_gather_dequant_plain(q, sc, t, odt)):
                raise AssertionError(f"paged_gather_dequant differs at F={F_} G={G_} {odt}")
    log("[kernels] paged_gather_dequant odd widths (F=13 G=1 int8, F=24 G=3 e4m3; f32 and bf16 "
        "out): bitwise equal")


# phase 8b's flat streams (mod-paper-1b, bf16): 4 equal segments of 1024,
# then 8 unequal ones packed on the same T=4096 stream (45 padded rows)
# The bf16 flat forward of mod-paper-1b against the f32 one on the same
# routed rows, as fractions of the largest f32 value: bf16 rounding alone,
# carried through the layers. Twice the 24-layer readings on an H100 (logits 0.060,
# router scores 0.079; PERF.md); a dropped routed row or attention across
# segments moves both by more than half their scale.
BF16_FLAT_LOGITS = 0.12
BF16_FLAT_SCORES = 0.16
RAGGED_1B = dict(equal=(1024,) * 4, unequal=(142, 998, 310, 655, 420, 777, 230, 519),
                 T=4096, seg_cap=1024)


def _ragged_selection(g, dev, lens, k, T):
    """(n_seg, k) int32 flat selections as decide_tokens_ragged makes them:
    sorted within each segment, -1 past a segment shorter than k."""
    offs = np.concatenate([[0], np.cumsum(lens)])
    idx = torch.full((len(lens), k), -1, dtype=torch.int32, device=dev)
    for s, L in enumerate(lens):
        n = min(k, L)
        sel = torch.sort(torch.randperm(L, generator=g, device=dev)[:n]).values
        idx[s, :n] = (int(offs[s]) + sel).to(torch.int32)
    return idx


def check_ragged_dispatch(cfg, dev, results):
    """The ragged MoD gather and scatter at phase 8b's shapes (T=4096,
    D=1792, bf16, k = capacity(1024) routed rows per segment), and a short
    segment with -1 selections. Bitwise against the plain versions; the
    library times are index_select / index_add of the valid selections
    (the latter of the precomputed gated update), as rows 1-2 use them;
    the plans the wrappers make ride on the lines (:func:`check_routing`
    checks that a ragged scatter is one launch)."""
    from repro_torch.kernels import ragged as KRG
    from repro_torch.kernels import routing as KR

    g = torch.Generator(device=dev).manual_seed(10)
    D, T = cfg.d_model, RAGGED_1B["T"]
    k = cfg.mod.capacity(RAGGED_1B["seg_cap"])
    cases = [("equal", RAGGED_1B["equal"], k, torch.bfloat16),
             ("unequal", RAGGED_1B["unequal"], k, torch.bfloat16),
             ("short f32", (100, 3, 0, 700), k, torch.float32)]
    for label, lens, kk, dtype in cases:
        x = torch.randn(T, D, generator=g, device=dev).to(dtype)
        idx = _ragged_selection(g, dev, lens, kk, T)
        delta = torch.randn(len(lens), kk, D, generator=g, device=dev).to(dtype)
        gate = torch.where(idx >= 0, torch.randn(idx.shape, generator=g, device=dev), 0.0)
        before = x.clone()
        got = KRG.ragged_gather_rows(x, idx)
        out = KRG.ragged_scatter_add_rows(x, idx, delta, gate)
        if not (torch.equal(got, KRG.ragged_gather_rows_plain(x, idx))
                and torch.equal(out, KRG.ragged_scatter_add_rows_plain(x, idx, delta, gate))
                and torch.equal(x, before)):
            raise AssertionError(f"ragged dispatch differs from its plain versions ({label})")
        if label.startswith("short"):
            log(f"[kernels] ragged dispatch {label} (segments {lens}, -1 tails): bitwise equal")
            continue
        valid = idx[idx >= 0].long()
        n_valid, es = valid.numel(), x.element_size()
        upd = (gate[idx >= 0][:, None] * delta[idx >= 0].float()).to(dtype)
        shape = f"{label} T={T} D={D} n_seg={len(lens)} k={kk} bf16"
        timed = {
            "ragged_gather_rows": dict(
                fn=lambda: KRG.ragged_gather_rows(x, idx),
                plain=lambda: KRG.ragged_gather_rows_plain(x, idx),
                library=lambda: x.index_select(0, valid),
                nbytes=2 * n_valid * D * es + 4 * idx.numel(), flops=0,
                plan=KR.dispatch_plan("gather", 1, T, idx.numel(), D * es, es, 4,
                                      (x.data_ptr(), got.data_ptr()))._asdict()),
            "ragged_scatter_add_rows": dict(
                fn=lambda: KRG.ragged_scatter_add_rows(x, idx, delta, gate),
                plain=lambda: KRG.ragged_scatter_add_rows_plain(x, idx, delta, gate),
                uncapturable="the plain version selects rows by a boolean mask, a host sync",
                library=lambda: x.index_add(0, valid, upd),
                nbytes=2 * T * D * es + n_valid * D * es + 8 * idx.numel(),
                flops=2 * n_valid * D,
                plan=KR.dispatch_plan("scatter", 1, T, idx.numel(), D * es, es, 4,
                                      (x.data_ptr(), delta.data_ptr(), out.data_ptr()))._asdict()),
        }
        for name, c in timed.items():
            how: dict = {}
            r = dict(call_ms=event_ms(c["fn"]), ms=replay_ms(c["fn"], how, "ms"),
                     plain_ms=replay_ms(c["plain"], how, "plain_ms",
                                        uncapturable=c.get("uncapturable", "")),
                     library_ms=replay_ms(c["library"], how, "library_ms"),
                     bound=bound_ms(c["nbytes"], c["flops"], dtype), timed_by=how,
                     max_abs_err=0.0, shape=shape)
            log(f"[kernels] {name:24s} {shape:46s} bitwise-equal ms={r['ms']:.4f} "
                f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.6f} ({r['bound'][1]}, "
                f"{r['bound'][0] / r['ms']:.0%} of it) {plan_note(c['plan'])}{timed_note(how)}")
            results.setdefault(name, {})[label] = dict(r, plan=c["plan"])


def _grads(fn, inputs, seed):
    """Gradients, by autograd, of a loss linear in fn's outputs (fixed random
    weights, so the cotangents do not depend on the forward values)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=outs[0].device).manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g, device=o.device)).sum() for o in outs)
    loss.backward()
    for t in leaves:
        if t.grad is None:
            raise AssertionError("a kernel wrapper returned no gradient")
    return [t.grad for t in leaves]


def check_grads(cfg, dev):
    """Autograd through each kernel's autograd.Function (kernel forward)
    against autograd through its plain version, bf16 and f32. Tolerances:
    gather/scatter backwards are the same two copy/update kernels (exact;
    dgate sums in another order, 1e-5); the fused kernels' backwards
    recompute the plain version (equal up to cuBLAS's own order, 1e-5);
    the flash backward (torch ops from the kernel's lse) against the
    dense plain version's autograd: f32 1e-4, bf16 3e-2 (the plain
    version's autograd rounds at its bf16 casts)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import routing as KR
    from repro_torch.kernels import swiglu as SW

    g = torch.Generator(device=dev).manual_seed(4)
    B, S, D, nq, hd, F = 2, 512, 512, 4, 128, 1024
    k = 64
    for dtype in (torch.bfloat16, torch.float32):
        loose = 1e-4 if dtype == torch.float32 else 3e-2
        x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
        idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                           for _ in range(B)])
        pos = idx.to(torch.int32)
        delta = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
        gate = torch.randn(B, k, generator=g, device=dev)
        q, kk, vv = (torch.randn(B, S, nq, hd, generator=g, device=dev).to(dtype)
                     for _ in range(3))
        spos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        ap = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
              "wq": _w(g, dev, dtype, D, nq * hd), "wk": _w(g, dev, dtype, D, nq * hd),
              "wv": _w(g, dev, dtype, D, nq * hd), "wo": _w(g, dev, dtype, nq * hd, D)}
        spec = FA.RoutedAttnSpec(nq, nq, hd, hd ** -0.5, True, 0, 10000.0, "rope", 1e-5)
        mp = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
              "w_up": _w(g, dev, dtype, D, F), "w_down": _w(g, dev, dtype, F, D),
              "w_gate": _w(g, dev, dtype, D, F)}
        mspec = SW.RoutedMlpSpec("silu", 1e-5)
        ak, mk = list(ap), list(mp)
        cases = {
            "gather_rows": (lambda x_: KR.gather_rows(x_, idx),
                            lambda x_: KR.gather_rows_plain(x_, idx), [x], 1e-5),
            "scatter_add_rows": (lambda *t: KR.scatter_add_rows(t[0], idx, t[1], t[2]),
                                 lambda *t: KR.scatter_add_rows_plain(t[0], idx, t[1], t[2]),
                                 [x, delta, gate], 1e-5),
            "flash_attention": (lambda *t: FA.flash_attention(*t, spos, spos),
                                lambda *t: FA.flash_attention_plain(*t, spos, spos),
                                [q, kk, vv], loose),
            "routed_attention": (
                lambda x_, *ps: FA.routed_attention(x_, idx, pos, dict(zip(ak, ps)), spec),
                lambda x_, *ps: FA.routed_attention_plain(x_, idx, pos, dict(zip(ak, ps)), spec),
                [x, *ap.values()], 1e-5),
            "routed_mlp_scatter": (
                lambda x_, h_, a_, g_, *ps: SW.routed_mlp_scatter(
                    x_, h_, a_, idx, g_, dict(zip(mk, ps)), mspec),
                lambda x_, h_, a_, g_, *ps: SW.routed_mlp_scatter_plain(
                    x_, h_, a_, idx, g_, dict(zip(mk, ps)), mspec),
                [x, delta, delta, gate, *mp.values()], 1e-5),
        }
        for name, (fn, plain, inputs, tol) in cases.items():
            build.reset_counters()
            got = _grads(fn, inputs, 5)
            launched = build.launch_counts()[name]
            want = _grads(plain, inputs, 5)
            errs = []
            for a, b in zip(got, want):
                torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
                errs.append((a.float() - b.float()).abs().max().item())
            if launched < 1:
                raise AssertionError(f"{name}: the gradient check launched no kernel")
            log(f"[grads] {name:18s} {str(dtype)[6:]:9s} {len(got)} input gradients, max |diff| "
                f"{max(errs):.3g} (tolerance {tol:g}), {launched} launches")


# ---------------------------------------------------------------------------
# Phase 3: the port on the CPU against the port on the card
# ---------------------------------------------------------------------------


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def cross_device_parity(dev):
    from repro_torch.config import get_config, with_mod_backend
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import api

    cfg = with_mod_backend(dataclasses.replace(get_config("mod-paper-60m"), dtype="float32"),
                           "pallas")
    cpu = torch.device("cpu")
    p_cpu = api.init_model(cfg, device=cpu, seed=3)
    p_gpu = _to(p_cpu, dev)
    B, S, steps = 4, 256, 16
    ctx = S + steps
    toks = torch.as_tensor(SyntheticLM(cfg.vocab, S, seed=11).batch(0, B)["tokens"]).long()
    lc, cc = api.model_prefill(p_cpu, cfg, {"tokens": toks}, ctx)
    lg, cg = api.model_prefill(p_gpu, cfg, {"tokens": toks.to(dev)}, ctx)

    def compare(tag, a, b):
        a, b = a.float(), b.float().cpu()
        diff = (a - b).abs().max().item()
        lim = 1e-3 * a.abs().max().item()
        log(f"[parity] {tag}: max|dlogit|={diff:.3g} (limit {lim:.3g})")
        if not diff <= lim:
            raise AssertionError(f"{tag}: logits differ by {diff} > {lim}")

    def rings(tag, c1, c2):
        for gi, (g1, g2) in enumerate(zip(c1["groups"], c2["groups"])):
            if not torch.equal(g1["mod"]["pos"], g2["mod"]["pos"].cpu()):
                raise AssertionError(f"{tag}: routed tokens of MoD group {gi} differ")
        log(f"[parity] {tag}: routed tokens identical in all {len(c1['groups'])} MoD rings")

    compare("prefill", lc, lg)
    rings("prefill", cc, cg)
    tok = lc[:, -1].argmax(-1)[:, None]
    active = torch.ones(B, dtype=torch.bool)
    for step in range(steps):
        pos = torch.full((B,), S + step, dtype=torch.int32)
        lc, cc, ac = api.model_decode(p_cpu, cc, cfg, tok, pos, active)
        lg, cg, ag = api.model_decode(p_gpu, cg, cfg, tok.to(dev), pos.to(dev), active.to(dev))
        mc, mg = ac["mod/decode_routed"], ag["mod/decode_routed"].cpu()
        log(f"[parity] decode step {step:2d}: max|dlogit|={(lc - lg.cpu()).abs().max().item():.3g} "
            f"routed cpu={mc.tolist()} gpu={mg.tolist()}")
        if not torch.equal(mc, mg):
            gap = (ac["mod/decode_scores"] - ag["mod/decode_scores"].cpu()).abs().max().item()
            log(f"[parity] routed masks differ; scores cpu={ac['mod/decode_scores'].tolist()} "
                f"gpu={ag['mod/decode_scores'].tolist()} max gap {gap:.3g}")
            raise AssertionError(f"decode step {step}: routed masks differ")
        compare(f"decode step {step}", lc, lg)
        tok = lc.argmax(-1)[:, None]  # the CPU run's tokens feed both
    rings("after decode", cc, cg)


@contextlib.contextmanager
def recorded_decisions(name):
    """Record every routing decision ``core.routing.<name>`` makes inside."""
    from repro_torch.core import routing as ROUT

    real, seen = getattr(ROUT, name), []

    def record(*args, **kwargs):
        decision = real(*args, **kwargs)
        seen.append(decision)
        return decision

    setattr(ROUT, name, record)
    try:
        yield seen
    finally:
        setattr(ROUT, name, real)


@contextlib.contextmanager
def forced_ragged_decisions(decisions):
    """Route each MoD layer of the flat forwards inside as ``decisions``
    (one per layer, in order) routed it: its rows and mask, with gates from
    this forward's own router logits at those rows. Yields the decisions
    this forward would have made itself."""
    from repro_torch.core import router as R
    from repro_torch.core import routing as ROUT

    real, own = ROUT.decide_tokens_ragged, []

    def force(params, x, row_offsets, cfg, seg_cap, generator=None):
        mine = real(params, x, row_offsets, cfg, seg_cap, generator)
        want = decisions[len(own)]
        own.append(mine)
        gate = R.apply_gate(mine.logits[0][want.idx.clamp(min=0).long()], cfg.mod)
        return mine._replace(idx=want.idx, mask=want.mask,
                             gate=torch.where(want.idx >= 0, gate, torch.zeros_like(gate)))

    ROUT.decide_tokens_ragged = force
    try:
        yield own
    finally:
        ROUT.decide_tokens_ragged = real


def train_step_parity(dev):
    """One train step of mod-paper-60m (f32, pallas_fused, B=2, S=256) on the
    CPU and on the card from the same state. The state starts at step 1 so
    the warmup leaves a nonzero learning rate. Limits: loss within 1e-5 and
    gradient norm within 1e-4 relative (f32 sums in another order);
    routed masks equal. AdamW's first step moves each weight by about
    lr·sign(g), so a weight whose gradient is within the f32 noise of 0 may
    move differently: at most 1e-4 of all weights may differ by more than
    lr/100."""
    from repro_torch.config import OptimConfig, TrainConfig, get_config, with_mod_backend
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import api
    from repro_torch.train.loop import make_train_state, make_train_step
    from repro_torch.utils import tree_leaves, tree_map

    cfg = with_mod_backend(dataclasses.replace(get_config("mod-paper-60m"), dtype="float32"),
                           "pallas_fused")
    lr = 1e-3
    tcfg = TrainConfig(global_batch=2, seq_len=256,
                       optim=OptimConfig(lr=lr, warmup_steps=1, total_steps=10))
    p_cpu = api.init_model(cfg, device="cpu", seed=5)
    p_gpu = tree_map(lambda t: t.detach().to(dev, copy=True), p_cpu)
    batch = {k: torch.as_tensor(v).long()
             for k, v in SyntheticLM(cfg.vocab, 256, seed=13).batch(0, 2).items()}
    step_fn = make_train_step(cfg, tcfg)
    out = {}
    for name, params, d in (("cpu", p_cpu, torch.device("cpu")), ("gpu", p_gpu, dev)):
        state = make_train_state(cfg, d, params=params)
        state["step"] = torch.ones((), dtype=torch.int32)
        with recorded_decisions("decide_tokens") as decisions:
            state, metrics = step_fn(state, {k: v.to(d) for k, v in batch.items()})
        out[name] = (state, {k: float(v) for k, v in metrics.items()},
                     [x.mask.detach().cpu() for x in decisions])
    (s_c, m_c, mask_c), (s_g, m_g, mask_g) = out["cpu"], out["gpu"]
    dl = abs(m_c["loss"] - m_g["loss"]) / abs(m_c["loss"])
    dn = abs(m_c["grad_norm"] - m_g["grad_norm"]) / m_c["grad_norm"]
    log(f"[parity] train step: loss cpu={m_c['loss']:.7f} gpu={m_g['loss']:.7f} (rel {dl:.3g}); "
        f"grad norm cpu={m_c['grad_norm']:.6f} gpu={m_g['grad_norm']:.6f} (rel {dn:.3g}); "
        f"lr {m_c['lr']:.3g}")
    if not (dl <= 1e-5 and dn <= 1e-4):
        raise AssertionError("train step: loss or gradient norm differ beyond the limits")
    if len(mask_c) != len(mask_g) or not mask_c:
        raise AssertionError("train step: different numbers of routing decisions")
    for i, (a, b) in enumerate(zip(mask_c, mask_g)):
        if not torch.equal(a, b):
            raise AssertionError(f"train step: routed mask of MoD layer {i} differs")
    n_total = n_far = 0
    worst = 0.0
    for a, b in zip(tree_leaves(s_c["params"]), tree_leaves(s_g["params"])):
        d = (a.detach() - b.detach().cpu()).abs()
        n_total += d.numel()
        n_far += int((d > lr / 100).sum())
        worst = max(worst, d.max().item())
    log(f"[parity] train step: routed masks identical in all {len(mask_c)} MoD layers; "
        f"post-AdamW weights: max |diff| {worst:.3g} = {worst / lr:.3g} lr, "
        f"{n_far} of {n_total} differ by more than lr/100")
    if n_far > 1e-4 * n_total:
        raise AssertionError("train step: post-AdamW weights differ beyond the limit")


# ---------------------------------------------------------------------------
# Phase 4: the serving path — mod-paper-1b at full width
# ---------------------------------------------------------------------------


def flash_calls() -> dict:
    """The flash launches since the last counter reset by call, as the
    wrapper counts them where it launches: {(path, B, Sq, Skv, nq, nkv, hd,
    kernel launches per call): calls}. Their sum must be the wrapper's
    launch count."""
    from repro_torch.kernels import flash_attention as FA

    calls = dict(FA.FLASH_ATTENTION.by_call)
    if sum(calls.values()) != FA.FLASH_ATTENTION.launches:
        raise AssertionError(f"flash launches by call sum to {sum(calls.values())}, "
                             f"not the count {FA.FLASH_ATTENTION.launches}")
    return calls


def log_flash_calls(run: str, calls: dict) -> None:
    by_path: dict = {}
    for key, n in calls.items():
        by_path[key[0]] = by_path.get(key[0], 0) + n
    top = sorted(calls.items(), key=lambda kv: -kv[1])[:6]
    log(f"[{run}] flash_attention launches by path (counted in the wrapper): "
        f"{json.dumps(by_path)} over {len(calls)} call shapes; most launched "
        "(path, B, Sq, Skv; kernels per call): "
        + "; ".join(f"{k[:4]}; {k[7]} {n}" for k, n in top))


def serve_1b(dev):
    from repro_torch.core.routing import batch_capacity_k
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    cfg = serve_1b_config()
    t0 = time.perf_counter()
    params = api.init_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_params() / 1e9:.2f}B params in {cfg.dtype}, "
        f"init {time.perf_counter() - t0:.1f}s")
    B, n_req, gen, lo, hi = 8, 16, 32, 128, 1024
    ecfg = EngineConfig(batch_size=B, ctx=hi + gen)
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, n_req)
    prompts = SyntheticLM(cfg.vocab, hi, seed=7).batch(0, n_req)["tokens"]
    # warm-up (cuBLAS handles, allocator) on a separate engine, off the count
    ServingEngine(params, cfg, ecfg, device=dev).run_stream(
        [Request(tokens=prompts[i, :lo], max_new_tokens=2) for i in range(2)], 0)
    engine = ServingEngine(params, cfg, ecfg, device=dev)
    reqs = [Request(tokens=prompts[i, : lens[i]], max_new_tokens=gen) for i in range(n_req)]
    build.reset_counters()
    torch.cuda.synchronize()
    outs = engine.run_stream(reqs, 0)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    flash = flash_calls()
    dispatch = dispatch_by_call()
    s = engine.stats()
    if len(outs) != n_req:
        raise AssertionError(f"{len(outs)} of {n_req} requests finished")
    for o in outs:
        if not o.ok or len(o.tokens) != gen:
            raise AssertionError(f"request {o.uid}: {o.finish_reason} {o.error} {len(o.tokens)} tokens")
    kb = batch_capacity_k(cfg, B)
    if abs(s["mean_routed_frac"] - kb / B) > 1e-9:
        raise AssertionError(f"decode routed fraction {s['mean_routed_frac']} != kb/B = {kb / B}")
    for name in SERVE_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
    log(f"[serve] {n_req} requests (prompts {lens.min()}-{lens.max()} tokens, {gen} new each), "
        f"{B} slots: {s['generated_tokens']:.0f} tokens in {s['wall_s']:.2f}s = "
        f"{s['tokens_per_s']:.1f} tok/s; prefill {1e3 * s['prefill_s'] / s['prefills']:.1f} ms "
        f"per prompt ({s['prefills']:.0f}), decode {1e3 * s['decode_s'] / s['decode_steps']:.2f} ms "
        f"per step ({s['decode_steps']:.0f} steps); routed fraction {s['mean_routed_frac']:.4f} "
        f"= kb/B = {kb}/{B}; all logits finite")
    # where the time goes: one decode step (8 live rows at position 1000)
    # and one 1000-token prefill, profiled outside the counted run
    tok = torch.zeros(B, 1, dtype=torch.long, device=dev)
    pos = torch.full((B,), 1000, dtype=torch.int32, device=dev)
    act = torch.ones(B, dtype=torch.bool, device=dev)
    prompt = torch.as_tensor(prompts[:1, :1000], device=dev).long()
    for label, fn in (
        ("decode step B=8", lambda: api.model_decode(params, engine.pool.caches, cfg, tok, pos, act)),
        ("prefill S=1000", lambda: api.model_prefill(params, cfg, {"tokens": prompt}, hi + gen)),
    ):
        wall, busy, top = profile_call(fn, iters=5)
        log(f"[profile] {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
            f"{1 - busy / wall:.3f}; top kernels: "
            + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top))
    log(f"[serve] launches on the main path: {json.dumps(counts)} "
        f"(per prefill of one prompt: gather/scatter {cfg.n_layers // 2}, flash {cfg.n_layers}; "
        f"per decode step: flash {cfg.n_layers})")
    log_flash_calls("serve", flash)
    # each layer attends once per prefill (the wgmma tile path) and once per
    # decode step (the decode path), routed MoD layers on their kb slots:
    # against their routed caches of capacity(ctx) slots, one chunk, so one
    # kernel launch per call (the wrapper records each call's launches)
    for path, want in (("wgmma", cfg.n_layers * s["prefills"]),
                       ("decode", cfg.n_layers * s["decode_steps"])):
        got = sum(n for key, n in flash.items() if key[0] == path)
        if got != want:
            raise AssertionError(f"{got} flash launches on the {path} path, not {want:.0f}")
    k_routed = cfg.mod.capacity(ecfg.ctx)
    routed = {key: n for key, n in flash.items() if key[0] == "decode" and key[3] == k_routed}
    if not routed or any(key[7] != 1 for key in routed):
        raise AssertionError(f"routed decode calls {routed}: want one kernel launch each")
    log(f"[serve] routed decode calls (B={kb}, {k_routed} keys): "
        f"{sum(routed.values())} calls of one kernel launch each (no merge launch)")
    return counts, flash, dispatch


# ---------------------------------------------------------------------------
# Phase 5: the training path — mod-paper-1b at full width and depth
# ---------------------------------------------------------------------------


def _kernel_group(name: str) -> str:
    """The port kernel a CUDA kernel name belongs to (the fused kernels are
    several __global__ functions each), else the kind of library kernel."""
    if "flash_fwd" in name:
        return "flash_attention"
    if "paged_gather" in name:
        return "paged_gather"
    if "PagedTarget" in name:  # the flat scatter grid with its page-table target
        return "paged_scatter_rows"
    if "ssd_intra" in name:  # ssd_intra_kernel (CUDA cores), ssd_intra_tc_kernel
        return "ssd_intra_chunk"
    if any(t in name for t in ("routed_attn_", "rope_kernel", "EpiAttn")):
        return "routed_attention"
    if any(t in name for t in ("EpiGlu", "EpiAct", "EpiScatter")):
        return "routed_mlp_scatter"
    if any(t in name for t in ("EpiSwiglu", "EpiStore")):
        return "swiglu"
    if "rmsnorm_rows" in name:
        return "routed_* rmsnorm"
    # the dispatch kernels: gather_rows_kernel, scatter_add_rows_kernel (and,
    # in a tree before the one-pass scatter, its copy_bytes + scatter_update)
    if any(t in name for t in ("gather_rows", "scatter_add_rows", "scatter_update", "copy_bytes")):
        return "gather/scatter"
    if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass", "Kernel2")):
        return "library GEMM (cuBLAS)"
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    return "other PyTorch kernels"


TRAIN_1B = dict(B=4, S=2048, steps=5)  # phase 5's run
# its losses at steps 1-2 on an H100 (PRs 18-20); three f32 sum orders of
# one function spread 5 bf16 steps by 1.7% (--mlp-losses), so only steps
# 1-2 are held, within 0.05%
PHASE5_LOSSES = (11.7684, 11.7565)


def trainer_1b(dev, ckdir):
    """Phase 5's trainer: mod-paper-1b, pallas_fused, AdamW with a cosine
    schedule (lr 1e-4 after 2 warmup steps), synthetic data from seed 0."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import OptimConfig, TrainConfig, get_config, with_mod_backend
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.train import Trainer

    cfg = with_mod_backend(get_config("mod-paper-1b"), "pallas_fused")
    B, S, steps = TRAIN_1B["B"], TRAIN_1B["S"], TRAIN_1B["steps"]
    tcfg = TrainConfig(global_batch=B, seq_len=S,
                       optim=OptimConfig(lr=1e-4, warmup_steps=2, total_steps=steps),
                       log_every=1, ckpt_every=10**9)
    loader = ShardedLoader(SyntheticLM(cfg.vocab, S, seed=0), B, dev)
    return Trainer(cfg, tcfg, loader, ckpt=CheckpointManager(ckdir), device=dev,
                   log_fn=lambda m: None)


def train_1b(dev):
    from repro_torch.kernels import build

    B, S, steps = TRAIN_1B["B"], TRAIN_1B["S"], TRAIN_1B["steps"]
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = trainer_1b(dev, ckdir)
        cfg = trainer.cfg
        t0 = time.perf_counter()
        state = trainer.init_or_resume()
        torch.cuda.synchronize()
        log(f"[train] {cfg.name}: {cfg.n_params() / 1e9:.2f}B params in {cfg.dtype}, backend "
            f"{cfg.mod.backend}, B={B} S={S} (k={cfg.mod.capacity(S)} routed rows per sequence), "
            f"init {time.perf_counter() - t0:.1f}s")
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.reset_peak_memory_stats()
        build.reset_counters()
        losses, busies = [], []
        for i in range(steps):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, m = trainer.run(state, 1)
            by_name: dict = {}
            for kname, us in device_records(prof):
                by_name[kname] = by_name.get(kname, 0.0) + us / 1e3
            busy = sum(by_name.values())
            wall = 1e3 * trainer.heartbeats[-1][1]
            groups: dict = {}
            for n, t in by_name.items():
                groups[_kernel_group(n)] = groups.get(_kernel_group(n), 0.0) + t
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            losses.append(m["loss"])
            busies.append(busy)
            log(f"[train] step {i + 1}: loss {m['loss']:.4f} ce {m['ce']:.4f} grad norm "
                f"{m['grad_norm']:.3f} lr {m['lr']:.3g}; wall {wall:.1f} ms, device busy "
                f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}")
            log("[train]   device ms by group: " + "; ".join(
                f"{g} {t:.1f}" for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
            log("[train]   top kernels: " + "; ".join(f"{n[:60]} {t:.1f} ms" for n, t in top))
        counts = build.launch_counts()
        flash = flash_calls()
        mlp_calls = dict(build.COUNTERS["routed_mlp_scatter"].by_call)
        attn_calls = dict(build.COUNTERS["routed_attention"].by_call)
    log(f"[train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    per_step = {name: counts[name] / steps for name in counts}
    log(f"[train] launches in {steps} steps: {json.dumps(counts)} (per step: routed_attention "
        f"{per_step['routed_attention']:g}, routed_mlp_scatter {per_step['routed_mlp_scatter']:g}, "
        f"flash_attention {per_step['flash_attention']:g}; {cfg.n_layers // 2} of each per forward)")
    for name in TRAIN_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    for name in ("gather_rows", "scatter_add_rows"):
        if counts.get(name, 0) != 0:
            raise AssertionError(f"{name} ran under pallas_fused: the fused kernels were bypassed")
    log_flash_calls("train", flash)
    if {key[0] for key in mlp_calls} != {"wgmma"}:
        raise AssertionError(f"routed_mlp_scatter's training launches took {mlp_calls}: want "
                             "every one on the wgmma GEMM")
    log("[train] routed_mlp_scatter launches by GEMM path (counted in the wrapper): " + "; ".join(
        f"{key[0]} at B={key[1]} S={key[2]} k={key[3]} D={key[4]} F={key[5]}: {n}"
        for key, n in mlp_calls.items()))
    if {key[0] for key in attn_calls} != {"wgmma"}:
        raise AssertionError(f"routed_attention's training launches took {attn_calls}: want "
                             "every one on the wgmma GEMM")
    log("[train] routed_attention launches by GEMM path (counted in the wrapper; the attention "
        "core on tensor cores in bf16): " + "; ".join(
            f"{key[0]} at B={key[1]} S={key[2]} k={key[3]} D={key[4]} {key[5]}x{key[7]} heads "
            f"(kv {key[6]}): {n}" for key, n in attn_calls.items()))
    log(f"[train] losses {', '.join(f'{x:.4f}' for x in losses)}; steps 1-2 against PR 20's "
        f"{PHASE5_LOSSES[0]}, {PHASE5_LOSSES[1]}: "
        f"{', '.join(f'{(x / w - 1) * 100:+.3f}%' for x, w in zip(losses, PHASE5_LOSSES))}; "
        f"device busy {', '.join(f'{b:.1f}' for b in busies)} ms")
    if any(abs(x / w - 1) > 5e-4 for x, w in zip(losses, PHASE5_LOSSES)):
        raise AssertionError(f"phase 5 losses {losses[:2]} not within 0.05% of {PHASE5_LOSSES}")
    return counts, flash, mlp_calls, attn_calls, dict(losses=losses, busy=busies)


def mlp_path_losses() -> None:
    """``--mlp-losses``: phase 5's training run (mod-paper-1b, bf16,
    pallas_fused, B=4 S=2048, 5 steps, the same seed and data) three times,
    with routed_mlp_scatter's forward on the wgmma GEMM (the port's path),
    on the CUDA-core GEMM (forced; the kernel before the wgmma GEMM) and as
    its plain version (cuBLAS bf16 products): the losses of three
    computations of one function at the same rounding points, which differ
    only in the order of their f32 sums. Shows how far 5 bf16 steps carry
    such a difference. A fourth run takes routed_attention as its plain
    version (cuBLAS and torch ops; the routed MLP on the wgmma GEMM), so
    that a loss drift can be put down to one kernel's sum order."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import swiglu as SW

    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets them for phase 5
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    saved = {(SW, "gemm_path"): SW.gemm_path, (SW, "_routed_mlp_launch"): SW._routed_mlp_launch,
             (FA, "_routed_attention_launch"): FA._routed_attention_launch}
    variants = {
        "routed_mlp_scatter wgmma": {},
        "routed_mlp_scatter cuda_cores": {(SW, "gemm_path"): lambda *a: "cuda_cores"},
        "routed_mlp_scatter plain (cuBLAS)": {
            (SW, "_routed_mlp_launch"): SW.routed_mlp_scatter_plain},
        "routed_attention plain (cuBLAS + torch ops)": {
            (FA, "_routed_attention_launch"): FA.routed_attention_plain},
    }
    for name, patch in variants.items():
        for (mod, attr), fn in patch.items():
            setattr(mod, attr, fn)
        build.reset_counters()
        with tempfile.TemporaryDirectory() as ckdir:
            trainer = trainer_1b(dev, ckdir)
            state = trainer.init_or_resume()
            losses = []
            for _ in range(TRAIN_1B["steps"]):
                state, m = trainer.run(state, 1)
                losses.append(m["loss"])
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
        calls = {kern: dict(build.COUNTERS[kern].by_call)
                 for kern in ("routed_mlp_scatter", "routed_attention")}
        log(f"[mlp-losses] {name}: losses {', '.join(f'{v:.4f}' for v in losses)}; kernel "
            f"launches {calls} ({smi_line()})")
        del trainer, state
        torch.cuda.empty_cache()


def ssm_path_losses() -> None:
    """``--ssm-losses``: phase 9c's training run (mamba2-1.3b, bf16, B=4
    S=2048, 5 steps, the same seed and data) four times: as the port runs
    it (the SSD kernel on tensor cores, the mirrored SiLU), with the SSD
    kernel forced onto its CUDA-core path, with the SSD function as its
    plain version (torch ops), and with the CUDA-core path and ``F.silu``
    (one rounding) in the SSM blocks, as the port ran before either change:
    the losses of each step, so that a change of 9c's loss can be put down
    to SiLU's rounding or to the SSD sum order, and the spread of three
    f32 sum orders of one function seen."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd as KSSD
    from repro_torch.models import ssm as SSM

    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    launch, silu = KSSD._launch, SSM.silu
    cuda = lambda *a: launch(*a[:5], "cuda")  # noqa: E731
    plain = lambda *a: KSSD.ssd_intra_chunk_plain(*a[:5])  # noqa: E731
    variants = {"port (SSD tensor cores, mirrored SiLU)": {},
                "SSD forced to CUDA cores": {(KSSD, "_launch"): cuda},
                "SSD as its plain version": {(KSSD, "_launch"): plain},
                "SSD on CUDA cores and F.silu": {(KSSD, "_launch"): cuda,
                                                 (SSM, "silu"): torch.nn.functional.silu}}
    for name, patch in variants.items():
        for (mod, attr), fn in patch.items():
            setattr(mod, attr, fn)
        build.reset_counters()
        try:
            with tempfile.TemporaryDirectory() as ckdir:
                trainer = trainer_ssm(dev, ckdir)
                state = trainer.init_or_resume()
                losses = []
                for _ in range(TRAIN_SSM["steps"]):
                    state, m = trainer.run(state, 1)
                    losses.append(m["loss"])
        finally:
            KSSD._launch, SSM.silu = launch, silu
        calls = sorted({k[0] for k in build.COUNTERS["ssd_intra_chunk"].by_call})
        log(f"[ssm-losses] {name}: losses {', '.join(f'{v:.4f}' for v in losses)}; SSD paths "
            f"{calls} ({smi_line()})")
        del trainer, state
        torch.cuda.empty_cache()


def train_runs(root: Path) -> int:
    """``--train-runs [ROOT]``: phase 5 (mod-paper-1b, pallas_fused) and
    phase 9c (mamba2-1.3b) training on the port under ``ROOT/src`` (default:
    this checkout), each with its per-step losses, device busy time and
    kernel groups. Run on a parent tree and this one in one call, in turns,
    to compare losses and busy time of two versions on one card. Returns 1
    if a run failed its checks (both runs are made)."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all()
    name, failed = root.name or str(root), False
    for label, fn in (("phase 5", train_1b), ("phase 9c", train_ssm)):
        try:
            info = fn(dev)[-1]
        except AssertionError as err:
            log(f"[train-runs] {name}: {label} failed: {err}")
            failed = True
            continue
        finally:
            torch.cuda.empty_cache()
        log(f"[train-runs] {name}: {label} losses {', '.join(f'{x:.4f}' for x in info['losses'])}; "
            f"busy {', '.join(f'{b:.1f}' for b in info['busy'])} ms"
            + "".join(f"; {group} group {', '.join(f'{t:.2f}' for t in info[key])} ms"
                      for key, group in (("ssd_ms", "ssd_intra_chunk"),
                                         ("dispatch_ms", "gather/scatter"),
                                         ("copies_ms", "copies")) if key in info)
            + f" ({smi_line()})")
    return int(failed)


# ---------------------------------------------------------------------------
# Phase 6: paged serving — the paged pool, prefix cache and ragged step
# ---------------------------------------------------------------------------


def _streams(outs):
    return {o.uid: o.tokens.tolist() for o in outs}


def first_token_logits(eng):
    """{uid: the logits row each request's first generated token is sampled
    from}, filled as ``eng`` runs."""
    rows, real = {}, eng._sample

    def sample(slot, row, index=None):
        if not slot.generated:
            rows[slot.req.uid] = np.array(row, dtype=np.float32)
        return real(slot, row, index)

    eng._sample = sample
    return rows


def paged_parity(dev):
    """(b) mod-paper-60m in f32, the same weights and requests on the CPU
    (plain versions) and on the card (kernels): the paged engine with the
    prefix cache (page 16, chunk 64) and the ragged engine must give the
    same greedy streams on both devices. 6 requests into 4 slots, a shared
    128-token prefix, suffixes of 16-100 tokens, 16 new tokens each."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    cfg = parity_60m_config()
    p_cpu = api.init_model(cfg, device="cpu", seed=3)
    p_gpu = _to(p_cpu, dev)
    toks = SyntheticLM(cfg.vocab, 228, seed=17).batch(0, 6)["tokens"]
    rng = np.random.default_rng(5)
    prompts = [np.concatenate([toks[0, :128], toks[i, 128:128 + int(n)]])
               for i, n in enumerate(rng.integers(16, 101, 6))]
    engines = {"paged+prefix": dict(page_size=16, prefill_chunk=64, prefix_cache=True),
               "ragged": dict(page_size=16, prefill_chunk=64, ragged=True, ragged_segments=4)}
    for name, kw in engines.items():
        got = {}
        for label, d, params in (("cpu", "cpu", p_cpu), ("gpu", dev, p_gpu)):
            eng = ServingEngine(params, cfg, EngineConfig(batch_size=4, ctx=256, **kw), device=d)
            got[label] = (_streams(eng.run_stream([Request(tokens=p, max_new_tokens=16)
                                               for p in prompts], 0)), eng.stats())
        (sc, stc), (sg, stg) = got["cpu"], got["gpu"]
        if sc != sg:
            diff = [u for u in sc if sc[u] != sg[u]]
            raise AssertionError(f"60m {name}: CPU and card streams differ for requests {diff}")
        log(f"[paged] 60m f32 {name}: CPU and card greedy streams identical for all "
            f"{len(sc)} requests ({sum(len(t) for t in sc.values())} tokens); prefix hit rate "
            f"{stg['prefix_hit_rate']:.3f}, prefill tokens computed {stg['prefill_tokens_computed']:.0f}")


def serve_paged_1b(dev, params):
    """(c) mod-paper-1b in bf16 on the card: 8 requests submitted upfront
    that share a 512-token prefix (a system prompt), each with its own
    64-448-token suffix and 32 new tokens, page 16, prefill chunk 256,
    through four engines: contiguous, paged, paged with the prefix cache,
    and ragged (segments = every prompt chunk, so all prompts drain in the
    first step). Streams must be identical; launches are counted per run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.serve.scheduler import GENERATE

    cfg = serve_1b_config()
    w = PAGED_1B
    B, gen, pre, page, C = w["B"], w["gen"], w["prefix"], w["page"], w["chunk"]
    suffix, ctx, n_chunks = paged_1b_plan()
    toks = SyntheticLM(cfg.vocab, pre + w["max_suffix"], seed=9).batch(0, B)["tokens"]
    prompts = [np.concatenate([toks[0, :pre], toks[i, pre:pre + int(n)]])
               for i, n in enumerate(suffix)]
    n_full = sum(1 for grp in params["groups"] if "full" in grp)
    runs = {
        "contiguous": dict(prefill_chunk=C),
        "paged": dict(page_size=page, prefill_chunk=C),
        "paged+prefix": dict(page_size=page, prefill_chunk=C, prefix_cache=True),
        "ragged": dict(page_size=page, prefill_chunk=C, ragged=True, ragged_segments=n_chunks),
    }
    # warm-up (cuBLAS handles, allocator) off the count
    warm = ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=ctx, **runs["ragged"]), device=dev)
    warm.run_stream([Request(tokens=prompts[0][:300], max_new_tokens=2)], 0)
    out, counts, stats, pools = {}, {}, {}, {}
    prof_line, snap = "", None
    for name, kw in runs.items():
        eng = ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=ctx, **kw), device=dev)
        if name == "paged":
            first_rows = first_token_logits(eng)
        for q in prompts:
            eng.submit(Request(tokens=q, max_new_tokens=gen))
        build.reset_counters()
        torch.cuda.synchronize()
        while eng.has_work:
            if name in SNAP_RUNS and snap is None and all(s.state == GENERATE for s in eng.slots):
                snap = snapshot_pool(eng)
            if name == "paged" and 5 <= eng.step_count < 8 and not prof_line:
                # one paged decode step, all 8 slots generating (the next
                # one where CUPTI hands back no device events)
                at = eng.step_count
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    eng.step()
                    torch.cuda.synchronize()
                    wall = 1e3 * (time.perf_counter() - t0)
                by_name: dict = {}
                for kname, us in device_records(prof):
                    by_name[kname] = by_name.get(kname, 0.0) + us / 1e3
                busy = sum(by_name.values())
                if busy <= 0.0:
                    continue
                gat = sum(t for n, t in by_name.items() if "paged_gather_kernel" in n)
                # the decode-row scatter: the flat scatter grid with its page-table target
                sca = sum(t for n, t in by_name.items() if "PagedTarget" in n)
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
                prof_line = (f"[profile] paged decode step B=8 (step {at}): wall {wall:.2f} ms, device "
                             f"busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}; paged_gather "
                             f"{gat:.3f} ms ({gat / busy:.3f} of busy), paged_scatter_rows {sca:.3f} "
                             f"ms ({sca / busy:.3f}); top: "
                             + "; ".join(f"{n[:50]} {t:.3f} ms" for n, t in top))
            else:
                eng.step()
                if name == "ragged" and eng.step_count == 1 and \
                        eng.stats()["prefill_tokens_computed"] != sum(len(q) for q in prompts):
                    raise AssertionError("the ragged run's first step did not carry every "
                                         "prompt chunk")
        torch.cuda.synchronize()
        counts[name] = build.launch_counts()
        stats[name] = eng.stats()
        out[name] = _streams(eng.finished)
        pools[name] = eng.pool.cache_bytes()["total"]
        if len(out[name]) != B or any(not o.ok or len(o.tokens) != gen for o in eng.finished):
            raise AssertionError(f"1b {name}: not every request finished with {gen} tokens")
    for name in runs:
        if out[name] != out["contiguous"]:
            diff = [u for u in out[name] if out[name][u] != out["contiguous"][u]]
            raise AssertionError(f"1b {name}: streams differ from the contiguous run for {diff}")
    per_page = sum(p_.numel() * p_.element_size() for p_ in eng.pool.pages) / eng.pool.n_pages
    for name in runs:
        s = stats[name]
        extra = ""
        if name != "contiguous":
            extra = (f"; pool {pools[name] / 2**20:.1f} MiB vs contiguous "
                     f"{pools['contiguous'] / 2**20:.1f} MiB, peak pages in use "
                     f"{s['peak_pages_in_use']:.0f} of {s['n_pages']:.0f} "
                     f"({s['peak_pages_in_use'] * per_page / 2**20:.1f} MiB of pages), prefix "
                     f"hit rate {s['prefix_hit_rate']:.3f}")
        log(f"[paged] 1b {name}: {s['generated_tokens']:.0f} tokens in {s['wall_s']:.2f}s = "
            f"{s['tokens_per_s']:.1f} tok/s; prefill {1e3 * s['prefill_s'] / max(1, s['prefills']):.1f}"
            f" ms per prompt ({s['prefills']:.0f}), decode {1e3 * s['decode_s'] / max(1, s['decode_steps']):.2f}"
            f" ms per step ({s['decode_steps']:.0f} steps, {s['steps']:.0f} engine steps); prefill "
            f"tokens computed {s['prefill_tokens_computed']:.0f}{extra}")
        log(f"[paged]   launches: {json.dumps(counts[name])}")
    log(f"[paged] 1b: all four runs gave identical greedy streams ({B} requests x {gen} tokens)")
    log(prof_line or "[profile] paged decode step: torch.profiler recorded no device time in "
                     "three steps; not measured")
    saved = stats["paged"]["prefill_tokens_computed"] - stats["paged+prefix"]["prefill_tokens_computed"]
    if not (stats["paged+prefix"]["prefix_hit_rate"] > 0 and saved == (B - 1) * pre):
        raise AssertionError(f"prefix cache saved {saved} prefill tokens, want {(B - 1) * pre}")
    for name in ("paged", "paged+prefix"):
        c, s = counts[name], stats[name]
        per_step = 3 * n_full
        if c["paged_scatter_rows"] != per_step * s["decode_steps"] or \
                c["paged_gather"] != per_step * (s["decode_steps"] + s["prefills"]):
            raise AssertionError(f"1b {name}: paged launches {c} are not {per_step} per decode "
                                 f"step (+{per_step} per chunked prefill)")
    if counts["ragged"]["ragged_paged_scatter_rows"] != 3 * n_full * stats["ragged"]["steps"]:
        raise AssertionError(f"ragged_paged_scatter_rows launched {counts['ragged']} times, not "
                             f"{3 * n_full} per ragged step")
    log(f"[paged] prefix cache saved {saved} = 7 x {pre} prefill tokens; paged_gather and "
        f"paged_scatter_rows launched {3 * n_full} times per decode step each (+{3 * n_full} "
        f"gathers per chunked prefill); ragged_paged_scatter_rows "
        f"{counts['ragged']['ragged_paged_scatter_rows']} times in {stats['ragged']['steps']:.0f} steps")
    # launches per leaf kind (2 K/V and 1 position leaf per full layer) and
    # shape, keyed as check_paged keys its timings: gathers of (8, P) tables
    # per decode step and of (1, P) per chunked prefill; the ragged run's
    # first step writes back every prompt chunk (checked above), the later
    # ones the B decode rows
    sp, sr = stats["paged"], stats["ragged"]
    W0 = B + n_chunks * C
    by_shape = {"paged_gather": {}, "paged_scatter_rows": {}, "ragged_paged_scatter_rows": {}}
    for leaf, n in (("kv", 2 * n_full), ("pos", n_full)):
        by_shape["paged_gather"][f"{leaf} B={B}"] = int(n * sp["decode_steps"])
        by_shape["paged_gather"][f"{leaf} B=1"] = int(n * sp["prefills"])
        by_shape["paged_scatter_rows"][f"{leaf} B={B}"] = int(n * sp["decode_steps"])
        by_shape["ragged_paged_scatter_rows"][f"{leaf} W={W0}"] = n
        by_shape["ragged_paged_scatter_rows"][f"{leaf} W={B}"] = int(n * (sr["steps"] - 1))
    if snap is None:
        raise AssertionError("1b paged+prefix: no step found every slot generating")
    return counts, by_shape, out["paged"], stats["paged"], first_rows, snap


# ---------------------------------------------------------------------------
# Phase 7: quantized paged-KV serving
# ---------------------------------------------------------------------------


def quant_parity(dev):
    """(a) mod-paper-60m in f32, phase 6b's requests and engine shapes, the
    same weights on the CPU (plain versions) and the card (kernels): the
    quantized paged + prefix and ragged engines with int8/page and fp8/head
    KV, and the paged + prefix engine serving int8 weights. Streams and
    kv_bytes must be identical on the two devices: the card's int8/e4m3
    casts, pow2 scales and dequantizing gather against the CPU's."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.serve.quant import QuantConfig

    cfg = parity_60m_config()
    p_cpu = api.init_model(cfg, device="cpu", seed=3)
    p_gpu = _to(p_cpu, dev)
    toks = SyntheticLM(cfg.vocab, 228, seed=17).batch(0, 6)["tokens"]
    rng = np.random.default_rng(5)
    prompts = [np.concatenate([toks[0, :128], toks[i, 128:128 + int(n)]])
               for i, n in enumerate(rng.integers(16, 101, 6))]
    base = dict(page_size=16, prefill_chunk=64)
    runs = [("paged+prefix int8/page", dict(prefix_cache=True), dict(kv="int8")),
            ("ragged int8/page", dict(ragged=True, ragged_segments=4), dict(kv="int8")),
            ("paged+prefix fp8/head", dict(prefix_cache=True), dict(kv="fp8", granularity="head")),
            ("ragged fp8/head", dict(ragged=True, ragged_segments=4),
             dict(kv="fp8", granularity="head")),
            ("paged+prefix int8/page + int8 weights", dict(prefix_cache=True),
             dict(kv="int8", weights="int8"))]
    for name, kw, q in runs:
        got = {}
        for label, d, params in (("cpu", "cpu", p_cpu), ("gpu", dev, p_gpu)):
            ecfg = EngineConfig(batch_size=4, ctx=256, quant=QuantConfig(**q), **base, **kw)
            eng = ServingEngine(params, cfg, ecfg, device=d)
            got[label] = (_streams(eng.run_stream([Request(tokens=p, max_new_tokens=16)
                                                   for p in prompts], 0)), eng.stats())
        (sc, stc), (sg, stg) = got["cpu"], got["gpu"]
        if sc != sg:
            diff = [u for u in sc if sc[u] != sg[u]]
            raise AssertionError(f"60m {name}: CPU and card streams differ for requests {diff}")
        if stc["kv_bytes"] != stg["kv_bytes"]:
            raise AssertionError(f"60m {name}: kv_bytes {stc['kv_bytes']} vs {stg['kv_bytes']}")
        log(f"[quant] 60m f32 {name}: CPU and card greedy streams identical for all {len(sc)} "
            f"requests ({sum(len(t) for t in sc.values())} tokens), kv_bytes "
            f"{stg['kv_bytes']:.0f} on both; prefix hit rate {stg['prefix_hit_rate']:.3f}")


def serve_quant_1b(dev, params, base_streams, base_stats, base_first):
    """(b) mod-paper-1b in bf16, phase 6c's workload and weights, through the
    quantized engines of QUANT_1B: throughput, pool and KV bytes against
    phase 6c's unquantized paged pool, the share of generated tokens equal
    to phase 6c's streams (reported, not a pass mark), launches per run, one
    profiled decode step, and the per-call cost of widening int8 weights.
    For the first generated token of each request it prints the unquantized
    logits' top-1/top-2 gap (``base_first``: phase 6c's paged run) beside
    the largest change that quantization made to those logits: a token
    flips only where the change reaches half the gap."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.serve.quant import QuantConfig, dequantize_params
    from repro_torch.serve.scheduler import GENERATE
    from repro_torch.utils import tree_leaves

    cfg = serve_1b_config()
    w = PAGED_1B
    B, gen, pre, page, C = w["B"], w["gen"], w["prefix"], w["page"], w["chunk"]
    suffix, ctx, n_chunks = paged_1b_plan()
    toks = SyntheticLM(cfg.vocab, pre + w["max_suffix"], seed=9).batch(0, B)["tokens"]
    prompts = [np.concatenate([toks[0, :pre], toks[i, pre:pre + int(n)]])
               for i, n in enumerate(suffix)]
    n_full = sum(1 for grp in params["groups"] if "full" in grp)
    base_kv = base_stats["kv_bytes"]
    counts, stats, prof_line, deq_line, snaps, quant_streams = {}, {}, "", "", {}, {}
    for name, kw, q in QUANT_1B:
        if "ragged" in kw:
            kw = dict(kw, ragged_segments=n_chunks)
        ecfg = EngineConfig(batch_size=B, ctx=ctx, page_size=page, prefill_chunk=C,
                            quant=QuantConfig(**q), **kw)
        eng = ServingEngine(params, cfg, ecfg, device=dev)
        first_rows = first_token_logits(eng)
        for pr in prompts:
            eng.submit(Request(tokens=pr, max_new_tokens=gen))
        build.reset_counters()
        torch.cuda.synchronize()
        while eng.has_work:
            if name in SNAP_RUNS and name not in snaps and all(
                    s.state == GENERATE for s in eng.slots):
                snaps[name] = snapshot_pool(eng)
            if name == "prefix int8/page" and 5 <= eng.step_count < 8 and not prof_line:
                at, before = eng.step_count, build.launch_counts()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    eng.step()
                    torch.cuda.synchronize()
                    wall = 1e3 * (time.perf_counter() - t0)
                after = build.launch_counts()
                by_name: dict = {}
                for kname, us in device_records(prof):
                    by_name[kname] = by_name.get(kname, 0.0) + us / 1e3
                busy = sum(by_name.values())
                if busy <= 0.0:
                    continue
                n_dq = after["paged_gather_dequant"] - before["paged_gather_dequant"]
                n_pg = after["paged_gather"] - before["paged_gather"]
                if (n_dq, n_pg) != (2 * n_full, n_full):
                    raise AssertionError(f"quantized decode step launched {n_dq} dequant and {n_pg} "
                                         f"plain gathers, not {2 * n_full} and {n_full}")
                dq = sum(t for n, t in by_name.items() if "paged_gather_dequant_kernel" in n)
                pg = sum(t for n, t in by_name.items() if "paged_gather_kernel" in n)
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
                prof_line = (f"[profile] quantized paged decode step B=8 (int8/page, step {at}): wall "
                             f"{wall:.2f} ms, device busy {busy:.2f} ms, idle share "
                             f"{1 - busy / wall:.3f}; {n_dq} paged_gather_dequant {dq:.3f} ms "
                             f"({dq / busy:.3f} of busy), {n_pg} paged_gather (pos) {pg:.3f} ms "
                             f"({pg / busy:.3f}); top: "
                             + "; ".join(f"{n[:50]} {t:.3f} ms" for n, t in top))
            else:
                eng.step()
        torch.cuda.synchronize()
        counts[name] = build.launch_counts()
        s = stats[name] = eng.stats()
        outs = _streams(eng.finished)
        if len(outs) != B or any(not o.ok or len(o.tokens) != gen for o in eng.finished):
            raise AssertionError(f"1b {name}: not every request finished with {gen} tokens")
        quant_streams[name] = outs
        same = sum(sum(a == b for a, b in zip(outs[u], base_streams[u])) for u in outs)
        first = min((next((i for i, (a, b) in enumerate(zip(outs[u], base_streams[u])) if a != b),
                          gen), u) for u in outs)
        first = ("none" if first[0] == gen
                 else f"generated token {first[0]} of request {first[1]}")
        ratio = base_kv / s["kv_bytes"]
        cb = eng.pool.cache_bytes()
        log(f"[quant] 1b {name}: {s['generated_tokens']:.0f} tokens in {s['wall_s']:.2f}s = "
            f"{s['tokens_per_s']:.1f} tok/s; prefill {1e3 * s['prefill_s'] / max(1, s['prefills']):.1f}"
            f" ms per prompt ({s['prefills']:.0f}), decode "
            f"{1e3 * s['decode_s'] / max(1, s['decode_steps']):.2f} ms per step "
            f"({s['decode_steps']:.0f} steps, {s['steps']:.0f} engine steps); pool "
            f"{cb['total'] / 2**20:.1f} MiB (scales {sum(t.numel() * 4 for t in eng.pool.scales) / 2**20:.2f}"
            f" MiB of it), kv_bytes {s['kv_bytes']:.0f} = {s['kv_bytes'] / 2**20:.1f} MiB vs "
            f"{base_kv / 2**20:.1f} MiB unquantized ({ratio:.4f}x less), peak pages "
            f"{s['peak_pages_in_use']:.0f} of {s['n_pages']:.0f}, prefix hit rate "
            f"{s['prefix_hit_rate']:.3f}; {same} of {B * gen} generated tokens equal the "
            f"unquantized streams (first divergence: {first})")
        log(f"[quant]   launches: {json.dumps(counts[name])}")
        notes = []
        for u in sorted(base_first):
            top2 = np.sort(base_first[u])[-2:]
            change = np.abs(first_rows[u] - base_first[u]).max()
            flip = int(first_rows[u].argmax()) != int(base_first[u].argmax())
            notes.append(f"{u}: gap {top2[1] - top2[0]:.4g}, change {change:.4g}"
                         + (" (flipped)" if flip else ""))
        log(f"[quant]   first generated token, unquantized top-1/top-2 logit gap and the largest "
            f"|dlogit| of the quantized run, per request (logits up to "
            f"{max(np.abs(r).max() for r in base_first.values()):.4g}): " + "; ".join(notes))
        if ratio < 1.9:
            raise AssertionError(f"1b {name}: kv_bytes only {ratio:.3f}x below the unquantized pool")
        c = counts[name]
        if "ragged" in name:
            want = {"ragged_paged_scatter_rows": (3 * n_full + 2) * s["steps"],
                    "paged_gather_dequant": 2 * n_full * s["steps"]}
        else:
            want = {"paged_gather_dequant": 2 * n_full * (s["decode_steps"] + s["prefills"]),
                    "paged_gather": n_full * (s["decode_steps"] + s["prefills"]),
                    "paged_scatter_rows": (3 * n_full + 2) * s["decode_steps"]}
        for k, v in want.items():
            if c[k] != v:
                raise AssertionError(f"1b {name}: {k} launched {c[k]} times, want {v}")
        if q.get("weights") == "int8":
            wall_ms = event_ms(lambda: dequantize_params(eng.params), iters=5, warmup=1)
            dev_ms = time_ms(lambda: dequantize_params(eng.params), iters=5)
            narrow = sum(t.numel() for t in tree_leaves(eng.params)
                         if isinstance(t, torch.Tensor) and t.dtype == torch.int8)
            calls = s["decode_steps"] + s["prefills"]
            deq_line = (f"[quant] int8 weights: dequantize_params (widen {narrow / 1e6:.1f}M int8 "
                        f"weights to bf16, at each of the run's {calls:.0f} model calls) takes "
                        f"{dev_ms:.2f} ms of device time ({wall_ms:.2f} ms between CUDA events), "
                        f"bound {bound_ms(narrow * 3, 0, torch.bfloat16)[0]:.3f} ms (bytes)")
    log(prof_line or "[profile] quantized paged decode step: torch.profiler recorded no device "
                     "time in three steps; not measured")
    log(deq_line)
    # launches of the dequant gather per shape, keyed as check_dequant keys
    # its timings: (8, P) tables per decode step, (1, P) per chunked prefill
    by_shape = {}
    for name, _, q in QUANT_1B:
        s = stats[name]
        label = f"{q['kv']}/{q.get('granularity', 'page')}"
        if "ragged" in name:
            by_shape[name] = {f"{label} B={B}": int(2 * n_full * s["steps"])}
        else:
            by_shape[name] = {f"{label} B={B}": int(2 * n_full * s["decode_steps"]),
                              f"{label} B=1": int(2 * n_full * s["prefills"])}
    if set(snaps) != set(SNAP_RUNS[1:]):
        raise AssertionError(f"1b quantized runs: no step found every slot generating in "
                             f"{set(SNAP_RUNS[1:]) - set(snaps)}")
    return counts, by_shape, snaps, quant_streams


# ---------------------------------------------------------------------------
# Phase 8: the flat ragged forward
# ---------------------------------------------------------------------------


def ragged_forward_parity(dev):
    """(a) mod-paper-60m in f32, the same weights on the CPU and the card:
    model_forward_ragged on 5 unequal segments (and a padded tail). Routed
    masks equal in every MoD layer; logits within 1e-4."""
    from repro_torch.models import api

    cfg = parity_60m_config()
    p_cpu = api.init_model(cfg, device="cpu", seed=4)
    p_gpu = _to(p_cpu, dev)
    lens = (97, 256, 13, 180, 64)
    offs = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32)
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab, int(offs[-1]) + 11))
    got = {}
    for label, d, params in (("cpu", torch.device("cpu"), p_cpu), ("gpu", dev, p_gpu)):
        with torch.no_grad(), recorded_decisions("decide_tokens_ragged") as dec:
            logits, _ = api.model_forward_ragged(params, cfg, toks.to(d), offs.to(d), max(lens))
        got[label] = (logits.float().cpu(), [x.mask.cpu() for x in dec])
    (lc, mc), (lg, mg) = got["cpu"], got["gpu"]
    if len(mc) != len(mg) or not all(torch.equal(a, b) for a, b in zip(mc, mg)):
        raise AssertionError("ragged forward: routed masks differ between the CPU and the card")
    diff = (lc - lg).abs().max().item()
    torch.testing.assert_close(lg, lc, atol=1e-4, rtol=1e-4)
    log(f"[ragged] 60m f32 model_forward_ragged, segments {lens} + 11 padded rows: routed masks "
        f"identical in all {len(mc)} MoD layers on the CPU and the card; max |dlogit| {diff:.3g} "
        f"(limit 1e-4)")


def _mask_differences(dr, dp, n_seg):
    """Compare the flat (dr) and the padded (dp) routing decisions of each
    MoD layer. Returns (segments whose routed tokens differ in some layer,
    the layers with a difference, the largest relative router-score
    difference in segments routed alike in every earlier layer). Top-k of
    two score vectors that differ by at most d can disagree only on tokens
    within 2d of the capacity boundary: each difference is printed with the
    boundary gap and d of its segment, one line per layer."""
    bad_segs, bad_layers, worst = set(), set(), 0.0
    for layer, (a, b) in enumerate(zip(dr, dp)):
        ma, mb = a.mask.view(n_seg, -1), b.mask
        la, lb = a.logits.view(n_seg, -1).float(), b.logits.float()
        clean = [s for s in range(n_seg) if s not in bad_segs]
        if clean:
            d = (la[clean] - lb[clean]).abs().max().item()
            worst = max(worst, d / max(lb[clean].abs().max().item(), 1e-30))
        notes = []
        for s in range(n_seg):
            if torch.equal(ma[s], mb[s]):
                continue
            bad_segs.add(s)
            bad_layers.add(layer)
            ranked = torch.sort(lb[s], descending=True).values
            k = int(mb[s].sum())
            notes.append(f"segment {s}: {int((ma[s] != mb[s]).sum())} of {ma.shape[1]} tokens, "
                         f"boundary gap {(ranked[k - 1] - ranked[k]).item():.3g}, score "
                         f"difference {(la[s] - lb[s]).abs().max().item():.3g}")
        if notes:
            log(f"[ragged]   layer {layer} routed tokens differ: " + "; ".join(notes))
    return bad_segs, bad_layers, worst


def _selections_consistent(own, forced, offs):
    """Hold the selection each MoD layer of a forward would have made
    itself (``own``) to the one it was routed by (``forced``), segment by
    segment. With d the largest |own - forced| router score of a segment,
    a token only its own scores select must score (forced) at most 2d below
    the lowest selected forced score, and a token only the forced scores
    select at most 2d above the highest one left out: top-k selections of
    two score vectors within d of each other can differ only there.
    Returns (the largest d over the largest |forced score| of its layer,
    selections that differ, selections); raises on a token outside those
    bounds."""
    worst, n_diff, n_sel = 0.0, 0, 0
    bounds = list(zip(offs[:-1].tolist(), offs[1:].tolist()))
    for layer, (mine, want) in enumerate(zip(own, forced)):
        s_own, s_ref = mine.logits[0].float(), want.logits[0].float()
        m_own, m_ref = mine.mask[0], want.mask[0]
        scale = s_ref[: bounds[-1][1]].abs().max().item()
        for a, b in bounds:
            d = (s_own[a:b] - s_ref[a:b]).abs().max().item()
            worst = max(worst, d / scale)
            sel, sc = m_ref[a:b], s_ref[a:b]
            only_own, only_ref = m_own[a:b] & ~sel, sel & ~m_own[a:b]
            n_diff += int(only_own.sum())
            n_sel += int(sel.sum())
            if bool(only_own.any()) and \
                    sc[only_own].min().item() < sc[sel].min().item() - 2 * d:
                raise AssertionError(f"layer {layer}, rows {a}:{b}: a token its own scores "
                                     f"select lies more than 2 x {d:.3g} below the threshold")
            if bool(only_ref.any()) and \
                    sc[only_ref].max().item() > sc[~sel].max().item() + 2 * d:
                raise AssertionError(f"layer {layer}, rows {a}:{b}: a token its own scores "
                                     f"drop lies more than 2 x {d:.3g} above the threshold")
    return worst, n_diff, n_sel


def flat_bf16_vs_f32(params, cfg, toks, offs, cap, dec32, logits32):
    """The bf16 flat forward routed as the f32 flat forward of the same
    weights routed (``dec32``, its logits ``logits32``): both compute the
    same function on the same routed rows, so they differ by bf16 rounding
    alone. Returns (max |dlogit| over the largest |f32 logit|, the share
    of rows with the same argmax, and :func:`_selections_consistent`'s
    readings of the bf16 router against the f32 one)."""
    from repro_torch.models import api

    with torch.no_grad(), forced_ragged_decisions(dec32) as own:
        logits, _ = api.model_forward_ragged(params, cfg, toks, offs, cap)
    if len(own) != len(dec32):
        raise AssertionError(f"bf16 flat forward made {len(own)} routing decisions, "
                             f"not {len(dec32)}")
    n = int(offs[-1])
    a, b = logits[:n].float(), logits32[:n].float()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("bf16 flat forward: non-finite logits")
    rel = (a - b).abs().max().item() / b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    return (rel, agree) + _selections_consistent(own, dec32, offs)


def forward_ragged_1b(dev, params):
    """(b) mod-paper-1b: model_forward_ragged on 4 equal segments of 1024
    against the padded model_forward on (4, 1024), with the same weights in
    f32 and in bf16 (the serving dtype); then the bf16 flat forward routed
    as the f32 one routed, against it; then the bf16 forward of 8 unequal
    segments on T=4096, timed and profiled, with its launches.

    The padded path's full blocks run the flash kernel, the flat path the
    dense masked attention, so the two round at different points. The f32
    run holds the function: in every MoD layer the router scores of the
    segments routed alike so far agree within 1e-3 of their largest, and so
    do the final logits of the segments routed alike in every layer, phase
    3's CPU-vs-card criterion; a routing difference (a near-tie the two
    roundings break apart, printed by :func:`_mask_differences`) takes its
    segment out of the comparison, and at least one segment must remain. In
    bf16 the two paths route boundary tokens apart in every layer, so their
    bf16 comparison is reported without a limit, and the bf16 flat path is
    held instead to the f32 flat path on the same routed rows
    (:func:`flat_bf16_vs_f32`): logits within BF16_FLAT_LOGITS and router
    scores within BF16_FLAT_SCORES of their largest, and each layer's own
    bf16 selection within its score difference of the f32 one."""
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.utils import tree_map

    cfg = serve_1b_config()
    T, cap = RAGGED_1B["T"], RAGGED_1B["seg_cap"]
    n_mod = sum(1 for grp in params["groups"] if "mod" in grp)
    g = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(0, cfg.vocab, (T,), generator=g, device=dev)
    lens = RAGGED_1B["equal"]
    offs = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32, device=dev)
    for label in ("f32", "bf16"):
        if label == "bf16":
            p_, c_ = params, cfg
        else:
            p_ = tree_map(lambda t: t.float(), params)
            c_ = dataclasses.replace(cfg, dtype="float32")
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            with recorded_decisions("decide_tokens_ragged") as dr:
                flat, _ = api.model_forward_ragged(p_, c_, toks, offs, cap)
            with recorded_decisions("decide_tokens") as dp:
                padded, _ = api.model_forward(p_, c_, {"tokens": toks.view(len(lens), -1)})
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if len(dr) != n_mod or len(dp) != n_mod:
            raise AssertionError(f"1b: {len(dr)} / {len(dp)} routing decisions, want {n_mod} each")
        bad_segs, bad_layers, score_rel = _mask_differences(dr, dp, len(lens))
        keep = torch.ones(T, dtype=torch.bool, device=dev)
        for s in bad_segs:
            keep[int(offs[s]):int(offs[s + 1])] = False
        rows = "the segments routed alike"
        if not bool(keep.any()):  # no such segment: the numbers over every row
            keep[:] = True
            rows = "all rows (no segment routed alike in every layer)"
        a, b = flat.float()[keep], padded.reshape(T, -1).float()[keep]
        diff, scale = (a - b).abs().max().item(), b.abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        log(f"[ragged] 1b {label} model_forward_ragged on 4 x 1024 vs model_forward on (4, 1024): "
            f"routed masks identical in {n_mod - len(bad_layers)} of {n_mod} MoD layers "
            f"(segments with a difference: {sorted(bad_segs)}); router scores of segments routed "
            f"alike so far within {score_rel:.3g} of their largest; over {rows}: max |dlogit| "
            f"{diff:.4g} at |logit| up to {scale:.4g} ({diff / max(scale, 1e-30):.3g} of it), "
            f"argmax equal in {agree:.4f} of the rows; peak memory {peak:.1f} GiB")
        if label == "f32" and (len(bad_segs) == len(lens) or not score_rel <= 1e-3
                               or not diff <= 1e-3 * scale):
            raise AssertionError(f"1b f32 ragged forward: no segment routed alike, router scores "
                                 f"{score_rel} or logits {diff / scale} apart (limit 1e-3)")
        if not bool(torch.isfinite(flat[: int(offs[-1])]).all()):
            raise AssertionError(f"1b {label} ragged forward: non-finite logits")
        if label == "f32":
            dec32, flat32 = dr, flat
        del flat, padded, a, b, p_
    rel, agree, score_rel, n_diff, n_sel = flat_bf16_vs_f32(params, cfg, toks, offs, cap,
                                                            dec32, flat32)
    log(f"[ragged] 1b bf16 model_forward_ragged routed as the f32 one on 4 x 1024, against it: "
        f"max |dlogit| {rel:.4g} of the largest f32 logit (limit {BF16_FLAT_LOGITS}), argmax equal "
        f"in {agree:.4f} of the rows; router scores within {score_rel:.4g} of their largest "
        f"(limit {BF16_FLAT_SCORES}); the bf16 scores' own selections differ in {n_diff} of "
        f"{n_sel}, each within twice its score difference of the threshold")
    if not (rel <= BF16_FLAT_LOGITS and score_rel <= BF16_FLAT_SCORES):
        raise AssertionError(f"1b bf16 flat forward: logits {rel} or router scores {score_rel} "
                             f"of their scale from the f32 one on the same routed rows")
    del dec32, flat32
    # the unequal segments: wall, device busy and launches of one forward
    lens = RAGGED_1B["unequal"]
    offs = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32, device=dev)

    def fwd():
        with torch.no_grad():
            return api.model_forward_ragged(params, cfg, toks, offs, cap)

    fwd()  # warm-up, off the count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counters()
    t0 = time.perf_counter()
    logits, _ = fwd()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(logits[: int(offs[-1])]).all()):
        raise AssertionError("1b ragged forward: non-finite logits")
    for name in RAGGED_KERNELS:
        if counts[name] != n_mod:
            raise AssertionError(f"1b ragged forward launched {name} {counts[name]} times, "
                                 f"not {n_mod}")
    pwall, busy, top = profile_call(fwd, iters=3, warmup=0)
    log(f"[ragged] 1b bf16 model_forward_ragged, segments {lens} on T={T}: wall {wall:.1f} ms "
        f"(profiled: wall {pwall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / pwall:.3f}); peak memory {peak:.1f} GiB; launches {json.dumps(counts)}; "
        f"top kernels: " + "; ".join(f"{n[:50]} {t:.2f} ms" for n, t in top))
    return counts


# ---------------------------------------------------------------------------
# Phase 9: the Mamba2 (ssm) family — mamba2-1.3b
# ---------------------------------------------------------------------------

# 9a's shapes: (B, H, NC, Q, hd, ds) of mamba2-1.3b's training forward (full
# blocks at S=2048, routed blocks at k=256) in the model's strided layout,
# and two odd small ones in the JAX layout: the smoke chunk (bf16: tensor
# cores) and widths that are not multiples of 16 (CUDA cores in bf16 too)
SSD_SHAPES = {"train full": (4, 64, 16, 128, 64, 128), "train routed": (4, 64, 2, 128, 64, 128),
              "odd": (1, 3, 2, 16, 32, 16), "odd widths": (2, 5, 3, 40, 8, 24)}
# readings of each path in 9a's A/B at the full training shape (bf16)
SSD_REPS = 3
# kernel vs plain version, relative to the largest |value|: both compute in
# f32 from the same widened inputs, but take the cumsum of loglam in
# different orders, and each decay exp(l_i - l_j) carries that rounding
# (up to |l|·2^-24 relative, |l| reaches ~190 inside a 128-chunk at
# mamba2's A and dt), plus the sums' order (1e-5)
SSD_TOL = 1e-5


def _ssd_inputs(dev, dtype, B, H, NC, Q, hd, ds, seed, model_layout):
    """A = -(1..H) and dt drawn as mamba2's init draws dt_bias, so the
    decay's upper triangle overflows; model_layout: x, loglam and dt are
    (B, H, NC, Q, ·) views of (B, S, H, ·) tensors, as ssd_chunked passes
    them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(B, NC, Q, H, generator=g, device=dev)
    dt = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    x = torch.randn(B, NC, Q, H, hd, generator=g, device=dev).to(dtype)
    Bm = torch.randn(B, NC, Q, ds, generator=g, device=dev).to(dtype)
    Cm = torch.randn(B, NC, Q, ds, generator=g, device=dev).to(dtype)
    x, dt = x.permute(0, 3, 1, 2, 4), dt.permute(0, 3, 1, 2)
    if not model_layout:
        x, dt = x.contiguous(), dt.contiguous()
    return x, dt * A[None, :, None, None], dt, Bm, Cm


def ssd_work(B, H, NC, Q, hd, ds, x_bytes):
    """(bytes, f32 operations) the function needs: every input read once,
    both f32 outputs written once; C.B^T and y over the lower triangle,
    once per (b, c) and per head respectively, inc in full."""
    tri = Q * (Q + 1) // 2
    nbytes = (B * H * NC * Q * hd * x_bytes + 2 * B * H * NC * Q * 4 + 2 * B * NC * Q * ds * x_bytes
              + B * H * NC * Q * hd * 4 + B * H * NC * hd * ds * 4)
    flops = 2 * B * NC * tri * ds + 2 * B * H * NC * tri * hd + 2 * B * H * NC * Q * hd * ds
    return nbytes, flops


def check_ssd(dev, results):
    """9a: the SSD intra-chunk kernel against its plain version at the
    shapes of mamba2-1.3b's training forward, bf16 and f32 inputs, each on
    the path ssd_plan picks (bf16 with Q, hd, ds multiples of 16: tensor
    cores; the rest: CUDA cores), recorded by call and held at SSD_TOL, with
    its times and bound (bf16 inputs: the bf16 tensor rate; f32: the f32
    CUDA-core rate); at the full training shape in bf16 an A/B of the two
    paths (the CUDA-core path forced through the planner), three readings
    each in turns; HMMA in the tensor-core kernel's SASS; the wiring of its
    autograd Function at the routed shape (the backward recomputes through
    the plain version, so this holds that each input gets its own finite
    gradient, not the kernel), and the time of that backward at the full
    shape."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd as KSSD

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    check_sass("ssd", "ssd_intra_tc_kernel", "HMMA", 1)
    results["ssd_intra_chunk"] = {}
    for name, shape in SSD_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, loglam, dt, Bm, Cm = _ssd_inputs(dev, dtype, *shape, 21, name.startswith("train"))
            plan = KSSD.ssd_plan(*shape, dtype, sms, KSSD.aligned_rows(x, Bm, Cm))
            want_path = "tensor" if dtype == torch.bfloat16 and all(
                n % 16 == 0 for n in shape[3:]) else "cuda"
            build.reset_counters()
            y, inc = KSSD.ssd_intra_chunk(x, loglam, dt, Bm, Cm)
            torch.cuda.synchronize()
            calls = dict(build.COUNTERS["ssd_intra_chunk"].by_call)
            if plan.path != want_path or calls != {(plan.path, *shape): 1}:
                raise AssertionError(f"ssd_intra_chunk {name} {dtype}: launched {calls} on plan "
                                     f"{plan.path}, want the {want_path} path")
            wy, winc = KSSD.ssd_intra_chunk_plain(x, loglam, dt, Bm, Cm)
            lmax = torch.cumsum(loglam, -1).abs().max().item()
            tol = SSD_TOL + 2 * lmax * 2.0**-24
            errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in ((y, wy), (inc, winc))]
            finite = bool(torch.isfinite(y).all() and torch.isfinite(inc).all())
            log(f"[kernels] ssd_intra_chunk {name} {tuple(x.shape)} ds={shape[5]} {dtype}: "
                f"path {plan.path}, G={plan.G}, grid {plan.grid}, {plan.smem} bytes of shared "
                f"memory: y / inc within {errs[0]:.3g} / {errs[1]:.3g} of their largest (limit "
                f"{tol:.3g}, max|l| {lmax:.1f}); finite {finite}")
            if not finite or max(errs) > tol:
                raise AssertionError(f"ssd_intra_chunk {name} {dtype} differs from its plain version")
            nbytes, flops = ssd_work(*shape, x.element_size())
            how: dict = {}
            fn = lambda: KSSD.ssd_intra_chunk(x, loglam, dt, Bm, Cm)  # noqa: E731
            if name == "train full" and dtype == torch.bfloat16:
                # the A/B: the CUDA-core path forced through the planner
                # against the tensor-core path, in turns
                cuda = lambda: KSSD._launch(x, loglam, dt, Bm, Cm, "cuda")  # noqa: E731
                ab = {"cuda": [], "tensor": []}
                for _ in range(SSD_REPS):
                    ab["cuda"].append(replay_ms(cuda, how, "ms"))
                    ab["tensor"].append(replay_ms(fn, how, "ms"))
                log(f"[kernels] ssd_intra_chunk {name} bf16 A/B (CUDA graph replay, in turns): "
                    + "; ".join(f"{p} path {', '.join(f'{t:.4f}' for t in v)} ms: best "
                                f"{min(v):.4f}, median {statistics.median(v):.4f}, spread "
                                f"{max(v) - min(v):.4f}" for p, v in ab.items())
                    + f"; sm clock, max, temperature, power: {smi_clocks()}")
                reps = sorted(ab["tensor"])
            else:
                reps = [replay_ms(fn, how, "ms")]
            r = dict(ms=statistics.median(reps),
                     plain_ms=replay_ms(lambda: KSSD.ssd_intra_chunk_plain(x, loglam, dt, Bm, Cm),
                                        how, "plain_ms", reps=5),
                     library_ms=None, bound=bound_ms(nbytes, flops, dtype), timed_by=how,
                     max_abs_err=max((y - wy).abs().max().item(), (inc - winc).abs().max().item()),
                     plan=plan._asdict(),
                     shape=f"{name} x{tuple(x.shape)} ds={shape[5]} {str(dtype)[6:]}")
            if name == "train full" and dtype == torch.bfloat16:
                r["cuda_path_ms"] = statistics.median(ab["cuda"])
            log(f"[kernels] ssd_intra_chunk {name} {str(dtype)[6:]}: {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} by {r['bound'][1]}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP){timed_note(how)}")
            results["ssd_intra_chunk"][(name, dtype)] = r
            del y, inc, wy, winc
    x, loglam, dt, Bm, Cm = _ssd_inputs(dev, torch.bfloat16, *SSD_SHAPES["train routed"], 22, True)
    got = _grads(KSSD.ssd_intra_chunk, [x, loglam, dt, Bm, Cm], 23)
    want = _grads(KSSD.ssd_intra_chunk_plain, [x, loglam, dt, Bm, Cm], 23)
    for a, b in zip(got, want):
        if not torch.isfinite(a).all():
            raise AssertionError("ssd_intra_chunk: non-finite gradient")
        torch.testing.assert_close(a.float(), b.float(), atol=1e-6, rtol=1e-6)
    log("[grads] ssd_intra_chunk (routed shape, bf16 x/B/C): the Function's backward (a "
        "recompute through the plain version: its wiring, not the kernel) gives each of the five "
        "inputs autograd's gradient through the plain version, all finite")
    # the backward's cost where mamba2-1.3b's training pays it most: the full
    # blocks' shape, all five inputs needing a gradient, as in 9c
    leaves = [t.requires_grad_(True) for t in
              _ssd_inputs(dev, torch.bfloat16, *SSD_SHAPES["train full"], 24, True)]
    y, inc = KSSD.ssd_intra_chunk(*leaves)
    gy, ginc = torch.randn_like(y), torch.randn_like(inc)
    wall, busy, top = profile_call(
        lambda: torch.autograd.grad([y, inc], leaves, [gy, ginc], retain_graph=True),
        iters=3, warmup=1)
    results["ssd_intra_chunk"]["backward_ms"] = busy
    log(f"[kernels] ssd_intra_chunk backward (a recompute through the plain version under "
        f"autograd) at the full training shape, bf16: device busy {busy:.3f} ms a call, wall "
        f"{wall:.3f} ms (torch.profiler); top kernels: "
        + "; ".join(f"{n[:50]} {t:.3f}" for n, t in top))
    del y, inc, gy, ginc, leaves
    torch.cuda.empty_cache()


def ssm_parity(dev):
    """9b: mamba2-1.3b at full width and 2 layers (one group; 4 until phase
    14 needed the room), f32, the same
    weights on the CPU (plain versions) and the card (kernels): a forward
    on B=2, S=256 (logits within 1e-3 of their largest, phase 3's limit;
    loss within 1e-5; routed masks equal), one Trainer step (phase 3's
    limits), 16 teacher-forced decode steps and the stepped engine's
    greedy streams (4 slots, 6 requests, prompts 16-48, 8 new tokens)."""
    from repro_torch.config import OptimConfig, TrainConfig, get_config
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.train import Trainer, make_train_state
    from repro_torch.utils import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), dtype="float32", n_layers=2)
    cpu = torch.device("cpu")
    p_cpu = api.init_model(cfg, device=cpu, seed=3)
    p_gpu = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
    B, S = 2, 256
    batch = {k: torch.as_tensor(v).long()
             for k, v in SyntheticLM(cfg.vocab, S, seed=31).batch(0, B).items()}
    out = {}
    for name, params, d in (("cpu", p_cpu, cpu), ("gpu", p_gpu, dev)):
        with torch.no_grad(), recorded_decisions("decide_tokens") as decisions:
            logits, _ = api.model_forward(params, cfg, {"tokens": batch["tokens"].to(d)})
            loss, _ = api.model_loss(params, cfg, {k: v.to(d) for k, v in batch.items()})
        out[name] = (logits.cpu(), float(loss), [x.mask.cpu() for x in decisions])
    (lc, loss_c, mc), (lg, loss_g, mg) = out["cpu"], out["gpu"]
    diff, lim = (lc - lg).abs().max().item(), 1e-3 * lc.abs().max().item()
    dl = abs(loss_c - loss_g) / abs(loss_c)
    same = len(mc) == len(mg) == 2 * len(p_cpu["groups"]) and all(
        torch.equal(a, b) for a, b in zip(mc, mg))
    log(f"[ssm] {cfg.n_layers}-layer full-width f32 forward B={B} S={S}: max|dlogit| {diff:.3g} (limit "
        f"{lim:.3g}), loss cpu {loss_c:.7f} gpu {loss_g:.7f} (rel {dl:.3g}); routed masks "
        f"identical in {len(mc)} decisions: {same}")
    if not (diff <= lim and dl <= 1e-5 and same):
        raise AssertionError("ssm forward: CPU and card differ")

    lr = 1e-3
    tcfg = TrainConfig(global_batch=B, seq_len=S, log_every=10**6, ckpt_every=10**9,
                       optim=OptimConfig(lr=lr, warmup_steps=1, total_steps=10))
    res = {}
    with tempfile.TemporaryDirectory() as ckdir:
        from repro_torch.checkpoint import CheckpointManager

        for name, params, d in (("cpu", p_cpu, cpu), ("gpu", p_gpu, dev)):
            loader = ShardedLoader(SyntheticLM(cfg.vocab, S, seed=37), B, d)
            trainer = Trainer(cfg, tcfg, loader, ckpt=CheckpointManager(ckdir), device=d,
                              log_fn=lambda m: None)
            state = make_train_state(cfg, d, params=tree_map(lambda t: t.detach().clone(), params))
            state["step"] = torch.ones((), dtype=torch.int32)  # past the warmup's lr = 0
            state, m = trainer.run(state, 1)
            res[name] = (state, m)
    (s_c, m_c), (s_g, m_g) = res["cpu"], res["gpu"]
    dl = abs(m_c["loss"] - m_g["loss"]) / abs(m_c["loss"])
    dn = abs(m_c["grad_norm"] - m_g["grad_norm"]) / m_c["grad_norm"]
    n_total = n_far = 0
    worst, finite = 0.0, True
    for a, b in zip(tree_leaves(s_c["params"]), tree_leaves(s_g["params"])):
        finite = finite and bool(torch.isfinite(b).all())
        dd = (a.detach() - b.detach().cpu()).abs()
        n_total += dd.numel()
        n_far += int((dd > lr / 100).sum())
        worst = max(worst, dd.max().item())
    log(f"[ssm] Trainer step: loss cpu {m_c['loss']:.7f} gpu {m_g['loss']:.7f} (rel {dl:.3g}); "
        f"grad norm cpu {m_c['grad_norm']:.6f} gpu {m_g['grad_norm']:.6f} (rel {dn:.3g}); "
        f"post-AdamW weights max |diff| {worst:.3g}, {n_far} of {n_total} beyond lr/100; "
        f"all finite {finite}")
    if not (dl <= 1e-5 and dn <= 1e-4 and n_far <= 1e-4 * n_total and finite):
        raise AssertionError("ssm Trainer step: CPU and card differ")

    caches = {"cpu": api.make_caches(cfg, B, 0, cpu), "gpu": api.make_caches(cfg, B, 0, dev)}
    active = torch.tensor([True, False])
    worst = 0.0
    for step in range(16):
        tok = batch["tokens"][:, step:step + 1]
        act = active if step % 4 == 3 else torch.ones(B, dtype=torch.bool)
        with torch.no_grad():
            lc, _, ac = api.model_decode(p_cpu, caches["cpu"], cfg, tok, torch.full((B,), step),
                                         act)
            lg, _, ag = api.model_decode(p_gpu, caches["gpu"], cfg, tok.to(dev),
                                         torch.full((B,), step, device=dev), act.to(dev))
        if not torch.equal(ac["mod/decode_routed"], ag["mod/decode_routed"].cpu()):
            raise AssertionError(f"ssm decode step {step}: routed rows differ")
        d_, lim = (lc - lg.cpu()).abs().max().item(), 1e-3 * lc.abs().max().item()
        worst = max(worst, d_ / lc.abs().max().item())
        if not d_ <= lim:
            raise AssertionError(f"ssm decode step {step}: logits differ by {d_} > {lim}")
    log(f"[ssm] 16 teacher-forced decode steps: routed rows identical, logits within "
        f"{worst:.3g} of their largest (limit 1e-3)")

    toks = SyntheticLM(cfg.vocab, 48, seed=41).batch(0, 6)["tokens"]
    lens = np.random.default_rng(9).integers(16, 49, 6)
    got = {}
    for name, params, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
        eng = ServingEngine(params, cfg, EngineConfig(batch_size=4, ctx=56), device=d)
        got[name] = (_streams(eng.run_stream([Request(tokens=toks[i, :n], max_new_tokens=8)
                                              for i, n in enumerate(lens)], 0)), eng.stats())
    (sc, stc), (sg, stg) = got["cpu"], got["gpu"]
    if sc != sg or stc["steps"] != stg["steps"]:
        raise AssertionError(f"ssm stepped engine: CPU and card streams differ: {sc} vs {sg}")
    log(f"[ssm] stepped engine (prefill mode {eng.prefill_mode}), prompts {lens.min()}-"
        f"{lens.max()}: CPU and card greedy streams identical for all {len(sc)} requests "
        f"({sum(len(t) for t in sc.values())} tokens, {stg['steps']:.0f} steps)")


@contextlib.contextmanager
def ssd_launch_shapes():
    """Count the SSD kernel's launches by chunk count (NC) inside."""
    from repro_torch.kernels import ssd as KSSD

    real, seen = KSSD._launch, {}

    def record(x, *args):
        seen[x.shape[2]] = seen.get(x.shape[2], 0) + 1
        return real(x, *args)

    KSSD._launch = record
    try:
        yield seen
    finally:
        KSSD._launch = real


# phase 9c's run: mamba2-1.3b at full width, 6 of its 48 layers (the
# whole depth took 95-116 s of the script's 1200 s on an H100 (700 W), most
# of it torch.profiler's records; 24 layers since phase 13 needed the room,
# 6 since phase 14 did: 24 took 54.0-62.6 s)
TRAIN_SSM = dict(B=4, S=2048, steps=5, layers=6)


def trainer_ssm(dev, ckdir):
    """Phase 9c's trainer: mamba2-1.3b in bf16 at full width and
    TRAIN_SSM's depth, random weights from seed 0, the config's
    remat="full", AdamW with a cosine schedule (lr 1e-4 after 2 warmup
    steps), synthetic data from seed 0."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import OptimConfig, TrainConfig, get_config
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.train import Trainer

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=TRAIN_SSM["layers"])
    B, S, steps = TRAIN_SSM["B"], TRAIN_SSM["S"], TRAIN_SSM["steps"]
    tcfg = TrainConfig(global_batch=B, seq_len=S,
                       optim=OptimConfig(lr=1e-4, warmup_steps=2, total_steps=steps),
                       log_every=1, ckpt_every=10**9)
    loader = ShardedLoader(SyntheticLM(cfg.vocab, S, seed=0), B, dev)
    return Trainer(cfg, tcfg, loader, ckpt=CheckpointManager(ckdir), device=dev,
                   log_fn=lambda m: None)


def train_ssm(dev):
    """9c: phase 9c's trainer (:func:`trainer_ssm`), B=4, S=2048, 5 Trainer
    steps, each profiled."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build

    B, S, steps = TRAIN_SSM["B"], TRAIN_SSM["S"], TRAIN_SSM["steps"]
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = trainer_ssm(dev, ckdir)
        cfg = trainer.cfg
        t0 = time.perf_counter()
        state = trainer.init_or_resume()
        torch.cuda.synchronize()
        log(f"[ssm-train] {cfg.name}, {cfg.n_layers} of 48 layers: {cfg.n_params() / 1e9:.2f}B "
            f"params in {cfg.dtype}, "
            f"backend {cfg.mod.backend}, remat {cfg.remat}, B={B} S={S} (k={cfg.mod.capacity(S)} "
            f"routed rows per sequence, chunk {cfg.ssm.chunk}), init {time.perf_counter() - t0:.1f}s")
        torch.cuda.reset_peak_memory_stats()
        build.reset_counters()
        losses, busies, ssd_ms, dispatch_ms, copies_ms = [], [], [], [], []
        with ssd_launch_shapes() as by_nc:
            for i in range(steps):
                # device activity only: a step issues ~10^5 host ops, whose
                # recording would stretch the wall it is compared with
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    state, m = trainer.run(state, 1)
                by_name: dict = {}
                for kname, us in device_records(prof):
                    by_name[kname] = by_name.get(kname, 0.0) + us / 1e3
                busy = sum(by_name.values())
                wall = 1e3 * trainer.heartbeats[-1][1]
                groups: dict = {}
                for n, t in by_name.items():
                    groups[_kernel_group(n)] = groups.get(_kernel_group(n), 0.0) + t
                losses.append(m["loss"])
                busies.append(busy)
                ssd_ms.append(groups.get("ssd_intra_chunk", 0.0))
                dispatch_ms.append(groups.get("gather/scatter", 0.0))
                copies_ms.append(groups.get("copies", 0.0))
                log(f"[ssm-train] step {i + 1}: loss {m['loss']:.4f} ce {m['ce']:.4f} grad norm "
                    f"{m['grad_norm']:.3f} lr {m['lr']:.3g}; wall {wall:.1f} ms, device busy "
                    f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}")
                log("[ssm-train]   device ms by group: " + "; ".join(
                    f"{g} {t:.1f}" for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
                log("[ssm-train]   top kernels: " + "; ".join(f"{n[:60]} {t:.1f} ms"
                                                              for n, t in top))
        counts = build.launch_counts()
        ssd_calls = dict(build.COUNTERS["ssd_intra_chunk"].by_call)
    log(f"[ssm-train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    n_grp = cfg.n_layers // 2
    log(f"[ssm-train] launches in {steps} steps: ssd_intra_chunk {counts['ssd_intra_chunk']} "
        f"(NC=16: {by_nc.get(16, 0)}, NC=2: {by_nc.get(2, 0)}; {2 * n_grp} per forward, "
        f"recomputed under remat), gather_rows {counts['gather_rows']}, scatter_add_rows "
        f"{counts['scatter_add_rows']}; SSD by call (path, B, H, NC, Q, hd, ds): "
        f"{sorted(ssd_calls.items())}")
    log(f"[ssm-train] losses {', '.join(f'{x:.4f}' for x in losses)}; device busy "
        f"{', '.join(f'{b:.1f}' for b in busies)} ms; ssd_intra_chunk group "
        f"{', '.join(f'{t:.1f}' for t in ssd_ms)} ms a step; gather/scatter group "
        f"{', '.join(f'{t:.2f}' for t in dispatch_ms)} ms a step (launches by call: "
        f"{sorted((n, k, c) for n, calls in dispatch_by_call().items() for k, c in calls.items())})")
    for name in ("ssd_intra_chunk", "gather_rows", "scatter_add_rows"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the ssm training path")
    # n_grp full SSD blocks (NC=16) and n_grp routed ones (NC=2) per
    # forward, each run twice a step under remat="full"
    if by_nc != {16: 2 * n_grp * steps, 2: 2 * n_grp * steps}:
        raise AssertionError(f"SSD launches by NC {by_nc}: want {2 * n_grp} a step at each")
    if ssd_calls and {k[0] for k in ssd_calls} != {"tensor"}:  # (a parent port counts no path)
        raise AssertionError(f"SSD training launches took {ssd_calls}: want tensor cores")
    return counts, by_nc, dict(losses=losses, busy=busies, ssd_ms=ssd_ms,
                               dispatch_ms=dispatch_ms, copies_ms=copies_ms)


# 9d serves mamba2-1.3b at full width, SSM_SERVE_LAYERS of its 48 layers:
# stepped ingestion takes one engine step a prompt token, and the whole
# depth took 288 s of the script's 1200 s limit on an H100 (700 W); 2 since
# phase 14 (whose 14d serves an SSM family stepped) needed the room: 12
# layers took 60.9 s, 6 33.9-36.4 s
SSM_SERVE_LAYERS = 2


def serve_ssm(dev):
    """9d: mamba2-1.3b in bf16 at full width, SSM_SERVE_LAYERS of its 48
    layers, through the stepped engine: 8 slots, 16 greedy requests,
    prompts of 32-128 tokens, 16 new tokens each."""
    from repro_torch.config import get_config
    from repro_torch.core.routing import batch_capacity_k
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=SSM_SERVE_LAYERS)
    params = api.init_model(cfg, device=dev, seed=0)
    B, n_req, gen, lo, hi = 8, 16, 16, 32, 128
    ecfg = EngineConfig(batch_size=B, ctx=hi + gen)
    lens = np.random.default_rng(1).integers(lo, hi + 1, n_req)
    prompts = SyntheticLM(cfg.vocab, hi, seed=7).batch(0, n_req)["tokens"]
    ServingEngine(params, cfg, ecfg, device=dev).run_stream(  # warm-up, off the count
        [Request(tokens=prompts[i, :4], max_new_tokens=2) for i in range(2)], 0)
    engine = ServingEngine(params, cfg, ecfg, device=dev)
    build.reset_counters()
    torch.cuda.synchronize()
    outs = engine.run_stream([Request(tokens=prompts[i, :lens[i]], max_new_tokens=gen)
                              for i in range(n_req)], 0)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    s = engine.stats()
    if len(outs) != n_req or not all(o.ok and len(o.tokens) == gen for o in outs):
        raise AssertionError("ssm serving: a request did not finish with all its tokens")
    kb = batch_capacity_k(cfg, B)
    log(f"[ssm-serve] {cfg.name} bf16, {cfg.n_layers} of 48 layers, prefill mode {engine.prefill_mode}: {n_req} requests "
        f"(prompts {lens.min()}-{lens.max()} tokens, {gen} new each), {B} slots: "
        f"{s['generated_tokens']:.0f} tokens in {s['wall_s']:.2f}s = {s['tokens_per_s']:.1f} "
        f"tok/s; {s['steps']:.0f} engine steps, decode {1e3 * s['decode_s'] / s['decode_steps']:.2f} "
        f"ms per step; mean occupancy {s['mean_occupancy']:.2f}; routed fraction "
        f"{s['mean_routed_frac']:.4f} (kb/B = {kb}/{B}); state pool "
        f"{s['kv_cache_bytes'] / 2**20:.1f} MiB; launches {json.dumps(counts)}")
    caches = api.make_caches(cfg, B, 0, dev)
    tok = torch.zeros(B, 1, dtype=torch.long, device=dev)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    act = torch.ones(B, dtype=torch.bool, device=dev)
    with torch.no_grad():
        wall, busy, top = profile_call(lambda: api.model_decode(params, caches, cfg, tok, pos, act),
                                       iters=5)
    log(f"[profile] ssm decode step B={B}: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle "
        f"share {1 - busy / wall:.3f}; top kernels: "
        + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top))
    return counts



# ---------------------------------------------------------------------------
# Phase 10: the op entry point — ragged paged attention and SwiGLU
# ---------------------------------------------------------------------------

# 10c's SwiGLU rows: one prefill chunk of 4 x 256 rows and the training
# forward's B·S = 4 x 2048, at mod-paper-1b's MLP (D 1792, F 7168)
SWIGLU_M = (1024, 8192)
# SwiGLU kernel against its plain version, and the plain version against
# an f64 product rounded where JAX rounds (h to x's dtype, y once), as
# fractions of the largest |y|: f32, both sum in their own order (2e-5,
# JAX's tolerance for its kernel against ref at |y| ~ 1); bf16, a sum on
# the other side of a rounding boundary moves an element of h by one bf16
# ulp, and y rounds once: one output ulp, 2^-8, and the h flips it carries
SWIGLU_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
# the pools of phases 6c and 7b whose layer 0 phase 10 reads, taken after
# the prefills (every slot generating)
SNAP_RUNS = ("paged+prefix", "prefix int8/page", "prefix fp8/head")


def snapshot_pool(eng) -> dict:
    """Clones of layer 0's K, V and position pages of a paged engine's pool
    (the first three paged leaves), its page table, each slot's next
    position, and on a quantized pool layer 0's scale columns, (N, p, G),
    and the same expanded to the (N, p, nkv) the ragged op takes."""
    pool = eng.pool
    k, v, pos = (pool.pages[j].clone() for j in range(3))
    snap = dict(k=k, v=v, pos=pos, table=pool.device_table(),
                n=torch.tensor([s.pos for s in eng.slots], dtype=torch.int32, device=k.device),
                cols=None, scales=None)
    if pool.spec.qleaves:
        views = pool.spec.scale_views(pool.scales)
        snap["cols"] = tuple(views[j][0].clone() for j in (0, 1))
        snap["scales"] = tuple(c.expand(-1, -1, k.shape[2]).contiguous() for c in snap["cols"])
    return snap


def _ragged_steps(snap, g, nq, dtype, tail=8):
    """10a's two steps on a pool snapshot: a decode step (one row per slot
    at its last written position, seg_cap 1) and a mixed step (the same
    decode rows, then a 256-row prefill segment re-reading slot 0's last
    256 positions, then a flat tail of ``tail`` invalid rows, seg_cap 256)."""
    dev, hd = snap["k"].device, snap["k"].shape[3]
    n = snap["n"]
    B, C = n.shape[0], PAGED_1B["chunk"]
    i32 = dict(dtype=torch.int32, device=dev)
    dec = (n - 1).to(torch.int32)
    pre = torch.arange(int(n[0]) - C, int(n[0]), **i32)
    steps = {
        "decode": dict(q_pos=dec, offs=torch.arange(B + 1, **i32),
                       slot=torch.arange(B, **i32), cap=1),
        "mixed": dict(q_pos=torch.cat([dec, pre, torch.full((tail,), -1, **i32)]),
                      offs=torch.cat([torch.arange(B + 1, **i32), torch.tensor([B + C], **i32)]),
                      slot=torch.cat([torch.arange(B, **i32), torch.zeros(1, **i32)]), cap=C,
                      prefill=(B, B + C)),
    }
    for st in steps.values():
        st["q"] = torch.randn(st["q_pos"].shape[0], nq, hd, generator=g, device=dev).to(dtype)
    return steps


def _ragged_args(snap, st, dtype):
    """(positional args, keywords) of ragged_attention_op for one step; the
    wide pool's pages cast to ``dtype`` (f32 copies for the f32 check)."""
    k, v = snap["k"], snap["v"]
    kw = dict(seg_cap=st["cap"])
    if snap["scales"] is None:
        k, v = k.to(dtype), v.to(dtype)
    else:
        kw.update(k_scales=snap["scales"][0], v_scales=snap["scales"][1])
    return (st["q"].to(dtype), k, v, snap["pos"], snap["table"], st["offs"], st["slot"],
            st["q_pos"]), kw


def _gather_flash(snap, st, dtype):
    """The port's decode path today on the same rows: each segment's slot
    context materialized by the page gather (the dequantizing gather on a
    quantized pool) and flash attention with kv_pos. Returns the decode
    rows' output and, in the mixed step, the prefill rows'."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged as KP

    N, p, nkv, hd = snap["k"].shape
    table = snap["table"]
    B, P = table.shape

    def ctx(t):  # (B', P) tables -> K, V (B', P·p, nkv, hd), kv_pos (B', P·p)
        if snap["cols"] is None:
            kk, vv = (KP.paged_gather(x.view(N, p, -1).to(dtype), t)
                      for x in (snap["k"], snap["v"]))
        else:
            kk, vv = (KP.paged_gather_dequant(x.view(N, p, -1), c, t, dtype)
                      for x, c in zip((snap["k"], snap["v"]), snap["cols"]))
        kp = KP.paged_gather(snap["pos"].view(N, p, 1), t)[..., 0]
        return kk.view(t.shape[0], P * p, nkv, hd), vv.view(t.shape[0], P * p, nkv, hd), kp

    q, qp = st["q"].to(dtype), st["q_pos"]
    kk, vv, kp = ctx(table)
    outs = [FA.flash_attention(q[:B, None], kk, vv, qp[:B, None], kp)[:, 0]]
    if "prefill" in st:  # host ints: this runs inside a CUDA graph capture
        lo, hi = st["prefill"]
        kk, vv, kp = ctx(table[:1].contiguous())
        outs.append(FA.flash_attention(q[None, lo:hi], kk, vv, qp[None, lo:hi], kp)[0])
    return outs


def _ragged_cost(snap, st, es, kv_es):
    """(bytes, operations) the step needs: q and the output, each distinct
    page of the segments' slots that holds a position (K and V rows, their
    scales on a narrow pool, the positions) and the table rows; 4·hd·nq
    operations per valid (query, key) pair."""
    N, p, nkv, hd = snap["k"].shape
    T, nq, _ = st["q"].shape
    rows = snap["table"][st["slot"].long()].long()  # (n_seg, P)
    kp = snap["pos"][rows].flatten(1)  # (n_seg, P·p)
    pages = torch.unique(rows)
    pages = pages[(snap["pos"][pages] >= 0).any(-1)]
    row_b = 2 * nkv * (hd * kv_es + (4 if snap["scales"] is not None else 0)) + 4
    nbytes = 2 * T * nq * hd * es + pages.numel() * p * row_b + rows.numel() * 4
    pairs = 0
    offs = st["offs"].tolist()
    for s in range(len(offs) - 1):
        qp = st["q_pos"][offs[s]:offs[s + 1]]
        ok = (kp[s][None] >= 0) & (qp[:, None] >= 0) & (kp[s][None] <= qp[:, None])
        pairs += int(ok.sum())
    return nbytes, 4.0 * hd * nq * pairs


def ragged_plan(args, kw):
    """:func:`ragged.ragged_attention_plan` of one call of the wrapper."""
    from repro_torch.kernels import ragged as KRG

    q, k, table = args[0], args[1], args[4]
    return KRG.ragged_attention_plan(q.shape[0], q.shape[1], k.shape[2], q.shape[2], k.shape[0],
                                     k.shape[1], *table.shape, args[6].shape[0], kw["seg_cap"],
                                     q.dtype, k.dtype)


def ragged_plan_note(plan) -> str:
    """A ragged attention plan as logged."""
    grid = "x".join(str(n) for n in plan.grid)
    keys = (f"key tile {plan.key_tile}, {plan.n_chunks} chunk(s) of {plan.chunk}"
            if plan.path == "mma" else f"{plan.key_tile} keys a warp step")
    return (f"plan={plan.path} rows {plan.rows}, {keys}, grid {grid}, smem {plan.smem}, "
            f"{plan.kernels} kernel(s)")


def check_ragged_attention(snaps, cfg, dev, results):
    """10a/10b: the kernel against its plain version (bf16 and f32 queries
    on every pool) and its bf16 rows against the gather + flash path, on
    phase 6c's and 7b's live pools; each timed by CUDA graph replay."""
    from repro_torch.kernels import ragged as KRG

    g = torch.Generator(device=dev).manual_seed(10)
    nq = cfg.attn.n_heads
    for pool, snap in snaps.items():
        steps = _ragged_steps(snap, g, nq, torch.bfloat16)
        for step, st in steps.items():
            for dtype in (torch.bfloat16, torch.float32):
                args, kw = _ragged_args(snap, st, dtype)
                plan = ragged_plan(args, kw)
                if plan.path != ("mma" if dtype == torch.bfloat16 else "f32"):
                    raise AssertionError(f"ragged attention {pool} {step} {dtype}: plan {plan}")
                out = KRG.ragged_paged_flash_attention(*args, **kw)
                want = KRG.ragged_paged_flash_attention_plain(*args, **kw)
                torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
                if out[int(st["offs"][-1]):].any():
                    raise AssertionError(f"ragged attention {pool} {step}: flat tail not zero")
                err = (out.float() - want.float()).abs().max().item()
                nbytes, flops = _ragged_cost(snap, st, args[0].element_size(),
                                             args[1].element_size())
                r = dict(ms=graph_ms(lambda: KRG.ragged_paged_flash_attention(*args, **kw)),
                         plain_ms=graph_ms(
                             lambda: KRG.ragged_paged_flash_attention_plain(*args, **kw), reps=5),
                         library_ms=None, bound=bound_ms(nbytes, flops, dtype), max_abs_err=err,
                         plan=plan._asdict(),
                         shape=f"{pool} {step} T={args[0].shape[0]} n_seg={st['slot'].numel()} "
                               f"seg_cap={st['cap']} {nq}x{args[0].shape[2]} "
                               f"{str(dtype)[6:]}")
                extra = ""
                if dtype == torch.bfloat16:
                    B = snap["n"].shape[0]
                    ref = _gather_flash(snap, st, dtype)
                    got = [out[:B]] + ([out[slice(*st["prefill"])]] if "prefill" in st else [])
                    for a, b in zip(got, ref):
                        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])
                    r["yardstick_err"] = max((a.float() - b.float()).abs().max().item()
                                             for a, b in zip(got, ref))
                    r["yardstick_ms"] = graph_ms(lambda: _gather_flash(snap, st, dtype))
                    extra = (f" gather+flash_ms={r['yardstick_ms']:.4f} (not one call; its rows "
                             f"within {r['yardstick_err']:.3g})")
                if (pool, step, dtype) == ("bf16", "decode", torch.bfloat16):
                    profiler_diagnostic(f"ragged attention {r['shape']}",
                                        lambda: KRG.ragged_paged_flash_attention(*args, **kw),
                                        r["ms"])
                log(f"[ragged-attn] {r['shape']:58s} max_abs_err={err:.3g} ms={r['ms']:.4f} "
                    f"plain_ms={r['plain_ms']:.4f}{extra} bound_ms={r['bound'][0]:.4f} "
                    f"({r['bound'][1]}) (CUDA graph replay) {ragged_plan_note(plan)}")
                results.setdefault("ragged_paged_flash_attention", {})[
                    (pool, step, dtype)] = r


def check_ragged_launches(cfg, dev) -> None:
    """By torch.profiler (in phase 2, where its records are complete): a
    one-chunk call (10d's edge case, 64 keys a slot) is one launch of the
    mma kernel and nothing else; a split call (the decode step on a
    synthetic bf16 pool of phase 10's layout, 992 keys a slot) is the mma
    kernel and its merge, and nothing else (the merge scratch is allocated,
    not filled)."""
    from repro_torch.kernels import ragged as KRG

    args, kw = ragged_edge_case(dev, torch.bfloat16, None, 31)
    if ragged_plan(args, kw).kernels != 1:
        raise AssertionError("the edge case is not a one-chunk plan")
    check_one_launch("ragged attention, one chunk", lambda: KRG.ragged_paged_flash_attention(
        *args, **kw), "ragged_attn_mma_kernel")
    g = torch.Generator(device=dev).manual_seed(14)
    snap = synthetic_pool(cfg, dev, "bf16")
    args, kw = _ragged_args(snap, _ragged_steps(snap, g, cfg.attn.n_heads,
                                                torch.bfloat16)["decode"], torch.bfloat16)
    plan = ragged_plan(args, kw)
    for attempt in range(3):
        # one profile has listed the merge, whose input the mma kernel
        # wrote, without the mma kernel (cause not known): a profile that
        # lists fewer launches than the plan is taken again
        names = device_kernels(lambda: KRG.ragged_paged_flash_attention(*args, **kw))
        if len(names) >= plan.kernels:
            break
        log(f"[kernels] ragged attention, split: torch.profiler listed {len(names)} of the "
            f"plan's {plan.kernels} launches (attempt {attempt + 1}); profiling again")
    if (plan.kernels != 2 or len(names) != 2 or "ragged_attn_mma_kernel" not in names[0]
            or "ragged_attn_merge_kernel" not in names[1]):
        raise AssertionError(f"ragged attention, split: {ragged_plan_note(plan)}; torch.profiler "
                             f"lists {names}")
    log(f"[kernels] ragged attention, {plan.n_chunks} chunks: two launches, the kernel and its "
        f"merge, nothing else on the card (torch.profiler: {names[0][:60]}; {names[1][:60]})")


# 10d's (causal, window) modes
RAGGED_EDGE_MODES = ((True, 0), (True, 7), (False, 0))


def ragged_edge_case(dev, dtype, narrow, seed, nq=8, nkv=2, hd=64, p=16, P=4, cap=24):
    """10d's inputs: GQA 8:2, an empty segment, query rows at position -1,
    a segment of exactly seg_cap rows and one longer (its rows past seg_cap
    take row seg_cap-1's output), a flat tail, shuffled and shared pages;
    ``narrow`` (int8 or e4m3) pages with pow2 scales, else ``dtype`` ones.
    Returns (positional args, keywords) of ragged_paged_flash_attention."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = (5, 0, 1, cap, 9, cap + 3)
    B = len(lens)
    N = 2 + B * P
    i32 = dict(dtype=torch.int32, device=dev)
    table = (2 + torch.randperm(B * P, generator=g, device=dev)).view(B, P).to(torch.int32)
    table[1, 0] = table[0, 0]
    pos = torch.full((N, p), -1, **i32)
    offs, q_pos = [0], []
    for s, L in enumerate(lens):
        n = int(torch.randint(max(L, 1) + p, P * p + 1, (1,), generator=g, device=dev))
        ids = torch.arange(n, **i32)[p if s == 1 else 0:]  # slot 1 shares slot 0's page 0
        pos[table[s, ids // p].long(), (ids % p).long()] = ids
        q_pos.append(torch.arange(n - L, n, **i32))
        offs.append(offs[-1] + L)
    q_pos = torch.cat(q_pos + [torch.full((6,), -1, **i32)])
    q_pos[[1, 7]] = -1
    q = torch.randn(q_pos.shape[0], nq, hd, generator=g, device=dev).to(dtype)
    kv = [torch.randn(N, p, nkv, hd, generator=g, device=dev) for _ in range(2)]
    kw = dict(seg_cap=cap)
    if narrow is None:
        kv = [t.to(dtype) for t in kv]
    else:
        qmax = 127.0 if narrow == torch.int8 else 448.0
        kv = [(t * qmax / 3).clamp(-qmax, qmax).round().to(narrow) for t in kv]
        for name in ("k_scales", "v_scales"):
            kw[name] = 2.0 ** torch.randint(-9, -5, (N, p, nkv), generator=g, device=dev).float()
    return (q, *kv, pos, table, torch.tensor(offs, **i32), torch.arange(B, **i32), q_pos), kw


def check_ragged_edge_case(dev, dtype, narrow, causal, window, seed=31):
    """One 10d case: one launch, within TOL of the plain version (their
    sums and p rounding differ in order), the flat tail and the rows at
    position -1 exactly 0."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ragged as KRG

    args, kw = ragged_edge_case(dev, dtype, narrow, seed)
    before = build.launch_counts()["ragged_paged_flash_attention"]
    out = KRG.ragged_paged_flash_attention(*args, causal=causal, window=window, **kw)
    if build.launch_counts()["ragged_paged_flash_attention"] != before + 1:
        raise AssertionError("ragged attention: the wrapper did not launch its kernel once")
    want = KRG.ragged_paged_flash_attention_plain(*args, causal=causal, window=window, **kw)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    if out[int(args[5][-1]):].any() or out[[1, 7]].any():
        raise AssertionError("ragged attention: a tail or position -1 row is not 0")


def check_ragged_small(dev):
    """10d: every edge case, f32 and bf16 queries on wide, int8 and e4m3
    pages, in each of RAGGED_EDGE_MODES."""
    cases = [(dtype, narrow, *mode) for dtype in (torch.float32, torch.bfloat16)
             for narrow in (None, torch.int8, torch.float8_e4m3fn) for mode in RAGGED_EDGE_MODES]
    for case in cases:
        check_ragged_edge_case(dev, *case)
    log(f"[ragged-attn] small shapes: {len(cases)} cases (GQA 8:2, hd 64, page 16, empty "
        f"segment, rows at -1, a segment of seg_cap rows and one longer, shared pages, flat "
        f"tail; f32/bf16 wide, int8/e4m3 narrow; causal, window 7, non-causal) within TOL of "
        f"the plain version")


def swiglu_library(x, w_gate, w_up, w_down):
    """SwiGLU from one cuBLAS call per product, at the kernel's rounding
    points: bf16 operands summed in f32 (torch.mm's ``out_dtype``), h
    rounded to x's dtype, y cast once; f32 operands by torch.mm in f32."""
    if x.dtype == torch.bfloat16:
        def mm(a, b):
            return torch.mm(a, b, out_dtype=torch.float32)
    else:
        mm = torch.mm
    h = (torch.nn.functional.silu(mm(x, w_gate)) * mm(x, w_up)).to(x.dtype)
    return mm(h, w_down).to(x.dtype)


def check_swiglu(mlp, dev, results):
    """10c: SwiGLU at mod-paper-1b's MLP (layer 0's weights), M = 1024 and
    8192, bf16 and f32, and an odd small shape: the kernel against its
    plain version, the plain version against an f64 product rounded at
    JAX's points, and the library computation against the plain version;
    times of the three (CUDA graph replay) and the bound."""
    from repro_torch.kernels import build
    from repro_torch.kernels import swiglu as SW

    check_sass("swiglu", "gemm_wgmma_kernel", "HGMMA", 2)  # EpiSwiglu, EpiStore
    g = torch.Generator(device=dev).manual_seed(12)
    D, F = mlp["w_gate"].shape
    cases = [(M, D, F, dt) for M in SWIGLU_M for dt in (torch.bfloat16, torch.float32)]
    # odd shapes: the tensor-core path (bf16, D and F multiples of 8) and
    # the CUDA-core one (f32, or a D and F that are not)
    cases += [(37, 40, 72, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [(33, 44, 70, dt) for dt in (torch.float32, torch.bfloat16)]
    for M, D_, F_, dtype in cases:
        if D_ == D:
            w = [mlp[k].to(dtype) for k in ("w_gate", "w_up", "w_down")]
        else:
            w = [(torch.randn(a, b, generator=g, device=dev) / a ** 0.5).to(dtype)
                 for a, b in ((D_, F_), (D_, F_), (F_, D_))]
        x = torch.randn(M, D_, generator=g, device=dev).to(dtype)
        build.reset_counters()
        out = SW.swiglu(x, *w)
        path = SW.gemm_path(dtype, M, F_, D_, True)
        if build.COUNTERS["swiglu"].by_call != {(path, M, D_, F_): 1}:
            raise AssertionError(f"swiglu M={M} {dtype} launched {build.COUNTERS['swiglu'].by_call}"
                                 f", want {path}")
        want = SW.swiglu_plain(x, *w)
        scale = want.float().abs().max().item()
        err = (out.float() - want.float()).abs().max().item()
        if not err <= SWIGLU_TOL[dtype] * scale:
            raise AssertionError(f"swiglu M={M} {dtype}: kernel differs from its plain version by "
                                 f"{err:.3g} (max |y| {scale:.3g})")
        # JAX's rounding points in f64: h = x-dtype(silu(g)·u), y = x-dtype(h @ Wd)
        xd, wd = x.double(), [t.double() for t in w]
        h = (torch.nn.functional.silu(xd @ wd[0]) * (xd @ wd[1])).to(dtype)
        ref = (h.double() @ wd[2]).to(dtype)
        err_ref = (want.float() - ref.float()).abs().max().item()
        if not err_ref <= SWIGLU_TOL[dtype] * scale:
            raise AssertionError(f"swiglu M={M} {dtype}: plain version {err_ref:.3g} from the f64 "
                                 f"product at JAX's rounding points")
        if M < 1024:
            log(f"[swiglu] M={M} D={D_} F={F_} {str(dtype)[6:]} gemm={path}: kernel within "
                f"{err:.3g} of the plain version, which is within {err_ref:.3g} of JAX's rounding "
                f"points in f64")
            continue
        lib = swiglu_library(x, *w)
        err_lib = (lib.float() - want.float()).abs().max().item()
        if not err_lib <= SWIGLU_TOL[dtype] * scale:
            raise AssertionError(f"swiglu M={M} {dtype}: the library computation is {err_lib:.3g} "
                                 f"from the plain version")
        es = x.element_size()
        r = dict(ms=graph_ms(lambda: SW.swiglu(x, *w), reps=5, iters=2),
                 plain_ms=graph_ms(lambda: SW.swiglu_plain(x, *w), reps=5, iters=2),
                 library_ms=graph_ms(lambda: swiglu_library(x, *w), reps=5, iters=2),
                 bound=bound_ms((2 * M * D_ + 3 * D_ * F_) * es, 6.0 * M * D_ * F_, dtype),
                 max_abs_err=err, shape=f"M={M} D={D_} F={F_} {str(dtype)[6:]}", gemm_path=path)
        r["tflops"] = 6.0 * M * D_ * F_ / r["ms"] / 1e9
        if (M, dtype) == (max(SWIGLU_M), torch.bfloat16):
            profiler_diagnostic(f"swiglu {r['shape']}", lambda: SW.swiglu(x, *w), r["ms"])
        log(f"[swiglu] {r['shape']:32s} gemm={path} max_abs_err={err:.3g} (max |y| {scale:.3g}; "
            f"plain vs JAX's rounding points {err_ref:.3g}, library vs plain {err_lib:.3g}) "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} (torch.matmul x3 in f32 + silu) "
            f"library_ms={r['library_ms']:.4f} ({SWIGLU_LIBRARY[dtype]}) "
            f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}) achieved {r['tflops']:.2f} TFLOP/s "
            f"(CUDA graph replay)")
        results.setdefault("swiglu", {})[(M, dtype)] = r


def ops_path(snaps, mlp, cfg, dev):
    """Phase 10's counted run: the op entry point (repro_torch.kernels.ops)
    as a user calls it, bf16: ragged_attention_op for the decode and the
    mixed step on each of the three live pools, swiglu_op at M = 1024 and
    8192. Counters are set to 0 just before and read just after."""
    from repro_torch.kernels import build, ops

    g = torch.Generator(device=dev).manual_seed(13)
    calls = []
    for pool, snap in snaps.items():
        for step, st in _ragged_steps(snap, g, cfg.attn.n_heads, torch.bfloat16).items():
            calls.append((ops.ragged_attention_op, *_ragged_args(snap, st, torch.bfloat16)))
    w = [mlp[k] for k in ("w_gate", "w_up", "w_down")]
    for M in SWIGLU_M:
        x = torch.randn(M, w[0].shape[0], generator=g, device=dev).to(torch.bfloat16)
        calls.append((ops.swiglu_op, (x, *w), {}))
    torch.cuda.synchronize()
    build.reset_counters()
    outs = [fn(*args, **kw) for fn, args, kw in calls]
    torch.cuda.synchronize()
    counts = build.launch_counts()
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("the op entry point returned non-finite values")
    want = {"ragged_paged_flash_attention": 2 * len(snaps), "swiglu": len(SWIGLU_M)}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"phase 10's ops launched {counts}, want {want}")
    by_plan = dict(build.COUNTERS["ragged_paged_flash_attention"].by_call)
    if any(key[0] != "mma" for key in by_plan):
        raise AssertionError(f"a bf16 ragged attention call left the mma path: {by_plan}")
    log(f"[ops] ragged attention launches by call (path, T, n_seg, seg_cap, nq, nkv, hd, kv, "
        f"chunks, kernels): {by_plan}")
    log(f"[ops] {len(calls)} op calls through repro_torch.kernels.ops: launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    return counts


# ---------------------------------------------------------------------------
# Phase 11: self-speculative serving
# ---------------------------------------------------------------------------

SPEC_N = 3  # tokens drafted a round
SPEC_GEN = 16  # new tokens a request in 11b (phase 6c's first 16)
# 11b's engines on PAGED_1B's workload: (name, engine settings, draft ratio,
# QuantConfig fields or None, the phase 6c / 7b run whose streams it equals)
SPEC_1B = (
    ("paged r0", dict(), 0.0, None, "paged"),
    ("paged r0.125 fused", dict(), 0.125, None, "paged"),
    ("paged+prefix r0", dict(prefix_cache=True), 0.0, None, "paged"),
    ("ragged r0", dict(ragged=True), 0.0, None, "paged"),
    ("prefix int8/page r0", dict(prefix_cache=True), 0.0, dict(kv="int8", granularity="page"),
     "prefix int8/page"),
)
# the kernels a round may launch (PERF.md §6 rows 7, 8, 3, 1, 2, 13), and
# the sources that hold them
SPEC_KERNELS = ("paged_gather", "paged_gather_dequant", "flash_attention", "gather_rows",
                "scatter_add_rows", "ragged_paged_scatter_rows")
SPEC_SOURCES = ("paged.cu", "flash_attention.cu", "routing.cu", "flat.cuh")


def csrc_kernels() -> dict:
    """{name of a ``__global__`` function: its file} for every kernel source
    of the port."""
    import re

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(?://[^\n]*\s*)?(\w+)\s*\(")
    out = {}
    for f in sorted((ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu*")):
        for name in pat.findall(f.read_text()):
            out[name] = f.name
    return out


def port_kernel_of(event_name: str, kernels: dict):
    """The port's ``__global__`` function a profiler kernel record names, or
    None for a kernel of torch or a library."""
    import re

    for name in kernels:
        if re.search(rf"\b{name}\b", event_name):
            return name
    return None


def speculative_parity(dev):
    """(a) mod-paper-60m in f32, phase 6b's weights and a shared 128-token
    prefix, 4 requests upfront into 4 slots, 12 new tokens: the paged engine
    (page 16, chunk 64) with ``speculate=3`` at draft ratio 0.0 (draft, then
    verify) and 0.125 (the model's ratio: one fused chain) on the CPU (plain
    versions) and the card (kernels). Streams must be identical across the
    devices and equal to the card's non-speculative paged engine's."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    cfg = parity_60m_config()
    p_cpu = api.init_model(cfg, device="cpu", seed=3)
    p_gpu = _to(p_cpu, dev)
    toks = SyntheticLM(cfg.vocab, 228, seed=17).batch(0, 4)["tokens"]
    rng = np.random.default_rng(5)
    prompts = [np.concatenate([toks[0, :128], toks[i, 128:128 + int(n)]])
               for i, n in enumerate(rng.integers(16, 101, 4))]
    base = dict(batch_size=4, ctx=256, page_size=16, prefill_chunk=64)

    def run(d, params, **kw):
        eng = ServingEngine(params, cfg, EngineConfig(**base, **kw), device=d)
        return _streams(eng.run_stream([Request(tokens=p, max_new_tokens=12) for p in prompts],
                                       0)), eng.stats()

    plain, _ = run(dev, p_gpu)
    for ratio in (0.0, cfg.mod.capacity_ratio):
        (sc, stc), (sg, stg) = (run(d, p, speculate=SPEC_N, draft_ratio=ratio)
                                for d, p in (("cpu", p_cpu), (dev, p_gpu)))
        if sc != sg:
            diff = [u for u in sc if sc[u] != sg[u]]
            raise AssertionError(f"60m speculative r{ratio}: CPU and card streams differ for {diff}")
        if sg != plain:
            diff = [u for u in sg if sg[u] != plain[u]]
            raise AssertionError(f"60m speculative r{ratio}: card streams differ from the plain "
                                 f"paged engine's for {diff}")
        if (stc["speculative_rounds"], stc["speculative_tokens_per_round"]) != (
                stg["speculative_rounds"], stg["speculative_tokens_per_round"]):
            raise AssertionError(f"60m speculative r{ratio}: rounds differ across devices")
        log(f"[spec] 60m f32 paged speculate={SPEC_N} draft ratio {ratio}"
            f"{' (fused)' if ratio == cfg.mod.capacity_ratio else ''}: CPU and card greedy streams "
            f"identical for all {len(sg)} requests ({sum(len(t) for t in sg.values())} tokens) and "
            f"equal to the card's plain paged engine's; {stg['speculative_rounds']:.0f} rounds, "
            f"accept rate {stg['speculative_accept_rate']:.3f}, "
            f"{stg['speculative_tokens_per_round']:.3f} tokens a round on both")


def serve_spec_1b(dev, params, base_streams, base_stats, quant_streams):
    """(b) mod-paper-1b in bf16, phase 6c's workload and weights (8 requests
    sharing a 512-token prefix, page 16, chunk 256), SPEC_GEN new tokens
    (the first SPEC_GEN of phase 6c's 32: every slot runs to the end in
    both), through SPEC_1B's engines at ``speculate=3``. Streams must equal
    phase 6c's (7b's for the int8 pool) and the fused run must average more
    than 3 tokens a round. Per engine: rounds, accept rate, tokens a round,
    wall ms a round and an accepted token (engine steps advanced) over the
    rounds whose step admitted nothing, device-busy ms of one profiled such
    round, peak memory, and each kernel's launches in such a round. Every
    round may launch only SPEC_KERNELS (launch counters), and the profiled
    round's device records hold no other kernel of ``csrc``
    (torch.profiler). Returns the launch counts of each run (prefills
    included) and of a round with every slot generating."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.serve.quant import QuantConfig
    from repro_torch.serve.scheduler import GENERATE

    cfg = serve_1b_config()
    w = PAGED_1B
    B, pre, page, C = w["B"], w["prefix"], w["page"], w["chunk"]
    suffix, ctx, n_chunks = paged_1b_plan()
    toks = SyntheticLM(cfg.vocab, pre + w["max_suffix"], seed=9).batch(0, B)["tokens"]
    prompts = [np.concatenate([toks[0, :pre], toks[i, pre:pre + int(n)]])
               for i, n in enumerate(suffix)]
    n_full = sum(1 for grp in params["groups"] if "full" in grp)
    n_mod = sum(1 for grp in params["groups"] if "mod" in grp)
    kernels = csrc_kernels()
    allowed = {k for k, f in kernels.items() if f in SPEC_SOURCES}
    plain_ms = 1e3 * base_stats["decode_s"] / base_stats["decode_steps"]
    want_streams = {"paged": base_streams, **quant_streams}
    counts, per_round = {}, {}
    for name, kw, ratio, q, ref in SPEC_1B:
        if "ragged" in kw:
            kw = dict(kw, ragged_segments=n_chunks)
        ecfg = EngineConfig(batch_size=B, ctx=ctx, page_size=page, prefill_chunk=C,
                            speculate=SPEC_N, draft_ratio=ratio,
                            quant=QuantConfig(**q) if q else QuantConfig(), **kw)
        eng = ServingEngine(params, cfg, ecfg, device=dev)
        for pr in prompts:
            eng.submit(Request(tokens=pr, max_new_tokens=SPEC_GEN))
        build.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        walls, advanced, prof, full_round = [], [], None, None
        while eng.has_work:
            rounds, at, before = eng._spec_rounds, eng.step_count, build.launch_counts()
            all_gen = not eng.scheduler.queue and all(s.state == GENERATE for s in eng.slots)
            profiling = prof is None and all_gen
            with (profile(activities=[ProfilerActivity.CUDA]) if profiling
                  else contextlib.nullcontext()) as pr_:
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
            if eng._spec_rounds == rounds:
                continue  # a mixed (ragged) step, or nothing ran
            delta = {k: v - before[k] for k, v in build.launch_counts().items() if v != before[k]}
            if set(delta) - set(SPEC_KERNELS):
                raise AssertionError(f"1b speculative {name}: a round launched {delta}")
            if not all_gen:
                continue  # the round's step also admitted (and prefilled)
            walls.append(wall)
            advanced.append(eng.step_count - at)
            if full_round is None:
                full_round = delta
            if profiling:
                events = device_records(pr_)
                busy = sum(us for _, us in events) / 1e3
                if busy > 0.0:
                    ours = {port_kernel_of(name, kernels) for name, _ in events} - {None}
                    if ours - allowed:
                        raise AssertionError(f"1b speculative {name}: the profiled round ran "
                                             f"{sorted(ours - allowed)} of csrc")
                    prof = dict(wall=wall, busy=busy, a=advanced[-1], kernels=sorted(ours),
                                n_events=len(events))
        torch.cuda.synchronize()
        counts[name] = build.launch_counts()
        s = eng.stats()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        outs = _streams(eng.finished)
        if len(outs) != B or any(not o.ok or len(o.tokens) != SPEC_GEN for o in eng.finished):
            raise AssertionError(f"1b speculative {name}: not every request finished with "
                                 f"{SPEC_GEN} tokens")
        want_s = {u: t[:SPEC_GEN] for u, t in want_streams[ref].items()}
        if outs != want_s:
            diff = [u for u in outs if outs[u] != want_s[u]]
            raise AssertionError(f"1b speculative {name}: streams differ from phase "
                                 f"{'7b' if q else '6c'}'s {ref} run for requests {diff}")
        fused = ratio == cfg.mod.capacity_ratio
        if fused and not s["speculative_tokens_per_round"] > 3.0:
            raise AssertionError(f"1b speculative {name}: {s['speculative_tokens_per_round']:.3f} "
                                 f"tokens a round, want > 3.0 (the drafter is the verifier)")
        if full_round is None:
            raise AssertionError(f"1b speculative {name}: no round ran with every slot generating")
        # a round: one materialize (3 gathers a full layer; on the int8
        # pool 2 dequantizing + 1 plain), one window write (3 a full
        # layer, + 2 scale tensors), flash in every step of every layer
        # (routed layers only where the step's kb > 0)
        draft = 0 if fused else SPEC_N * (n_full + (n_mod if ratio > 0 else 0))
        want = {"flash_attention": (SPEC_N + 1) * (n_full + n_mod) + draft,
                "ragged_paged_scatter_rows": 3 * n_full + (2 if q else 0)}
        want.update({"paged_gather": n_full, "paged_gather_dequant": 2 * n_full} if q
                    else {"paged_gather": 3 * n_full})
        if full_round != want:
            raise AssertionError(f"1b speculative {name}: a round with every slot generating "
                                 f"launched {full_round}, want {want}")
        per_round[name] = full_round
        wall_round = sum(walls) / len(walls)
        wall_tok = sum(walls) / sum(advanced)
        busy_note = ("busy of one round: torch.profiler recorded no device time; not measured"
                     if prof is None else
                     f"profiled round (a={prof['a']}): wall {prof['wall']:.2f} ms, device busy "
                     f"{prof['busy']:.2f} ms ({prof['busy'] / prof['a']:.2f} ms an accepted "
                     f"token), idle share {1 - prof['busy'] / prof['wall']:.3f}, "
                     f"{prof['n_events']} device records; kernels of csrc: "
                     f"{', '.join(prof['kernels'])}")
        log(f"[spec] 1b {name}: {s['speculative_rounds']:.0f} rounds, accept rate "
            f"{s['speculative_accept_rate']:.3f}, {s['speculative_tokens_per_round']:.3f} tokens a "
            f"round, {s['steps']:.0f} engine steps; over the {len(walls)} rounds that admitted "
            f"nothing, wall {wall_round:.2f} ms a round, "
            f"{wall_tok:.2f} ms an accepted token (phase 6c's plain paged decode step "
            f"{plain_ms:.2f} ms); {s['generated_tokens']:.0f} tokens in {s['wall_s']:.2f}s = "
            f"{s['tokens_per_s']:.1f} tok/s; peak memory {peak:.2f} GiB; streams equal phase "
            f"{'7b' if q else '6c'}'s {ref} run")
        log(f"[spec]   {busy_note}")
        log(f"[spec]   launches a round: {json.dumps(per_round.get(name))}; the run's (prefills "
            f"included): {json.dumps({k: v for k, v in counts[name].items() if v})}")
    log(f"[spec] 1b: every round launched only {', '.join(SPEC_KERNELS)} (launch counters; "
        f"gather_rows and scatter_add_rows 0: decode routes batch rows with torch index ops)")
    return counts, per_round


# ---------------------------------------------------------------------------
# Phase 12: the MoE family (token-choice MoE, staged and integrated MoDE)
# ---------------------------------------------------------------------------

MOE_SMOKE = ("olmoe-1b-7b", "phi3.5-moe-imode")  # 12a: staged and integrated MoDE
MOE_TOL = dict(atol=1e-5, rtol=1e-5)  # 12a: f32 logits, CPU against the card
# 12c: phi3.5-moe-imode at full width, 4 of its 32 layers; a padded prefill
# of 4 prompts, then 16 decode steps
# 12b serves olmoe-1b-7b at full width and this many of its 16 layers (the
# script's 1200 s)
MOE_SERVE_LAYERS = 4
MOE_IMODE = dict(layers=4, prompts=(256, 200, 144, 96), decode=16)
# 12d: olmoe-1b-7b at full width, 4 of its 16 layers (2 full, 2 routed)
MOE_TRAIN = dict(layers=4, B=2, S=2048, steps=3)


@contextlib.contextmanager
def moe_calls(annotate: bool = False):
    """Record every ``moe_mlp`` call inside: (S, aux as device tensors),
    read after the run; ``annotate`` also wraps each call in a
    ``torch.profiler.record_function("moe_mlp")`` range."""
    from repro_torch.models import moe as MOE

    real, seen = MOE.moe_mlp, []

    def record(params, x, cfg):
        with (torch.profiler.record_function("moe_mlp") if annotate
              else contextlib.nullcontext()):
            out, aux = real(params, x, cfg)
        seen.append((x.shape[0], x.shape[1], {k: v.detach() for k, v in aux.items()}))
        return out, aux

    MOE.moe_mlp = record
    try:
        yield seen
    finally:
        MOE.moe_mlp = real


def moe_mean(seen, key: str, prefill: bool) -> float:
    """Mean of ``aux[key]`` over the recorded calls of prefill (S > 1) or
    decode (S = 1) shape that had rows (a decode step at draft ratio 0
    routes none), nan if there were none."""
    vals = [a[key].float() for B, S, a in seen if B > 0 and (S > 1) == prefill and key in a]
    return float(torch.stack(vals).mean()) if vals else float("nan")


def profiled_step(eng, moe: bool = False):
    """One engine step under torch.profiler: (wall ms, device-busy ms, the
    port's ``__global__`` functions among its device records, the launch
    counters' change, the number of device records, the device ms inside
    ``moe_mlp`` ranges (:func:`moe_range_ms`; with ``moe`` only, which
    records host ops too, else None), the number of the port's records by
    source file, device ms by :func:`_kernel_group`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build

    before = build.launch_counts()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if moe else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    delta = {k: v - before[k] for k, v in build.launch_counts().items() if v != before[k]}
    events = device_records(prof, skip=("moe_mlp",))
    busy = sum(us for _, us in events) / 1e3
    kernels = csrc_kernels()
    ours = {port_kernel_of(name, kernels) for name, _ in events} - {None}
    by_file: dict = {}
    groups: dict = {}
    for name, us in events:
        k = port_kernel_of(name, kernels)
        if k is not None:
            by_file[kernels[k]] = by_file.get(kernels[k], 0) + 1
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    return (wall, busy, ours, delta, len(events), moe_range_ms(prof) if moe else None, by_file,
            groups)


def check_profiled_kernels(tag: str, ours: set, delta: dict) -> None:
    """The port kernels torch.profiler saw in a step are those whose launch
    counters moved in it, by source file (``gemm.cuh`` serves the fused
    kernels' products)."""
    kernels = csrc_kernels()
    files = {Path(SOURCES[n][0]).name for n in delta}
    allowed = files | ({"gemm.cuh"} if set(delta) & {"routed_attention", "routed_mlp_scatter",
                                                      "swiglu"} else set())
    seen = {kernels[k] for k in ours}
    if seen - allowed:
        raise AssertionError(f"{tag}: torch.profiler saw kernels of {sorted(seen - allowed)} "
                             f"whose launch counters did not move ({delta})")
    if files - seen:
        raise AssertionError(f"{tag}: counted launches of {sorted(files - seen)} ({delta}) but "
                             f"torch.profiler saw none of their kernels")


def moe_parity(dev):
    """(a) olmoe-1b-7b (staged MoDE) and phi3.5-moe-imode (integrated MoDE)
    at smoke size, f32, the same weights on the CPU (plain versions) and
    the card (kernels), under the backends xla, pallas and pallas_fused:
    model_loss's logits within MOE_TOL, the dropped and no-op fractions
    equal, the other aux within MOE_TOL; then greedy streams of the paged
    engine (page 16, chunk 32, 6 requests into 4 slots sharing a 48-token
    prefix, 12 new tokens) equal on both devices, and a second run on the
    card bit-identical (the deterministic combine)."""
    from repro_torch.config import get_config, smoke_config, with_mod_backend
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    for arch in MOE_SMOKE:
        base = dataclasses.replace(smoke_config(get_config(arch)), dtype="float32")
        p_cpu = api.init_model(base, device="cpu", seed=5)
        p_gpu = _to(p_cpu, dev)
        toks = torch.as_tensor(SyntheticLM(base.vocab, 65, seed=13).batch(0, 2)["tokens"]).long()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for backend in ("xla", "pallas", "pallas_fused"):
            cfg = with_mod_backend(base, backend)
            lc, ac = api.model_forward(p_cpu, cfg, batch)
            _, lac = api.model_loss(p_cpu, cfg, batch)
            build.reset_counters()
            lg, ag = api.model_forward(p_gpu, cfg, {k: v.to(dev) for k, v in batch.items()})
            _, lag = api.model_loss(p_gpu, cfg, {k: v.to(dev) for k, v in batch.items()})
            counts = {k: v for k, v in build.launch_counts().items() if v}
            diff = (lc - lg.cpu()).abs().max().item()
            if not torch.allclose(lg.cpu(), lc, **MOE_TOL):
                raise AssertionError(f"12a {arch} {backend}: logits differ by {diff}")
            if sorted(lac) != sorted(lag):
                raise AssertionError(f"12a {arch} {backend}: aux keys {sorted(lac)} vs {sorted(lag)}")
            worst = 0.0
            for key in lac:
                a, b = lac[key].float(), lag[key].float().cpu()
                if key.endswith(("drop_frac", "noop_frac")):
                    if not torch.equal(a, b):
                        raise AssertionError(f"12a {arch} {backend}: {key} {a} vs {b}")
                elif not torch.allclose(b, a, **MOE_TOL):
                    raise AssertionError(f"12a {arch} {backend}: {key} {a} vs {b}")
                worst = max(worst, (a - b).abs().max().item())
            want = {"flash_attention"}
            if base.mod.enabled:
                want |= ({"routed_attention", "scatter_add_rows"} if backend == "pallas_fused"
                         else {"gather_rows", "scatter_add_rows"})
            if set(counts) != want:
                raise AssertionError(f"12a {arch} {backend}: the card's forward and loss launched "
                                     f"{counts}, want {sorted(want)}")
            fr = {k: round(float(v), 6) for k, v in lag.items() if k.endswith(("frac",))}
            log(f"[moe] 12a {arch} smoke f32 {backend}: CPU == card logits max|d|={diff:.3g} "
                f"(limit {MOE_TOL}), aux max|d|={worst:.3g}, fractions equal {json.dumps(fr)}; "
                f"loss {float(lag['loss']):.6f}; card launches {json.dumps(counts)}")
        cfg = with_mod_backend(base, "pallas")
        pt = SyntheticLM(cfg.vocab, 96, seed=19).batch(0, 6)["tokens"]
        rng = np.random.default_rng(6)
        prompts = [np.concatenate([pt[0, :48], pt[i, 48:48 + int(n)]])
                   for i, n in enumerate(rng.integers(4, 41, 6))]

        def run(d, params):
            eng = ServingEngine(params, cfg, EngineConfig(batch_size=4, ctx=128, page_size=16,
                                                          prefill_chunk=32), device=d)
            return _streams(eng.run_stream([Request(tokens=p, max_new_tokens=12)
                                            for p in prompts], 0))

        sc, sg, sg2 = run("cpu", p_cpu), run(dev, p_gpu), run(dev, p_gpu)
        if sc != sg:
            raise AssertionError(f"12a {arch}: CPU and card streams differ for "
                                 f"{[u for u in sc if sc[u] != sg[u]]}")
        if sg2 != sg:
            raise AssertionError(f"12a {arch}: two runs on the card differ for "
                                 f"{[u for u in sg if sg[u] != sg2[u]]}")
        log(f"[moe] 12a {arch} smoke f32 paged engine: CPU and card greedy streams identical for "
            f"all {len(sg)} requests ({sum(len(t) for t in sg.values())} tokens); a second card "
            f"run identical")


def serve_moe_1b(dev):
    """(b) olmoe-1b-7b (staged MoDE, 64 experts top-8) at full width and
    MOE_SERVE_LAYERS of its 16 layers, bf16, random weights from seed 0, backend pallas, on PAGED_1B's
    workload: the paged + prefix engine, the ragged engine and the fused
    speculative engine (speculate=SPEC_N at draft ratio 0.125, the model's
    own, SPEC_GEN new tokens). Streams equal the paged + prefix engine's.
    Per engine: tok/s, prefill ms a prompt, decode wall and (one profiled
    step or round with every slot generating) busy ms, idle share, peak
    memory, kv_bytes and the mean moe/drop_frac of the prefill and decode
    MoE calls. The profiled step's launch counts are held to the step's
    layers and to torch.profiler's ``__global__`` names. Returns the launch
    counts of each run."""
    from repro_torch.config import get_config, with_mod_backend
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.serve.scheduler import GENERATE
    from repro_torch.utils import tree_leaves

    cfg = with_mod_backend(dataclasses.replace(get_config("olmoe-1b-7b"),
                                               n_layers=MOE_SERVE_LAYERS), "pallas")
    t0 = time.perf_counter()
    params = api.init_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    w = PAGED_1B
    B, gen, pre, page, C = w["B"], w["gen"], w["prefix"], w["page"], w["chunk"]
    suffix, ctx, n_chunks = paged_1b_plan()
    toks = SyntheticLM(cfg.vocab, pre + w["max_suffix"], seed=9).batch(0, B)["tokens"]
    prompts = [np.concatenate([toks[0, :pre], toks[i, pre:pre + int(n)]])
               for i, n in enumerate(suffix)]
    n_full = sum(1 for grp in params["groups"] if "full" in grp)
    n_mod = sum(1 for grp in params["groups"] if "mod" in grp)
    log(f"[moe] 12b {cfg.name}: {n_params / 1e9:.3f}B params ({cfg.n_params() / 1e9:.3f}B by "
        f"n_params, {cfg.active_params_per_token() / 1e9:.3f}B active a token) in {cfg.dtype}, "
        f"{n_full} full + {n_mod} routed MoE layers, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k}, init {time.perf_counter() - t0:.1f}s")
    paged = dict(page_size=page, prefill_chunk=C)
    runs = {"paged+prefix": dict(paged, prefix_cache=True),
            "ragged": dict(paged, ragged=True, ragged_segments=n_chunks),
            "speculative fused": dict(paged, speculate=SPEC_N, draft_ratio=cfg.mod.capacity_ratio)}
    warm = ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=ctx, **runs["ragged"]),
                         device=dev)
    warm.run_stream([Request(tokens=prompts[0][:300], max_new_tokens=2)], 0)
    # a decode step with every slot generating: paged gathers and flash in
    # each layer (the routed ones at kb = round(0.125 * 8) = 1), the write-
    # back (paged, or ragged on the ragged engine); a fused round: SPEC_N + 1
    # such steps, one materialize and one window write
    step_want = {"paged_gather": 3 * n_full, "flash_attention": n_full + n_mod}
    wants = {"paged+prefix": dict(step_want, paged_scatter_rows=3 * n_full),
             "ragged": dict(step_want, ragged_paged_scatter_rows=3 * n_full),
             "speculative fused": dict(step_want, flash_attention=(SPEC_N + 1) * (n_full + n_mod),
                                       ragged_paged_scatter_rows=3 * n_full)}
    out, counts = {}, {}
    for name, kw in runs.items():
        n_new = SPEC_GEN if "speculate" in kw else gen
        eng = ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=ctx, **kw), device=dev)
        for q in prompts:
            eng.submit(Request(tokens=q, max_new_tokens=n_new))
        build.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        prof = None
        with moe_calls(annotate=True) as seen:
            while eng.has_work:
                all_gen = not eng.scheduler.queue and all(s.state == GENERATE for s in eng.slots)
                if prof is None and all_gen and eng.step_count >= 2:
                    wall, busy, ours, delta, n_ev, moe_ms, _, _ = profiled_step(eng, moe=True)
                    if delta != wants[name]:
                        raise AssertionError(f"12b {name}: a step with every slot generating "
                                             f"launched {delta}, want {wants[name]}")
                    if busy > 0.0:
                        check_profiled_kernels(f"12b {name}", ours, delta)
                        prof = dict(wall=wall, busy=busy, kernels=sorted(ours), n=n_ev,
                                    delta=delta, step=eng.step_count, moe=moe_ms)
                else:
                    eng.step()
            torch.cuda.synchronize()
        counts[name] = build.launch_counts()
        s = eng.stats()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        out[name] = _streams(eng.finished)
        if len(out[name]) != B or any(not o.ok or len(o.tokens) != n_new for o in eng.finished):
            raise AssertionError(f"12b {name}: not every request finished with {n_new} tokens")
        want_s = {u: t[:n_new] for u, t in out["paged+prefix"].items()}
        if out[name] != want_s:
            raise AssertionError(f"12b {name}: streams differ from the paged + prefix engine's "
                                 f"for {[u for u in want_s if out[name][u] != want_s[u]]}")
        drop_p, drop_d = moe_mean(seen, "moe/drop_frac", True), moe_mean(seen, "moe/drop_frac",
                                                                          False)
        unit = "round" if "speculate" in kw else "step"
        spec = (f"; {s['speculative_rounds']:.0f} rounds, accept rate "
                f"{s['speculative_accept_rate']:.3f}, {s['speculative_tokens_per_round']:.3f} "
                f"tokens a round" if "speculate" in kw else "")
        busy_note = ("busy: torch.profiler recorded no device time; not measured" if prof is None
                     else f"profiled {unit} (engine step {prof['step']}): wall {prof['wall']:.2f} "
                          f"ms, device busy {prof['busy']:.2f} ms (inside moe_mlp: GEMMs "
                          f"{prof['moe']['gemm']:.2f}, other torch ops {prof['moe']['other']:.2f}),"
                          f" idle share {1 - prof['busy'] / prof['wall']:.3f}, {prof['n']} device "
                          f"records")
        log(f"[moe] 12b {name}: {s['generated_tokens']:.0f} tokens in {s['wall_s']:.2f}s = "
            f"{s['tokens_per_s']:.1f} tok/s; prefill "
            f"{1e3 * s['prefill_s'] / max(1, s['prefills']):.1f} ms per prompt ({s['prefills']:.0f}), "
            f"decode {1e3 * s['decode_s'] / max(1, s['decode_steps']):.2f} ms wall per {unit} "
            f"({s['decode_steps']:.0f}){spec}; {busy_note}; peak memory {peak:.2f} GiB; kv_bytes "
            f"{s['kv_bytes'] / 2**20:.1f} MiB; mean moe/drop_frac {drop_p:.4f} over "
            f"{sum(1 for b, S, _ in seen if S > 1)} prefill MoE calls, {drop_d:.4f} over "
            f"{sum(1 for b, S, _ in seen if S == 1 and b > 0)} decode ones; streams equal the "
            f"paged + prefix engine's")
        log(f"[moe]   launches: {json.dumps({k: v for k, v in counts[name].items() if v})}; a "
            f"profiled {unit}: {json.dumps(wants[name])} by counter"
            + ("" if prof is None else f", kernels of csrc by torch.profiler: "
                                       f"{', '.join(prof['kernels'])}"))
    del params, warm, eng
    torch.cuda.empty_cache()
    return counts


def serve_imode(dev):
    """(c) phi3.5-moe-imode (integrated MoDE: 16 experts top-2 plus 4 no-op
    experts) at full width, MOE_IMODE's 4 of its 32 layers, bf16, seed 0:
    the padded engine prefills 4 prompts and runs 16 decode steps (one
    profiled with every slot generating). Prints the no-op fraction of the
    prefill and decode MoE calls and the busy time a step."""
    from repro_torch.config import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.serve.scheduler import GENERATE

    m = MOE_IMODE
    cfg = dataclasses.replace(get_config("phi3.5-moe-imode"), n_layers=m["layers"])
    params = api.init_model(cfg, device=dev, seed=0)
    lens = m["prompts"]
    toks = SyntheticLM(cfg.vocab, max(lens), seed=21).batch(0, len(lens))["tokens"]
    eng = ServingEngine(params, cfg, EngineConfig(batch_size=len(lens),
                                                  ctx=max(lens) + m["decode"] + 1), device=dev)
    for i, n in enumerate(lens):
        eng.submit(Request(tokens=toks[i, :n], max_new_tokens=m["decode"] + 1))
    build.reset_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    with moe_calls(annotate=True) as seen:
        while eng.has_work:
            if prof is None and eng.step_count >= 2 and all(s.state == GENERATE
                                                              for s in eng.slots):
                wall, busy, ours, delta, n_ev, moe_ms, _, _ = profiled_step(eng, moe=True)
                if delta != {"flash_attention": cfg.n_layers}:
                    raise AssertionError(f"12c: a decode step launched {delta}, want "
                                         f"{cfg.n_layers} flash_attention")
                if busy > 0.0:
                    check_profiled_kernels("12c", ours, delta)
                    prof = dict(wall=wall, busy=busy, n=n_ev, moe=moe_ms)
            else:
                eng.step()
        torch.cuda.synchronize()
    s = eng.stats()
    if any(not o.ok or len(o.tokens) != m["decode"] + 1 for o in eng.finished):
        raise AssertionError("12c: not every request finished")
    counts = build.launch_counts()
    noop_p, noop_d = moe_mean(seen, "moe/noop_frac", True), moe_mean(seen, "moe/noop_frac", False)
    drop_p = moe_mean(seen, "moe/drop_frac", True)
    if not (0.0 < noop_p < 1.0 and 0.0 < noop_d < 1.0):
        raise AssertionError(f"12c: no-op fractions {noop_p}, {noop_d}")
    busy_note = ("busy: torch.profiler recorded no device time; not measured" if prof is None
                 else f"profiled decode step: wall {prof['wall']:.2f} ms, device busy "
                      f"{prof['busy']:.2f} ms (inside moe_mlp: GEMMs {prof['moe']['gemm']:.2f}, "
                      f"other torch ops {prof['moe']['other']:.2f}), idle share "
                      f"{1 - prof['busy'] / prof['wall']:.3f}")
    log(f"[moe] 12c phi3.5-moe-imode integrated MoDE ({cfg.moe.n_experts} experts + "
        f"{cfg.moe.n_noop_experts} no-op, top-{cfg.moe.top_k}), d_model {cfg.d_model}, "
        f"{cfg.n_layers} of 32 layers, bf16: prompts {list(lens)}, {s['decode_steps']:.0f} decode "
        f"steps; mean moe/noop_frac {noop_p:.4f} (prefill) / {noop_d:.4f} (decode), "
        f"moe/drop_frac {drop_p:.4f} (prefill); prefill "
        f"{1e3 * s['prefill_s'] / max(1, s['prefills']):.1f} ms per prompt, decode "
        f"{1e3 * s['decode_s'] / max(1, s['decode_steps']):.2f} ms wall per step; {busy_note}; "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    del params, eng
    torch.cuda.empty_cache()
    return counts


def moe_range_ms(prof) -> dict:
    """Device ms of the kernels inside the ``moe_mlp`` ranges of a profile
    taken with host activity (the forward and its recompute; the backward
    runs on autograd's thread, outside them), split into GEMMs and the
    rest. A range's device annotation spans the kernels launched inside it
    on the card (one stream: in order), so a kernel counts where it lies
    within one."""
    spans = device_spans(prof)
    ranges = [(start, end) for name, start, end in spans if name == "moe_mlp"]
    out = {"gemm": 0.0, "other": 0.0}
    for name, start, end in spans:
        if name != "moe_mlp" and any(a <= start and end <= b for a, b in ranges):
            grp = "gemm" if _kernel_group(name) == "library GEMM (cuBLAS)" else "other"
            out[grp] += (end - start) / 1e3
    return out


def train_moe(dev):
    """(d) olmoe-1b-7b at full width, MOE_TRAIN's 4 of its 16 layers (2 full
    and 2 routed MoE layers; the whole depth's f32 AdamW moments do not fit
    on one card), pallas_fused, B=2, S=2048, 3 steps from seed 0 (lr 1e-4
    after 2 warmup steps): finite losses; per step the busy ms by kernel
    group, of which the MoE's own forward ops, and the launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import OptimConfig, TrainConfig, get_config, with_mod_backend
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models.moe import expert_capacity
    from repro_torch.train import Trainer

    m = MOE_TRAIN
    B, S, steps = m["B"], m["S"], m["steps"]
    cfg = with_mod_backend(dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=m["layers"]),
                           "pallas_fused")
    tcfg = TrainConfig(global_batch=B, seq_len=S,
                       optim=OptimConfig(lr=1e-4, warmup_steps=2, total_steps=steps),
                       log_every=1, ckpt_every=10**9)
    losses, busies = [], []
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(cfg, tcfg, ShardedLoader(SyntheticLM(cfg.vocab, S, seed=0), B, dev),
                          ckpt=CheckpointManager(ckdir), device=dev, log_fn=lambda msg: None)
        state = trainer.init_or_resume()
        torch.cuda.synchronize()
        log(f"[moe] 12d {cfg.name} training: {cfg.n_params() / 1e9:.3f}B params, {cfg.n_layers} "
            f"of 16 layers (depth cut: the full 16 layers' bf16 params and grads and f32 AdamW "
            f"moments need ~83 GB), full width, {cfg.mod.backend}, B={B} S={S}, MoE capacity "
            f"{cfg.moe.capacity_factor} x S x top_k / E (full layers C="
            f"{expert_capacity(S, cfg)}, routed layers k={cfg.mod.capacity(S)} rows, C="
            f"{expert_capacity(cfg.mod.capacity(S), cfg)})")
        torch.cuda.reset_peak_memory_stats(dev)
        build.reset_counters()
        with moe_calls(annotate=True) as seen:
            for i in range(steps):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    state, mt = trainer.run(state, 1)
                by_name: dict = {}
                for kname, us in device_records(prof, skip=("moe_mlp",)):
                    by_name[kname] = by_name.get(kname, 0.0) + us / 1e3
                busy = sum(by_name.values())
                groups: dict = {}
                for n, t in by_name.items():
                    groups[_kernel_group(n)] = groups.get(_kernel_group(n), 0.0) + t
                try:
                    moe_ms = moe_range_ms(prof)
                    moe_note = (f"of which inside moe_mlp's forward ranges (forward and remat "
                                f"recompute): GEMMs {moe_ms['gemm']:.1f}, other torch ops "
                                f"{moe_ms['other']:.1f} ms")
                except AttributeError as err:
                    moe_note = f"moe_mlp ranges: not measured ({err})"
                wall = 1e3 * trainer.heartbeats[-1][1]
                losses.append(mt["loss"])
                busies.append(busy)
                aux = {k: round(v, 4) for k, v in mt.items() if "moe/" in k}
                log(f"[moe] 12d step {i + 1}: loss {mt['loss']:.4f} ce {mt['ce']:.4f} grad norm "
                    f"{mt['grad_norm']:.3f}; wall {wall:.1f} ms, device busy {busy:.1f} ms, idle "
                    f"share {1 - busy / wall:.3f}; moe aux {json.dumps(aux)}")
                log("[moe]   device ms by group: " + "; ".join(
                    f"{g} {t:.1f}" for g, t in sorted(groups.items(), key=lambda kv: -kv[1]))
                    + f"; {moe_note}")
        counts = build.launch_counts()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"12d: non-finite training loss: {losses}")
    for name in ("routed_attention", "scatter_add_rows", "flash_attention"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"12d: {name} was not launched on the MoE training path")
    if counts.get("routed_mlp_scatter", 0):
        raise AssertionError("12d: routed_mlp_scatter ran in an MoE model")
    log(f"[moe] 12d losses {', '.join(f'{x:.4f}' for x in losses)}; device busy "
        f"{', '.join(f'{b:.1f}' for b in busies)} ms; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB; {len(seen)} moe_mlp calls; "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
    torch.cuda.empty_cache()
    return counts


def moe_phase(dev) -> dict:
    """Phase 12 in order; the launch counts by path."""
    serve, imode, train = timed_parts("12", (("a", moe_parity, dev), ("b", serve_moe_1b, dev),
                                             ("c", serve_imode, dev), ("d", train_moe, dev)))[1:]
    return {"moe_serve": serve["paged+prefix"], "moe_serve_ragged": serve["ragged"],
            "moe_spec": serve["speculative fused"], "moe_imode": imode, "moe_train": train}


# ---------------------------------------------------------------------------
# Phase 14: the further dense configs and the Zamba2 hybrid
# ---------------------------------------------------------------------------

CONFIGS_DENSE = ("granite-8b", "granite-20b", "mistral-nemo-12b", "qwen2-7b")
# 14c serves each at full width and CONFIGS_DENSE_LAYERS of its layers
# (whole, they took 82-127 s of a script that then ran 802-938 s on slow
# H100 hosts with phase 18; half their layers took 54-59 s)
CONFIGS_DENSE_LAYERS = 8
CONFIGS_HYBRID = "zamba2-2.7b"
# 14a: each config's smoke size with what sets it apart kept (the CPU tests'
# reduced configs): GQA with a group of 4, MQA with 48 query heads, d_model
# 160 against nq*hd 128, a group of 7 with non-zero q/k/v biases, and the
# hybrid at the smoke head dim and at its own 80; f32, CPU against the card
CONFIGS_REDUCED = {
    "granite-8b": ("granite-8b", dict(n_heads=8, n_kv_heads=2)),
    "granite-20b": ("granite-20b", dict(n_heads=48, n_kv_heads=1)),
    "mistral-nemo-12b": ("mistral-nemo-12b", dict(n_heads=4, n_kv_heads=2, d_model=160)),
    "qwen2-7b": ("qwen2-7b", dict(n_heads=14, n_kv_heads=2)),
    "zamba2-2.7b hd32": ("zamba2-2.7b", {}),
    "zamba2-2.7b hd80": ("zamba2-2.7b", dict(head_dim=80)),
}
CONFIGS_TOL = 1e-4  # 14a: f32 logits, CPU against the card, of the largest |value|
# 14b: the kernels at the shapes the new configs give them
CONFIGS_ROUTED = {  # (D, nq, nkv, d_ff, biases), k = 128 routed rows of S = 1024
    "mistral-nemo-12b": (5120, 32, 8, 14336, False),
    "qwen2-7b": (3584, 28, 4, 18944, True),
    "granite-20b": (6144, 48, 1, 24576, False),
}
ZAMBA2_SSD = (1, 80, 16, 128, 64, 64)  # B, H, NC, Q, hd, ds of the forward at S = 2048
# 14d: zamba2-2.7b at full width, HYBRID_LAYERS of its 54 layers (1 of its
# 9 segments, one shared-block site: the whole model took 134-180 s of the
# script's 1200, and phases 15-18 come after it; 18 layers took 42-82 s
# and 12 layers 40-45 s, the script 802-938 s on slow hosts once phase 18
# was added; 18a serves 3 sites, 18b trains all 54 layers): phase 9d's prompts (16 of 32-128
# drawn tokens: 35-124), 8 slots, 32 new tokens, on the contiguous and the
# paged pool; the fcfs policy admits every free slot (mod_aware admits
# round(0.125 * 8) = 1 stepped prompt at a time: ~1400 steps of the whole
# model where fcfs takes ~300); then one teacher-forced forward
HYBRID_LAYERS = 6
HYBRID_SERVE = dict(B=8, requests=16, lo=32, hi=128, gen=32, page=16)
HYBRID_FWD = dict(B=1, S=2048)


def release_device_memory(dev) -> None:
    """What the allocator holds and no tensor uses goes back to the card,
    cuBLAS's per-stream workspaces included (as PyTorch's own leak check
    releases them); 14c and 14d's models need 15-56 GB each."""
    gc.collect()
    torch.cuda.synchronize(dev)
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def configs_reduced(label: str):
    """The port's config of a CONFIGS_REDUCED entry, f32, backend pallas."""
    from repro_torch.config import get_config, smoke_config, with_mod_backend

    arch, kw = CONFIGS_REDUCED[label]
    kw = dict(kw)
    cfg = smoke_config(get_config(arch))
    d_model = kw.pop("d_model", cfg.d_model)
    return with_mod_backend(dataclasses.replace(
        cfg, dtype="float32", d_model=d_model, attn=dataclasses.replace(cfg.attn, **kw)), "pallas")


def draw_biases(tree, g) -> None:
    """Every attention block's q/k/v biases drawn non-zero, in place (the
    model's init zeroes them)."""
    if isinstance(tree, dict):
        for key, v in tree.items():
            if key in ("bq", "bk", "bv"):
                v.copy_(0.5 * torch.randn(v.shape, generator=g))
            else:
                draw_biases(v, g)
    elif isinstance(tree, list):
        for v in tree:
            draw_biases(v, g)


def distinct_prompts(vocab: int, n: int, prefix: int, lo: int, hi: int, seed: int):
    """n prompts of a shared ``prefix`` and lo..hi more tokens, no token
    twice in a prompt (a repeated token can tie a routed layer's top-k
    within an ulp)."""
    rng = np.random.default_rng(seed)
    pool = rng.permutation(vocab)
    shared, rest = pool[:prefix], pool[prefix:]
    return [np.concatenate([shared, rng.choice(rest, int(m), replace=False)]).astype(np.int32)
            for m in rng.integers(lo, hi + 1, n)]


def configs_parity(dev):
    """14a: CONFIGS_REDUCED in f32, the same weights on the CPU (plain
    versions) and on the card (kernels): the forward's logits within
    CONFIGS_TOL of their largest and its routed masks equal; greedy streams
    equal on both devices, of the paged + prefix and ragged engines for the
    dense configs (4 slots, page 16, chunk 32, 5 requests sharing a
    48-token prefix, 8 new tokens), of the stepped engine on the
    contiguous and the paged pool for the hybrid (4 slots, 5 prompts of
    16-40 tokens, 6 new tokens)."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    for label in CONFIGS_REDUCED:
        cfg = configs_reduced(label)
        p_cpu = api.init_model(cfg, device="cpu", seed=3)
        draw_biases(p_cpu, torch.Generator().manual_seed(4))
        p_gpu = _to(p_cpu, dev)
        toks = torch.as_tensor(SyntheticLM(cfg.vocab, 64, seed=13).batch(0, 2)["tokens"]).long()
        out = {}
        for name, params, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
            build.reset_counters()
            with torch.no_grad(), recorded_decisions("decide_tokens") as decisions:
                logits, _ = api.model_forward(params, cfg, {"tokens": toks.to(d)})
            out[name] = (logits.cpu(), [x.mask.cpu() for x in decisions],
                         {k: v for k, v in build.launch_counts().items() if v})
        (lc, mc, _), (lg, mg, counts) = out["cpu"], out["gpu"]
        diff, lim = (lc - lg).abs().max().item(), CONFIGS_TOL * lc.abs().max().item()
        same = len(mc) == len(mg) > 0 and all(torch.equal(a, b) for a, b in zip(mc, mg))
        want = {"flash_attention", "gather_rows", "scatter_add_rows"}
        if cfg.family == "hybrid":
            want.add("ssd_intra_chunk")
        if not (diff <= lim and same) or set(counts) != want:
            raise AssertionError(f"14a {label}: CPU and card differ (max|dlogit| {diff:.3g}, "
                                 f"limit {lim:.3g}; masks equal {same}) or the card launched "
                                 f"{counts}, want {sorted(want)}")
        if cfg.family == "hybrid":
            prompts = distinct_prompts(cfg.vocab, 5, 0, 16, 40, seed=9)
            engines = {"contiguous": dict(ctx=48), "paged": dict(ctx=48, page_size=16)}
            n_new = 6
        else:
            prompts = distinct_prompts(cfg.vocab, 5, 48, 4, 40, seed=6)
            engines = {"paged+prefix": dict(ctx=128, page_size=16, prefill_chunk=32,
                                            prefix_cache=True),
                       "ragged": dict(ctx=128, page_size=16, prefill_chunk=32, ragged=True,
                                      ragged_segments=4)}
            n_new = 8
        streams = {}
        for name, kw in engines.items():
            got = {}
            for side, d, params in (("cpu", "cpu", p_cpu), ("gpu", dev, p_gpu)):
                eng = ServingEngine(params, cfg, EngineConfig(batch_size=4, **kw), device=d)
                got[side] = _streams(eng.run_stream(
                    [Request(tokens=p, max_new_tokens=n_new) for p in prompts], 0))
            sc, sg = got["cpu"], got["gpu"]
            if sc != sg:
                raise AssertionError(f"14a {label} {name}: CPU and card streams differ for "
                                     f"{[u for u in sc if sc[u] != sg[u]]}")
            streams[name] = sg
        a = cfg.attn
        log(f"[configs] 14a {label} f32 (d_model {cfg.d_model}, {a.n_heads}/{a.n_kv_heads} heads "
            f"of {cfg.head_dim}, bias {a.qkv_bias}, rope θ {a.rope_theta:g}): CPU == card logits "
            f"max|d| {diff:.3g} (limit {lim:.3g}), {len(mg)} routed masks equal; card launches "
            f"{json.dumps(counts)}; greedy streams equal on both devices in "
            + ", ".join(f"{n} ({sum(len(t) for t in s.values())} tokens)"
                        for n, s in streams.items()))


def configs_kernels(dev, results) -> None:
    """14b: flash attention at head dim 80 (f32 and bf16 prefill S=1000 with
    32 heads; decode B=8 over 9 key chunks and in one; bf16 B=1 S=2048, the
    hybrid's forward) and at the dense configs' decode shapes (granite-20b's
    MQA 48/1, qwen2's 28/4 and its 4-token speculative window, B=8 ctx
    1056); routed_attention and routed_mlp_scatter at mistral-nemo's,
    qwen2's (biases) and granite-20b's widths (k=128 of S=1024); the SSD
    kernel at zamba2's forward shape. Each against its plain version, its
    plan or GEMM path held, timed by CUDA-graph replay beside its bound and
    (flash) SDPA."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import swiglu as SW

    g = torch.Generator(device=dev).manual_seed(41)
    i32 = dict(dtype=torch.int32, device=dev)
    both, bf = (torch.bfloat16, torch.float32), (torch.bfloat16,)

    def decode_pos(B, ctx):
        lens = torch.randint(128, ctx + 1, (B,), generator=g, device=dev)
        kv = torch.arange(ctx, **i32)[None].repeat(B, 1)
        kv = torch.where(kv < lens[:, None], kv, torch.full_like(kv, -1))
        return (lens - 1)[:, None].int(), kv

    cases = []
    pos = torch.arange(1000, **i32)[None]
    cases.append((FlashCase("hd80 prefill S=1000", 1, 1000, 1000, 32, 32, 80, pos, pos, both),
                  "mma_sync"))
    pos = torch.arange(2048, **i32)[None]
    cases.append((FlashCase("hd80 forward S=2048", 1, 2048, 2048, 32, 32, 80, pos, pos, bf),
                  "mma_sync"))
    qp, kvp = decode_pos(8, 1056)
    cases.append((FlashCase("hd80 decode B=8 ctx=1056", 8, 1, 1056, 32, 32, 80, qp, kvp, both),
                  "decode"))
    kvp = torch.arange(100, **i32)[None].repeat(8, 1)
    cases.append((FlashCase("hd80 decode B=8 ctx=100", 8, 1, 100, 32, 32, 80,
                            torch.full((8, 1), 99, **i32), kvp, bf), "decode"))
    qp, kvp = decode_pos(8, 1056)
    cases.append((FlashCase("mqa decode B=8 ctx=1056", 8, 1, 1056, 48, 1, 128, qp, kvp, bf),
                  "wgmma"))
    cases.append((FlashCase("group7 decode B=8 ctx=1056", 8, 1, 1056, 28, 4, 128, qp, kvp, bf),
                  "decode"))
    qw = torch.cat([qp - 3, qp - 2, qp - 1, qp], dim=1)  # the window's 4 positions
    cases.append((FlashCase("group7 window=4 B=8 ctx=1056", 8, 4, 1056, 28, 4, 128, qw, kvp,
                            bf), "wgmma"))
    for c, path in cases:
        for dtype in c.dtypes:
            plan = FA.flash_plan(c.B, c.Sq, c.Skv, c.nq, c.nkv, c.hd, dtype)
            want_path = "f32" if dtype == torch.float32 else path
            build.reset_counters()
            r = flash_row(FA, c, dtype, g)
            calls = dict(FA.FLASH_ATTENTION.by_call)
            key = (plan.path, c.B, c.Sq, c.Skv, c.nq, c.nkv, c.hd, plan.kernels)
            if plan.path != want_path or key not in calls:
                raise AssertionError(f"14b flash {c.label} {dtype}: plan {plan.path}, launched "
                                     f"{calls}, want the {want_path} path")
            r["path"], r["kernels"] = plan.path, plan.kernels
            r["plan"] = dict(path=plan.path, key_tile=plan.key_tile, key_split=plan.key_split,
                             chunk=plan.chunk, n_splits=plan.n_splits, merge=plan.merge)
            log(f"[configs] 14b flash_attention {r['shape']:40s} {plan.path:8s} "
                f"kernels={plan.kernels} max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (SDPA) "
                f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]})")
            results.setdefault("flash_attention", {})[(c.label, dtype)] = r

    B, S, k = 1, 1024, 128
    for arch, (D, nq, nkv, F, bias) in CONFIGS_ROUTED.items():
        hd = 128
        spec = FA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, 0, 1e6, "rope", 1e-5)
        mspec = SW.RoutedMlpSpec("silu", 1e-5)
        for dtype in (torch.bfloat16, torch.float32):
            es = 2 if dtype == torch.bfloat16 else 4
            x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
            idx = torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values[None]
            pos = idx.to(torch.int32)
            ap = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
                  "wq": _w(g, dev, dtype, D, nq * hd), "wk": _w(g, dev, dtype, D, nkv * hd),
                  "wv": _w(g, dev, dtype, D, nkv * hd), "wo": _w(g, dev, dtype, nq * hd, D)}
            if bias:
                for key, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
                    ap[key] = (0.5 * torch.randn(n * hd, generator=g, device=dev)).to(dtype)
            build.reset_counters()
            a, h = FA.routed_attention(x, idx, pos, ap, spec)
            attn_path = FA.routed_attention_path(dtype, B, k, D, nq, nkv, hd, True)
            if build.COUNTERS["routed_attention"].by_call != {
                    (attn_path, B, S, k, D, nq, nkv, hd): 1}:
                raise AssertionError(f"14b routed_attention {arch} {dtype}: launched "
                                     f"{build.COUNTERS['routed_attention'].by_call}")
            wa, wh = FA.routed_attention_plain(x, idx, pos, ap, spec)
            for got, want in ((a, wa), (h, wh)):
                torch.testing.assert_close(got.float(), want.float(), **ROUTED_TOL[dtype])
            mp = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
                  "w_up": _w(g, dev, dtype, D, F), "w_down": _w(g, dev, dtype, F, D),
                  "w_gate": _w(g, dev, dtype, D, F)}
            gate = torch.randn(B, k, generator=g, device=dev)
            build.reset_counters()
            out = SW.routed_mlp_scatter(x, h, a, idx, gate, mp, mspec)
            mlp_path = SW.gemm_path(dtype, B * k, F, D, True)
            if build.COUNTERS["routed_mlp_scatter"].by_call != {(mlp_path, B, S, k, D, F): 1}:
                raise AssertionError(f"14b routed_mlp_scatter {arch} {dtype}: launched "
                                     f"{build.COUNTERS['routed_mlp_scatter'].by_call}")
            want = SW.routed_mlp_scatter_plain(x, h, a, idx, gate, mp, mspec)
            torch.testing.assert_close(out.float(), want.float(), **ROUTED_TOL[dtype])
            M = B * k
            attn_flops = 2.0 * M * D * (nq + 2 * nkv) * hd + 2.0 * M * nq * hd * D \
                + 4.0 * hd * nq * _causal_pairs(pos)
            attn_bytes = (3 * M * D + (2 * nq + 2 * nkv) * hd * D + D
                          + (nq + 2 * nkv) * hd * bias) * es + 12 * M
            mlp_flops, mlp_bytes = 6.0 * M * D * F, (2 * B * S * D + 2 * M * D + 3 * D * F + D) \
                * es + 12 * M
            shape = f"{arch} B={B} S={S} k={k} D={D} {str(dtype)[6:]}"
            ha, hm = {}, {}
            rows = {
                "routed_attention": dict(
                    ms=replay_ms(lambda: FA.routed_attention(x, idx, pos, ap, spec), ha, "ms",
                                 reps=5),
                    plain_ms=replay_ms(lambda: FA.routed_attention_plain(x, idx, pos, ap, spec),
                                       ha, "plain_ms", reps=5),
                    library_ms=None, bound=bound_ms(attn_bytes, attn_flops, dtype),
                    max_abs_err=max((a.float() - wa.float()).abs().max().item(),
                                    (h.float() - wh.float()).abs().max().item()),
                    shape=f"{shape} {nq}/{nkv}x{hd}{' bias' if bias else ''}", timed_by=ha,
                    gemm_path=attn_path),
                "routed_mlp_scatter": dict(
                    ms=replay_ms(lambda: SW.routed_mlp_scatter(x, h, a, idx, gate, mp, mspec),
                                 hm, "ms", reps=5),
                    plain_ms=replay_ms(lambda: SW.routed_mlp_scatter_plain(
                        x, h, a, idx, gate, mp, mspec), hm, "plain_ms", reps=5),
                    library_ms=replay_ms(lambda: routed_mlp_library(x, h, a, idx, gate, mp,
                                                                    mspec), hm, "library_ms",
                                         reps=5),
                    bound=bound_ms(mlp_bytes, mlp_flops, dtype),
                    max_abs_err=(out.float() - want.float()).abs().max().item(),
                    shape=f"{shape} F={F}", timed_by=hm, gemm_path=mlp_path),
            }
            for name, r in rows.items():
                lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
                log(f"[configs] 14b {name} {r['shape']} gemm={r['gemm_path']} "
                    f"max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                    f"plain_ms={r['plain_ms']:.4f} library_ms={lib} bound_ms="
                    f"{r['bound'][0]:.4f} ({r['bound'][1]}){timed_note(r['timed_by'])}")
                results.setdefault(name, {})[(arch, dtype)] = r
            del x, a, h, wa, wh, out, want, ap, mp

    r = ssd_row("[configs] 14b", "zamba2 forward", dev, ZAMBA2_SSD, 43)
    del r["call"]  # (its launches: phase 14d's forward, read by key)
    results.setdefault("ssd_intra_chunk", {})[("zamba2 forward", torch.bfloat16)] = r


def serve_dense_config(dev, arch: str) -> dict:
    """14c: one dense config at full width and CONFIGS_DENSE_LAYERS of its
    layers, bf16, random weights
    from seed 0, backend pallas, on PAGED_1B's workload through the paged +
    prefix and the ragged engine: streams equal, every request done with
    its 32 tokens, the prefix cache saving 7 x 512 prefill tokens; tok/s,
    prefill ms a prompt, decode wall and (one profiled step with every slot
    generating) busy ms, idle share, peak memory, ``kv_bytes``; the
    profiled step's launches held to its layers by counter and to
    torch.profiler's ``__global__`` names. Returns each run's launch counts
    and flash launches by call."""
    from repro_torch.config import get_config, with_mod_backend
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.serve.scheduler import GENERATE
    from repro_torch.utils import tree_leaves

    cfg = with_mod_backend(dataclasses.replace(get_config(arch), n_layers=CONFIGS_DENSE_LAYERS),
                           "pallas")
    release_device_memory(dev)
    t0 = time.perf_counter()
    params = api.init_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    w = PAGED_1B
    B, gen, pre, page, C = w["B"], w["gen"], w["prefix"], w["page"], w["chunk"]
    suffix, ctx, n_chunks = paged_1b_plan()
    toks = SyntheticLM(cfg.vocab, pre + w["max_suffix"], seed=9).batch(0, B)["tokens"]
    prompts = [np.concatenate([toks[0, :pre], toks[i, pre:pre + int(n)]])
               for i, n in enumerate(suffix)]
    n_full = sum(1 for grp in params["groups"] if "full" in grp)
    n_mod = sum(1 for grp in params["groups"] if "mod" in grp)
    a = cfg.attn
    log(f"[configs] 14c {arch}: {n_params / 1e9:.3f}B params in {cfg.dtype} ({n_full} full + "
        f"{n_mod} routed layers, d_model {cfg.d_model}, {a.n_heads}/{a.n_kv_heads} heads of "
        f"{cfg.head_dim}, bias {a.qkv_bias}, rope θ {a.rope_theta:g}, vocab {cfg.vocab}), init "
        f"{init_s:.1f}s")
    paged = dict(page_size=page, prefill_chunk=C)
    runs = {"paged+prefix": dict(paged, prefix_cache=True),
            "ragged": dict(paged, ragged=True, ragged_segments=n_chunks)}
    ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=ctx, **runs["ragged"]),
                  device=dev).run_stream([Request(tokens=prompts[0][:300], max_new_tokens=2)], 0)
    # a decode step with every slot generating: the paged gathers of the full
    # layers' K/V/pos, flash in every layer (the routed ones at kb = 1), the
    # write-back (paged, or ragged on the ragged engine)
    step_want = {"paged_gather": 3 * n_full, "flash_attention": n_full + n_mod}
    wants = {"paged+prefix": dict(step_want, paged_scatter_rows=3 * n_full),
             "ragged": dict(step_want, ragged_paged_scatter_rows=3 * n_full)}
    out, counts, stats, flash = {}, {}, {}, {}
    for name, kw in runs.items():
        eng = ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=ctx, **kw), device=dev)
        for q in prompts:
            eng.submit(Request(tokens=q, max_new_tokens=gen))
        build.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        prof = None
        while eng.has_work:
            all_gen = not eng.scheduler.queue and all(s.state == GENERATE for s in eng.slots)
            if prof is None and all_gen and eng.step_count >= 2:
                wall, busy, ours, delta, n_ev, _, _, groups = profiled_step(eng)
                if delta != wants[name]:
                    raise AssertionError(f"14c {arch} {name}: a step with every slot generating "
                                         f"launched {delta}, want {wants[name]}")
                if busy > 0.0:
                    check_profiled_kernels(f"14c {arch} {name}", ours, delta)
                    prof = dict(wall=wall, busy=busy, kernels=sorted(ours), step=eng.step_count,
                                groups=groups)
            else:
                eng.step()
        torch.cuda.synchronize()
        counts[name] = build.launch_counts()
        flash[name] = flash_calls()
        s = stats[name] = eng.stats()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        out[name] = _streams(eng.finished)
        if len(out[name]) != B or any(not o.ok or len(o.tokens) != gen for o in eng.finished):
            raise AssertionError(f"14c {arch} {name}: not every request finished with {gen} "
                                 f"tokens")
        busy_note = ("busy: torch.profiler recorded no device time; not measured" if prof is None
                     else f"profiled step {prof['step']}: wall {prof['wall']:.2f} ms, device busy "
                          f"{prof['busy']:.2f} ms, idle share {1 - prof['busy'] / prof['wall']:.3f}"
                          f" (" + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                              prof["groups"].items(), key=lambda kv: -kv[1])[:4]) + ")")
        log(f"[configs] 14c {arch} {name}: {s['generated_tokens']:.0f} tokens in "
            f"{s['wall_s']:.2f}s = {s['tokens_per_s']:.1f} tok/s; prefill "
            f"{1e3 * s['prefill_s'] / max(1, s['prefills']):.1f} ms per prompt "
            f"({s['prefills']:.0f}), decode {1e3 * s['decode_s'] / max(1, s['decode_steps']):.2f} "
            f"ms wall per step ({s['decode_steps']:.0f}); {busy_note}; peak memory {peak:.2f} GiB;"
            f" kv_bytes {s['kv_bytes'] / 2**20:.1f} MiB")
        log(f"[configs]   launches: {json.dumps({k: v for k, v in counts[name].items() if v})}")
    if out["ragged"] != out["paged+prefix"]:
        raise AssertionError(f"14c {arch}: the ragged engine's streams differ from the paged + "
                             f"prefix engine's")
    if stats["ragged"]["prefill_tokens_computed"] != sum(len(q) for q in prompts):
        raise AssertionError(f"14c {arch}: the ragged engine computed "
                             f"{stats['ragged']['prefill_tokens_computed']} prefill tokens")
    saved = stats["ragged"]["prefill_tokens_computed"] - \
        stats["paged+prefix"]["prefill_tokens_computed"]
    if saved != (B - 1) * pre:
        raise AssertionError(f"14c {arch}: the prefix cache saved {saved} prefill tokens, want "
                             f"{(B - 1) * pre}")
    log(f"[configs] 14c {arch}: both engines gave identical greedy streams ({B} requests x {gen} "
        f"tokens); the prefix cache saved {saved:.0f} prefill tokens")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ({f"configs_serve {arch}": counts["paged+prefix"],
             f"configs_serve_ragged {arch}": counts["ragged"]},
            {f"configs_serve {arch}": flash["paged+prefix"],
             f"configs_serve_ragged {arch}": flash["ragged"]})


def serve_both_pools(prefix, tag, params, cfg, dev, reqs_fn, B, ctx, page, step_want,
                     profile_after, note=""):
    """The stepped engine over ``reqs_fn()``'s requests on the contiguous and
    the paged pool: streams equal, every request done with its tokens; one
    profiled step (every slot live, after ``profile_after`` steps) with its
    launches held to ``step_want[pool]`` and to torch.profiler's names.
    ``prefix`` starts each log line, ``tag`` names the run in logs and
    errors, ``note`` describes the requests. Returns (launch counts, flash
    by call, the paged kernels' launches by call, streams) by pool."""
    from repro_torch.core.routing import batch_capacity_k
    from repro_torch.kernels import build
    from repro_torch.serve import EngineConfig, ServingEngine
    from repro_torch.serve.scheduler import FREE

    out, counts, flash, paged = {}, {}, {}, {}
    for pool, kw in (("contiguous", {}), ("paged", dict(page_size=page))):
        eng = ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=ctx, policy="fcfs",
                                                      **kw), device=dev)
        reqs = reqs_fn()
        for r in reqs:
            eng.submit(r)
        build.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        prof = None
        while eng.has_work:
            # a step with every slot live (ingesting or generating)
            if (prof is None and eng.step_count >= profile_after
                    and all(s.state != FREE for s in eng.slots)):
                wall, busy, ours, delta, _, _, _, groups = profiled_step(eng)
                if delta != step_want[pool]:
                    raise AssertionError(f"{tag} {pool}: a step launched {delta}, want "
                                         f"{step_want[pool]}")
                if busy > 0.0:
                    check_profiled_kernels(f"{tag} {pool}", ours, delta)
                    prof = dict(wall=wall, busy=busy, step=eng.step_count, groups=groups)
            else:
                eng.step()
        torch.cuda.synchronize()
        counts[pool] = build.launch_counts()
        flash[pool] = flash_calls()
        paged[pool] = {name: dict(build.COUNTERS[name].by_call)
                       for name in ("paged_gather", "paged_scatter_rows")}
        s = eng.stats()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        out[pool] = _streams(eng.finished)
        if len(out[pool]) != len(reqs) or any(
                not o.ok or len(o.tokens) != r.max_new_tokens
                for o, r in zip(sorted(eng.finished, key=lambda o: o.uid), reqs)):
            raise AssertionError(f"{tag} {pool}: not every request finished with its tokens")
        busy_note = ("busy: torch.profiler recorded no device time; not measured" if prof is None
                     else f"profiled step {prof['step']} ({B} live slots): wall "
                          f"{prof['wall']:.2f} ms, device busy {prof['busy']:.2f} ms, idle share "
                          f"{1 - prof['busy'] / prof['wall']:.3f} ("
                          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                              prof["groups"].items(), key=lambda kv: -kv[1])[:4]) + ")")
        pb = eng.pool.cache_bytes()
        log(f"{prefix} {tag} {pool} pool: {len(reqs)} requests{note}, {B} slots, policy fcfs: "
            f"{s['generated_tokens']:.0f} tokens in {s['wall_s']:.2f}s = {s['tokens_per_s']:.1f} "
            f"tok/s; {s['steps']:.0f} engine steps, "
            f"{1e3 * s['decode_s'] / max(1, s['decode_steps']):.2f} ms wall a step; mean "
            f"occupancy {s['mean_occupancy']:.2f}; routed fraction {s['mean_routed_frac']:.4f} "
            f"(kb/B = {batch_capacity_k(cfg, B)}/{B}); {busy_note}; pool "
            f"{pb['total'] / 2**20:.1f} MiB (kv_bytes {s['kv_bytes'] / 2**20:.1f}, residual "
            f"{pb['resid_bytes'] / 2**20:.1f}); peak memory {peak:.2f} GiB")
        log(f"{prefix}   launches: {json.dumps({k: v for k, v in counts[pool].items() if v})}")
    if out["paged"] != out["contiguous"]:
        raise AssertionError(f"{tag}: the paged pool's streams differ from the contiguous pool's")
    log(f"{prefix} {tag}: the contiguous and the paged pool gave identical greedy streams")
    return counts, flash, paged, out


def hybrid_requests(cfg, n: int) -> list:
    """The first ``n`` of 14d's HYBRID_SERVE requests: prompt lengths drawn
    from seed 1, tokens from the synthetic corpus at seed 7, ``gen`` new
    tokens each."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serve import Request

    w = HYBRID_SERVE
    lens = np.random.default_rng(1).integers(w["lo"], w["hi"] + 1, w["requests"])
    toks = SyntheticLM(cfg.vocab, w["hi"], seed=7).batch(0, w["requests"])["tokens"]
    return [Request(tokens=toks[i, :lens[i]], max_new_tokens=w["gen"]) for i in range(n)]


def serve_hybrid(dev) -> dict:
    """14d: zamba2-2.7b at full width, HYBRID_LAYERS of its layers, bf16,
    random weights from seed 0: HYBRID_SERVE's requests through the stepped engine on the
    contiguous and the paged pool (streams equal, every request done with
    its tokens; a profiled decode step's launches held to the model's
    layers), then one teacher-forced forward and its loss at B=1, S=2048
    (flash at head dim 80 on mma.sync tiles, the SSD kernel at d_state 64).
    Returns each run's launch counts, flash launches by call, and the
    forward's SSD launches by call."""
    from repro_torch.config import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.utils import tree_leaves

    cfg = dataclasses.replace(get_config(CONFIGS_HYBRID), n_layers=HYBRID_LAYERS)
    release_device_memory(dev)
    t0 = time.perf_counter()
    params = api.init_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_seg = len(params["groups"])
    n_pairs = len(params["groups"][0])
    log(f"[configs] 14d {cfg.name} at {cfg.n_layers} of 54 layers: {n_params / 1e9:.3f}B params "
        f"in {cfg.dtype}, {n_seg} segments"
        f" of {n_pairs} {{full, mod}} Mamba2 pairs, one shared attention block ({cfg.attn.n_heads}"
        f" heads of {cfg.head_dim}), d_state {cfg.ssm.d_state}; init "
        f"{time.perf_counter() - t0:.1f}s")
    w = HYBRID_SERVE
    B, n_req, gen, hi = w["B"], w["requests"], w["gen"], w["hi"]
    reqs = partial(hybrid_requests, cfg, n_req)
    lens = np.asarray([len(r.tokens) for r in reqs()])
    ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=hi + gen, policy="fcfs"),
                  device=dev).run_stream([Request(tokens=r.tokens[:4], max_new_tokens=2)
                                          for r in reqs()[:2]], 0)
    # a decode step: flash at every segment's shared block, the routed SSD
    # layers' batch rows by torch index ops (no dispatch kernel); on the
    # paged pool the shared block's K/V/pos rings gathered and written back
    step_want = {"contiguous": {"flash_attention": n_seg},
                 "paged": {"flash_attention": n_seg, "paged_gather": 3 * n_seg,
                           "paged_scatter_rows": 3 * n_seg}}
    counts, flash, _, _ = serve_both_pools(
        "[configs]", "14d", params, cfg, dev, reqs, B, hi + gen, w["page"], step_want,
        profile_after=20, note=f" (prompts {lens.min()}-{lens.max()} tokens, {gen} new each)")
    Bf, S = HYBRID_FWD["B"], HYBRID_FWD["S"]
    batch = {k: torch.as_tensor(v).long().to(dev)
             for k, v in SyntheticLM(cfg.vocab, S, seed=31).batch(0, Bf).items()}
    build.reset_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        loss, aux = api.model_loss(params, cfg, batch)
        torch.cuda.synchronize()
        fwd = build.launch_counts()
        flash_fwd = flash_calls()
        ssd_calls = dict(build.COUNTERS["ssd_intra_chunk"].by_call)
        try:
            wall, busy, top = profile_call(lambda: api.model_loss(params, cfg, batch), iters=2,
                                           warmup=1)
            timing = (f"wall {wall:.2f} ms, device busy {busy:.2f} ms; top kernels: "
                      + "; ".join(f"{n[:50]} {t:.3f}" for n, t in top))
        except NoDeviceTime:
            timing = "torch.profiler recorded no device time; not measured"
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    want_flash = {("mma_sync", Bf, S, S, cfg.attn.n_heads, cfg.attn.n_kv_heads, 80, 1): n_seg}
    if not torch.isfinite(loss) or flash_fwd != want_flash or not ssd_calls or any(
            k[0] != "tensor" or k[6] != 64 for k in ssd_calls):
        raise AssertionError(f"14d forward: loss {float(loss)}, flash {flash_fwd} (want "
                             f"{want_flash}), ssd {ssd_calls}")
    log(f"[configs] 14d teacher-forced forward B={Bf} S={S}: loss {float(loss):.6f} (ce "
        f"{float(aux['ce']):.6f}, finite); flash calls "
        f"{json.dumps([list(k) + [n] for k, n in flash_fwd.items()])}; "
        f"ssd calls {json.dumps([list(k) + [n] for k, n in ssd_calls.items()])}; peak memory "
        f"{peak:.2f} GiB; {timing}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ({"configs_hybrid_serve": counts["contiguous"],
             "configs_hybrid_serve_paged": counts["paged"], "configs_hybrid_forward": fwd},
            {"configs_hybrid_serve": flash["contiguous"], "configs_hybrid_serve_paged":
             flash["paged"], "configs_hybrid_forward": flash_fwd}, ssd_calls)


def configs_phase(dev, results):
    """Phase 14 in order. Returns the launch counts by path, flash's
    launches by call by path, and the hybrid forward's SSD launches by
    call."""
    t = time.perf_counter()
    before = torch.cuda.memory_reserved(dev) / 2**30
    release_device_memory(dev)
    log(f"[configs] device memory at the start: {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved "
        f"({before:.2f} before the release; PYTORCH_CUDA_ALLOC_CONF="
        f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '')})")
    configs_parity(dev)
    t14a = time.perf_counter() - t
    configs_kernels(dev, results)
    t14b = time.perf_counter() - t - t14a
    counts: dict = {}
    flash: dict = {}
    for arch in CONFIGS_DENSE:
        c, f = serve_dense_config(dev, arch)
        counts.update(c)
        flash.update(f)
    t14c = time.perf_counter() - t - t14a - t14b
    c, f, ssd_calls = serve_hybrid(dev)
    counts.update(c)
    flash.update(f)
    log(f"[time] 14a {t14a:.1f}s, 14b {t14b:.1f}s, 14c {t14c:.1f}s, 14d "
        f"{time.perf_counter() - t - t14a - t14b - t14c:.1f}s")
    return counts, flash, ssd_calls


# ---------------------------------------------------------------------------
# Phase 15: the enc-dec family (whisper-tiny) and the VLM backbone (qwen2-vl-7b)
# ---------------------------------------------------------------------------

ENCDEC_ARCH, VLM_ARCH = "whisper-tiny", "qwen2-vl-7b"
ENCDEC_VLM_TOL = 1e-4  # 15a: f32 logits, CPU against the card, of the largest |value|
# 15a: the smoke configs' image layout (text, 3 x 4 merged patches, text)
VLM_SMOKE_LAYOUT = [("text", 5), ("image", (3, 4)), ("text", 7)]
# 15b: whisper-tiny at full size: 3 training steps, then 8 slots serving 16
# requests (a prompt of 4 tokens, 64 new, frames of their own) on both pools
WHISPER_TRAIN = dict(B=8, S=448, steps=3)
WHISPER_SERVE = dict(B=8, requests=16, prompt=4, gen=64, page=16)
# 15c: qwen2-vl-7b at full width and depth: one B=1 S=2048 forward over
# embeddings laid out as Qwen2-VL lays out an image of 24 x 40 merged
# patches between text, then 8 slots serving 8 text requests of 16-48
# tokens, 16 new, on both pools
VLM_LAYOUT = [("text", 64), ("image", (24, 40)), ("text", 2048 - 64 - 960)]
VLM_SERVE = dict(B=8, requests=8, lo=16, hi=48, gen=16, page=16)


def encdec_vlm_smoke(arch: str):
    """The port's smoke config of ``arch`` in f32, backend pallas."""
    from repro_torch.config import get_config, smoke_config, with_mod_backend

    return with_mod_backend(dataclasses.replace(smoke_config(get_config(arch)),
                                                dtype="float32"), "pallas")


def _family_batch(cfg, B: int, S: int, seed: int, dev, layout=None) -> dict:
    """A training batch of ``cfg``'s family from ``seed``: labels, and the
    stub frontend's inputs (``api.stub_inputs``: frames for the enc-dec
    model beside its tokens, embeddings and M-RoPE positions for the VLM,
    laid out by ``layout`` when given)."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import api

    b = {k: torch.as_tensor(v).long().to(dev)
         for k, v in SyntheticLM(cfg.vocab, S, seed=seed).batch(0, B).items()}
    b.update(api.stub_inputs(cfg, B, S, seed=seed, device=dev))
    if cfg.family == "vlm":
        del b["tokens"]
        if layout is not None:
            pos = api.mrope_positions(layout, device=dev)
            b["positions"] = pos[:, None].expand(3, B, pos.shape[1]).contiguous()
    return b


def encdec_vlm_parity(dev) -> None:
    """15a: whisper-tiny's and qwen2-vl-7b's smoke configs in f32, the same
    weights and inputs on the CPU (plain versions, one torch thread) and on
    the card (kernels): the forward's logits (the VLM over embeddings with
    an image's M-RoPE layout) within ENCDEC_VLM_TOL of their largest and its
    routed masks equal; one train step's loss within 1e-5 and gradient
    norm within 1e-4 relative; 8 decode steps' logits within the limit
    (whisper after ``prefill_cross``); greedy streams equal on both devices
    on the contiguous and the paged pool (5 requests, 4 slots)."""
    from repro_torch.config import OptimConfig, TrainConfig
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.models import encdec as ED
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.train.loop import make_train_state, make_train_step
    from repro_torch.utils import tree_map

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in (ENCDEC_ARCH, VLM_ARCH):
            cfg = encdec_vlm_smoke(arch)
            p_cpu = api.init_model(cfg, device="cpu", seed=3)
            draw_biases(p_cpu, torch.Generator().manual_seed(4))
            p_gpu = _to(p_cpu, dev)
            batch = _family_batch(cfg, 2, 24, 13, "cpu", VLM_SMOKE_LAYOUT)
            out = {}
            for name, params, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
                build.reset_counters()
                b = {k: v.to(d) for k, v in batch.items()}
                with torch.no_grad(), recorded_decisions("decide_tokens") as decisions:
                    logits, _ = api.model_forward(params, cfg, b)
                counts = {k: v for k, v in build.launch_counts().items() if v}
                tcfg = TrainConfig(global_batch=2, seq_len=24,
                                   optim=OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10))
                state = make_train_state(cfg, d, params=tree_map(
                    lambda t: t.detach().clone(), params))
                state["step"] = torch.ones((), dtype=torch.int32)
                _, metrics = make_train_step(cfg, tcfg)(state, b)
                out[name] = (logits.cpu(), [x.mask.cpu() for x in decisions], counts,
                             float(metrics["loss"]), float(metrics["grad_norm"]))
            (lc, mc, _, loss_c, gn_c), (lg, mg, counts, loss_g, gn_g) = out["cpu"], out["gpu"]
            diff, lim = (lc - lg).abs().max().item(), ENCDEC_VLM_TOL * lc.abs().max().item()
            same = len(mc) == len(mg) > 0 and all(torch.equal(a, b) for a, b in zip(mc, mg))
            dl, dn = abs(loss_c - loss_g) / abs(loss_c), abs(gn_c - gn_g) / gn_c
            want = {"flash_attention", "gather_rows", "scatter_add_rows"}
            if not (diff <= lim and same and dl <= 1e-5 and dn <= 1e-4) or set(counts) != want:
                raise AssertionError(f"15a {arch}: CPU and card differ (max|dlogit| {diff:.3g}, "
                                     f"limit {lim:.3g}; masks equal {same}; loss rel {dl:.3g}, "
                                     f"grad norm rel {dn:.3g}) or the card launched {counts}")
            # 8 decode steps, the same tokens on both devices
            B, ctx = 4, 32
            toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, (8, B)))
            worst = 0.0
            caches = {}
            for name, params, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
                c = api.make_caches(cfg, B, ctx, device=d)
                if cfg.family == "encdec":
                    c = ED.prefill_cross(params, c, _family_batch(cfg, B, 4, 17, d)["enc_emb"],
                                         cfg)
                caches[name] = c
            for i in range(8):
                step = {}
                for name, params, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
                    with torch.no_grad():
                        lg_, caches[name], _ = api.model_decode(
                            params, caches[name], cfg, toks[i][:, None].to(d),
                            torch.full((B,), i, dtype=torch.int32, device=d),
                            torch.ones(B, dtype=torch.bool, device=d))
                    step[name] = lg_.cpu()
                d_i = (step["cpu"] - step["gpu"]).abs().max().item()
                if d_i > ENCDEC_VLM_TOL * step["cpu"].abs().max().item():
                    raise AssertionError(f"15a {arch} decode step {i}: max|dlogit| {d_i:.3g}")
                worst = max(worst, d_i)
            streams = {}
            rng = np.random.default_rng(9)
            reqs = [(rng.choice(cfg.vocab, int(n), replace=False).astype(np.int32),
                     _family_batch(cfg, 1, 4, 40 + i, "cpu").get("enc_emb"))
                    for i, n in enumerate(rng.integers(6, 20, 5))]
            for pool, kw in (("contiguous", {}), ("paged", dict(page_size=16))):
                got = {}
                for side, d, params in (("cpu", "cpu", p_cpu), ("gpu", dev, p_gpu)):
                    eng = ServingEngine(params, cfg, EngineConfig(batch_size=4, ctx=32, **kw),
                                        device=d)
                    got[side] = _streams(eng.run_stream([
                        Request(tokens=t, max_new_tokens=6,
                                enc_emb=None if e is None else e[0]) for t, e in reqs], 0))
                if got["cpu"] != got["gpu"]:
                    raise AssertionError(f"15a {arch} {pool}: CPU and card streams differ for "
                                         f"{[u for u in got['cpu'] if got['cpu'][u] != got['gpu'][u]]}")
                streams[pool] = got["gpu"]
            log(f"[encdec-vlm] 15a {arch} f32 smoke: CPU == card logits max|d| {diff:.3g} "
                f"(limit {lim:.3g}), {len(mg)} routed masks equal; train step loss "
                f"{loss_g:.6f} (rel {dl:.3g}), grad norm {gn_g:.5f} (rel {dn:.3g}); 8 decode "
                f"steps max|dlogit| {worst:.3g}; card launches {json.dumps(counts)}; greedy "
                f"streams equal on both devices on "
                + ", ".join(f"{n} ({sum(len(t) for t in s.values())} tokens)"
                            for n, s in streams.items()))
    finally:
        torch.set_num_threads(threads)


def dispatch_rows(g, dev, dtype, B: int, S: int, D: int, k: int, zero: bool = False) -> dict:
    """gather_rows, scatter_add_rows and (with ``zero``) gather's VJP, the
    scatter's zero target, at (B, S, D, k): each bitwise against its plain
    version, then timed by CUDA-graph replay beside it, a library call
    (``take_along_dim`` and ``index_select`` on the flattened rows; the
    ``index_add`` of the gated update; ``zeros`` + ``index_add_``) and the
    byte bound. Returns {name: row}; a row's ``call`` keys it as the
    wrappers count their launches."""
    from repro_torch.kernels import routing as KR

    x, idx, delta, gate, flat = dispatch_inputs(g, dev, dtype, B, S, D, k)
    es = x.element_size()
    out, out2 = KR.gather_rows(x, idx), KR.scatter_add_rows(x, idx, delta, gate)
    if not (torch.equal(out, KR.gather_rows_plain(x, idx))
            and torch.equal(out2, KR.scatter_add_rows_plain(x, idx, delta, gate))):
        raise AssertionError(f"dispatch at B={B} S={S} D={D} k={k}: a kernel differs from its "
                             "plain version")
    xf = x.view(B * S, D)
    upd = (gate[..., None] * delta.float()).to(dtype).view(B * k, D)
    hg, hs = {}, {}
    rows = {
        "gather_rows": dict(
            ms=replay_ms(lambda: KR.gather_rows(x, idx), hg, "ms"),
            plain_ms=replay_ms(lambda: KR.gather_rows_plain(x, idx), hg, "plain_ms"),
            library_ms=replay_ms(lambda: torch.take_along_dim(x, idx[..., None], dim=1), hg,
                                 "library_ms"),
            index_select_ms=replay_ms(lambda: xf.index_select(0, flat), hg, "index_select_ms"),
            bound=bound_ms(2 * B * k * D * es + 8 * B * k, 0, dtype),
            plan=KR.dispatch_plan("gather", B, S, k, D * es, es, 8,
                                  (x.data_ptr(), out.data_ptr()))._asdict(),
            max_abs_err=0.0, timed_by=hg, call=("gather", B, S, k, D * es)),
        "scatter_add_rows": dict(
            ms=replay_ms(lambda: KR.scatter_add_rows(x, idx, delta, gate), hs, "ms"),
            plain_ms=replay_ms(lambda: KR.scatter_add_rows_plain(x, idx, delta, gate), hs,
                               "plain_ms"),
            library_ms=replay_ms(lambda: xf.index_add(0, flat, upd), hs, "library_ms"),
            bound=bound_ms(2 * B * S * D * es + B * k * D * es + 12 * B * k, 2 * B * k * D,
                           dtype),
            plan=KR.dispatch_plan("scatter", B, S, k, D * es, es, 8,
                                  (x.data_ptr(), delta.data_ptr(), out2.data_ptr()))._asdict(),
            max_abs_err=0.0, timed_by=hs, call=("scatter", B, S, k, D * es)),
    }
    if zero:
        ones = torch.ones(B, k, device=dev)
        z = KR.gather_rows_vjp(idx, delta, x.shape)
        if not torch.equal(z, KR.scatter_add_rows_plain(torch.zeros_like(x), idx, delta, ones)):
            raise AssertionError(f"gather_rows_vjp (the zero target) at B={B} S={S} D={D} k={k} "
                                 "differs from the plain scatter into zeros")
        hz: dict = {}
        rows["scatter_add_rows zero"] = dict(
            ms=replay_ms(lambda: KR.gather_rows_vjp(idx, delta, x.shape), hz, "ms"),
            plain_ms=replay_ms(lambda: KR.scatter_add_rows_plain(
                torch.zeros_like(x), idx, delta, ones), hz, "plain_ms"),
            library_ms=replay_ms(lambda: torch.zeros_like(xf).index_add_(
                0, flat, delta.view(B * k, D)), hz, "library_ms"),
            library="zeros + index_add_ (two calls)",
            bound=bound_ms(B * S * D * es + B * k * D * es + 8 * B * k, 2 * B * k * D, dtype),
            plan=KR.dispatch_plan("scatter_zero", B, S, k, D * es, es, 8,
                                  (delta.data_ptr(), z.data_ptr()))._asdict(),
            max_abs_err=0.0, timed_by=hz, call=("scatter_zero", B, S, k, D * es))
    return rows


def log_dispatch_rows(prefix: str, label: str, rows: dict, dtype, results) -> None:
    """Logs :func:`dispatch_rows`'s rows and files them in ``results`` under
    (label, dtype) (a zero-target row under ("zero " + label, dtype))."""
    for name, r in rows.items():
        kernel, _, zero = name.partition(" ")
        r["shape"] = f"{zero} {label} k={r['call'][3]} {str(dtype)[6:]}".strip()
        extra = f" index_select_ms={r['index_select_ms']:.4f}" if "index_select_ms" in r else ""
        log(f"{prefix} {name:22s} {r['shape']} bitwise-equal ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}{extra} "
            f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}, {r['bound'][0] / r['ms']:.0%} of it) "
            f"{plan_note(r['plan'])}{timed_note(r['timed_by'])}")
        results.setdefault(kernel, {})[(f"{zero} {label}".strip(), dtype)] = r


def paged_rows(prefix: str, label: str, g, dev, dtype, F: int, lens, gen: int, P: int, p: int,
               gather: bool = True) -> dict:
    """paged_gather (with ``gather``) and paged_scatter_rows on a pool as an
    engine's decode step over prompts of ``lens`` tokens gives them
    (:func:`_paged_inputs`): bitwise against their plain versions, the
    scatter writing no row outside its targets, the plans launched; each
    timed by CUDA-graph replay beside its plain version, the library call
    (``index_select``; ``index_copy_``) and the byte bound, and logged
    under ``prefix``. Returns {name: row}; a row's ``call`` keys it as the
    wrapper counts its launches."""
    from repro_torch.kernels import build
    from repro_torch.kernels import paged as KP

    pages, table, prow, ppos, _ = _paged_inputs(g, dev, dtype, F, lens, gen, P, p, p)
    N, Bp, es = pages.shape[0], table.shape[0], pages.element_size()
    build.reset_counters()
    if not torch.equal(KP.paged_gather(pages, table), KP.paged_gather_plain(pages, table)):
        raise AssertionError(f"{prefix} paged_gather differs from its plain version ({label})")
    before = pages.clone()
    want = KP.paged_scatter_rows_plain(before.clone(), table, prow, ppos)
    KP.paged_scatter_rows(pages, table, prow, ppos)
    tgt = (table.long()[torch.arange(Bp, device=dev), ppos.long() // p] * p + ppos.long() % p)
    if not torch.equal(pages, want) or not _changed_rows(pages, before) <= set(tgt.tolist()):
        raise AssertionError(f"{prefix} paged_scatter_rows wrong or wrote outside its rows "
                             f"({label})")
    gplan = KP.gather_plan(N, Bp, P, p * F * es, pages.data_ptr())
    splan = KP.scatter_rows_plan(N, Bp, P, p, F * es, pages.data_ptr(), prow.data_ptr())
    if ((gplan.vec, Bp, P, p * F * es) not in build.COUNTERS["paged_gather"].by_call
            or (splan.vec, Bp, F * es) not in build.COUNTERS["paged_scatter_rows"].by_call):
        raise AssertionError(f"{prefix} paged kernels {label}: launched "
                             f"{dict(build.COUNTERS['paged_gather'].by_call)} and "
                             f"{dict(build.COUNTERS['paged_scatter_rows'].by_call)}, not "
                             f"{gplan} and {splan}")
    flat, fi = pages.view(N * p, F), tgt.contiguous()
    reads = torch.unique(table).numel()  # each distinct page mapped is read once
    shape = f"{label} N={N} p={p} F={F} P={P} {str(dtype)[6:]} B={Bp}"
    timed = {
        # every logical page written, each mapped page read, the table
        "paged_gather": dict(
            fn=lambda: KP.paged_gather(pages, table),
            plain=lambda: KP.paged_gather_plain(pages, table),
            library=lambda t=table.flatten().long(): torch.index_select(pages, 0, t),
            nbytes=(Bp * P + reads) * p * F * es + 4 * Bp * P, plan=gplan,
            call=(Bp, P, p * F * es)),
        # the rows read and written, the B positions and table entries
        "paged_scatter_rows": dict(
            fn=lambda: KP.paged_scatter_rows(pages, table, prow, ppos),
            plain=lambda: KP.paged_scatter_rows_plain(pages, table, prow, ppos),
            library=lambda: flat.index_copy_(0, fi, prow),
            nbytes=2 * Bp * F * es + 4 * Bp + 4 * Bp, plan=splan, call=(Bp, F * es)),
    }
    rows = {}
    for name, c in timed.items():
        if name == "paged_gather" and not gather:
            continue
        how: dict = {}
        r = rows[name] = dict(
            ms=replay_ms(c["fn"], how, "ms"), plain_ms=replay_ms(c["plain"], how, "plain_ms"),
            library_ms=replay_ms(c["library"], how, "library_ms"),
            bound=bound_ms(c["nbytes"], 0, torch.bfloat16), timed_by=how, max_abs_err=0.0,
            shape=shape, off_path=False, plan=c["plan"]._asdict(), call=c["call"])
        log(f"{prefix} {name:18s} {shape} bitwise-equal ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"({'index_select' if name == 'paged_gather' else 'index_copy_'}) "
            f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]}) plan=vec{c['plan'].vec} "
            f"unroll{c['plan'].unroll} x {c['plan'].blocks} blocks{timed_note(how)}")
    return rows


def ssd_row(prefix: str, label: str, dev, shape: tuple, seed: int) -> dict:
    """The SSD kernel at ``shape`` (B, H, NC, Q, hd, ds), bf16 in the model's
    strided layout: on the tensor-core path and launched there, within
    SSD_TOL (plus the cumsum's rounding) of its plain version, then timed
    by CUDA-graph replay beside it and the bound, and logged under
    ``prefix``. Returns the row (its ``call`` is ``shape``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd as KSSD

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x, loglam, dt, Bm, Cm = _ssd_inputs(dev, torch.bfloat16, *shape, seed, True)
    plan = KSSD.ssd_plan(*shape, torch.bfloat16, sms, KSSD.aligned_rows(x, Bm, Cm))
    build.reset_counters()
    y, inc = KSSD.ssd_intra_chunk(x, loglam, dt, Bm, Cm)
    calls = dict(build.COUNTERS["ssd_intra_chunk"].by_call)
    if plan.path != "tensor" or calls != {("tensor", *shape): 1}:
        raise AssertionError(f"{prefix} ssd_intra_chunk {label}: plan {plan.path}, launched "
                             f"{calls}")
    wy, winc = KSSD.ssd_intra_chunk_plain(x, loglam, dt, Bm, Cm)
    tol = SSD_TOL + 2 * torch.cumsum(loglam, -1).abs().max().item() * 2.0**-24
    errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in ((y, wy), (inc, winc))]
    if max(errs) > tol or not bool(torch.isfinite(y).all() and torch.isfinite(inc).all()):
        raise AssertionError(f"{prefix} ssd_intra_chunk {label}: {errs} beyond {tol:.3g}")
    nbytes, flops = ssd_work(*shape, x.element_size())
    how: dict = {}
    r = dict(ms=replay_ms(lambda: KSSD.ssd_intra_chunk(x, loglam, dt, Bm, Cm), how, "ms"),
             plain_ms=replay_ms(lambda: KSSD.ssd_intra_chunk_plain(x, loglam, dt, Bm, Cm), how,
                                "plain_ms", reps=5),
             library_ms=None, bound=bound_ms(nbytes, flops, torch.bfloat16), timed_by=how,
             max_abs_err=max((y - wy).abs().max().item(), (inc - winc).abs().max().item()),
             plan=plan._asdict(), call=shape,
             shape=f"{label} x{tuple(x.shape)} ds={shape[5]} bfloat16")
    log(f"{prefix} ssd_intra_chunk {r['shape']}: path {plan.path}, G={plan.G}, grid "
        f"{plan.grid}; y / inc within {errs[0]:.3g} / {errs[1]:.3g} of their largest (limit "
        f"{tol:.3g}); ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
        f"({r['bound'][1]}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return r


def encdec_vlm_kernels(dev, results) -> None:
    """15b-c's kernel shapes against their plain versions, timed by CUDA-graph
    replay beside the bound and the library call: flash attention at
    whisper-tiny's (6 heads of 64: the encoder over 1500 frames at B=1 as
    admission runs it, non-causal on the wgmma tiles; cross-attention
    decode of 8 slots over the 1500 frames, 12 chunks + the merge, every
    position 0 as the model passes them; the decoder's training calls at
    B=8, S=448: cross-attention of the full and the routed (k=128) rows,
    causal self-attention of both; the decode steps' self-attention of 8
    slots and a routed slot's cross-attention) and qwen2-vl-7b's (28/4
    heads of 128: the S=2048 forward with the image layout's t stream, its
    routed blocks' 256 rows, a decode step of 8 slots); gather_rows and
    scatter_add_rows at whisper's routed decoder blocks (B=8, S=448,
    D=384: 768-byte rows, k=128); paged_gather and paged_scatter_rows at
    15b-c's paged pools (8 slots, page 16: whisper's K/V rows of 6 x 64
    and its position rows, qwen2-vl's K/V rows of 4 x 128), bitwise equal
    to their plain versions and writing no row outside their targets."""
    from repro_torch.config import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import api

    g = torch.Generator(device=dev).manual_seed(53)
    i32 = dict(dtype=torch.int32, device=dev)
    bf = (torch.bfloat16,)
    zeros = lambda B, S: torch.zeros((B, S), **i32)  # noqa: E731
    ar = lambda B, S: torch.arange(S, **i32)[None].repeat(B, 1)  # noqa: E731
    t_vlm = api.mrope_positions(VLM_LAYOUT, device=dev)[0][None]

    def routed(B, S, k):  # a routed block's rows: k of S, sorted
        return torch.stack([torch.randperm(S, generator=g, device=dev)[:k].sort().values
                            for _ in range(B)]).int()

    def decode_pos(B, ctx, lo):  # each slot's cache filled to a length in [lo, ctx]
        lens = torch.randint(lo, ctx + 1, (B,), generator=g, device=dev)
        kv = torch.arange(ctx, **i32)[None].repeat(B, 1)
        return (lens - 1)[:, None].int(), torch.where(kv < lens[:, None], kv, -1).int()

    w_routed = routed(8, 448, 128)
    t_routed = t_vlm.gather(1, routed(1, 2048, 256).long())  # the routed rows' t stream
    cases = [
        (FlashCase("whisper encoder B=1 S=1500", 1, 1500, 1500, 6, 6, 64, ar(1, 1500),
                   ar(1, 1500), bf, causal=False), "wgmma"),
        (FlashCase("whisper cross decode B=8 Skv=1500", 8, 1, 1500, 6, 6, 64, zeros(8, 1),
                   zeros(8, 1500), bf, causal=False), "decode"),
        (FlashCase("whisper cross train B=8 Sq=448 Skv=1500", 8, 448, 1500, 6, 6, 64,
                   zeros(8, 448), zeros(8, 1500), bf, True, causal=False), "wgmma"),
        (FlashCase("whisper cross routed B=8 Sq=128 Skv=1500", 8, 128, 1500, 6, 6, 64,
                   zeros(8, 128), zeros(8, 1500), bf, True, causal=False), "wgmma"),
        (FlashCase("whisper self train B=8 S=448", 8, 448, 448, 6, 6, 64, ar(8, 448),
                   ar(8, 448), bf, True), "wgmma"),
        (FlashCase("qwen2-vl forward S=2048 mrope t", 1, 2048, 2048, 28, 4, 128, t_vlm, t_vlm,
                   bf), "wgmma"),
        # the routed blocks' and the decode steps' calls of 15b-c
        (FlashCase("whisper routed self train B=8 S=128", 8, 128, 128, 6, 6, 64, w_routed,
                   w_routed, bf, True), "wgmma"),
        (FlashCase("whisper self decode B=8 ctx=80", 8, 1, 80, 6, 6, 64, *decode_pos(8, 80, 4),
                   bf), "decode"),
        (FlashCase("whisper cross routed decode B=1 Skv=1500", 1, 1, 1500, 6, 6, 64, zeros(1, 1),
                   zeros(1, 1500), bf, causal=False), "decode"),
        (FlashCase("qwen2-vl routed forward S=256 mrope t", 1, 256, 256, 28, 4, 128, t_routed,
                   t_routed, bf), "wgmma"),
        (FlashCase("qwen2-vl decode B=8 ctx=64", 8, 1, 64, 28, 4, 128, *decode_pos(8, 64, 16),
                   bf), "decode"),
    ]
    for c, path in cases:
        dtype = torch.bfloat16
        plan = FA.flash_plan(c.B, c.Sq, c.Skv, c.nq, c.nkv, c.hd, dtype)
        build.reset_counters()
        r = flash_row(FA, c, dtype, g)
        key = (plan.path, c.B, c.Sq, c.Skv, c.nq, c.nkv, c.hd, plan.kernels)
        if plan.path != path or key not in FA.FLASH_ATTENTION.by_call or (
                c.label.startswith("whisper cross decode") and plan.n_splits != 12):
            raise AssertionError(f"15 flash {c.label}: plan {plan}, launched "
                                 f"{dict(FA.FLASH_ATTENTION.by_call)}, want the {path} path")
        r["path"], r["kernels"] = plan.path, plan.kernels
        r["plan"] = dict(path=plan.path, key_tile=plan.key_tile, key_split=plan.key_split,
                         chunk=plan.chunk, n_splits=plan.n_splits, merge=plan.merge)
        log(f"[encdec-vlm] 15 flash_attention {r['shape']:46s} {plan.path:6s} "
            f"kernels={plan.kernels} causal={c.causal} max_abs_err={r['max_abs_err']:.3g} "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"(SDPA) bound_ms={r['bound'][0]:.4f} ({r['bound'][1]})")
        results.setdefault("flash_attention", {})[(c.label, dtype)] = r
    # the dispatch kernels at whisper's routed decoder blocks
    cfg = get_config(ENCDEC_ARCH)
    B, S, D = WHISPER_TRAIN["B"], WHISPER_TRAIN["S"], cfg.d_model
    log_dispatch_rows("[encdec-vlm] 15", f"whisper B={B} S={S} D={D}",
                      dispatch_rows(g, dev, torch.bfloat16, B, S, D, cfg.mod.capacity(S)),
                      torch.bfloat16, results)
    # the paged kernels at the paged serving pools of 15b-c: each slot's
    # table maps the pages its prompt and new tokens reach
    vcfg = get_config(VLM_ARCH)
    ws, vs = WHISPER_SERVE, VLM_SERVE
    w_ctx = -(-(ws["prompt"] + ws["gen"]) // ws["page"]) * ws["page"]
    v_ctx = -(-(vs["hi"] + vs["gen"]) // vs["page"]) * vs["page"]
    v_lens = [int(n) for n in np.random.default_rng(2).integers(vs["lo"], vs["hi"] + 1, vs["B"])]
    paged_cases = [  # label, dtype, F, prompt lengths, new tokens, P, page, run
        ("whisper kv", torch.bfloat16, cfg.attn.n_kv_heads * cfg.head_dim,
         [ws["prompt"]] * ws["B"], ws["gen"], w_ctx // ws["page"], ws["page"],
         "encdec_vlm_whisper_serve_paged"),
        ("whisper pos", torch.int32, 1, [ws["prompt"]] * ws["B"], ws["gen"],
         w_ctx // ws["page"], ws["page"], "encdec_vlm_whisper_serve_paged"),
        ("qwen2-vl kv", torch.bfloat16, vcfg.attn.n_kv_heads * vcfg.head_dim, v_lens, vs["gen"],
         v_ctx // vs["page"], vs["page"], "encdec_vlm_vlm_serve_paged"),
    ]
    for label, dtype, F, lens, gen, P, p, run in paged_cases:
        for name, r in paged_rows("[encdec-vlm] 15", label, g, dev, dtype, F, lens, gen, P,
                                  p).items():
            results.setdefault(name, {})[f"15 {label} B={len(lens)}"] = dict(r, run=run)


def train_whisper(dev, params, cfg) -> tuple:
    """15b(i): WHISPER_TRAIN's steps of the Trainer's step (loss with the
    router and predictor terms, clip, AdamW) on whisper-tiny at full size,
    bf16: encoder over 1500 stub frames, decoder S=448, remat full. Returns
    (launch counts, flash launches by call, dispatch launches by call)."""
    from repro_torch.config import OptimConfig, TrainConfig
    from repro_torch.kernels import build
    from repro_torch.train.loop import make_train_state, make_train_step
    from repro_torch.utils import tree_map

    w = WHISPER_TRAIN
    tcfg = TrainConfig(global_batch=w["B"], seq_len=w["S"],
                       optim=OptimConfig(lr=3e-4, warmup_steps=1, total_steps=10))
    state = make_train_state(cfg, dev, params=tree_map(lambda t: t.detach().clone(), params))
    step_fn = make_train_step(cfg, tcfg)
    batches = [_family_batch(cfg, w["B"], w["S"], 100 + i, dev) for i in range(w["steps"])]
    build.reset_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append((float(m["loss"]), float(m["ce"]), float(m["grad_norm"])))
        walls.append(1e3 * (time.perf_counter() - t0))
    counts = build.launch_counts()
    flash, dispatch = flash_calls(), dispatch_by_call()
    try:
        wall, busy, top = profile_call(lambda: step_fn(state, batches[-1]), iters=1, warmup=0)
        timing = (f"profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms; top: "
                  + "; ".join(f"{n[:40]} {t:.2f}" for n, t in top[:4]))
    except NoDeviceTime:
        timing = "torch.profiler recorded no device time; busy not measured"
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    enc_key = ("wgmma", w["B"], 1500, 1500, 6, 6, 64, 1)
    if (not all(np.isfinite(v) for row in losses for v in row) or not counts["gather_rows"]
            or not counts["scatter_add_rows"] or enc_key not in flash):
        raise AssertionError(f"15b train: losses {losses}, launches {counts}, flash {flash}")
    log(f"[encdec-vlm] 15b whisper-tiny train B={w['B']} S={w['S']} (1500 frames, remat "
        f"{cfg.remat}, backend {cfg.mod.backend}): (loss, ce, grad norm) by step "
        f"{[tuple(round(v, 6) for v in row) for row in losses]}; wall "
        f"{', '.join(f'{t:.1f}' for t in walls)} ms; {timing}; peak memory {peak:.2f} GiB")
    log(f"[encdec-vlm]   train launches: "
        f"{json.dumps({k: v for k, v in counts.items() if v})}; flash by call "
        f"{json.dumps([list(k) + [n] for k, n in sorted(flash.items())])}")
    del state
    return counts, flash, dispatch


def serve_whisper(dev, params, cfg) -> tuple:
    """15b(ii): WHISPER_SERVE on both pools; each request's frames drawn
    from seed 1000 + its index, encoded once at admission (flash over 1500
    frames at B=1, 4 encoder layers). A decode step: flash in every
    decoder block's self- and cross-attention (the routed blocks at kb = 1),
    paged gathers and scatters of the full blocks' self rings on the paged
    pool. Returns (launch counts, flash by call, the paged kernels'
    launches by call) by pool."""
    from repro_torch.models import api
    from repro_torch.serve import Request

    w = WHISPER_SERVE
    rng = np.random.default_rng(11)
    prompts = [rng.choice(cfg.vocab, w["prompt"], replace=False) for _ in range(w["requests"])]
    frames = [api.stub_inputs(cfg, 1, 0, seed=1000 + i, device=dev)["enc_emb"][0]
              for i in range(w["requests"])]
    reqs = lambda: [Request(tokens=p, max_new_tokens=w["gen"], enc_emb=e)  # noqa: E731
                    for p, e in zip(prompts, frames)]
    n_groups = cfg.n_layers // 2
    step_flash = 2 * (2 * n_groups)  # self + cross in each full and routed block
    want = {"contiguous": {"flash_attention": step_flash},
            "paged": {"flash_attention": step_flash, "paged_gather": 3 * n_groups,
                      "paged_scatter_rows": 3 * n_groups}}
    ctx = -(-(w["prompt"] + w["gen"]) // w["page"]) * w["page"]
    return serve_both_pools(
        "[encdec-vlm]", "15b whisper-tiny", params, cfg, dev, reqs, w["B"], ctx, w["page"], want,
        profile_after=2 * w["prompt"],
        note=f" (prompts of {w['prompt']} tokens, {w['gen']} new each, frames of their own)")[:3]


def vlm_phase(dev) -> tuple:
    """15c: qwen2-vl-7b at full width and depth, bf16, random weights from
    seed 0: one B=1 S=2048 forward and its loss over embeddings laid out as
    VLM_LAYOUT (flash over the t stream on the wgmma tiles; routed blocks
    by gather/scatter: M-RoPE is not fused), then VLM_SERVE on both pools
    (text requests, stepped). Returns the launch counts by run, flash's
    launches by call by run, and the paged serving run's paged kernels'
    launches by call."""
    from repro_torch.config import get_config, with_mod_backend
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import Request
    from repro_torch.utils import tree_leaves

    # pallas_fused: M-RoPE's routed blocks fall back to gather/scatter
    cfg = with_mod_backend(get_config(VLM_ARCH), "pallas_fused")
    release_device_memory(dev)
    t0 = time.perf_counter()
    params = api.init_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[encdec-vlm] 15c {cfg.name}: {n_params / 1e9:.3f}B params in {cfg.dtype} "
        f"({len(params['groups'])} {{full, mod}} groups, {cfg.attn.n_heads}/{cfg.attn.n_kv_heads} "
        f"heads of {cfg.head_dim}, M-RoPE sections {cfg.attn.mrope_sections}), init "
        f"{time.perf_counter() - t0:.1f}s")
    S = sum(n if k == "text" else n[0] * n[1] for k, n in VLM_LAYOUT)
    batch = _family_batch(cfg, 1, S, 31, dev, VLM_LAYOUT)
    build.reset_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        loss, aux = api.model_loss(params, cfg, batch)
        torch.cuda.synchronize()
        fwd = build.launch_counts()
        flash_fwd = flash_calls()
        try:
            wall, busy, top = profile_call(lambda: api.model_loss(params, cfg, batch), iters=2,
                                           warmup=1)
            timing = (f"wall {wall:.2f} ms, device busy {busy:.2f} ms; top kernels: "
                      + "; ".join(f"{n[:50]} {t:.3f}" for n, t in top))
        except NoDeviceTime:
            timing = "torch.profiler recorded no device time; not measured"
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    n_groups = len(params["groups"])
    k = cfg.mod.capacity(S)
    want_flash = {("wgmma", 1, S, S, 28, 4, 128, 1): n_groups,
                  ("wgmma", 1, k, k, 28, 4, 128, 1): n_groups}
    if (not torch.isfinite(loss) or flash_fwd != want_flash
            or fwd["gather_rows"] != n_groups or fwd["scatter_add_rows"] != n_groups
            or fwd["routed_attention"] or fwd["routed_mlp_scatter"]):
        raise AssertionError(f"15c forward: loss {float(loss)}, flash {flash_fwd} (want "
                             f"{want_flash}), launches {fwd}")
    log(f"[encdec-vlm] 15c forward B=1 S={S} over embeddings (text 64, image 24x40 sharing t=64,"
        f" text from {int(batch['positions'][0, 0, 64 + 960])}; backend {cfg.mod.backend}): "
        f"loss {float(loss):.6f} "
        f"(ce {float(aux['ce']):.6f}, finite); flash calls "
        f"{json.dumps([list(k_) + [n] for k_, n in flash_fwd.items()])}; gather/scatter "
        f"{fwd['gather_rows']}/{fwd['scatter_add_rows']}; peak memory {peak:.2f} GiB; {timing}")
    w = VLM_SERVE
    lens = np.random.default_rng(2).integers(w["lo"], w["hi"] + 1, w["requests"])
    toks = SyntheticLM(cfg.vocab, w["hi"], seed=8).batch(0, w["requests"])["tokens"]
    reqs = lambda: [Request(tokens=toks[i, :lens[i]], max_new_tokens=w["gen"])  # noqa: E731
                    for i in range(w["requests"])]
    want = {"contiguous": {"flash_attention": 2 * n_groups},
            "paged": {"flash_attention": 2 * n_groups, "paged_gather": 3 * n_groups,
                      "paged_scatter_rows": 3 * n_groups}}
    ctx = -(-(w["hi"] + w["gen"]) // w["page"]) * w["page"]
    counts, flash, paged, _ = serve_both_pools(
        "[encdec-vlm]", "15c qwen2-vl-7b", params, cfg, dev, reqs, w["B"], ctx, w["page"], want,
        profile_after=4, note=f" (text prompts {lens.min()}-{lens.max()} tokens, {w['gen']} new "
                              f"each)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ({"encdec_vlm_vlm_forward": fwd, "encdec_vlm_vlm_serve": counts["contiguous"],
             "encdec_vlm_vlm_serve_paged": counts["paged"]},
            {"encdec_vlm_vlm_forward": flash_fwd, "encdec_vlm_vlm_serve": flash["contiguous"],
             "encdec_vlm_vlm_serve_paged": flash["paged"]}, paged["paged"])


def encdec_vlm_phase(dev, results) -> tuple:
    """Phase 15 in order. Returns the launch counts by path, flash's launches
    by call by path, the dispatch kernels' launches by call of 15b's
    training run, and the paged kernels' launches by call of the paged
    serving runs."""
    from repro_torch.config import get_config
    from repro_torch.models import api

    t = time.perf_counter()
    release_device_memory(dev)
    encdec_vlm_parity(dev)
    t15a = time.perf_counter() - t
    encdec_vlm_kernels(dev, results)
    t15k = time.perf_counter() - t - t15a
    cfg = get_config(ENCDEC_ARCH)
    params = api.init_model(cfg, device=dev, seed=0)
    train_counts, train_flash, train_dispatch = train_whisper(dev, params, cfg)
    serve_counts, serve_flash, serve_paged = serve_whisper(dev, params, cfg)
    del params
    t15b = time.perf_counter() - t - t15a - t15k
    vlm_counts, vlm_flash, vlm_paged = vlm_phase(dev)
    log(f"[time] 15a {t15a:.1f}s, 15 kernels {t15k:.1f}s, 15b {t15b:.1f}s, 15c "
        f"{time.perf_counter() - t - t15a - t15k - t15b:.1f}s")
    counts = {"encdec_vlm_whisper_train": train_counts,
              "encdec_vlm_whisper_serve": serve_counts["contiguous"],
              "encdec_vlm_whisper_serve_paged": serve_counts["paged"], **vlm_counts}
    flash = {"encdec_vlm_whisper_train": train_flash,
             "encdec_vlm_whisper_serve": serve_flash["contiguous"],
             "encdec_vlm_whisper_serve_paged": serve_flash["paged"], **vlm_flash}
    paged = {"encdec_vlm_whisper_serve_paged": serve_paged["paged"],
             "encdec_vlm_vlm_serve_paged": vlm_paged}
    return counts, flash, train_dispatch, paged


# ---------------------------------------------------------------------------
# Phase 13: overload control and fault injection
# ---------------------------------------------------------------------------

# 13a: mod-paper-60m and -vanilla in f32, the same weights on the CPU and the
# card: 4 slots, page 16, chunk 16 (the prefix cache's granularity)
OVERLOAD_60M = dict(B=4, ctx=128, page=16, chunk=16, prefix=32, requests=10, new=8)
OVERLOAD_CTRL_60M = dict(n_levels=3, queue_high=4, queue_low=1, degrade_patience=1,
                         restore_patience=3)
# 13a's fault soaks: FaultInjector.seeded(0, n_faults=6, horizon=30) on each engine
FAULT_ENGINES_60M = {"paged": {}, "ragged": dict(ragged=True),
                     "speculative": dict(speculate=3)}
# 13b-c: mod-paper-1b in bf16 at full width, 32 slots (at 8 kb is 1 at every
# level), PAGED_1B's prompt shape (a shared 512-token prefix, suffixes of
# 64-448), 48 requests of 16 new tokens; no p99 SLO, so the walk depends on
# the queue depth alone and repeats run for run
OVERLOAD_1B = dict(B=32, requests=48, gen=16)
OVERLOAD_CTRL_1B = dict(n_levels=3, queue_high=8, queue_low=2, degrade_patience=1,
                        restore_patience=4)
# the kernels phase 13's engines launch (PERF.md §6 rows 1, 2, 3, 7, 9, 13)
OVERLOAD_KERNELS = ("gather_rows", "scatter_add_rows", "flash_attention", "paged_gather",
                    "paged_scatter_rows", "ragged_paged_scatter_rows")
# the stats() counters 13a holds equal on both devices
OVERLOAD_COUNTERS = ("steps", "generated_tokens", "finished_requests", "shed", "expired",
                     "cancelled", "failed", "preemptions", "pages_held", "pages_in_use")
CONTROLLER_COUNTERS = ("degraded_decode_steps", "capacity_level", "capacity_level_max",
                       "capacity_level_changes", "degraded_steps")


class StepClock:
    """Phase 13's deadline clock: the engine's own step count, so deadlines
    expire at the same step on both devices."""

    def __init__(self):
        self.engine = None

    def __call__(self) -> float:
        return float(self.engine.step_count)


def _outcomes(eng) -> dict:
    """{uid: (finish reason, error, tokens, submitted, admitted, first token
    and finished step)} of every finished request."""
    return {o.uid: (o.finish_reason, o.error, o.tokens.tolist(), o.submitted_step,
                    o.admitted_step, o.first_token_step, o.finished_step) for o in eng.finished}


def _counters(eng, keys) -> dict:
    s = eng.stats()
    return {k: s[k] for k in keys if k in s}


def adaptive_lifecycle(d, params, cfg) -> dict:
    """13a (i): the paged + prefix engine under OVERLOAD_CTRL_60M and a step
    clock; 10 requests sharing a 32-token prefix, two of them latency-tier,
    one deadline that expires while queued (uid 7), one mid-decode (uid 2,
    latency-tier, admitted first), one cancellation (uid 4 at step 2) and
    one ``max_queue`` rejection. Returns the run's trace: the level of every
    step, the outcomes, the counters and the rejection's reason."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serve import CapacityController, EngineConfig, EngineOverloaded, Request
    from repro_torch.serve import ServingEngine

    w = OVERLOAD_60M
    clock = StepClock()
    eng = ServingEngine(params, cfg, EngineConfig(
        batch_size=w["B"], ctx=w["ctx"], page_size=w["page"], prefill_chunk=w["chunk"],
        prefix_cache=True, max_queue=w["requests"], clock=clock,
        capacity_controller=CapacityController(**OVERLOAD_CTRL_60M)), device=d)
    clock.engine = eng
    n = w["requests"]
    toks = SyntheticLM(cfg.vocab, w["prefix"] + 40, seed=29).batch(0, n)["tokens"]
    lens = np.random.default_rng(31).integers(4, 41, n)
    uids = []
    for i in range(n):
        kw = dict(priority="latency" if i in (2, 6) else "batch")
        if i in (2, 7):
            kw["deadline_s"] = {2: 5.0, 7: 3.0}[i]
        uids.append(eng.submit(Request(tokens=np.concatenate(
            [toks[0, :w["prefix"]], toks[i, w["prefix"]:w["prefix"] + int(lens[i])]]),
            max_new_tokens=w["new"], **kw)))
    try:
        eng.submit(Request(tokens=toks[0, :8], max_new_tokens=2))
        raise AssertionError("13a: the request past max_queue was queued")
    except EngineOverloaded as err:
        reason = err.reason
    levels = []
    while eng.has_work:
        if eng.step_count == 2:
            eng.cancel(uids[4])
        eng.step()
        levels.append(eng.last_step_level)
        eng.pool.check_invariants()
    clock.engine = None  # no reference cycle keeps the engine's tensors alive
    out = _outcomes(eng)
    want = {uids[7]: "expired", uids[2]: "expired", uids[4]: "cancelled"}
    for u, r in want.items():
        if out[u][0] != r:
            raise AssertionError(f"13a lifecycle: request {u} ended {out[u][0]}, want {r}")
    if not (out[uids[7]][2] == [] and 0 < len(out[uids[2]][2]) < w["new"]):
        raise AssertionError(f"13a lifecycle: expiries {out[uids[7]]} {out[uids[2]]}")
    if sum(o[0] in ("eos", "length") for o in out.values()) != n - 3 or max(levels) < 1:
        raise AssertionError(f"13a lifecycle: outcomes {out}, levels {levels}")
    return dict(levels=levels, outcomes=out, reason=reason,
                counters=_counters(eng, OVERLOAD_COUNTERS + CONTROLLER_COUNTERS))


def _fault_requests(rng, n, vocab):
    from repro_torch.serve import Request

    return [Request(tokens=rng.integers(1, vocab, size=int(rng.integers(8, 41))),
                    max_new_tokens=int(rng.integers(3, 8))) for _ in range(n)]


def drive_faults(eng, inj, pending, filler, depth: int = 2, max_steps: int = 400) -> list:
    """The soak loop of tests/test_faults.py: keep ``depth`` requests queued
    while ``pending`` lasts (popped from its end), then submit a
    ``filler()`` whenever the queue runs dry before every fault fired;
    recount the pool's books after each step. Returns the requests
    submitted and the engine's preemption count after each step."""
    live, preempted = [], []
    for _ in range(max_steps):
        while pending and len(eng.scheduler.queue) < depth:
            live.append(pending.pop())
            eng.submit(live[-1])
        if not pending and not inj.exhausted and not eng.scheduler.queue:
            live.append(filler())
            eng.submit(live[-1])
        eng.step()
        preempted.append(eng.preemptions)
        eng.pool.check_invariants()
        eng.scheduler.check_invariants(eng.slots, len(eng.finished))
        if not eng.has_work and not pending and inj.exhausted:
            return live, preempted
    raise AssertionError(f"fault soak did not converge in {max_steps} steps: {inj.fired}")


def assert_fault_contract(tag: str, eng, inj) -> None:
    """JAX's fault contract (tests/test_faults.py:_assert_contract): one
    FINISH_ERROR a corruption step, each saying non-finite; every other
    request ends eos or length without an error; nothing held or mapped;
    the failed counter equals the kills."""
    kills = {f["step"] for f in inj.fired if f["kind"].endswith("_logits")}
    failed = [o for o in eng.finished if o.finish_reason == "error"]
    if len(failed) != len(kills) or any("non-finite" not in o.error for o in failed):
        raise AssertionError(f"{tag}: {len(failed)} failed for {len(kills)} corruption steps: "
                             f"{[o.error for o in failed]} {inj.fired}")
    if any(not o.ok or o.error for o in eng.finished if o.finish_reason != "error"):
        raise AssertionError(f"{tag}: a request the faults did not target failed")
    if eng.pool.held or int(np.asarray(eng.pool.n_mapped).sum()):
        raise AssertionError(f"{tag}: pages left held {eng.pool.held} or mapped")
    s = eng.stats()
    if s["failed"] != len(failed) or s["shed"] or s["expired"]:
        raise AssertionError(f"{tag}: counters {s['failed']} {s['shed']} {s['expired']}")


def fault_soak(d, params, cfg, seed: int, engine: dict) -> dict:
    """13a (ii)-(iii): FaultInjector.seeded(seed, n_faults=6, horizon=30)
    through one 60m engine (4 slots, ctx 64, page 16, chunk 16): 10
    requests of 8-40 prompt and 3-7 new tokens, drawn from ``seed``, plus
    fillers; the fired log, outcomes and counters."""
    from repro_torch.serve import EngineConfig, FaultInjector, ServingEngine

    rng = np.random.default_rng(seed)
    inj = FaultInjector.seeded(seed, n_faults=6, horizon=30)
    eng = ServingEngine(params, cfg, EngineConfig(batch_size=4, ctx=64, page_size=16,
                                                  prefill_chunk=16, fault_injector=inj,
                                                  **engine), device=d)
    drive_faults(eng, inj, _fault_requests(rng, 10, cfg.vocab),
                 lambda: _fault_requests(rng, 1, cfg.vocab)[0])
    assert_fault_contract(f"13a {cfg.name} {engine}", eng, inj)
    return dict(fired=inj.fired, outcomes=_outcomes(eng),
                counters=_counters(eng, OVERLOAD_COUNTERS),
                prompts={o.uid: o.prompt.tolist() for o in eng.finished})


def overload_parity(dev):
    """13a: mod-paper-60m (and -vanilla) in f32, the same weights on the CPU
    (plain versions) and the card (kernels): the adaptive lifecycle run and
    the seeded fault matrix on the paged, ragged and speculative engines
    give equal levels, outcomes, fired logs and counters on both devices;
    on the vanilla model every request the matrix did not kill decodes the
    tokens of a fault-free run."""
    from repro_torch.config import get_config
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, ServingEngine

    cfg = parity_60m_config()
    p_cpu = api.init_model(cfg, device="cpu", seed=3)
    p_gpu = _to(p_cpu, dev)
    runs = {"adaptive": lambda d, p: adaptive_lifecycle(d, p, cfg)}
    for name, kw in FAULT_ENGINES_60M.items():
        runs[f"faults {name}"] = lambda d, p, kw=kw: fault_soak(d, p, cfg, 0, kw)
    for name, fn in runs.items():
        c, g = fn("cpu", p_cpu), fn(dev, p_gpu)
        for key in c:
            if c[key] != g[key]:
                raise AssertionError(f"13a 60m {name}: CPU and card differ in {key}: "
                                     f"{c[key]} vs {g[key]}")
        extra = (f"levels {''.join(map(str, g['levels']))}, rejection {g['reason']!r}"
                 if "levels" in g else
                 f"fired {', '.join(f['kind'] + '@' + str(f['step']) for f in g['fired'])}")
        log(f"[overload] 13a 60m f32 {name}: CPU == card for {len(g['outcomes'])} requests "
            f"(streams, finish reasons, lifecycle steps); {extra}; counters "
            f"{json.dumps(g['counters'])}")
    vcfg = dataclasses.replace(get_config("mod-paper-60m-vanilla"), dtype="float32",
                               n_layers=PARITY_60M_LAYERS)
    v_cpu = api.init_model(vcfg, device="cpu", seed=3)
    v_gpu = _to(v_cpu, dev)
    c, g = fault_soak("cpu", v_cpu, vcfg, 0, {}), fault_soak(dev, v_gpu, vcfg, 0, {})
    if c != g:
        raise AssertionError("13a 60m-vanilla faults: CPU and card differ")
    clean = ServingEngine(v_gpu, vcfg, EngineConfig(batch_size=4, ctx=64, page_size=16,
                                                    prefill_chunk=16), device=dev)
    for r in _fault_requests(np.random.default_rng(0), 10, vcfg.vocab):
        clean.submit(r)
    base = {tuple(o.prompt.tolist()): o.tokens.tolist() for o in clean.run()}
    compared = 0
    for u, o in g["outcomes"].items():
        want = base.get(tuple(g["prompts"][u]))
        if o[0] == "error" or want is None:
            continue
        compared += 1
        if o[2] != want:
            raise AssertionError(f"13a 60m-vanilla: request {u}'s stream moved under faults")
    kills = sum(o[0] == "error" for o in g["outcomes"].values())
    if compared < len(base) - kills:
        raise AssertionError(f"13a 60m-vanilla: compared {compared} of {len(base)} streams")
    log(f"[overload] 13a 60m-vanilla f32 faults paged: CPU == card; {compared} survivors' "
        f"streams equal a fault-free run's ({kills} killed)")


def overload_1b_requests(cfg, priority: str):
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serve import Request

    w, n = PAGED_1B, OVERLOAD_1B["requests"]
    pre = w["prefix"]
    suffix = np.random.default_rng(13).integers(64, w["max_suffix"] + 1, n)
    toks = SyntheticLM(cfg.vocab, pre + w["max_suffix"], seed=9).batch(0, n)["tokens"]
    return [Request(tokens=np.concatenate([toks[0, :pre], toks[i, pre:pre + int(s)]]),
                    max_new_tokens=OVERLOAD_1B["gen"], priority=priority)
            for i, s in enumerate(suffix)]


def overload_1b_engine(params, cfg, dev, ctrl: bool, **kw):
    from repro_torch.serve import CapacityController, EngineConfig, ServingEngine

    w = PAGED_1B
    ctx = -(-(w["prefix"] + w["max_suffix"] + OVERLOAD_1B["gen"]) // w["page"]) * w["page"]
    return ServingEngine(params, cfg, EngineConfig(
        batch_size=OVERLOAD_1B["B"], ctx=ctx, page_size=w["page"], prefill_chunk=w["chunk"],
        prefix_cache=True, capacity_controller=CapacityController(**OVERLOAD_CTRL_1B) if ctrl
        else None, **kw), device=dev)


def serve_overload_1b(dev, params):
    """13b: mod-paper-1b in bf16 at full width, the paged + prefix engine
    with 32 slots: (i) 48 batch-tier requests at once under
    OVERLOAD_CTRL_1B: the walk reaches level 2 and ends at 0, every request
    ok; the routed layers' decode flash calls run at kb = 4 / 2 / 1, 12
    calls a decode step at each level, by the wrapper's counter, and a
    profiled decode-only step at each level shows torch.profiler as many
    flash kernels as the counter; (ii) the same requests latency-tier under
    the same controller: no step degraded, streams equal (iii), the same
    requests with no controller. Per level: steps, decode wall ms a
    decode-only step, the profiled step's device-busy ms."""
    from repro_torch.core.routing import batch_capacity_k, capacity_ladder
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serve.overload import default_levels
    from repro_torch.serve.scheduler import FREE, GENERATE

    cfg = serve_1b_config()
    B = OVERLOAD_1B["B"]
    n_mod = sum(1 for grp in params["groups"] if "mod" in grp)
    kbs = [batch_capacity_k(c, B) for c in capacity_ladder(cfg, default_levels())]
    if kbs != [4, 2, 1]:
        raise AssertionError(f"13b: kb by level {kbs}, want [4, 2, 1]")
    out = {}
    eng = overload_1b_engine(params, cfg, dev, ctrl=True)
    for r in overload_1b_requests(cfg, "batch"):
        eng.submit(r)
    torch.cuda.synchronize()
    counts0, calls0 = build.launch_counts(), dict(FA.FLASH_ATTENTION.by_call)
    steps = {lvl: 0 for lvl in range(3)}
    walls = {lvl: [] for lvl in range(3)}
    prof = {}
    levels = []
    while eng.has_work:
        lvl = eng._controller.level  # every request is batch-tier
        quiet = (all(s.state == GENERATE for s in eng.slots if s.active)
                 and (not eng.scheduler.queue or not any(s.state == FREE for s in eng.slots)))
        d0, p0 = eng.decode_steps, eng._n_prefills
        if quiet and lvl not in prof and any(s.active for s in eng.slots):
            c_before = dict(FA.FLASH_ATTENTION.by_call)
            wall, busy, _, delta, _, _, by_file, groups = profiled_step(eng)
            step_calls = {k: n - c_before.get(k, 0) for k, n in FA.FLASH_ATTENTION.by_call.items()
                          if n != c_before.get(k, 0)}
            routed = sum(n for k, n in step_calls.items()
                         if k[0] == "decode" and k[2] == 1 and k[1] == kbs[lvl])
            launches = sum(k[7] * n for k, n in step_calls.items())  # kernels, not calls
            if routed != n_mod or sum(step_calls.values()) != delta.get("flash_attention", 0):
                raise AssertionError(f"13b level {lvl}: a decode step made {routed} routed calls "
                                     f"at kb={kbs[lvl]} ({step_calls})")
            if busy > 0.0:
                if by_file.get("flash_attention.cu", 0) != launches:
                    raise AssertionError(f"13b level {lvl}: torch.profiler saw "
                                         f"{by_file.get('flash_attention.cu', 0)} flash kernels, "
                                         f"the counter {launches}")
                prof[lvl] = dict(wall=wall, busy=busy, step=eng.step_count - 1,
                                 kernels=by_file, groups=groups,
                                 active=sum(s.active for s in eng.slots))
        else:
            n_active = sum(s.active for s in eng.slots)
            t0 = time.perf_counter()
            eng.step()
            if eng._n_prefills == p0 and eng.decode_steps > d0:
                walls[eng.last_step_level].append((1e3 * (time.perf_counter() - t0), n_active))
        levels.append(eng.last_step_level)
        if eng.decode_steps > d0:
            steps[eng.last_step_level] += 1
    torch.cuda.synchronize()
    s = eng.stats()
    delta = {k: v - counts0[k] for k, v in build.launch_counts().items()}
    calls = {k: n - calls0.get(k, 0) for k, n in FA.FLASH_ATTENTION.by_call.items()}
    by_kb = {kb: sum(n for k, n in calls.items() if k[0] == "decode" and k[2] == 1 and k[1] == kb)
             for kb in kbs}
    out["controlled"] = {o.uid: o.tokens.tolist() for o in eng.finished}
    if any(not o.ok for o in eng.finished) or len(eng.finished) != OVERLOAD_1B["requests"]:
        raise AssertionError("13b (i): not every request finished ok")
    if s["capacity_level_max"] != 2.0 or s["capacity_level"] != 0.0 or levels[-1] != 0:
        raise AssertionError(f"13b (i): levels {levels}, controller {s['capacity_level']}")
    for lvl, kb in enumerate(kbs):
        if by_kb[kb] != n_mod * steps[lvl]:
            raise AssertionError(f"13b (i): {by_kb[kb]} routed decode calls at kb={kb}, want "
                                 f"{n_mod} x {steps[lvl]} steps at level {lvl}")
    log(f"[overload] 13b (i) {cfg.name} bf16, {B} slots, {len(eng.finished)} batch-tier requests "
        f"of {OVERLOAD_1B['gen']} tokens at once: levels {''.join(map(str, levels))}; "
        f"{s['generated_tokens']:.0f} tokens in {s['wall_s']:.2f}s = {s['tokens_per_s']:.1f} "
        f"tok/s, {s['degraded_decode_steps']:.0f} degraded decode steps, {s['prefills']:.0f} "
        f"prefills, prefix hit rate {s['prefix_hit_rate']:.3f}")
    for lvl, kb in enumerate(kbs):
        p = prof.get(lvl)
        busy = ("busy: not measured (torch.profiler recorded no device time)" if p is None else
                f"profiled step {p['step']} ({p['active']} slots active): wall {p['wall']:.2f} "
                f"ms, device busy {p['busy']:.2f} ms, idle share "
                f"{1 - p['busy'] / p['wall']:.3f}; by group: " + "; ".join(
                    f"{g} {t:.2f}" for g, t in sorted(p["groups"].items(), key=lambda kv: -kv[1])))
        w = walls[lvl]
        log(f"[overload]   level {lvl} (kb={kb}): {steps[lvl]} decode steps, routed decode "
            f"flash calls {by_kb[kb]} = {n_mod} x {steps[lvl]}; decode-only step wall "
            f"{statistics.mean(x for x, _ in w) if w else float('nan'):.2f} ms mean over "
            f"{len(w)} ({statistics.mean(n for _, n in w) if w else float('nan'):.1f} slots "
            f"active on average); {busy}")
    log(f"[overload]   launches: {json.dumps({k: v for k, v in delta.items() if v})}")
    for name, prio, ctrl in (("latency", "latency", True), ("uncontrolled", "batch", False)):
        e = overload_1b_engine(params, cfg, dev, ctrl=ctrl)
        for r in overload_1b_requests(cfg, prio):
            e.submit(r)
        e.run()
        out[name] = {o.uid: o.tokens.tolist() for o in e.finished}
        st = e.stats()
        if name == "latency" and (st["degraded_decode_steps"] != 0.0
                                  or st["capacity_level_max"] < 1.0):
            raise AssertionError(f"13b (ii): degraded decode steps {st['degraded_decode_steps']}, "
                                 f"controller max {st['capacity_level_max']}")
        log(f"[overload] 13b ({'ii' if ctrl else 'iii'}) {name}: {st['steps']:.0f} steps, "
            f"{st['tokens_per_s']:.1f} tok/s"
            + (f", controller max level {st['capacity_level_max']:.0f}, "
               f"{st['degraded_decode_steps']:.0f} degraded decode steps" if ctrl else ""))
    if out["latency"] != out["uncontrolled"]:
        raise AssertionError("13b: latency-tier streams differ from the uncontrolled run's for "
                             f"{[u for u in out['latency'] if out['latency'][u] != out['uncontrolled'][u]]}")
    log(f"[overload] 13b: latency-tier streams under the controller equal the uncontrolled "
        f"run's bitwise ({len(out['latency'])} requests)")
    return {lvl: dict(steps=steps[lvl], kb=kbs[lvl], **({} if lvl not in prof else prof[lvl]))
            for lvl in range(3)}


def faults_1b(dev, params):
    """13c: mod-paper-1b in bf16, 13b's engine and requests under
    OVERLOAD_CTRL_1B, with FaultInjector.seeded(0, n_faults=6, horizon=30)
    plus one page_exhaustion fault that holds every obtainable page for 6
    steps at step 4 (every slot decoding; a slot crossing a page boundary
    meanwhile preempts the youngest): JAX's fault contract, and at least one
    preemption while those pages are held."""
    from repro_torch.serve import Fault, FaultInjector

    cfg = serve_1b_config()
    # hold_pages takes what it can: every page obtainable at step 4
    inj = FaultInjector(FaultInjector.seeded(0, n_faults=6, horizon=30).faults
                        + [Fault("page_exhaustion", step=4, pages=1 << 30, duration=6)])
    eng = overload_1b_engine(params, cfg, dev, ctrl=True, fault_injector=inj)
    reqs = overload_1b_requests(cfg, "batch")
    _, preempted = drive_faults(eng, inj, reqs[::-1],
                                lambda: overload_1b_requests(cfg, "batch")[0], depth=len(reqs))
    assert_fault_contract("13c", eng, inj)
    s = eng.stats()
    held = preempted[9] - preempted[3]  # in steps 4-9, while the pages were held
    if held < 1:
        raise AssertionError(f"13c: no preemption while every page was held ({inj.fired})")
    log(f"[overload] 13c {cfg.name} bf16 fault matrix: fired "
        f"{', '.join(f['kind'] + '@' + str(f['step']) for f in inj.fired)}; {len(eng.finished)} "
        f"requests, failed {s['failed']:.0f} (one a corruption step), preemptions "
        f"{s['preemptions']:.0f} ({held} in steps 4-9 under the full hold), {s['steps']:.0f} "
        f"steps; nothing held or mapped at the end")


def overload_phase(dev):
    """Phase 13 in order, on mod-paper-1b weights made from seed 0
    (SERVE_1B_LAYERS of its layers); returns
    (the launch counts of its card runs, 13b's levels)."""
    from repro_torch.kernels import build
    from repro_torch.models import api

    params = api.init_model(serve_1b_config(), device=dev, seed=0)
    build.reset_counters()
    t = time.perf_counter()
    overload_parity(dev)
    t1 = time.perf_counter()
    levels = serve_overload_1b(dev, params)
    t2 = time.perf_counter()
    faults_1b(dev, params)
    torch.cuda.synchronize()
    log(f"[time] 13a {t1 - t:.1f}s, 13b {t2 - t1:.1f}s, 13c {time.perf_counter() - t2:.1f}s")
    counts = build.launch_counts()
    missing = [k for k in OVERLOAD_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase 13 never launched {missing}: {counts}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[overload] phase 13 launches: {json.dumps({k: v for k, v in counts.items() if v})}")
    return counts, levels


# ---------------------------------------------------------------------------
# Phase 16: partitioned routing (data_shards) and the mesh engine
# ---------------------------------------------------------------------------

# 16a/16b: phase 4's 16 requests on mod-paper-1b at SERVE_1B_LAYERS, 8 slots;
# the paged engines with phase 6c's page and chunk
MESH_1B = dict(B=8, requests=16, gen=32, lo=128, hi=1024, page=16, chunk=256)
MESH_SHARDS = (1, 2, 4)
# 16c: two gloo ranks on the card, mod-paper-60m f32 at PARITY_60M_LAYERS,
# on the meshes (pod, data, model) below: the data degree is pod x data
MESH_60M = dict(B=8, requests=12, prompt=16, gen=8, ctx=32)
MESH_60M_MESHES = ((1, 2, 1), (1, 1, 2), (2, 1, 1))
MESH_LOGITS_TOL = 1e-5  # 16c: f32 logits of a mesh run against one process


def mesh_1b_requests(cfg):
    """Phase 4's requests: lengths from default_rng(0) in [lo, hi], tokens
    from SyntheticLM(seed=7)."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serve import Request

    w = MESH_1B
    lens = np.random.default_rng(0).integers(w["lo"], w["hi"] + 1, w["requests"])
    prompts = SyntheticLM(cfg.vocab, w["hi"], seed=7).batch(0, w["requests"])["tokens"]
    return [Request(tokens=prompts[i, : lens[i]], max_new_tokens=w["gen"])
            for i in range(w["requests"])]


@contextlib.contextmanager
def recorded_batch_decisions():
    """Every ``routing.decide_batch`` call of the block, kept on the device
    (no sync): (routed rows, active mask, data_shards, rows of the call)."""
    from repro_torch.core import routing as ROUT

    orig = ROUT.decide_batch
    seen: list = []

    def rec(params, x, cfg, active=None, data_shards=1):
        d = orig(params, x, cfg, active, data_shards)
        seen.append((d.idx, active, data_shards, x.shape[0]))
        return d

    ROUT.decide_batch = rec
    try:
        yield seen
    finally:
        ROUT.decide_batch = orig


def check_shard_routing(tag: str, seen: list, kb_local: int, groups: int) -> str:
    """Every recorded decode decision routes exactly ``kb_local`` rows in
    each of its ``groups`` (the call's own rows form one group on a mesh
    rank), and of them the group's live rows first (``min(kb_local,
    live)``). Returns a summary: routed rows a step, per shard."""
    per_shard = [dict() for _ in range(groups)]
    for idx, active, shards, rows in seen:
        idx, act = idx.cpu().numpy(), active.cpu().numpy()
        bl = rows // shards
        for g in range(shards):
            mine = idx[(idx // bl) == g]
            live = int(act[g * bl:(g + 1) * bl].sum())
            if len(mine) != kb_local or int(act[mine].sum()) != min(kb_local, live):
                raise AssertionError(f"{tag}: group {g} routed {mine.tolist()} with {live} live "
                                     f"rows, not kb_local = {kb_local} (live first)")
            key = (len(mine), int(act[mine].sum()))
            per_shard[g % groups][key] = per_shard[g % groups].get(key, 0) + 1
    return "; ".join(
        f"shard {g}: " + ", ".join(f"{n} rows ({lv} live) in {c} calls"
                                   for (n, lv), c in sorted(d.items()))
        for g, d in enumerate(per_shard))


def mesh_serve_run(tag, params, cfg, dev, ecfg, reqs, profile=True):
    """One engine run of ``reqs`` (all submitted at once) with its decode
    decisions recorded; one pure decode step (every slot generating) under
    torch.profiler. Returns (streams, stats, decisions, (wall, busy) ms of
    the profiled step or None)."""
    from repro_torch.serve import ServingEngine

    eng = ServingEngine(params, cfg, ecfg, device=dev)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    prof = None
    with recorded_batch_decisions() as seen:
        while eng.has_work:
            if (profile and prof is None and eng.decode_steps >= 2
                    and all(s.state == "generate" for s in eng.slots)):
                wall, busy = profiled_step(eng)[:2]
                prof = (wall, busy)
            else:
                eng.step()
        torch.cuda.synchronize()
    if profile and prof is None:
        raise AssertionError(f"[mesh] {tag}: no step had every slot generating to profile")
    outs = eng.finished
    if len(outs) != len(reqs) or not all(o.ok for o in outs):
        raise AssertionError(f"[mesh] {tag}: {[(o.uid, o.finish_reason) for o in outs]}")
    return {o.uid: o.tokens.tolist() for o in outs}, eng.stats(), seen, prof


def serve_data_shards_1b(dev):
    """16a: the contiguous engine at data_shards 1, 2, 4, then the paged +
    prefix and int8/page engines at 2; 16b: the contiguous engine over a
    one-rank NCCL mesh, its launches counted. Returns (the mesh run's
    launch counts, the d=1 streams)."""
    from repro_torch.core.routing import batch_capacity_k
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as M
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, QuantConfig

    cfg = serve_1b_config()
    params = api.init_model(cfg, device=dev, seed=0)
    w = MESH_1B
    B, ctx = w["B"], w["hi"] + w["gen"]
    reqs = mesh_1b_requests(cfg)
    paged = dict(page_size=w["page"], prefill_chunk=w["chunk"], prefix_cache=True)
    runs = [(f"contiguous d={d}", d, {}) for d in MESH_SHARDS] + [
        ("paged+prefix d=2", 2, paged),
        ("int8/page d=2", 2, dict(paged, quant=QuantConfig(kv="int8", granularity="page")))]
    streams: dict = {}
    # warm-up (cuBLAS handles, allocator), off every reading
    mesh_serve_run("warm-up", params, cfg, dev, EngineConfig(batch_size=B, ctx=ctx),
                   reqs[:2], profile=False)
    for tag, d, kw in runs:
        t = time.perf_counter()
        ecfg = EngineConfig(batch_size=B, ctx=ctx, data_shards=d if d > 1 else None, **kw)
        got, s, seen, (wall, busy) = mesh_serve_run(tag, params, cfg, dev, ecfg, reqs)
        kb, kb_local = batch_capacity_k(cfg, B, d), batch_capacity_k(cfg, B // d)
        if s["routed_kb"] != kb or s["data_shards"] != d:
            raise AssertionError(f"[mesh] {tag}: stats {s['routed_kb']} / {s['data_shards']}")
        summary = check_shard_routing(tag, seen, kb_local, d)
        streams[tag] = got
        base = streams["contiguous d=1"]
        same = sum(a == b for u in got for a, b in zip(got[u], base[u]))
        total = sum(len(t) for t in got.values())
        log(f"[mesh] 16a {tag}: global kb {kb} = {d} x kb_local {kb_local}; "
            f"{len(seen)} routed decode calls, {summary}; decode step (profiled, every slot "
            f"generating) wall {wall:.2f} ms, busy {busy:.3f} ms, idle share "
            f"{1 - busy / wall:.3f}; engine mean {1e3 * s['decode_s'] / s['decode_steps']:.2f} ms "
            f"wall a decode step over {s['decode_steps']:.0f}; tokens equal to d=1: "
            f"{same}/{total}; {time.perf_counter() - t:.1f}s")
    # 16b: the same engine over a one-rank NCCL mesh
    store = tempfile.TemporaryDirectory()
    M.init_process_group("nccl", rank=0, world_size=1,
                         store=torch.distributed.FileStore(os.path.join(store.name, "store"), 1))
    try:
        mesh = M.auto_mesh()
        described = M.describe_mesh(mesh)
        ecfg = EngineConfig(batch_size=B, ctx=ctx, mesh=mesh)
        build.reset_counters()
        torch.cuda.synchronize()
        got, s, seen, (wall, busy) = mesh_serve_run("mesh (1, 1)", params, cfg, dev, ecfg, reqs)
        counts = build.launch_counts()
    finally:
        M.destroy_process_group()
        store.cleanup()
    if got != streams["contiguous d=1"]:
        raise AssertionError("[mesh] 16b: the one-rank mesh's streams differ from data_shards=1")
    for name in SERVE_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"[mesh] 16b: kernel {name} was not launched on the mesh path")
    summary = check_shard_routing("16b", seen, batch_capacity_k(cfg, B), 1)
    log(f"[mesh] 16b one-rank mesh {described}: streams "
        f"bitwise equal to data_shards=1 ({sum(len(t) for t in got.values())} tokens); "
        f"{summary}; decode step wall {wall:.2f} ms, busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall:.3f}; launches {json.dumps(counts)}")
    del params
    return counts, streams["contiguous d=1"]


def _mesh_60m_requests(cfg):
    from repro_torch.serve import Request

    w = MESH_60M
    rng = np.random.default_rng(3)  # distinct tokens a prompt: no routing ties
    return [Request(tokens=rng.permutation(cfg.vocab)[: w["prompt"]], max_new_tokens=w["gen"])
            for _ in range(w["requests"])]


def _mesh_60m_serve(dev, **kw):
    """16c's engine run: (streams, the decode logits of every step, routed
    kb, pool rows, wall ms a decode step)."""
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, ServingEngine

    cfg = parity_60m_config()
    params = api.init_model(cfg, device=dev, seed=0)
    taps: list = []
    w = MESH_60M
    eng = ServingEngine(params, cfg, EngineConfig(batch_size=w["B"], ctx=w["ctx"],
                                                  logit_tap=lambda l: taps.append(l.copy()),
                                                  **kw), device=dev)
    outs = eng.run_stream(_mesh_60m_requests(cfg), 2)
    s = eng.stats()
    return ({o.uid: o.tokens.tolist() for o in outs}, np.stack(taps),
            eng.scheduler.routed_capacity, eng.pool.rows, 1e3 * s["decode_s"] / s["decode_steps"])


def _mesh_rank(rank, world, store, model_axis, pod, device, queue):
    """One gloo rank of 16c (a process of its own, on ``device``)."""
    import traceback

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import mesh as M

    try:
        dev = M.init_process_group("gloo", rank=rank, world_size=world, device=device,
                                   store=torch.distributed.FileStore(store, world))
        queue.put((rank, _mesh_60m_serve(dev, mesh=M.auto_mesh(model_axis, pod=pod)), None))
    except Exception:  # noqa: BLE001 -- reported to the parent, which fails
        queue.put((rank, None, traceback.format_exc()))
    finally:
        M.destroy_process_group()


def mesh_gloo_60m(dev):
    """16c: two processes on the one card over gloo (NCCL refuses two ranks
    on one device), mod-paper-60m f32 at 4 of 8 layers, on the meshes
    (data, model) = (2, 1) and (1, 2) and (pod, data, model) = (2, 1, 1) at
    once (three groups of two ranks), against the single-process runs at
    the data degree."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    groups = {}
    t = time.perf_counter()
    stores = tempfile.TemporaryDirectory()
    for pod, data, model in MESH_60M_MESHES:
        queue = ctx.Queue()
        store = os.path.join(stores.name, f"store-{pod}x{data}x{model}")
        procs = [ctx.Process(target=_mesh_rank, args=(r, 2, store, model, pod, dev.type, queue))
                 for r in range(2)]
        for p in procs:
            p.start()
        groups[(pod, data, model)] = (queue, procs)
    # the references run while the ranks start
    refs = {d: _mesh_60m_serve(dev, data_shards=d if d > 1 else None) for d in (1, 2)}
    results = {}
    try:
        for key, (queue, procs) in groups.items():
            results[key] = sorted((queue.get(timeout=180) for _ in procs), key=lambda g: g[0])
    finally:
        for queue, procs in groups.values():
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        stores.cleanup()
    for (pod, data, model), got in results.items():
        name = (f"({data}, {model})" if pod == 1
                else f"(pod, data, model) = ({pod}, {data}, {model})")
        d = pod * data
        errors = [e for _, _, e in got if e is not None]
        if errors:
            raise AssertionError(f"[mesh] 16c {name}: a rank failed:\n{errors[0]}")
        ref_streams, ref_logits, ref_kb, _, ref_ms = refs[d]
        for rank, (streams, logits, kb, rows, ms), _ in got:
            if streams != ref_streams:
                raise AssertionError(f"[mesh] 16c {name} rank {rank}: streams differ "
                                     f"from the single-process data_shards={d} run")
            if logits.shape != ref_logits.shape:
                raise AssertionError(f"[mesh] 16c: {logits.shape} logits, not {ref_logits.shape}")
            err = float(np.abs(logits - ref_logits).max())
            if err > MESH_LOGITS_TOL or kb != ref_kb or rows != MESH_60M["B"] // d:
                raise AssertionError(f"[mesh] 16c {name} rank {rank}: logits off by "
                                     f"{err}, kb {kb} / {ref_kb}, {rows} pool rows")
            log(f"[mesh] 16c mesh {name} rank {rank} (gloo, {dev.type}): streams equal "
                f"to one process at data_shards={d} ({sum(len(s) for s in streams.values())} "
                f"tokens), decode logits within {err:.2e} over {len(logits)} steps, global kb "
                f"{kb}, {rows} pool rows; engine mean {ms:.2f} ms wall a decode step (one "
                f"process: {ref_ms:.2f})")
    log(f"[mesh] 16c: the three meshes' six ranks and the references in "
        f"{time.perf_counter() - t:.1f}s, the ranks' start included")


def mesh_phase(dev):
    """Phase 16: returns the one-rank mesh run's launch counts."""
    counts, _ = serve_data_shards_1b(dev)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_gloo_60m(dev)
    return counts


# ---------------------------------------------------------------------------
# Phase 17: the mesh trainer
# ---------------------------------------------------------------------------

# 17a: mod-paper-1b at SERVE_1B_LAYERS, bf16, pallas_fused, over a one-rank
# NCCL mesh against one process (the same weights and batches)
MESH_TRAIN_1B = dict(B=4, S=2048, steps=3)
# 17b: two gloo ranks on the card, mod-paper-60m f32 at PARITY_60M_LAYERS,
# remat "full": FSDP gathers a layer group's leaves inside its remat
# boundary, so a rank holds one group's gathered weights at a time (the
# peak memory lines show it beside DP's)
MESH_TRAIN_60M = dict(B=8, S=128, steps=3, lr=1e-3)
MESH_TRAIN_REMAT = "full"
MESH_TRAIN_MESHES = ((2, 1, False), (1, 2, False), (2, 1, True))
# 17b tolerances: losses relative; parameters as tests/test_torch_mesh_train.py
# holds them (every element within AdamW's 2·lr a step, all but 0.1% of a
# leaf within 1e-5 + 2e-6 of its largest |value|); the pipeline absolute
MESH_TRAIN_LOSS_RTOL = 1e-5
MESH_TRAIN_P_TOL, MESH_TRAIN_P_OUTLIERS = 2e-6, 1e-3
MESH_TRAIN_PIPE_TOL = 1e-6
MESH_TRAIN_KERNELS = {False: ("routed_attention", "routed_mlp_scatter", "flash_attention"),
                      True: ("gather_rows", "scatter_add_rows", "flash_attention")}


def _mesh_train_run(tag, cfg, dev, spmd=None):
    """MESH_TRAIN_1B's steps of a Trainer (one process, or this rank of
    ``spmd``'s mesh), the last one profiled. Returns (losses, launch
    counts, (wall, busy) ms of the profiled step)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import OptimConfig, TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.train import Trainer

    w = MESH_TRAIN_1B
    tcfg = TrainConfig(global_batch=w["B"], seq_len=w["S"],
                       optim=OptimConfig(lr=1e-4, warmup_steps=2, total_steps=w["steps"]),
                       log_every=10**9, ckpt_every=10**9)
    source = SyntheticLM(cfg.vocab, w["S"], seed=0)
    loader = ShardedLoader(source, w["B"], dev, spmd=spmd)
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(cfg, tcfg, loader, ckpt=CheckpointManager(ckdir), device=dev, spmd=spmd,
                          log_fn=lambda m: None)
        state = trainer.init_or_resume()
        torch.cuda.synchronize()
        build.reset_counters()
        losses = []
        for i in range(w["steps"]):
            if i == w["steps"] - 1:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    state, m = trainer.run(state, 1)
            else:
                state, m = trainer.run(state, 1)
            losses.append(m["loss"])
        counts = build.launch_counts()
    loader.close()
    busy = sum(us for _, us in device_records(prof)) / 1e3
    wall = 1e3 * trainer.heartbeats[-1][1]
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[mesh-train] 17a {tag}: non-finite losses {losses}")
    return losses, counts, (wall, busy)


def mesh_train_1b(dev):
    """17a: DP and FSDP over a one-rank NCCL mesh, each against one
    process on the same weights and batches: DP against the pallas_fused
    Trainer (the fused kernels on both), FSDP against the pallas Trainer
    (the gather/scatter fallback on both). Returns the mesh runs' summed
    launch counts."""
    from repro_torch.config import MeshConfig, with_mod_backend
    from repro_torch.launch import mesh as M

    fused = with_mod_backend(serve_1b_config(), "pallas_fused")
    plain = with_mod_backend(serve_1b_config(), "pallas")
    w = MESH_TRAIN_1B
    refs = {False: _mesh_train_run("one process, pallas_fused", fused, dev),
            True: _mesh_train_run("one process, pallas", plain, dev)}
    store = tempfile.TemporaryDirectory()
    M.init_process_group("nccl", rank=0, world_size=1,
                         store=torch.distributed.FileStore(os.path.join(store.name, "store"), 1))
    total: dict = {}
    try:
        for fsdp in (False, True):
            spmd = M.mesh_ctx(MeshConfig(data=1, model=1, fsdp=fsdp))
            losses, counts, (wall, busy) = _mesh_train_run(f"fsdp={fsdp}", fused, dev, spmd)
            ref_losses, _, (ref_wall, ref_busy) = refs[fsdp]
            tag = "FSDP" if fsdp else "DP"
            if losses != ref_losses:
                raise AssertionError(f"[mesh-train] 17a {tag}: losses {losses} differ from one "
                                     f"process's {ref_losses}")
            for name in MESH_TRAIN_KERNELS[fsdp]:
                if counts.get(name, 0) <= 0:
                    raise AssertionError(f"[mesh-train] 17a {tag}: {name} was not launched")
            for name in MESH_TRAIN_KERNELS[not fsdp][:2]:
                if counts.get(name, 0):
                    raise AssertionError(f"[mesh-train] 17a {tag}: {name} launched {counts[name]}"
                                         " times: the wrong dispatch path")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            log(f"[mesh-train] 17a {tag} on {M.describe_mesh(spmd.mesh)}, mod-paper-1b at "
                f"{SERVE_1B_LAYERS} layers, {fused.dtype}, B={w['B']} S={w['S']}: losses "
                f"{', '.join(f'{x:.6f}' for x in losses)} bitwise equal to one process "
                f"({'pallas' if fsdp else 'pallas_fused'}); step {w['steps']} wall {wall:.1f} ms, "
                f"busy {busy:.1f} ms, idle share {1 - busy / wall:.3f} (one process: wall "
                f"{ref_wall:.1f} ms, busy {ref_busy:.1f} ms, idle share "
                f"{1 - ref_busy / ref_wall:.3f}); launches "
                f"{json.dumps({k: v for k, v in counts.items() if v})}")
    finally:
        M.destroy_process_group()
        store.cleanup()
    return total


def _mesh_train_60m_config():
    from repro_torch.config import with_mod_backend

    return with_mod_backend(dataclasses.replace(parity_60m_config(), remat=MESH_TRAIN_REMAT),
                            "pallas_fused")


def _mesh_train_60m_batch(cfg, dev):
    from repro_torch.data.synthetic import SyntheticLM

    w = MESH_TRAIN_60M
    b = SyntheticLM(cfg.vocab, w["S"], seed=0).batch(0, w["B"])
    return {k: torch.as_tensor(v).long().to(dev) for k, v in b.items()}


def _mesh_train_60m_tcfg():
    from repro_torch.config import OptimConfig, TrainConfig

    w = MESH_TRAIN_60M
    return TrainConfig(global_batch=w["B"], seq_len=w["S"],
                       optim=OptimConfig(lr=w["lr"], warmup_steps=1, total_steps=w["steps"]))


def _mesh_train_60m_steps(dev, spmd=None, with_grads=False) -> dict:
    """17b's run: MESH_TRAIN_60M's steps on one batch. Returns the losses,
    the final parameters, the state bytes, the placed bytes (on a mesh),
    the peak device memory the run allocated above what was allocated
    before it, and the gradients of one more forward when ``with_grads``."""
    from repro_torch.data.loader import rank_rows
    from repro_torch.train import loop as L
    from repro_torch.utils import tree_leaves

    cfg = _mesh_train_60m_config()
    tcfg = _mesh_train_60m_tcfg()
    batch = _mesh_train_60m_batch(cfg, dev)
    if spmd is not None:
        rows = torch.as_tensor(rank_rows(tcfg.global_batch, spmd.data_shards, spmd.data_rank))
        batch = {k: v[rows.to(dev)] for k, v in batch.items()}
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = L.make_train_state(cfg, dev, seed=0, spmd=spmd)
    step = L.make_train_step(cfg, tcfg, spmd)
    losses = []
    for _ in range(MESH_TRAIN_60M["steps"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated(dev) - base
    out = dict(losses=losses, bytes=L.state_bytes(state), peak=peak, grads=None,
               placed=L.MeshLayout(cfg, spmd).placed_bytes() if spmd is not None else None)
    if with_grads:
        _, _, out["grads"] = L.make_grads_fn(cfg, tcfg, spmd)(state["params"], batch,
                                                             MESH_TRAIN_60M["steps"])
    out["params"] = [t.detach() for t in tree_leaves(state["params"])]
    return out


def _mesh_train_against(ref, got, spmd) -> dict:
    """One mesh run held against the single-process run, on the rank: the
    largest loss error, the largest parameter error, the largest share of
    a leaf past 1e-5 + MESH_TRAIN_P_TOL·max, whether every element is
    within AdamW's 2·lr a step, the state bytes and the peak memory (the
    parent checks and prints them)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import api

    cfg = _mesh_train_60m_config()
    paths = [SH._path(k) for k, _ in SH._leaves(api.init_model(cfg, device="meta",
                                                             generator=torch.Generator()))]
    worst, far_max, bound_ok = 0.0, 0.0, True
    for path, full, mine in zip(paths, ref["params"], got["params"]):
        want = SH.cut_leaf(path, full, cfg, SH.mesh_sizes(spmd.mesh), spmd.coords(), spmd.fsdp)
        err = (mine - want).abs()
        far = float((err > 1e-5 + MESH_TRAIN_P_TOL * float(full.abs().max())).float().mean())
        worst, far_max = max(worst, float(err.max())), max(far_max, far)
        bound_ok &= float(err.max()) < 2 * MESH_TRAIN_60M["lr"] * MESH_TRAIN_60M["steps"]
    return dict(loss_err=max(abs(a / b - 1) for a, b in zip(got["losses"], ref["losses"])),
                worst=worst, far=far_max, bound_ok=bound_ok, bytes=got["bytes"],
                placed=got["placed"], ref_bytes=ref["bytes"], peak=got["peak"],
                ref_peak=ref["peak"])


def _mesh_train_rank(rank, world, store, device, ref_path, queue):
    """One gloo rank of 17b: the three meshes in turn, then one compressed
    all-reduce of its CUDA gradients against the same call on CPU copies,
    then a two-stage pipeline on CUDA tensors, then each mesh run held
    against the single-process run the parent writes to ``ref_path``
    meanwhile. Sends the parent summaries only."""
    import traceback

    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.config import MeshConfig
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch import mesh as M
    from repro_torch.optim.compression import compressed_all_reduce, init_error_feedback

    try:
        dev = M.init_process_group("gloo", rank=rank, world_size=world, device=device,
                                   store=torch.distributed.FileStore(store, world))
        out: dict = {"start_s": time.perf_counter() - t0}
        t = time.perf_counter()
        runs = []
        for d, m, fsdp in MESH_TRAIN_MESHES:
            spmd = M.mesh_ctx(MeshConfig(data=d, model=m, fsdp=fsdp))
            got = _mesh_train_60m_steps(dev, spmd, with_grads=(d, m, fsdp) == (2, 1, False))
            runs.append(((d, m, fsdp), spmd, got))
            if got["grads"] is not None:
                grads = got.pop("grads")
        out["train_s"] = time.perf_counter() - t
        t = time.perf_counter()
        group = torch.distributed.group.WORLD
        err = init_error_feedback(grads)
        got, got_e = compressed_all_reduce(grads, group, err)
        want, want_e = compressed_all_reduce([g.cpu() for g in grads], group,
                                             [e.cpu() for e in err])
        out["compressed"] = (all(a.is_cuda for a in got + got_e)
                             and all(torch.equal(a.cpu(), b)
                                     for a, b in zip(got + got_e, want + want_e)),
                             sum(a.numel() for a in got))
        del grads, err, got, got_e, want, want_e
        g = torch.Generator().manual_seed(5)
        W = [(torch.randn((64, 64), generator=g) * 0.2).to(dev) for _ in range(world)]
        bias = [(torch.randn((64,), generator=g) * 0.1).to(dev) for _ in range(world)]
        x = torch.randn((8, 4, 64), generator=g).to(dev)
        pipe = pipeline_forward(lambda p, h, i: torch.tanh(h @ p[0] + p[1]),
                                (W[rank], bias[rank]), x, group)
        seq = x
        for i in range(world):
            seq = torch.tanh(seq @ W[i] + bias[i])
        out["pipeline"] = (pipe.is_cuda, float((pipe - seq).abs().max()))
        out["collectives_s"] = time.perf_counter() - t
        t = time.perf_counter()
        deadline = time.monotonic() + 240
        while not os.path.exists(ref_path):
            if time.monotonic() > deadline:
                raise TimeoutError("the parent wrote no single-process run")
            time.sleep(0.05)
        out["ref_wait_s"] = time.perf_counter() - t
        ref = torch.load(ref_path, map_location=dev)
        for key, spmd, got in runs:
            out[key] = _mesh_train_against(ref, got, spmd)
        queue.put((rank, out, None))
    except Exception:  # noqa: BLE001 -- reported to the parent, which fails
        queue.put((rank, None, traceback.format_exc()))
    finally:
        M.destroy_process_group()


def mesh_train_gloo_60m(dev):
    """17b: two processes on the one card over gloo, the meshes (2, 1),
    (1, 2) and (2, 1)+fsdp in one spawn, each held against the
    single-process run (the same weights from seed 0 and the same batch)
    that this process makes while the ranks start."""
    import torch.multiprocessing as mp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    t = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    store, ref_path = os.path.join(tmp.name, "store"), os.path.join(tmp.name, "reference.pt")
    procs = [ctx.Process(target=_mesh_train_rank, args=(r, 2, store, dev.type, ref_path, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        tr = time.perf_counter()
        ref = _mesh_train_60m_steps(dev)
        torch.save({"losses": ref["losses"], "params": [p.cpu() for p in ref["params"]],
                    "bytes": ref["bytes"], "peak": ref["peak"]}, ref_path + ".part")
        os.replace(ref_path + ".part", ref_path)
        ref_s = time.perf_counter() - tr
        del ref
        got = sorted((queue.get(timeout=300) for _ in procs), key=lambda g: g[0])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        tmp.cleanup()
    errors = [e for _, _, e in got if e is not None]
    if errors:
        raise AssertionError(f"[mesh-train] 17b: a rank failed:\n{errors[0]}")
    mib = 2**20
    for rank, out, _ in got:
        for (d, m, fsdp) in MESH_TRAIN_MESHES:
            r = out[(d, m, fsdp)]
            tag = f"({d}, {m}){'+fsdp' if fsdp else ''} rank {rank}"
            if r["loss_err"] > MESH_TRAIN_LOSS_RTOL:
                raise AssertionError(f"[mesh-train] 17b {tag}: losses off by {r['loss_err']}")
            if not r["bound_ok"] or r["far"] > MESH_TRAIN_P_OUTLIERS:
                raise AssertionError(f"[mesh-train] 17b {tag}: parameters off by {r['worst']} "
                                     f"({r['far']:.2e} of a leaf past the tolerance)")
            if r["bytes"] != r["placed"]:
                raise AssertionError(f"[mesh-train] 17b {tag}: {r['bytes']} state bytes, "
                                     f"placement {r['placed']}")
            log(f"[mesh-train] 17b {tag} (gloo, {dev.type}): losses within {r['loss_err']:.2e} of "
                f"one process over {MESH_TRAIN_60M['steps']} steps; parameters within "
                f"{r['worst']:.2e} ({r['far']:.2e} of a leaf past 1e-5 + {MESH_TRAIN_P_TOL:g}·max); "
                f"state {r['bytes']} bytes = placement (one process {r['ref_bytes']}, "
                f"{r['bytes'] / r['ref_bytes']:.3f} of it); peak memory of the run "
                f"{r['peak'] / mib:.1f} MiB (one process {r['ref_peak'] / mib:.1f}, "
                f"{r['peak'] / r['ref_peak']:.3f} of it; remat {MESH_TRAIN_REMAT})")
        ok, n = out["compressed"]
        if not ok:
            raise AssertionError(f"[mesh-train] 17b rank {rank}: compressed_all_reduce of CUDA "
                                 "gradients differs from the same call on CPU tensors")
        on_dev, perr = out["pipeline"]
        if not on_dev or perr > MESH_TRAIN_PIPE_TOL:
            raise AssertionError(f"[mesh-train] 17b rank {rank}: pipeline off by {perr}")
        log(f"[mesh-train] 17b rank {rank}: compressed_all_reduce of {n} CUDA gradient values "
            f"bitwise equal to the CPU call; two-stage pipeline_forward on {dev.type} within "
            f"{perr:.1e} of the sequential stages; start {out['start_s']:.1f}s, the three meshes "
            f"{out['train_s']:.1f}s, the collectives {out['collectives_s']:.1f}s, then waited "
            f"{out['ref_wait_s']:.1f}s for the single-process run")
    log(f"[mesh-train] 17b: both ranks in {time.perf_counter() - t:.1f}s, their start included; "
        f"the single-process run here {ref_s:.1f}s meanwhile")


def mesh_train_phase(dev):
    """Phase 17: returns the one-rank mesh runs' launch counts."""
    counts = mesh_train_1b(dev)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_train_gloo_60m(dev)
    return counts


# ---------------------------------------------------------------------------
# Phase 18: the hybrid served from int8 / fp8 pages and int8 weights, remat
# "selective" on the card, a training step on packed documents
# ---------------------------------------------------------------------------

# 18a: zamba2-2.7b at HYBRID_QUANT_LAYERS, bf16, seed 0, on 14d's paged
# engine (8 slots, page 16, policy fcfs) over 14d's first
# HYBRID_QUANT_REQUESTS requests: in bf16 (the streams the narrow runs are
# set beside) and under each quantization. A step is host-bound (72-102 ms wall, 6 ms busy) and a run
# takes the longest prompt's tokens plus the new ones in steps: 8 requests
# (prompts up to 124 tokens) took 71 s of phase 18's 131 s on an H100; the
# first 2 (77 and 81 tokens) take 113 steps a run. The last run serves
# the int8 tree widened once, in bf16: its streams and first-token logits
# must be the int8-weights run's bits (that run widens the same tree at
# each model call), so how far that run moves from the bf16 one is the
# model's answer to the weights' rounding, not the narrow path's
HYBRID_QUANT_LAYERS = 18
HYBRID_QUANT_REQUESTS = 2
WIDENED = "widened int8 tree"
HYBRID_QUANT_RUNS = (("bf16", {}), ("int8/page", dict(kv="int8")),
                     ("fp8/head", dict(kv="fp8", granularity="head")),
                     ("int8 weights", dict(weights="int8")), (WIDENED, {}))
# 18b: zamba2-2.7b at all 54 layers, B=2, S=2048 (remat "none" does not fit
# one card there: PERF.md's reckoning), and mod-paper-1b at
# SERVE_1B_LAYERS, B=4, S=2048, pallas_fused, under every mode
REMAT_HYBRID = dict(B=2, S=2048, steps=3, modes=("selective", "full"))
REMAT_1B = dict(B=4, S=2048, steps=2, modes=("none", "selective", "full"))
REMAT_LOSS_RTOL = 5e-4  # steps 1-2's losses, each mode against the first
# 18c: mod-paper-60m at PARITY_60M_LAYERS, f32, one Trainer step of two
# microbatches on packed rows, CPU against the card
PACKED_60M = dict(B=4, S=128, microbatches=2)
PACKED_TOL = 1e-5  # relative


def _path_tag(label: str) -> str:
    return label.replace("/", "_").replace(" ", "_")


def profiled_kernel_step(eng):
    """One engine step under torch.profiler (device activity only): (wall
    ms, device-busy ms, the launch counters' change, the device records of
    each of the port's ``__global__`` functions, device ms by
    :func:`_kernel_group`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build

    before = build.launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    delta = {k: v - before[k] for k, v in build.launch_counts().items() if v != before[k]}
    kernels = csrc_kernels()
    records: dict = {}
    groups: dict = {}
    busy = 0.0
    for name, us in device_records(prof):
        busy += us / 1e3
        k = port_kernel_of(name, kernels)
        if k is not None:
            records[k] = records.get(k, 0) + 1
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    return wall, busy, delta, records, groups


def _agreement(got: dict, want: dict):
    """(share of tokens equal position by position, requests equal whole)."""
    same = total = whole = 0
    for uid, toks in want.items():
        other = got[uid]
        same += sum(int(a == b) for a, b in zip(toks, other))
        total += len(toks)
        whole += int(toks == other)
    return same / total, whole


def serve_hybrid_quant(dev):
    """18a: zamba2-2.7b at full width and HYBRID_QUANT_LAYERS, bf16, seed 0,
    on 14d's paged engine over 14d's first HYBRID_QUANT_REQUESTS requests,
    once in bf16 and once under each of int8/page KV, fp8/head KV and int8
    weights: every request done with its tokens, the streams' agreement
    with the bf16 run's and each first token's bf16 top-1/top-2 gap beside
    the logit change (reported, not held), ``kv_bytes`` and its ratio to
    the bf16 pool's, wall a decode step, one profiled step (every request
    live) with its launches held to the model's sites by counter and the
    dequantizing gathers torch.profiler lists printed beside them (late in
    the whole script it lists none: printed, not held), the whole run's
    launches held to its steps, and the cost of widening the int8 weights
    at each model call; then WIDENED, whose streams and first-token logits
    must equal the int8-weights run's bitwise. Returns (launch counts by
    path, the paged kernels' launches by call by path, the dequantizing
    gathers' launches by run, and each quantized pool as its profiled step
    left it: the page table and, for every site's K and V ring, its narrow
    pages, its leaf's scales and the site's scale columns)."""
    from repro_torch.config import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.paged import canon_pages
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, ServingEngine
    from repro_torch.serve.quant import QuantConfig, dequantize_params, quantize_params
    from repro_torch.serve.scheduler import FREE
    from repro_torch.utils import tree_leaves

    cfg = dataclasses.replace(get_config(CONFIGS_HYBRID), n_layers=HYBRID_QUANT_LAYERS)
    release_device_memory(dev)
    t0 = time.perf_counter()
    params = api.init_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_seg = len(params["groups"])
    w = HYBRID_SERVE
    B, ctx, n = w["B"], w["hi"] + w["gen"], HYBRID_QUANT_REQUESTS
    lens = [len(r.tokens) for r in hybrid_requests(cfg, n)]
    log(f"[hybrid-remat] 18a {cfg.name} at {cfg.n_layers} of 54 layers, bf16, {n_seg} shared-block "
        f"sites of {cfg.attn.n_kv_heads}x{cfg.head_dim} kv heads; init "
        f"{time.perf_counter() - t0:.1f}s; {n} requests (prompts {min(lens)}-{max(lens)} tokens, "
        f"{w['gen']} new each), {B} slots, page {w['page']}, ctx {ctx}, policy fcfs")
    plain_step = {"flash_attention": n_seg, "paged_gather": 3 * n_seg,
                  "paged_scatter_rows": 3 * n_seg}
    narrow_step = {"flash_attention": n_seg, "paged_gather": n_seg,
                   "paged_gather_dequant": 2 * n_seg, "paged_scatter_rows": 3 * n_seg + 2}
    streams, counts, paged, dequant, snaps, kv, firsts = {}, {}, {}, {}, {}, {}, {}
    for label, q in HYBRID_QUANT_RUNS:
        qc = QuantConfig(**q)
        if label == WIDENED:
            params = dequantize_params(quantize_params(params))
        eng = ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=ctx, policy="fcfs",
                                                      page_size=w["page"], quant=qc), device=dev)
        reqs = hybrid_requests(cfg, n)
        firsts[label] = first_token_logits(eng)
        for r in reqs:
            eng.submit(r)
        build.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        step_want = narrow_step if qc.enabled else plain_step
        prof = None
        while eng.has_work:
            if (prof is None and eng.step_count >= 20
                    and sum(s.state != FREE for s in eng.slots) == n):
                # one profiled step, every request live: its launches by
                # counter held to the sites, torch.profiler's printed (it
                # drops the records of paged.cu's kernels late in the whole
                # script, so they are not held, and its busy time then
                # leaves them out)
                wall, busy, delta, records, groups = profiled_kernel_step(eng)
                if delta != step_want:
                    raise AssertionError(f"18a {label}: a step launched {delta}, want {step_want}")
                prof = dict(wall=wall, busy=busy, step=eng.step_count, groups=groups,
                            deq=records.get("paged_gather_dequant_kernel", 0))
                if qc.enabled:  # every site's K and V ring as this step read it
                    snaps[label] = dict(table=eng.pool.device_table(), rings=[
                        (f"{'kv'[qi]} site {site}", canon_pages(eng.pool.pages[j]).clone(),
                         eng.pool.scales[qi].clone(), ql.columns(site, qc.granularity))
                        for qi, ql in enumerate(eng.pool.spec.qleaves)
                        for site, j in enumerate(ql.js)])
            else:
                eng.step()
        torch.cuda.synchronize()
        counts[label] = build.launch_counts()
        paged[label] = {name: dict(build.COUNTERS[name].by_call)
                        for name in ("paged_gather", "paged_scatter_rows")}
        s = eng.stats()
        streams[label] = _streams(eng.finished)
        if len(eng.finished) != n or any(not o.ok or len(o.tokens) != r.max_new_tokens for o, r in
                                         zip(sorted(eng.finished, key=lambda o: o.uid), reqs)):
            raise AssertionError(f"18a {label}: not every request finished with its tokens")
        steps = s["decode_steps"]
        want = {k: v * steps for k, v in step_want.items()}
        got = {k: counts[label].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"18a {label}: the run launched {got}, want {want} "
                                 f"({steps:.0f} steps)")
        dequant[label] = got.get("paged_gather_dequant", 0)
        kv[label] = s["kv_bytes"]
        line = (f"[hybrid-remat] 18a {label}: {s['generated_tokens']:.0f} tokens in "
                f"{s['wall_s']:.2f}s = {s['tokens_per_s']:.1f} tok/s; {s['steps']:.0f} steps, "
                f"{1e3 * s['decode_s'] / max(1, steps):.2f} ms wall a step; kv_bytes "
                f"{s['kv_bytes'] / 2**20:.2f} MiB (x{s['kv_bytes'] / kv['bf16']:.4f} of the bf16 "
                f"pool's; unquantized {eng.pool.unquantized_kv_bytes() / 2**20:.2f}), residual "
                f"{s['resid_bytes'] / 2**20:.2f} MiB; peak memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        if label != "bf16":
            share, whole = _agreement(streams[label], streams["bf16"])
            line += (f"; tokens equal to the bf16 run's {share:.4f} ({whole} of {n} requests "
                     f"whole)")
        log(line)
        if label != "bf16":  # each request's first token: the bf16 top-1/top-2 gap
            base = firsts["bf16"]  # beside the change this run made to those logits
            gaps = {u: float(np.diff(np.sort(row)[-2:])[0]) for u, row in base.items()}
            moved = {u: float(np.abs(firsts[label][u] - row).max()) for u, row in base.items()}
            same = sum(int(np.argmax(firsts[label][u]) == np.argmax(r)) for u, r in base.items())
            log(f"[hybrid-remat] 18a {label} first tokens: bf16 top-1/top-2 gap "
                f"{min(gaps.values()):.4f}-{max(gaps.values()):.4f}, this run's largest logit "
                f"change {min(moved.values()):.4f}-{max(moved.values()):.4f} (logits up to "
                f"{max(float(np.abs(r).max()) for r in base.values()):.2f}); first tokens equal "
                f"in {same} of {n} requests")
        if prof is None:
            raise AssertionError(f"18a {label}: no step had every request live")
        if prof["busy"] <= 0.0:
            log(f"[hybrid-remat] 18a {label}: torch.profiler recorded no device time; busy not "
                "measured")
        else:
            log(f"[hybrid-remat] 18a {label} profiled step {prof['step']} ({n} of {B} slots "
                f"live): wall "
                f"{prof['wall']:.2f} ms, device busy {prof['busy']:.2f} ms, idle share "
                f"{1 - prof['busy'] / prof['wall']:.3f}; launches {json.dumps(step_want)} by "
                f"counter; paged_gather_dequant_kernel records by torch.profiler {prof['deq']} "
                f"(printed, not held) ("
                + ", ".join(f"{k} {v:.2f}" for k, v in sorted(prof["groups"].items(),
                                                               key=lambda kv: -kv[1])[:5]) + ")")
        if label == WIDENED:
            same_logits = all(np.array_equal(firsts[label][u], r)
                              for u, r in firsts["int8 weights"].items())
            if streams[label] != streams["int8 weights"] or not same_logits:
                raise AssertionError(f"18a {label}: the streams or first-token logits differ "
                                     f"from the int8-weights run's")
            log(f"[hybrid-remat] 18a {label}: streams and first-token logits bitwise equal to "
                f"the int8-weights run's")
        log(f"[hybrid-remat]   launches: "
            f"{json.dumps({k: v for k, v in counts[label].items() if v})}")
        if q.get("weights") == "int8":
            wall_ms = event_ms(lambda: dequantize_params(eng.params), iters=5, warmup=1)
            dev_ms = time_ms(lambda: dequantize_params(eng.params), iters=5)
            narrow = sum(t.numel() for t in tree_leaves(eng.params)
                         if isinstance(t, torch.Tensor) and t.dtype == torch.int8)
            log(f"[hybrid-remat] 18a int8 weights: dequantize_params widens {narrow / 1e6:.1f}M "
                f"int8 weights to bf16 at each of the run's {steps:.0f} model calls: "
                f"{dev_ms:.2f} ms of device time ({wall_ms:.2f} ms between CUDA events), bound "
                f"{bound_ms(narrow * 3, 0, torch.bfloat16)[0]:.3f} ms (bytes)")
        del eng
    del params
    release_device_memory(dev)
    tags = {label: "hybrid_paged_" + _path_tag(label) for label, _ in HYBRID_QUANT_RUNS}
    return ({tags[k]: v for k, v in counts.items()}, {tags[k]: v for k, v in paged.items()},
            dequant, snaps)


def hybrid_remat_kernels(dev, results, snaps) -> None:
    """18's kernel shapes against their plain versions, timed by CUDA-graph
    replay beside the bound and a library call where one computes the
    same: the dequantizing gather on 18a's pools as their profiled step
    left them (every site's K and V ring bitwise; site 0's K ring timed:
    int8 pages with a (N, p, 1) scale, e4m3 pages with the site's 32 of
    the leaf's n_seg x 32 scale columns; 80-byte groups); paged_gather and
    paged_scatter_rows at 18a's pools (the position rings and the bf16 K/V
    rows of the bf16, int8-weights and widened runs, the narrow K/V rows of the quantized runs and the fp8/head scale
    rows; an int8/page scale row is a 4-byte row, the position rows' call),
    bitwise and writing no row outside their targets; flash
    attention's training call at zamba2's shared block (32 heads of 80,
    B=2, S=2048, with its lse) against SDPA; gather_rows, scatter_add_rows
    and gather's VJP (the zero target) at the routed Mamba2 layers' B=2,
    S=2048, D=2560, k=256; ssd_intra_chunk at 18b's full (NC=16) and routed
    (NC=2) layers (B=2, H=80, ds 64)."""
    from repro_torch.config import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged as KP

    cfg = get_config(CONFIGS_HYBRID)
    g = torch.Generator(device=dev).manual_seed(61)
    i32 = dict(dtype=torch.int32, device=dev)
    # the dequantizing gather on 18a's pools: every site's K and V ring
    # bitwise, site 0's K ring timed
    for label, snap in snaps.items():
        table = snap["table"]
        for ring, q, sc, cols in snap["rings"]:
            scales = sc[:, :, cols]
            got = KP.paged_gather_dequant(q, scales, table, torch.bfloat16)
            if not torch.equal(got, KP.paged_gather_dequant_plain(q, scales, table,
                                                                  torch.bfloat16)):
                raise AssertionError(f"18 paged_gather_dequant differs from its plain version "
                                     f"({label}, {ring})")
        log(f"[hybrid-remat] 18 paged_gather_dequant zamba2 {label}: all "
            f"{len(snap['rings'])} rings (K and V of every site) bitwise-equal to the plain "
            f"version")
        _, q, sc, cols = snap["rings"][0]
        scales = sc[:, :, cols]
        (N, p, F), (Bg, P), G = q.shape, table.shape, scales.shape[2]
        reads = torch.unique(table).numel()
        nbytes = reads * p * (F + 4 * G) + 4 * Bg * P + Bg * P * p * F * 2
        fn = (lambda: KP.paged_gather_dequant(q, scales, table, torch.bfloat16))
        how: dict = {}
        r = dict(ms=replay_ms(fn, how, "ms"),
                 plain_ms=replay_ms(lambda: KP.paged_gather_dequant_plain(
                     q, scales, table, torch.bfloat16), how, "plain_ms"),
                 library_ms=None, bound=bound_ms(nbytes, 0, torch.bfloat16), max_abs_err=0.0,
                 shape=f"zamba2 {label} N={N} p={p} F={F} G={G} B={Bg} P={P} -> bf16",
                 timed_by=how, run=label)
        log(f"[hybrid-remat] 18 paged_gather_dequant {r['shape']:56s} bitwise-equal "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms=none "
            f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]}, {r['bound'][0] / r['ms']:.0%} of "
            f"it){timed_note(how)}")
        results.setdefault("paged_gather_dequant", {})[f"hybrid {label} B={Bg}"] = r
    # paged_gather / paged_scatter_rows at 18a's pools: 8 slots of P pages
    w = HYBRID_SERVE
    lens = [len(r.tokens) for r in hybrid_requests(cfg, HYBRID_QUANT_REQUESTS)]
    lens += [w["hi"]] * (w["B"] - len(lens))  # every slot's pages mapped
    P = (w["hi"] + w["gen"]) // w["page"]
    F_kv = cfg.attn.n_kv_heads * cfg.head_dim
    n_seg = HYBRID_QUANT_LAYERS // cfg.hybrid_attn_every
    paged_cases = [  # label, dtype, F, the runs that launch the shape
        ("kv bf16", torch.bfloat16, F_kv, ("bf16", "int8 weights", WIDENED)),
        # (an int8/page pool's scale rows are 4 bytes too: the same call)
        ("pos", torch.int32, 1, tuple(lb for lb, _ in HYBRID_QUANT_RUNS)),
        ("kv narrow", torch.int8, F_kv, ("int8/page", "fp8/head")),
        ("scales head", torch.float32, n_seg * cfg.attn.n_kv_heads, ("fp8/head",)),
    ]
    for label, dtype, F, runs in paged_cases:
        # narrow pages and scales are read by the dequantizing gather
        gather = not label.startswith(("kv narrow", "scales"))
        for name, r in paged_rows("[hybrid-remat] 18", f"zamba2 {label}", g, dev, dtype, F,
                                  lens, w["gen"], P, w["page"], gather).items():
            results.setdefault(name, {})[f"18 {label} B={w['B']}"] = dict(
                r, runs=["hybrid_paged_" + _path_tag(rn) for rn in runs])
    # flash attention's training call at the shared block
    B, S = REMAT_HYBRID["B"], REMAT_HYBRID["S"]
    nq, nkv, hd = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.head_dim
    pos = torch.arange(S, **i32)[None].repeat(B, 1)
    c = FlashCase(f"hd80 train B={B} S={S} lse", B, S, S, nq, nkv, hd, pos, pos,
                  (torch.bfloat16,), True)
    plan = FA.flash_plan(c.B, c.Sq, c.Skv, c.nq, c.nkv, c.hd, torch.bfloat16)
    build.reset_counters()
    r = flash_row(FA, c, torch.bfloat16, g)
    key = (plan.path, c.B, c.Sq, c.Skv, c.nq, c.nkv, c.hd, plan.kernels)
    if plan.path != "mma_sync" or key not in FA.FLASH_ATTENTION.by_call:
        raise AssertionError(f"18 flash {c.label}: plan {plan}, launched "
                             f"{dict(FA.FLASH_ATTENTION.by_call)}, want the mma_sync tiles")
    r["path"], r["kernels"] = plan.path, plan.kernels
    r["plan"] = dict(path=plan.path, key_tile=plan.key_tile, key_split=plan.key_split,
                     chunk=plan.chunk, n_splits=plan.n_splits, merge=plan.merge)
    log(f"[hybrid-remat] 18 flash_attention {r['shape']:36s} {plan.path} kernels={plan.kernels} "
        f"max_abs_err={r['max_abs_err']:.3g} lse_err={r['lse_err']:.3g} ms={r['ms']:.4f} "
        f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (SDPA) "
        f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]})")
    results.setdefault("flash_attention", {})[(c.label, torch.bfloat16)] = r
    # the MoD dispatch of the routed Mamba2 layers, with gather's VJP
    D, k = cfg.d_model, cfg.mod.capacity(S)
    log_dispatch_rows("[hybrid-remat] 18", f"zamba2 B={B} S={S} D={D}",
                      dispatch_rows(g, dev, torch.bfloat16, B, S, D, k, zero=True),
                      torch.bfloat16, results)
    # the SSD kernel at the training forward's full and routed shapes
    ssm = cfg.ssm
    for kind, NC in (("full", S // ssm.chunk), ("routed", k // ssm.chunk)):
        shape = (B, ssm.n_heads(cfg.d_model), NC, ssm.chunk, ssm.head_dim, ssm.d_state)
        results.setdefault("ssd_intra_chunk", {})[(f"zamba2 train {kind}", torch.bfloat16)] = \
            ssd_row("[hybrid-remat] 18", f"zamba2 train {kind}", dev, shape, 62)


def remat_run(tag: str, cfg, B: int, S: int, steps: int, dev) -> dict:
    """``steps`` Trainer steps of ``cfg`` (its remat mode) from the Trainer's
    seed, B x S rows of the synthetic corpus at seed 0, AdamW with a cosine
    schedule (lr 1e-4 after 2 warmup steps), the last step profiled (device
    activity only). Returns the losses, wall ms a step, the last step's busy
    ms, the state's
    device bytes, the peak allocated and reserved bytes above nothing, the
    launches and flash's, the dispatch kernels' and the SSD kernel's
    launches by call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import OptimConfig, TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.train import Trainer

    release_device_memory(dev)
    tcfg = TrainConfig(global_batch=B, seq_len=S,
                       optim=OptimConfig(lr=1e-4, warmup_steps=2, total_steps=steps),
                       log_every=1, ckpt_every=10**9)
    loader = ShardedLoader(SyntheticLM(cfg.vocab, S, seed=0), B, dev)
    out = dict(losses=[], wall=[])
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(cfg, tcfg, loader, ckpt=CheckpointManager(ckdir), device=dev,
                          log_fn=lambda m: None)
        t0 = time.perf_counter()
        state = trainer.init_or_resume()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        out["state_gib"] = torch.cuda.memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
        build.reset_counters()
        for i in range(steps):
            # the last step profiled (device activity only): its records
            # take seconds to read at 54 layers, and recording them slows
            # the host
            last = i == steps - 1
            with (profile(activities=[ProfilerActivity.CUDA]) if last
                  else contextlib.nullcontext()) as prof:
                state, m = trainer.run(state, 1)
            wall = 1e3 * trainer.heartbeats[-1][1]
            out["losses"].append(m["loss"])
            out["wall"].append(wall)
            line = (f"[hybrid-remat] 18b {tag} step {i + 1}: loss {m['loss']:.6f} grad norm "
                    f"{m['grad_norm']:.4f}; wall {wall:.1f} ms")
            if last:
                groups: dict = {}
                for name, us in device_records(prof):
                    groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + us / 1e3
                out["busy"] = sum(groups.values())
                line += (f" (profiled), device busy {out['busy']:.1f} ms, idle share "
                         f"{1 - out['busy'] / wall:.3f} (" + ", ".join(
                             f"{g} {t:.1f}" for g, t in sorted(groups.items(),
                                                               key=lambda kv: -kv[1])[:4]) + ")")
            log(line)
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["reserved_gib"] = torch.cuda.max_memory_reserved(dev) / 2**30
        out["counts"] = build.launch_counts()
        out["flash"] = flash_calls()
        out["dispatch"] = dispatch_by_call()
        out["ssd"] = dict(build.COUNTERS["ssd_intra_chunk"].by_call)
        loader.close()
        del trainer, state
    release_device_memory(dev)
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"18b {tag}: non-finite loss {out['losses']}")
    log(f"[hybrid-remat] 18b {tag}: init {init_s:.1f}s; state (weights, AdamW moments) "
        f"{out['state_gib']:.2f} GiB; peak allocated {out['peak_gib']:.2f} GiB "
        f"({out['peak_gib'] - out['state_gib']:.2f} above the state), peak reserved "
        f"{out['reserved_gib']:.2f} GiB; launches "
        f"{json.dumps({k: v for k, v in out['counts'].items() if v})}")
    return out


def train_remat(dev) -> dict:
    """18b: zamba2-2.7b at full width and all 54 layers, bf16, B=2,
    S=2048, REMAT_HYBRID's steps under remat "selective" and then "full";
    mod-paper-1b at full width and SERVE_1B_LAYERS of its 24 layers, bf16,
    pallas_fused, B=4, S=2048, REMAT_1B's steps under "none", "selective"
    and "full"; each run from the same weights and batches. Steps 1-2's
    losses within REMAT_LOSS_RTOL of the first mode's (the modes compute
    one function: selective keeps the products full recomputes); the
    kernels launched in every run (flash, the SSD kernel and the dispatch
    kernels for zamba2; the fused routed kernels for 1b, recomputed under
    both remat modes, unseen by the selective policy). Returns the runs."""
    from repro_torch.config import get_config, with_mod_backend

    runs: dict = {}
    zcfg = get_config(CONFIGS_HYBRID)
    c1b = with_mod_backend(dataclasses.replace(get_config("mod-paper-1b"),
                                               n_layers=SERVE_1B_LAYERS), "pallas_fused")
    log(f"[hybrid-remat] 18b {zcfg.name}: all {zcfg.n_layers} layers, {zcfg.n_params() / 1e9:.3f}B "
        f"params in {zcfg.dtype}, B={REMAT_HYBRID['B']} S={REMAT_HYBRID['S']}; "
        f"{c1b.name} at {c1b.n_layers} of 24 layers, pallas_fused, B={REMAT_1B['B']} "
        f"S={REMAT_1B['S']}")
    for name, cfg, w, want in (("zamba2", zcfg, REMAT_HYBRID,
                                ("flash_attention", "ssd_intra_chunk", "gather_rows",
                                 "scatter_add_rows")),
                               ("1b", c1b, REMAT_1B, TRAIN_KERNELS)):
        first = None
        for mode in w["modes"]:
            tag = f"{name} {mode}"
            r = runs[tag] = remat_run(tag, dataclasses.replace(cfg, remat=mode), w["B"], w["S"],
                                      w["steps"], dev)
            missing = [k for k in want if r["counts"].get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"18b {tag}: {missing} not launched")
            if first is None:
                first = r
                continue
            for i, (a, b) in enumerate(zip(r["losses"][:2], first["losses"][:2])):
                if abs(a / b - 1) > REMAT_LOSS_RTOL:
                    raise AssertionError(f"18b {tag}: step {i + 1}'s loss {a} is not within "
                                         f"{REMAT_LOSS_RTOL} of {w['modes'][0]}'s {b}")
        log(f"[hybrid-remat] 18b {name}: losses " + "; ".join(
            f"{m} {', '.join(f'{x:.6f}' for x in runs[f'{name} {m}']['losses'])}"
            for m in w["modes"]) + "; bitwise across modes: " + str(all(
                runs[f"{name} {m}"]["losses"] == runs[f"{name} {w['modes'][0]}"]["losses"]
                for m in w["modes"])) + "; busy ms of the last step " + "; ".join(
            f"{m} {runs[f'{name} {m}']['busy']:.1f}" for m in w["modes"])
            + "; wall ms of the steps after the first " + "; ".join(
            f"{m} {', '.join(f'{x:.1f}' for x in runs[f'{name} {m}']['wall'][1:])}"
            for m in w["modes"])
            + "; peak GiB " + "; ".join(
            f"{m} {runs[f'{name} {m}']['peak_gib']:.2f}" for m in w["modes"]))
    return runs


class PackedRows:
    """A source of global batches packed from a seeded stream of documents of
    3-100 tokens (``repro_torch.data.packing.pack_documents``)."""

    def __init__(self, vocab: int, seq_len: int, n_docs: int, seed: int = 0):
        from repro_torch.data.packing import pack_documents

        rng = np.random.default_rng(seed)
        docs = [rng.integers(1, vocab, int(n)) for n in rng.integers(3, 101, n_docs)]
        self.rows = list(pack_documents(docs, seq_len))

    def batch(self, step: int, batch_size: int) -> dict:
        rows = self.rows[step * batch_size:(step + 1) * batch_size]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def packed_parity(dev) -> dict:
    """18c: one Trainer step of mod-paper-60m at PARITY_60M_LAYERS, f32,
    backend pallas, on rows packed from documents (``loss_mask`` drops the
    targets across documents), two microbatches, the same weights on the
    CPU (plain versions) and on the card (kernels): losses within
    PACKED_TOL. Returns the card step's launches."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import OptimConfig, TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.train import Trainer, make_train_state

    cfg = parity_60m_config()
    w = PACKED_60M
    source = PackedRows(cfg.vocab, w["S"], 32)
    mask = source.batch(0, w["B"])["loss_mask"]
    if not 0 < mask.mean() < 1:
        raise AssertionError(f"18c: the packed rows' mask keeps {mask.mean()} of the targets")
    params = api.init_model(cfg, device="cpu", seed=0)
    losses, counts = {}, {}
    for d in ("cpu", dev):
        tcfg = TrainConfig(global_batch=w["B"], seq_len=w["S"], microbatches=w["microbatches"],
                           optim=OptimConfig(lr=1e-3, warmup_steps=1, total_steps=2),
                           log_every=1, ckpt_every=10**9)
        loader = ShardedLoader(source, w["B"], torch.device(d), microbatches=w["microbatches"])
        with tempfile.TemporaryDirectory() as ckdir:
            trainer = Trainer(cfg, tcfg, loader, ckpt=CheckpointManager(ckdir), device=d,
                              log_fn=lambda m: None)
            state = make_train_state(cfg, d, params=_to(params, d))
            build.reset_counters()
            state, m = trainer.run(state, 1)
            if d != "cpu":
                torch.cuda.synchronize()
            counts[str(d)] = build.launch_counts()
            losses[str(d)] = m["loss"]
        loader.close()
    cpu, card = losses["cpu"], losses[str(dev)]
    if abs(card / cpu - 1) > PACKED_TOL:
        raise AssertionError(f"18c packed step: loss {card} on the card, {cpu} on the CPU")
    for k in ("gather_rows", "scatter_add_rows", "flash_attention"):
        if counts[str(dev)].get(k, 0) <= 0:
            raise AssertionError(f"18c packed step: {k} not launched")
    log(f"[hybrid-remat] 18c packed rows ({w['B']} x {w['S']} from {len(source.rows)} rows of "
        f"documents, {float(mask.mean()):.4f} of the targets kept), {w['microbatches']} "
        f"microbatches, one Trainer step of {cfg.name} at {cfg.n_layers} layers, f32: loss "
        f"{card:.8f} on the card, {cpu:.8f} on the CPU ({abs(card / cpu - 1):.2e} apart, limit "
        f"{PACKED_TOL:g}); launches "
        f"{json.dumps({k: v for k, v in counts[str(dev)].items() if v})}")
    return counts[str(dev)]


def hybrid_remat_phase(dev, results) -> tuple:
    """Phase 18 in order. Returns (launch counts by path, flash's launches by
    call by path, the dispatch kernels' by path, the paged kernels' by path,
    the SSD kernel's by path, the dequantizing gathers' by 18a run)."""
    t = time.perf_counter()
    counts, paged, dequant, snaps = serve_hybrid_quant(dev)
    t18a = time.perf_counter() - t
    hybrid_remat_kernels(dev, results, snaps)
    del snaps
    t18k = time.perf_counter() - t - t18a
    runs = train_remat(dev)
    t18b = time.perf_counter() - t - t18a - t18k
    counts["packed"] = packed_parity(dev)
    log(f"[time] 18a {t18a:.1f}s, 18 kernels {t18k:.1f}s, 18b {t18b:.1f}s, 18c "
        f"{time.perf_counter() - t - t18a - t18k - t18b:.1f}s")
    tags = {tag: "train_remat_" + _path_tag(tag) for tag in runs}
    counts.update({tags[k]: r["counts"] for k, r in runs.items()})
    return (counts, {tags[k]: r["flash"] for k, r in runs.items()},
            {tags[k]: r["dispatch"] for k, r in runs.items()}, paged,
            {tags[k]: r["ssd"] for k, r in runs.items()}, dequant)


# ---------------------------------------------------------------------------
# Phase 19: tensor parallelism for the ssm, hybrid and enc-dec families, and
# tensor-parallel training with kv heads shared by ranks
# ---------------------------------------------------------------------------

# two gloo ranks on the card, mesh (1, 2), f32, backend "pallas" (the routed
# blocks gather and scatter in both runs), each against one process on the
# same weights and batches: the families at full width (layers: the depth
# they are cut to, None = whole), trained and served
TP_ARCHS = (("mamba2-1.3b", 4), ("zamba2-2.7b", 6), ("whisper-tiny", None))
# granite-20b (MQA: its one kv head on both ranks) at full width, trained;
# its single-process state is ~26 GB, so that run goes first and is freed
# before the ranks start
TP_KV = ("granite-20b", 2)
# three steps: the first step's learning rate is 0 (warmup), so the third
# step's loss is the first that the ranks' updates move
TP_TRAIN = dict(B=2, S=256, steps=3, lr=1e-4)
TP_SERVE = dict(B=4, requests=4, prompt=8, gen=8, ctx=32)
# then one bf16 training step of the ssm and hybrid families on the ranks:
# the SSD kernel on its tensor-core path at a rank's 32 / 40 heads, flash at
# the shared block's 16 heads of 80
TP_BF16 = dict(B=2, S=1024)
TP_CALLS = ("ssd_intra_chunk", "flash_attention", "gather_rows", "scatter_add_rows")


def tp_config(arch: str, layers, dtype: str = "float32"):
    from repro_torch.config import get_config, with_mod_backend

    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return with_mod_backend(cfg, "pallas")


def tp_requests(cfg) -> list:
    """TP_SERVE's greedy requests: prompts of distinct tokens; a whisper
    request carries stub frames of its own seed."""
    from repro_torch.models import api
    from repro_torch.serve import Request

    w = TP_SERVE
    rng = np.random.default_rng(5)
    out = []
    for i in range(w["requests"]):
        kw = {}
        if cfg.family == "encdec":
            kw["enc_emb"] = api.stub_inputs(cfg, 1, 1, seed=100 + i,
                                            device="cpu")["enc_emb"][0].float().numpy()
        out.append(Request(tokens=rng.permutation(cfg.vocab)[: w["prompt"]],
                           max_new_tokens=w["gen"], **kw))
    return out


def _memory(dev, base: int) -> dict:
    return dict(peak=torch.cuda.max_memory_allocated(dev) - base,
                reserved=torch.cuda.memory_reserved(dev))


def tp_train(cfg, dev, spmd=None) -> dict:
    """TP_TRAIN's Trainer steps (one process, or this rank of ``spmd``'s
    mesh), the last one profiled: losses, (wall, busy) ms of that step, the
    state bytes, the run's peak memory above what was allocated before it
    and the allocator's reserved bytes after it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import OptimConfig, TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.train import stub_frontend
    from repro_torch.train import Trainer
    from repro_torch.train import loop as L

    w = TP_TRAIN
    tcfg = TrainConfig(global_batch=w["B"], seq_len=w["S"],
                       optim=OptimConfig(lr=w["lr"], warmup_steps=1, total_steps=w["steps"]),
                       log_every=10**9, ckpt_every=10**9)
    transform = stub_frontend(cfg, 0) if cfg.family == "encdec" else None
    loader = ShardedLoader(SyntheticLM(cfg.vocab, w["S"], seed=0), w["B"], dev, spmd=spmd,
                           transform=transform)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(cfg, tcfg, loader, ckpt=CheckpointManager(ckdir), device=dev, spmd=spmd,
                          log_fn=lambda m: None)
        state = trainer.init_or_resume()
        for i in range(w["steps"]):
            if i == w["steps"] - 1:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    state, m = trainer.run(state, 1)
            else:
                state, m = trainer.run(state, 1)
            losses.append(m["loss"])
    loader.close()
    out = dict(losses=losses, wall=1e3 * trainer.heartbeats[-1][1],
               busy=sum(us for _, us in device_records(prof)) / 1e3,
               state_bytes=L.state_bytes(state), **_memory(dev, base))
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[tp-families] 19 {cfg.name}: non-finite losses {losses}")
    return out


def tp_serve(cfg, dev, mesh=None) -> dict:
    """TP_SERVE's requests through the contiguous engine (one process, or
    this rank of ``mesh``): streams, mean wall ms a decode step, the pool's
    bytes on this process, the run's peak and reserved memory."""
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, ServingEngine

    w = TP_SERVE
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(api.init_model(cfg, device=dev, seed=0), cfg,
                        EngineConfig(batch_size=w["B"], ctx=w["ctx"], mesh=mesh), device=dev)
    outs = eng.run_stream(tp_requests(cfg), 2)
    s = eng.stats()
    out = dict(streams={o.uid: o.tokens.tolist() for o in outs},
               decode_ms=1e3 * s["decode_s"] / max(s["decode_steps"], 1),
               pool_bytes=eng.pool.cache_bytes()["total"], **_memory(dev, base))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_bf16_step(cfg, dev, spmd) -> float:
    """One bf16 training step of ``cfg`` on this rank (TP_BF16's batch);
    its loss."""
    from repro_torch.config import OptimConfig, TrainConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.train import loop as L

    w = TP_BF16
    tcfg = TrainConfig(global_batch=w["B"], seq_len=w["S"], optim=OptimConfig(lr=1e-4))
    batch = {k: torch.as_tensor(v).long().to(dev)
             for k, v in SyntheticLM(cfg.vocab, w["S"], seed=0).batch(0, w["B"]).items()}
    state = L.make_train_state(cfg, dev, seed=0, spmd=spmd)
    state, m = L.make_train_step(cfg, tcfg, spmd)(state, batch)
    loss = float(m["loss"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if not np.isfinite(loss):
        raise AssertionError(f"[tp-families] 19 bf16 {cfg.name}: non-finite loss {loss}")
    return loss


def _tp_calls() -> dict:
    from repro_torch.kernels import build

    return {name: dict(build.COUNTERS[name].by_call) for name in TP_CALLS}


def _tp_rank(rank, world, store, device, queue):
    """One gloo rank of phase 19: the families trained and served, their
    bf16 steps, then granite-20b trained; the launch counts of each path
    (reset just before it, read just after). Sends the parent summaries."""
    import traceback

    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.config import MeshConfig
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as M

    try:
        dev = M.init_process_group("gloo", rank=rank, world_size=world, device=device,
                                   store=torch.distributed.FileStore(store, world))
        spmd = M.mesh_ctx(MeshConfig(data=1, model=world))
        out: dict = {"start_s": time.perf_counter() - t0}
        t = time.perf_counter()
        build.reset_counters()
        for arch, layers in TP_ARCHS:
            cfg = tp_config(arch, layers)
            out[arch] = dict(train=tp_train(cfg, dev, spmd), serve=tp_serve(cfg, dev, spmd.mesh))
        out["bf16"] = {arch: tp_bf16_step(tp_config(arch, layers, "bfloat16"), dev, spmd)
                       for arch, layers in TP_ARCHS[:2]}
        out["families"] = (build.launch_counts(), _tp_calls())
        out["families_s"] = time.perf_counter() - t
        t = time.perf_counter()
        build.reset_counters()
        arch, layers = TP_KV
        out[arch] = dict(train=tp_train(tp_config(arch, layers), dev, spmd))
        out["kv"] = (build.launch_counts(), _tp_calls())
        out["kv_s"] = time.perf_counter() - t
        queue.put((rank, out, None))
    except Exception:  # noqa: BLE001 -- reported to the parent, which fails
        queue.put((rank, None, traceback.format_exc()))
    finally:
        M.destroy_process_group()


def _tp_note(run: dict) -> str:
    gib = 2**30
    return (f"peak {run['peak'] / gib:.2f} GiB, reserved {run['reserved'] / gib:.2f} GiB")


def _tp_check_run(tag: str, rank: int, got: dict, ref: dict) -> None:
    """One rank's training (and serving) run held against one process's,
    and logged beside it."""
    tr, rtr = got["train"], ref["train"]
    err = max(abs(a / b - 1) for a, b in zip(tr["losses"], rtr["losses"]))
    if err > MESH_TRAIN_LOSS_RTOL:
        raise AssertionError(f"[tp-families] 19 {tag} rank {rank}: losses {tr['losses']} off "
                             f"one process's {rtr['losses']} by {err:.2e}")
    log(f"[tp-families] 19 {tag} rank {rank}: {TP_TRAIN['steps']} Trainer steps, losses "
        f"{', '.join(f'{x:.6f}' for x in tr['losses'])} within {err:.2e} of one process; step "
        f"{TP_TRAIN['steps']} wall {tr['wall']:.1f} ms, busy {tr['busy']:.1f} ms (one process: "
        f"wall {rtr['wall']:.1f} ms, busy {rtr['busy']:.1f} ms); state {tr['state_bytes']} bytes "
        f"({tr['state_bytes'] / rtr['state_bytes']:.3f} of one process's); {_tp_note(tr)} (one "
        f"process: {_tp_note(rtr)})")
    if "serve" not in got:
        return
    sv, rsv = got["serve"], ref["serve"]
    if sv["streams"] != rsv["streams"]:
        raise AssertionError(f"[tp-families] 19 {tag} rank {rank}: streams {sv['streams']} "
                             f"differ from one process's {rsv['streams']}")
    log(f"[tp-families] 19 {tag} rank {rank}: {len(sv['streams'])} greedy requests, streams "
        f"equal to one process ({sum(len(s) for s in sv['streams'].values())} tokens); decode "
        f"step {sv['decode_ms']:.2f} ms wall (one process {rsv['decode_ms']:.2f}); pool "
        f"{sv['pool_bytes'] / 2**20:.1f} MiB (one process {rsv['pool_bytes'] / 2**20:.1f}); "
        f"{_tp_note(sv)}")


def tp_kernels(dev, results, calls: dict) -> None:
    """The kernels at phase 19's local shapes, held against their plain
    versions and timed beside the bound and a library call: the SSD kernel
    at a rank's 32 (mamba2) and 40 (zamba2) heads, the full and routed
    layers of the bf16 step; flash at the shared block's 16 heads of 80
    (bf16, with lse) and at granite-20b's 24 query heads over its one kv
    head (f32, with lse); gather / scatter at the bf16 step's routed rows.
    ``calls``: the ranks' launches by call, which every shape must have."""
    from repro_torch.kernels import flash_attention as FA

    g = torch.Generator(device=dev).manual_seed(71)
    B, S = TP_BF16["B"], TP_BF16["S"]
    for arch, _ in TP_ARCHS[:2]:
        cfg = tp_config(arch, None, "bfloat16")
        ssm, k = cfg.ssm, cfg.mod.capacity(S)
        H = ssm.n_heads(cfg.d_model) // 2
        short = arch.split("-")[0]
        for kind, n in (("full", S), ("routed", k)):
            Q = min(ssm.chunk, n)
            shape = (B, H, n // Q, Q, ssm.head_dim, ssm.d_state)
            if calls["ssd_intra_chunk"].get(("tensor", *shape), 0) <= 0:
                raise AssertionError(f"[tp-families] 19 ssd_intra_chunk {shape}: no tensor-core "
                                     f"launch on the ranks ({calls['ssd_intra_chunk']})")
            r = ssd_row("[tp-families] 19", f"{short} tp rank {kind}", dev, shape, 72)
            results.setdefault("ssd_intra_chunk", {})[(f"{short} tp {kind}", torch.bfloat16)] = \
                dict(r, run="tp_families")
        log_dispatch_rows("[tp-families] 19", f"{short} tp B={B} S={S} D={cfg.d_model}",
                          dispatch_rows(g, dev, torch.bfloat16, B, S, cfg.d_model, k),
                          torch.bfloat16, results)
    i32 = dict(dtype=torch.int32, device=dev)
    zamba2 = tp_config("zamba2-2.7b", None, "bfloat16")
    granite = tp_config(*TP_KV)
    wt = TP_TRAIN
    for cfg, dtype, Bc, Sc, run in ((zamba2, torch.bfloat16, B, S, "tp_families"),
                                    (granite, torch.float32, wt["B"], wt["S"], "tp_train_kv")):
        nq, nkv, hd = cfg.attn.n_heads // 2, max(1, cfg.attn.n_kv_heads // 2), cfg.head_dim
        pos = torch.arange(Sc, **i32)[None].repeat(Bc, 1)
        c = FlashCase(f"{cfg.name.split('-')[0]} tp rank train B={Bc} S={Sc} lse", Bc, Sc, Sc,
                      nq, nkv, hd, pos, pos, (dtype,), True)
        plan = FA.flash_plan(c.B, c.Sq, c.Skv, c.nq, c.nkv, c.hd, dtype)
        key = (plan.path, c.B, c.Sq, c.Skv, c.nq, c.nkv, c.hd, plan.kernels)
        launched = calls["flash_attention"] if run == "tp_families" else calls["kv_flash"]
        if launched.get(key, 0) <= 0:
            raise AssertionError(f"[tp-families] 19 flash {c.label}: {key} not launched on the "
                                 f"ranks ({launched})")
        r = flash_row(FA, c, dtype, g)
        r.update(path=plan.path, kernels=plan.kernels, run=run,
                 plan=dict(path=plan.path, key_tile=plan.key_tile, key_split=plan.key_split,
                           chunk=plan.chunk, n_splits=plan.n_splits, merge=plan.merge))
        log(f"[tp-families] 19 flash_attention {r['shape']:40s} {plan.path} "
            f"kernels={plan.kernels} max_abs_err={r['max_abs_err']:.3g} "
            f"lse_err={r['lse_err']:.3g} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} (SDPA) bound_ms={r['bound'][0]:.4f} "
            f"({r['bound'][1]})")
        results.setdefault("flash_attention", {})[(c.label, dtype)] = r


def tp_families_phase(dev, results) -> tuple:
    """Phase 19: granite-20b's single-process run, then two gloo ranks on
    the card (mesh (1, 2)) while this process makes the families'
    single-process runs; each rank's runs held against them; then the
    kernels at the ranks' local shapes. Returns ({path: launch counts},
    {path: {kernel: launches by call}}) of rank 0."""
    import torch.multiprocessing as mp

    t = time.perf_counter()
    arch, layers = TP_KV
    kv_ref = dict(train=tp_train(tp_config(arch, layers), dev))
    kv_ref_s = time.perf_counter() - t
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    tmp = tempfile.TemporaryDirectory()
    store = os.path.join(tmp.name, "store")
    procs = [ctx.Process(target=_tp_rank, args=(r, 2, store, dev.type, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        tr = time.perf_counter()
        refs = {}
        for a, n in TP_ARCHS:
            cfg = tp_config(a, n)
            refs[a] = dict(train=tp_train(cfg, dev), serve=tp_serve(cfg, dev))
        refs[arch] = kv_ref
        bf16_ref = {a: tp_bf16_step(tp_config(a, n, "bfloat16"), dev, None)
                    for a, n in TP_ARCHS[:2]}
        ref_s = time.perf_counter() - tr
        got = sorted((queue.get(timeout=600) for _ in procs), key=lambda x: x[0])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        tmp.cleanup()
    errors = [e for _, _, e in got if e is not None]
    if errors:
        raise AssertionError(f"[tp-families] 19: a rank failed:\n{errors[0]}")
    ranks_s = time.perf_counter() - t - kv_ref_s
    for rank, out, _ in got:
        for a, n in TP_ARCHS + (TP_KV,):
            _tp_check_run(f"{a} ({'whole' if n is None else f'{n} layers'}, f32, mesh (1, 2))",
                          rank, out[a], refs[a])
        drift = ", ".join(f"{a} {x:.6f} (one process {bf16_ref[a]:.6f}, drift "
                          f"{abs(x / bf16_ref[a] - 1):.2e})" for a, x in out["bf16"].items())
        log(f"[tp-families] 19 rank {rank}: bf16 step losses (finite; not held) {drift}; start "
            f"{out['start_s']:.1f}s, the families {out['families_s']:.1f}s, granite-20b "
            f"{out['kv_s']:.1f}s")
    counts = {"tp_families": got[0][1]["families"][0], "tp_train_kv": got[0][1]["kv"][0]}
    calls = dict(got[0][1]["families"][1], kv_flash=got[0][1]["kv"][1]["flash_attention"])
    want = {"tp_families": ("ssd_intra_chunk", "flash_attention", "gather_rows",
                            "scatter_add_rows"),
            "tp_train_kv": ("flash_attention", "gather_rows", "scatter_add_rows")}
    for path, c in counts.items():
        idle = [k for k in want[path] if c.get(k, 0) <= 0]
        if idle:
            raise AssertionError(f"[tp-families] 19 {path}: {idle} not launched on rank 0")
        log(f"[tp-families] 19 {path} launches (rank 0): "
            f"{json.dumps({k: v for k, v in c.items() if v})}")
    tk = time.perf_counter()
    tp_kernels(dev, results, calls)
    log(f"[time] 19 granite-20b one process {kv_ref_s:.1f}s, the ranks {ranks_s:.1f}s (the "
        f"families' single-process runs {ref_s:.1f}s meanwhile), kernels "
        f"{time.perf_counter() - tk:.1f}s; phase 19 {time.perf_counter() - t:.1f}s")
    by_call = {"tp_families": got[0][1]["families"][1], "tp_train_kv": got[0][1]["kv"][1]}
    return counts, by_call


def dispatch_by_call() -> dict:
    """The padded dispatch kernels' launches by call since the last reset,
    keyed as the wrappers count them: (kind, vec, unroll, B, S, k, row
    bytes)."""
    from repro_torch.kernels import build

    return {name: dict(build.COUNTERS[name].by_call) for name in ("gather_rows", "scatter_add_rows")}


def main() -> int:
    # read when the caching allocator starts (its first allocation): after
    # phases 2-12, 45-57 GiB stayed reserved with 0.00-0.12 GiB allocated,
    # even after the release below, and phase 14's 56 GB granite-20b init
    # ran out of memory; expandable segments let the allocator map those
    # pages again for new tensors
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mlp-losses"]:
        sys.path.insert(0, str(ROOT / "src"))
        mlp_path_losses()
        return 0
    if sys.argv[1:2] == ["--flash-timing"]:
        flash_timing(Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else ROOT)
        return 0
    if sys.argv[1:2] == ["--ssm-losses"]:
        sys.path.insert(0, str(ROOT / "src"))
        ssm_path_losses()
        return 0
    if sys.argv[1:2] == ["--train-runs"]:
        return train_runs(Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else ROOT)
    if sys.argv[1:2] == ["--routed-paged-timing"]:
        routed_paged_timing(Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else ROOT)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--moe"]:
        from repro_torch.kernels import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build_all()
        t = time.perf_counter()
        moe_phase(torch.device("cuda", 0))
        log(f"[time] phase 12 moe: {time.perf_counter() - t:.1f}s")
        return 0
    if sys.argv[1:2] == ["--configs"]:
        from repro_torch.kernels import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[device] {smi_line()}")
        build.build_all()
        t = time.perf_counter()
        configs_phase(torch.device("cuda", 0), {})
        log(f"[time] phase 14 configs: {time.perf_counter() - t:.1f}s")
        return 0
    if sys.argv[1:2] == ["--encdec-vlm"]:
        from repro_torch.kernels import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[device] {smi_line()}")
        build.build_all()
        t = time.perf_counter()
        encdec_vlm_phase(torch.device("cuda", 0), {})
        log(f"[time] phase 15 encdec-vlm: {time.perf_counter() - t:.1f}s")
        return 0
    if sys.argv[1:2] == ["--mesh"]:
        from repro_torch.kernels import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[device] {smi_line()}")
        build.build_all()
        t = time.perf_counter()
        mesh_phase(torch.device("cuda", 0))
        log(f"[time] phase 16 mesh: {time.perf_counter() - t:.1f}s")
        return 0
    if sys.argv[1:2] == ["--mesh-train"]:
        from repro_torch.kernels import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[device] {smi_line()}")
        build.build_all()
        t = time.perf_counter()
        counts = mesh_train_phase(torch.device("cuda", 0))
        log(f"[time] phase 17 mesh-train: {time.perf_counter() - t:.1f}s; launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
        return 0
    if sys.argv[1:2] == ["--hybrid-remat"]:
        from repro_torch.kernels import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[device] {smi_line()}")
        build.build_all()
        t = time.perf_counter()
        counts = hybrid_remat_phase(torch.device("cuda", 0), {})[0]
        log(f"[time] phase 18 hybrid-remat: {time.perf_counter() - t:.1f}s; launches by path "
            f"{json.dumps({p: {k: v for k, v in c.items() if v} for p, c in counts.items()})}")
        return 0
    if sys.argv[1:2] == ["--tp-families"]:
        from repro_torch.kernels import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[device] {smi_line()}")
        build.build_all()
        t = time.perf_counter()
        counts = tp_families_phase(torch.device("cuda", 0), {})[0]
        log(f"[time] phase 19 tp-families: {time.perf_counter() - t:.1f}s; launches by path "
            f"{json.dumps({p: {k: v for k, v in c.items() if v} for p, c in counts.items()})}")
        return 0
    if sys.argv[1:2] == ["--overload"]:
        from repro_torch.kernels import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[device] {smi_line()}")
        build.build_all()
        t = time.perf_counter()
        overload_phase(torch.device("cuda", 0))
        log(f"[time] phase 13 overload: {time.perf_counter() - t:.1f}s")
        return 0
    from repro_torch.config import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = smi_line()
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[device] {smi}; {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; kernels built in {build_s:.1f}s "
        f"({', '.join(f'{k}: {Path(v['path']).name}' for k, v in libs.items())})")
    for stem, info in libs.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {stem}: {line.strip()}")

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"[time] {label}: {time.perf_counter() - t:.1f}s")
        return out

    cfg1b = get_config("mod-paper-1b")
    results: dict = {}
    timed("phase 2 kernels", timed_parts, "2", (
        (" routing", check_routing, cfg1b, dev, results),
        (" ragged launches", check_ragged_launches, cfg1b, dev),
        (" flash", check_flash, cfg1b, dev, results), (" fused", check_fused, cfg1b, dev, results),
        (" paged", check_paged, cfg1b, dev, results), (" quant casts", check_quant_casts, dev),
        (" dequant", check_dequant, cfg1b, dev, results),
        (" ragged dispatch", check_ragged_dispatch, cfg1b, dev, results),
        (" grads", check_grads, cfg1b, dev)))
    timed("phase 3 parity", lambda: (cross_device_parity(dev), train_step_parity(dev)))
    timed("phase 6a-8a parity", lambda: (paged_parity(dev), quant_parity(dev),
                                         ragged_forward_parity(dev)))
    serve_counts, serve_flash, serve_dispatch = timed("phase 4 serve", serve_1b, dev)
    dispatch_calls = {"serve": serve_dispatch}
    train_counts, train_flash, train_mlp_calls, train_attn_calls, _ = timed("phase 5 train",
                                                                            train_1b, dev)
    from repro_torch.models import api

    params = api.init_model(serve_1b_config(), device=dev, seed=0)
    paged_counts, paged_shapes, base_streams, base_stats, base_first, snap = timed(
        "phase 6c paged serve", serve_paged_1b, dev, params)
    quant_counts, quant_shapes, snaps, quant_streams = timed(
        "phase 7b quantized serve", serve_quant_1b, dev, params, base_streams, base_stats,
        base_first)
    snaps = {"bf16": snap, "int8/page": snaps["prefix int8/page"],
             "fp8/head": snaps["prefix fp8/head"]}
    ragged_counts = timed("phase 8b flat forward", forward_ragged_1b, dev, params)
    mlp = {k: v.clone() for k, v in params["groups"][0]["full"]["mlp"].items()}
    ops_counts = timed("phase 10 ops path", ops_path, snaps, mlp, cfg1b, dev)
    timed("phase 10 kernels", lambda: (check_ragged_attention(snaps, cfg1b, dev, results),
                                       check_ragged_small(dev), check_swiglu(mlp, dev, results)))
    timed("phase 11a speculative parity", speculative_parity, dev)
    spec_counts, spec_rounds = timed("phase 11b speculative serve", serve_spec_1b, dev, params,
                                     base_streams, base_stats, quant_streams)
    del params, snaps, snap, mlp
    torch.cuda.empty_cache()
    timed("phase 9a ssd kernel", check_ssd, dev, results)
    timed("phase 9b ssm parity", ssm_parity, dev)
    ssm_train_counts, ssd_by_nc, _ = timed("phase 9c ssm train", train_ssm, dev)
    dispatch_calls["train_ssm"] = dispatch_by_call()
    torch.cuda.empty_cache()
    ssm_serve_counts = timed("phase 9d ssm serve", serve_ssm, dev)
    torch.cuda.empty_cache()
    moe_counts = timed("phase 12 moe", moe_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    configs_counts, configs_flash, hybrid_ssd = timed("phase 14 configs", configs_phase, dev,
                                                      results)
    gc.collect()
    torch.cuda.empty_cache()
    encdec_counts, encdec_flash, encdec_dispatch, encdec_paged = timed(
        "phase 15 encdec-vlm", encdec_vlm_phase, dev, results)
    dispatch_calls["encdec_vlm_whisper_train"] = encdec_dispatch
    gc.collect()
    torch.cuda.empty_cache()
    mesh_counts = timed("phase 16 mesh", mesh_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_train_counts = timed("phase 17 mesh-train", mesh_train_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    (hybrid_counts, hybrid_flash, hybrid_dispatch, hybrid_paged, remat_ssd,
     hybrid_dequant) = timed("phase 18 hybrid-remat", hybrid_remat_phase, dev, results)
    dispatch_calls.update(hybrid_dispatch)
    gc.collect()
    torch.cuda.empty_cache()
    tp_counts, tp_calls = timed("phase 19 tp-families", tp_families_phase, dev, results)
    dispatch_calls["tp_families"] = {name: tp_calls["tp_families"][name]
                                     for name in ("gather_rows", "scatter_add_rows")}
    # last: its 32-slot pools would leave the allocator's cache in pieces
    # that later phases' large tensors may not fit in
    gc.collect()
    torch.cuda.empty_cache()
    overload_counts, _ = timed("phase 13 overload", overload_phase, dev)

    # flash: every shape of phase 2, each with the launches of exactly its
    # call (path and shape) in phases 4 and 5, as the wrapper counted them
    # (the serving prompts are 128-1024 tokens long, so a prefill row may
    # count none); every call shape of those runs rides on the kernel's entry
    fl_runs = {"serve": serve_flash, "train": train_flash, **configs_flash, **encdec_flash,
               **hybrid_flash, **{p: c["flash_attention"] for p, c in tp_calls.items()}}
    shapes = {"flash_attention": [
        dict(shape=r["shape"], path=r["path"], plan=r["plan"], ms=r["ms"],
             plain_ms=r["plain_ms"], library_ms=r["library_ms"], bound_ms=r["bound"][0],
             timed_by=r["timed_by"],
             launches=sum(c.get((r["path"], *r["call"], r["kernels"]), 0)
                          for c in fl_runs.values()))
        for r in results["flash_attention"].values()]}
    flash_by_call = {run: [dict(path=k[0], B=k[1], Sq=k[2], Skv=k[3], nq=k[4], nkv=k[5],
                                hd=k[6], kernels=k[7], launches=n) for k, n in sorted(c.items())]
                     for run, c in fl_runs.items()}
    # the padded dispatch: every shape of phase 2, each with the launches of
    # exactly its call (kind, B, S, k, row bytes) in phases 4 and 9c
    for name in ("gather_rows", "scatter_add_rows"):
        shapes[name] = [
            dict(shape=r["shape"], plan=r["plan"], ms=r["ms"], plain_ms=r["plain_ms"],
                 library_ms=r["library_ms"], bound_ms=r["bound"][0], timed_by=r["timed_by"],
                 **({"library": r["library"]} if "library" in r else {}),
                 **({"index_select_ms": r["index_select_ms"]} if "index_select_ms" in r else {}),
                 launches=sum(n for run in dispatch_calls.values()
                              for key, n in run[name].items() if (key[0], *key[3:]) == r["call"]))
            for r in results[name].values()]
    picks = {  # the entry of each kernel at a main-path shape (bf16)
        "gather_rows": results["gather_rows"][("B=1 S=1000 D=1792", torch.bfloat16)],
        "scatter_add_rows": results["scatter_add_rows"][("B=1 S=1000 D=1792", torch.bfloat16)],
        "flash_attention": results["flash_attention"][("prefill S=1000", torch.bfloat16)],
        "routed_attention": results["routed_attention"][torch.bfloat16],
        "routed_mlp_scatter": results["routed_mlp_scatter"][torch.bfloat16],
    }
    for name in PAGED_KERNELS:
        # every shape phase 6c gives the kernel, with its launches there;
        # the line's numbers are those of the shape that took the most of
        # the kernel's device time on that path
        # (a shape marked off the path, as the unaligned rows, has none);
        # phase 15's shapes, with their launches in its paged serving runs
        on_path = {key: paged_shapes[name][key] for key, r in results[name].items()
                   if not r["off_path"] and "run" not in r and "runs" not in r}
        on_path.update({key: sum(n for call, n in encdec_paged[r["run"]][name].items()
                                 if call[1:] == r["call"])
                        for key, r in results[name].items() if "run" in r})
        # phase 18's shapes, with their launches in 18a's paged runs
        on_path.update({key: sum(n for run in r["runs"] for call, n in
                                 hybrid_paged[run][name].items() if call[1:] == r["call"])
                        for key, r in results[name].items() if "runs" in r})
        shapes[name] = [dict(shape=r["shape"], launches=on_path.get(key, 0), ms=r["ms"],
                             plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                             bound_ms=r["bound"][0], **({"plan": r["plan"]} if "plan" in r else {}))
                        for key, r in results[name].items()]
        key = max((k for k in on_path if "run" not in results[name][k]
                   and "runs" not in results[name][k]),
                  key=lambda k: on_path[k] * results[name][k]["ms"])
        picks[name] = results[name][key]
    # the dequant gather: every shape phase 7b gives it, with its launches
    # on the int8/page prefix run (fp8/head shapes: on the fp8/head run);
    # the line's numbers are the int8/page prefix run's costliest shape
    quant_path = {f"{q['kv']}/{q.get('granularity', 'page')}": name
                  for name, kw, q in QUANT_1B if "weights" not in q and "ragged" not in kw}
    dq = results["paged_gather_dequant"]
    # (phase 18's shapes: their launches in 18a's run of the same pool)
    dq_launch = {key: hybrid_dequant[r["run"]] if "run" in r
                 else quant_shapes[quant_path[key.split()[0]]].get(key, 0)
                 for key, r in dq.items()}
    shapes["paged_gather_dequant"] = [
        dict(shape=r["shape"], launches=dq_launch[key], ms=r["ms"], plain_ms=r["plain_ms"],
             library_ms=None, bound_ms=r["bound"][0]) for key, r in dq.items()]
    picks["paged_gather_dequant"] = dq[max((k for k in dq if k.startswith("int8/page")),
                                          key=lambda k: dq_launch[k] * dq[k]["ms"])]
    # the SSD kernel: its shapes, with their launches on phase 9c's bf16 run
    # (none at f32 inputs or the odd shape); the line's numbers are the
    # full blocks' shape
    ssd_nc = {"train full": 16, "train routed": 2}
    ssd = {k: r for k, r in results["ssd_intra_chunk"].items() if k != "backward_ms"}
    # (zamba2's forward shape: its launches in phase 14d's forward)
    zamba2_ssd = sum(n for k, n in hybrid_ssd.items() if k[1:] == ZAMBA2_SSD)
    # (phase 18's training shapes: their launches in 18b's zamba2 runs;
    # phase 19's local shapes: in the ranks' bf16 steps, on the row's path:
    # the f32 runs launch the routed shapes on the CUDA-core path)
    tp_ssd = tp_calls["tp_families"]["ssd_intra_chunk"]
    shapes["ssd_intra_chunk"] = [
        dict(shape=r["shape"], launches=zamba2_ssd if key[0] == "zamba2 forward"
             else sum(n for k, n in tp_ssd.items() if k == (r["plan"]["path"], *r["call"]))
             if r.get("run") == "tp_families"
             else sum(n for c in remat_ssd.values() for k, n in c.items()
                      if k[1:] == r["call"]) if "call" in r
             else ssd_by_nc.get(ssd_nc.get(key[0]), 0) if key[1] == torch.bfloat16 else 0,
             ms=r["ms"],
             plain_ms=r["plain_ms"], library_ms=None, bound_ms=r["bound"][0],
             bound_by=r["bound"][1], plan=r["plan"],
             **({"cuda_path_ms": r["cuda_path_ms"]} if "cuda_path_ms" in r else {}))
        for key, r in ssd.items()]
    # every bf16 shape but the odd ones is on a path: none may count 0
    idle = [row["shape"] for (name, dtype), row in zip(ssd, shapes["ssd_intra_chunk"])
            if dtype == torch.bfloat16 and not name.startswith("odd") and row["launches"] <= 0]
    if idle:
        raise AssertionError(f"ssd_intra_chunk: no launch on the path of {idle}")
    picks["ssd_intra_chunk"] = results["ssd_intra_chunk"][("train full", torch.bfloat16)]
    # the op entry point's kernels: every shape of 10a-c, launched once each
    # by phase 10's counted run in bf16 (f32 shapes are checks only); the
    # line's numbers are the costliest counted shape's
    ra = results["ragged_paged_flash_attention"]
    shapes["ragged_paged_flash_attention"] = [
        dict(shape=r["shape"], plan=r["plan"], launches=int(key[2] == torch.bfloat16), ms=r["ms"],
             plain_ms=r["plain_ms"], library_ms=None, bound_ms=r["bound"][0],
             yardstick_ms=r.get("yardstick_ms")) for key, r in ra.items()]
    picks["ragged_paged_flash_attention"] = max(
        (r for key, r in ra.items() if key[2] == torch.bfloat16), key=lambda r: r["ms"])
    sw = results["swiglu"]
    shapes["swiglu"] = [dict(shape=r["shape"], gemm_path=r["gemm_path"],
                             launches=int(key[1] == torch.bfloat16), ms=r["ms"],
                             plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                             bound_ms=r["bound"][0]) for key, r in sw.items()]
    for name in ("routed_mlp_scatter", "routed_attention"):
        shapes[name] = [
            dict(shape=r["shape"], gemm_path=r["gemm_path"], launches=train_counts.get(name, 0)
                 if dt == torch.bfloat16 else 0, ms=r["ms"], plain_ms=r["plain_ms"],
                 library_ms=r["library_ms"], bound_ms=r["bound"][0])
            for dt, r in results[name].items()]
    picks["swiglu"] = sw[(max(SWIGLU_M), torch.bfloat16)]
    model_runs = {"serve": serve_counts, "train": train_counts, **paged_counts, **quant_counts,
                  "forward_ragged": ragged_counts, "train_ssm": ssm_train_counts,
                  "serve_ssm": ssm_serve_counts,
                  **{f"serve_spec {n}": c for n, c in spec_counts.items()}, **moe_counts,
                  **configs_counts, **encdec_counts, "overload": overload_counts,
                  "mesh": mesh_counts, "mesh_train": mesh_train_counts, **hybrid_counts,
                  **tp_counts}
    for run, c in model_runs.items():
        if any(c.get(k, 0) for k in OPS_KERNELS):
            raise AssertionError(f"{run} launched an op-entry-point kernel: {c}")
    for name in RAGGED_KERNELS:  # phase 8b's unequal-segment forward
        shapes[name] = [dict(shape=r["shape"], launches=ragged_counts[name] if key == "unequal"
                             else 0, ms=r["ms"], plain_ms=r["plain_ms"],
                             library_ms=r["library_ms"], bound_ms=r["bound"][0])
                        for key, r in results[name].items()]
        picks[name] = results[name]["unequal"]
    kernels = []
    for name, r in picks.items():
        src, replaces = SOURCES[name]
        # launches from the path the kernel's timed shape belongs to: the
        # serving run for gather/scatter/flash, the training run for the
        # fused kernels, the paged and ragged runs for the paged kernels;
        # every run's counts ride along
        by_path = {"serve": serve_counts, "train": train_counts,
                   "serve_paged": paged_counts["paged"],
                   "serve_paged_prefix": paged_counts["paged+prefix"],
                   "serve_ragged": paged_counts["ragged"],
                   "serve_quant_prefix_int8_page": quant_counts["prefix int8/page"],
                   "serve_quant_prefix_fp8_head": quant_counts["prefix fp8/head"],
                   "serve_quant_ragged_int8_page": quant_counts["ragged int8/page"],
                   "serve_quant_prefix_int8_weights":
                       quant_counts["prefix int8/page + int8 weights"],
                   "forward_ragged": ragged_counts,
                   "train_ssm": ssm_train_counts, "serve_ssm": ssm_serve_counts,
                   "ops": ops_counts,
                   **{f"serve_spec {n}": c for n, c in spec_counts.items()}, **moe_counts,
                   **configs_counts, **encdec_counts, "overload": overload_counts,
                   "mesh": mesh_counts, "mesh_train": mesh_train_counts, **hybrid_counts,
                   **tp_counts}
        path = {"routed_attention": "train", "routed_mlp_scatter": "train",
                "paged_gather": "serve_paged", "paged_scatter_rows": "serve_paged",
                "ragged_paged_scatter_rows": "serve_ragged",
                "paged_gather_dequant": "serve_quant_prefix_int8_page",
                "ragged_gather_rows": "forward_ragged",
                "ragged_scatter_add_rows": "forward_ragged",
                "ssd_intra_chunk": "train_ssm",
                "ragged_paged_flash_attention": "ops", "swiglu": "ops"}.get(name, "serve")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": by_path[path][name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": r["shape"],
            # how each time was taken: CUDA-graph replay, or torch.profiler
            # for a plain call named as not capturing
            "timed_by": r.get("timed_by") or {"ms": "graph", "plain_ms": "graph"},
            **({"yardstick_ms": r["yardstick_ms"], "yardstick": "paged_gather x3 + "
                "flash_attention (the port's decode path; not one call)"}
               if "yardstick_ms" in r else {}),
            **({"gemm_path": r["gemm_path"]} if "gemm_path" in r else {}),
            **({"library": SWIGLU_LIBRARY[torch.bfloat16]} if name == "swiglu" else {}),
            **({"library": ROUTED_MLP_LIBRARY[torch.bfloat16],
                "launches_by_call": [dict(gemm_path=k[0], B=k[1], S=k[2], k=k[3], D=k[4], F=k[5],
                                          launches=n) for k, n in train_mlp_calls.items()]}
               if name == "routed_mlp_scatter" else {}),
            **({"launches_by_call": flash_by_call} if name == "flash_attention" else {}),
            **({"backward_ms": results["ssd_intra_chunk"]["backward_ms"],
                "backward": "recompute through the plain version under autograd (torch.profiler)"}
               if name == "ssd_intra_chunk" else {}),
            **({"launches_by_call": [dict(gemm_path=k[0], B=k[1], S=k[2], k=k[3], D=k[4],
                                          nq=k[5], nkv=k[6], hd=k[7], launches=n)
                                     for k, n in train_attn_calls.items()],
                "attention_core": "mma.sync tensor cores (bf16)"}
               if name == "routed_attention" else {}),
            **({"plan": r["plan"]} if "plan" in r else {}),
            "launches_by_path": {k: v.get(name, 0) for k, v in by_path.items()},
            **({"launches_per_spec_round": {run: c.get(name, 0) for run, c in spec_rounds.items()}}
               if name in SPEC_KERNELS else {}),
            **({"shapes": shapes[name]} if name in shapes else {}),
        })
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.0f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
