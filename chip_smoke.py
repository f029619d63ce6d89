#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. The card's name and power limit (``nvidia-smi``), then the build of every
   CUDA source (``nvcc`` for sm_90a, one process per source, all started
   together), with each source's ``ptxas -v`` lines.  ``cuobjdump -sass``
   of the flash-attention library counts the ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) instructions of each bf16 kernel, the forward's
   and the backward's (``bwd_wgmma_dq_kernel`` at d 16-256, both forms of
   ``bwd_wgmma_dkv_kernel`` at d 16-128 and ``bwd_wgmma_dkv_wide_kernel``
   at d 256); a count of 0 fails the run, and
   so does a bf16 instance of the backward's CUDA-core forms.  That of the
   recurrent library counts the local-memory
   loads and stores of the scans' six kernel instances (one fails the run)
   and their tensor-core products (``HMMA``: the WKV kernel's none, or the
   rg-lru's any, fails it); their registers come from the ptxas log.  That
   of the scans' backward library counts the local-memory traffic,
   global atomics (``ATOMG``, ``RED``) and tensor-core products (``HMMA``)
   of its five instances (``wkv6_bwd_kernel`` and ``rglru_bwd_kernel``,
   f32 and bf16, and ``sum_parts_kernel`` in f32): any local-memory
   access or atomic fails the run, and so does a WKV instance without
   ``HMMA`` or another with one; their registers come from the ptxas
   log.
   That of the topo-score library counts the global
   atomics (``ATOMG``, ``ATOM``, ``RED``) of K2's normal-cycle form (both
   its instances) and K1's tail (both forms), which reduce across CTAs
   through a thread-block cluster: any in the one-cluster K2 instance or
   the tail, or other than the ticket's one atomic in K2's split instance,
   fails the run, and so does a shard-merge kernel of its own (the merges
   run in the last shard's launches).  In K1's class
   sweep (its three builds) and lane form it counts ``REDUX`` (none fails
   the run), ``SHFL``, ``MUFU.RCP`` (one in the sweep fails it; the lane
   form's are the Eq. 1 score's IEEE reciprocal), the ``I2F...RP`` that
   opens an integer division (one fails it) and local-memory traffic.  In
   K2's and K3's lane forms (both layouts each) an integer division, local
   memory, a reciprocal in K2 or more in K3 than its Eq. 1 scores need
   fails the run.
2. ``[kernels]``: each topo-score kernel against its plain PyTorch version on
   the card, bit for bit (tiers, per-tile argmax, scores), over all three
   server specs, several requests with the exactness traps in their inputs,
   and n in {256, 1500, 65536}; K2 and K3 also at ``BIG_LANES`` (2,621,440
   lanes, aligned and not); ``placement_tier`` also against host
   ``best_tier``.
3. ``[fused]``: the fused engine's kernels against their plain versions
   on the card, bit for bit: K1's resident form (``fused_class``), its
   tail (``fused_argmax``) and K2's normal-cycle form (``normal_cycle``)
   on random resident states at 100, 1024 and 10240 nodes (m_res 4 and 8
   with 13 gathered rows) and a 16-slot state through the wide kernel, every
   ``REQUESTS`` entry (alpha 0, 0.3, 0.5, 1) at two preemptor priorities,
   with and without patch rows, the class sweep also in every geometry its
   launcher takes (``sweep_geometries``), forced one by one; then the skip
   path.  Every state's free and victim masks are checked disjoint.  Then
   the two cluster kernels alone (``cluster_phase``): N across the cluster
   geometry's boundaries (``CLUSTER_NODES``, up to 40960), the RTX 4090,
   A100 and TPU v5e host SKUs and the 16-slot state, 0, 1, 9 and
   ``MAX_PATCH_ROWS``
   patch rows, K2 also in its split form at every N (one launch: the
   cluster that takes the last ticket places), the tail over the
   resident segment and over 16-row chunks, class tables with forced exact
   ties, more patch rows than the kernels take (must raise), and 50
   back-to-back launches of each, of K2's split form (its ticket back at
   0 after each) and of the sweep (bit-identical); the
   sweeps that feed the tail there are held to their plain version too.
   ``[delta]``: the view-delta encoder (``encode_delta``) against its plain
   version on the same inputs and against host ``encode_row`` of every
   delta and pending row, bit for bit, on 48 random views of a 1024-server
   cluster (rows past cap, more than 8 adds and pending rows among them:
   the host rows it copies), then the host time of a plan's patch rows
   both ways and the encoder's time.  ``[shortlist]``: the prescreen
   (``prescreen``, one launch: one cluster, or the split form at many
   rows) against its plain version, bit for bit (the top-K rows in order
   and ``excl_ub``), at 1024 and 10240 rows of two SKUs, random and
   tie-heavy, with and without patch rows, forced representatives, k = 1,
   128 and every row; then at ragged row counts, 40960 rows, every bound
   tied and 20 slots a row (``PRESCREEN_EXTRA``, the selected keys held
   too); then at rows whose CTAs' rows outgrow shared memory
   (``PRESCREEN_WIDE``, the keys through global scratch), so that each of
   the kernel's four instances runs; then its skip path.
4. ``[main]``: the scheduler path, ``run_hit_rate_experiment`` (the paper's
   Table 4 protocol, ``TopoScheduler.plan()`` per scale-up) with
   ``imp_pallas`` and then host ``imp`` on the 100-node Table 3 cluster (2
   cycles x 50 scale-ups, which must give 100/100/0/0) and on a 1024-node
   cluster (1 x 20); the decisions of the two engines must be identical.
   Launch counters are set to 0 just before each run and read just after
   it: the topo_score_argmax launches must equal the ``imp_pallas``
   engine's per-node calls less its host fallbacks, and be > 0.  Then the
   20-node 3 x 10 protocol must give 30/30/0.  Then ``imp_batched`` (the
   fused engine over the device-resident state) at 100 nodes (2 x 50,
   100/100/0/0), 1024 nodes (1 x 20) and 10240 nodes (1 x 10), decision
   for decision against host ``imp`` and against ``imp_batched_full`` (the
   full sweep: at 1024 and 10240 nodes ``imp_batched`` runs the shortlist,
   k = 128), after the per-size engines ``imp_batched_legacy`` (2 x 50)
   and ``imp_jax`` (1 x 50) at 100 nodes, decision for decision against
   host ``imp``, one K3 (``topo_score``) launch a subset-size sweep and
   no other kernel: one ``normal_cycle`` launch a plan, one ``prescreen`` a
   shortlisted plan, one ``fused_class`` and ``fused_argmax`` a plan and
   one more of each for a plan whose winner the shortlist could not prove
   (every plan of a saturated cluster fails its normal cycle; the Table 3
   mix needs no wide chunk), every launch count equal to what the engine's
   recorded paths launch (``PATH_COUNTS``), and no lane-form K1 launch.
   ``[batch]``: an 8-request ``plan_batch`` on the saturated 1024- and
   10240-node clusters through the session, decision for decision against
   sequential single plans (and, with candidate counts, against
   ``imp_batched_full``'s; at 1024 also host ``imp``), twice: the second
   reuses the session; launches held to the paths.
   ``[sharded]``: the merges of a sharded state against their plain
   versions on the same records, bit for bit: the last shard's tail and
   K2 with the earlier shards' records (``fused_argmax(prior=)``,
   ``normal_cycle(prior=)``, K2 also forced into its split form) against
   the plain compose (the last shard's plain record form, then
   ``tail_merge_plain`` / ``normal_merge_plain``), and
   ``prescreen_select``; and the merged results against the unsharded
   kernels over every row, with D in {1, 2, 3, 4, 8}
   shards on the one card and N in {13, 1024, 10240} (pad rows where D
   does not divide N), patch rows on several shards, gathered rows and
   chunks across shards, forced exact ties and the same-tier case (the
   shard forms of the tail, K2 and the prescreen held to their plain
   versions too), and K2 at 81920 nodes over 2 and 3 shards, every shard
   in its split form; then, after ``[commit]``, ``imp_sharded`` and
   ``imp_sharded_full`` over the default mesh (D = 1) and over 4 shards on
   the saturated 100-, 1024- and 10240-node clusters, decision for
   decision (masks and candidate counts) against ``imp_batched`` and
   ``imp_batched_full`` and host ``imp``, ``engine="auto"`` at 10240
   nodes resolving to ``imp_sharded``, and the reference's randomized
   plan/commit/rollback/``plan_batch`` sequences at 5, 11 and 13 nodes
   over 8 shards against host ``imp``; launches held to the paths: D K2
   launches a plan, the last of them merging (one merged K2 a plan over 4
   shards, none over one), a merged tail a plan that sweeps, and no merge
   of a launch of its own.
5. ``[commit]``: twin 1024-node clusters, 100 steps of
   ``schedule_or_preempt``, rollbacks and releases: ``imp_batched`` against
   host ``imp`` with identical decisions and masks at every step (the row
   scatter and the pending-row patches).
6. ``[day]``: the co-location day cycle (``repro_torch.core.colocation``)
   on the card through ``imp_batched``, 24 h, seed 0, warm-up on (the
   protocol of ``benchmarks/bench_colocation.py:day_config``).  At 24
   nodes ``compare_day_cycle(engines=("imp_batched", "godel"))`` must give
   every deterministic field of ``BENCH_colocation.json`` and
   ``compare_two_level`` both modes of ``BENCH_elastic.json``; at 128 nodes
   the day's ``key_metrics()`` must equal host ``imp``'s and the
   reference's numbers; at 1024 nodes its events, scalar metrics and hour
   rows must equal the reference's host ``imp`` day (``DAY_1024``); the
   reference's 12-node, 5-hour, seed-5 segment under ``imp_sharded`` over
   4 shards gives ``imp_batched``'s hour rows, and the 1024-node day under
   ``imp_sharded`` over the one card the reference's events and hour
   rows.  Each
   counted day is built, then its counts are set to 0 just before
   ``run()`` and read just after: one ``normal_cycle`` launch a plan the
   scheduler counts, every fused launch count equal to what the recorded
   paths launch (single plans, the shortlist above 128 rows, batch
   sessions, the delta encoder), no lane-form K1 launch.  Each ``[day]`` line
   carries events, wall time, events/s and the plan P50/P90.
   ``[day-trace]`` profiles 200 plans of the 1024-node day from simulated
   hour 8 (the morning ramp): device time per kernel against the window's
   wall, and the host functions that dominate the next 200 plans.  After
   ``[serve]``, ``[day-serve]`` multiplies its decode throughput by the
   Fig. 2 factor of the best- and worst-placed online instance of the
   24-node ``imp_batched`` day and of the ``godel`` day (the last step of
   ``examples/colocated_serving.py``).
7. ``[flash]``: the flash-attention kernel (K4) against its plain version on
   the card, in f32 (2e-5) and bf16 (2.5e-2), over the reference tests'
   five shapes, the serving path's shape, a head_dim-128 shape, a window
   with fully masked first tiles, a ragged Sq at the 128-row q block, a
   windowed head_dim-128 shape whose length is not a multiple of 128, and
   at head dim 256 recurrentgemma-9b's prefill (B 4, H 16, MQA, S 1024,
   window 2048) and a ragged windowed Sq; the bidirectional form at
   seamless-m4t-medium's encoder (B 4, 16/16 heads, S 1024, d 64) and at a
   cross-attention (Sq 777 against Sk 1024); the prefix-LM form at
   paligemma-3b's prefill (B 4, 8/1 heads, S 1280, P 256, d 256), at a
   ragged P 100 over S 300 (d 256), and with a window at d 64; no output
   may be non-finite.  Then 50 back-to-back launches at the serving
   shape must give bit-identical outputs.
7b. ``[flash-bwd]``: K4's backward (``csrc/flash_attention_bwd.cu``, two
   launches a call: dQ with D = rowsum(dO O), then dK and dV; in bf16
   ``wgmma`` kernels fed by a TMA ring, a producer warpgroup and two
   consumers, the dK/dV CTA summing its G query heads in a fixed order (on
   a small grid a cluster of two CTAs a KV tile, its four consumers'
   partial sums met in a fixed order; at d 256 the consumers split the
   head dim and a cluster of 4 CTAs takes each KV tile, the partials met
   a box at a time in rank order), no atomics; the CUDA cores for f32)
   against ``flash_attention_bwd_plain`` at every ``[flash]`` shape in
   f32 and bf16, on the forward kernel's own output and log-sum-exp: each
   of dq,
   dk, dv within ``BWD_TOL`` (f32 1e-4, bf16 3e-2) of its largest plain
   element, no value non-finite, and the forward's log-sum-exp within
   ``LSE_TOL`` of the plain forward's; autograd through
   ``flash_attention`` gives the same gradients with one forward (with
   its log-sum-exp) and one backward launch; 10 back-to-back calls at the
   serving shape, at ``FLASH_D256`` and at ``PALIGEMMA`` bit-identical.
7c. ``[scan-bwd]``: the scans' backward kernels (``csrc/recurrent_bwd.cu``:
   ``wkv6_bwd_kernel``, the chunked form, a CTA a (batch, head): a first
   pass forward keeping a checkpoint every 6 chunks of 16 steps, then each
   segment rebuilt and its chunks walked back, the products as split TF32
   on the tensor cores, a walk a channel on the CUDA cores with a
   division-free dw; ``rglru_bwd_kernel``, the adjoint's reverse scan in
   the forward's slices with the gates' chain rule; sums over the batch by
   a second pass in a fixed order, no atomics) against
   ``wkv6_scan_bwd_plain`` and ``rglru_scan_bwd_plain`` at B 4 with H 64
   or R 4096, S 1, 15, 16, 17, 35, 95, 96, 97, 1024 (WKV: either side
   of a chunk and of a checkpoint segment) and 1, 31, 32, 33, 67, 1024
   (rg-lru), r/k/v or x in bf16 and f32, non-zero s0, h0 and cotangents
   on both outputs, on drawn and extreme inputs (WKV log-decays at both
   ends of the clip; gr at +-20): every f32 gradient within 1e-5 of its
   largest plain element, a bf16 one also within its bf16 rounding, the
   non-finite elements (where the sqrt's slope is infinite) the same;
   10 launches at the training shape bit-identical.
8. ``[serve]``: the serving path, llama3.2-1b at full width and depth with
   seeded random weights made on the card, through ``ServeEngine`` (batch
   4, seq_len 1024): 8 requests of 512-1024 prompt tokens and 32 new tokens
   each.  Counters at 0 just before, read just after: K4 launches must be
   16 layers x 2 prefill batches.  Every request has 32 tokens, no logit is
   non-finite, and the first batch served again gives the same tokens.
   ``[serve-trace]`` profiles one prefill and one decode step.
9. ``[serve-check]``: decode against prefill at full width.  2 sequences of
   1000 tokens, then 4 decode steps; each step's logits within 0.08 of a
   fresh prefill (through K4) of the extended sequence, with the depth cut
   to 2 layers.  The full depth's differences are recorded beside them, and
   so is how far each layer amplifies a 1e-6 perturbation of the input
   (f32): the random-weight model is chaotic at depth (``serve_check``).
9b. ``[families]``: the MoE, recurrent, encoder-decoder and VLM families
   at full width with seeded random weights made on the card, through
   ``ServeEngine`` with ``[serve]``'s protocol: mixtral-8x7b (depth cut
   32 -> 16 layers: 93 GB of bf16 weights exceed the card's 80 GB),
   olmoe-1b-7b, rwkv6-7b, recurrentgemma-9b, seamless-m4t-medium (12 + 12
   layers, zero frames) and paligemma-3b (18 layers, 256 zero patch
   embeddings in front of each prompt), one at a time.  Counters at 0 just
   before ``run()``, read just after: K4 launches = attention layers x
   prefill batches (seamless: 3 x 12 a batch, of them 2 x 12
   bidirectional; paligemma: 18 a batch, each with the prefix), the
   ``wkv6_scan`` and ``rglru_scan`` launches = their layers x (prefill
   batches + decode steps).  Every request has 32 tokens, no logit is
   non-finite, the first batch served again gives the same tokens; the
   MoE lines carry each layer's dropped fraction.  ``[families-check]``:
   rwkv6 and recurrentgemma decode against a fresh prefill at full width
   (2 x 1000 and 2 x 2100 tokens, the latter wrapping the 2048-slot ring
   cache), gated at 0.08 on 2 and 3 layers, the full depth recorded; for
   each MoE config layer 0's MoE in f32 on the card against the CPU on the
   hidden states of a 2 x 1000-token prefill put on a grid where the
   router's product is exact: expert indices, slot order, keep mask and
   capacity slots identical, outputs within 1e-4 relative; decode against
   prefill recorded with the dropped fraction, not gated; for seamless and
   paligemma the model in f32 on the card against the same model on the
   CPU (prefill and 4 decode steps, seeded random frames or patch
   embeddings, within 1e-4 relative) at 1 + 1 and 2 layers a stack
   (seamless's 2 + 2 recorded beside the CPU's own movement under a 1e-7
   change of its frames), and decode against prefill on the card, gated at
   0.08 there and recorded at full depth.
9c. ``[examples]``: ``examples/torch_preemption_demo.py`` on the card,
   whose lines must equal its lines with ``--device cpu`` (the plain
   versions, held to the reference's demo by the CPU tests), and
   ``examples/torch_colocated_serving.py``,
   whose 12-node ``imp_batched`` day must give the port's host ``imp``
   day's ``key_metrics()``.
9d. ``[train]``: ``launch.train.run`` on llama3.2-1b at full width and
   depth (16 layers, d 2048, vocab 128256), bf16 compute over f32 master
   weights, ``remat="full"``, 4 x 1024 tokens of the synthetic pipeline a
   step, 6 steps.  Counters at 0 just before, read just after: K4's
   forward 2 x 16 launches a step (the forward and its recompute), all
   with the log-sum-exp, its backward 16.  Every loss and grad norm
   finite, the first loss below ln(128256) + 2; step 0 twice from one
   state bit-identical; one step traced (K4's shares of the device
   time); step ms, tokens/s and peak memory recorded.  Then the same for
   paligemma-3b at full width (d 2048, 8/1 heads of 256, 256 zero patch
   embeddings before the 1024 tokens, so K4 at d 256 under the prefix-LM
   mask), its depth cut 18 -> 8 (``TRAIN_VLM_LAYERS``: past 11 layers the
   zero patches' gradients overflow, in the reference's arithmetic as in
   the port's), 4 steps: K4's forward 2 x 8 launches a step, all with the
   log-sum-exp and the prefix, its backward 8.  Then rwkv6-7b (d 4096, 64
   heads of 64, vocab 65536) at 17 of its 32 layers and recurrentgemma-9b
   (d 4096, rnn width 4096, vocab 256000) at 8 of its 38 (two
   super-blocks and the two-layer rg-lru tail), 4 steps each
   (``TRAIN_RECURRENT``: the depths the card's memory holds,
   `tools/train_depth.py`): the launches each model's block kinds imply
   (`expected_train_launches`: ``wkv6_scan`` 2 x 17 a step and
   ``wkv6_scan_bwd`` 17, no K4; ``rglru_scan`` 2 x 6 and
   ``rglru_scan_bwd`` 6, K4's forward 2 x 2 with the log-sum-exp and its
   backward 2), the same gates, and the traced step's shares of the
   scans' forward and backward kernels.
   ``[train-check]``: llama3.2-1b, rwkv6-7b and recurrentgemma-9b at full
   width in f32 (2 x 256 tokens): the loss and every leaf's gradient on
   the card (K4's and the scans' f32 kernels) within 1e-3 of the CPU's
   (the plain versions), relative to the leaf's largest element, at 1, 1
   and 2 layers (recurrentgemma's two rg-lru tail layers), beside the
   CPU's own movement under a 1e-7 change of the weights; one layer
   deeper (recurrentgemma's super-block with its attention), where that
   movement alone reaches ~1e-3 or more, recorded.  Each backward kernel must
   have run once a layer of its kind.  ``[train-resume]``: the smoke llama
   on the card (K4 at
   d 16): 6 steps straight against 3 steps, an injected failure, and a
   resume from the step-3 checkpoint into a fresh state, bit for bit;
   then ``examples/torch_fault_tolerant_train.py`` on the card must
   resume after its injected failure.
10. One ``{"kernels": [...]}`` line: per kernel its launches on its path,
   the largest difference against the plain version, the time per call
   from CUDA events (kernel and plain version), the device time per launch
   from torch.profiler (K2's and K3's lane forms also at ``BIG_LANES``,
   each launch after a write that evicts the L2, and at 1024 and
   ``BIG_LANES`` against the yardstick build, A B B A),
   the bound and the share of it the kernel reaches,
   the function's operations over the kernel's time (``tflops``), and the
   time of one PyTorch library call of the same function where there is
   one (the fused kernels at preemptor B on the saturated 1024- and
   10240-node clusters, called as the engine calls them, their launch
   states checked once; ``ms_checked`` when each call checks its tensors
   anew).  ``[cluster-sweep]`` gives K2's (one cluster and split) and the
   tail's device time a call from 128 to 40960 nodes, without and with
   patch rows.  The sweep's row carries its device time in every geometry
   at the main shapes, against the yardstick build (A B B A), on states
   with exactly e = 1..8 eligible victims a row and in the wide form
   (``[sweep-timing]``); ``[floor]`` times an empty kernel launched through
   the same ctypes path.  The three shard merges' rows are timed at the
   records of a plan of preemptor B on the saturated 10240-node cluster
   over 4 shards: ``prescreen_select``'s launch, and for the two merges
   folded into the last shard's launches the time the fold adds (that
   launch with the earlier records less the same launch without them,
   device time, A B B A).  Then ``[trace]`` lines: one traced
   ``imp_pallas`` plan on 1024 nodes and one ``imp_batched`` plan on 1024
   and on 10240 nodes, each's device time against its sourcing wall time,
   and the host functions that dominate; a ``[sourcing]`` line with the
   P50/P90 of every engine and size of ``[main]``; the summary line
   carries ``[sharded]``'s P50/P90 by engine, size and shard count.  The
   rows of ``wkv6_scan`` (rwkv6-7b's prefill: B 4, S 1024, H 64; also
   timed at B 1, one CTA an SM) and ``rglru_scan`` (recurrentgemma-9b's: B
   4, S 1024, R 4096), and of each at a decode step (S 1), are held within
   1e-5 of the largest plain output, from a non-zero carried state, at S
   1, 1023, 1024 and each kernel's chunk boundaries (``chunk_check_s``),
   in bf16 and f32, on drawn and extreme decays (``scan_inputs``); they
   and K4's at head dim 256 (``FLASH_D256``) carry the launches of
   ``[families]`` (the decode rows those at S 1).  K4 has a row for each
   form beside the causal one: ``flash_attention_bidirectional`` at
   seamless's encoder (and the cross-attention shape), with seamless's
   bidirectional launches, and ``flash_attention_prefix`` at paligemma's
   prefill, with its launches; the causal row also times seamless's
   decoder self-attention.  ``flash_attention_bwd`` carries ``[train]``'s
   backward launches, each of its two kernels' device time, their sum and
   the wrapper's at the serving shape (bf16, causal), the bound (five
   products), the plain backward's time and the library's
   (``torch.autograd.grad`` of ``scaled_dot_product_attention``), and the
   forward's time with and without its log-sum-exp output; under
   ``shapes`` the same at the head_dim-128 shape (each also printed as a
   ``[flash-bwd-timing]`` line); ``flash_attention_bwd_d256`` the same at
   ``FLASH_D256`` and ``PALIGEMMA`` (the library under the boolean
   prefix-LM mask), with paligemma-3b's ``[train]`` backward launches.
   ``wkv6_scan_bwd`` and ``rglru_scan_bwd`` carry ``[train]``'s
   launches, their device time a call at the training shape (B 4, S 1024,
   H 64 or R 4096, bf16) by kernel (the sweep and the sums over CTAs),
   the wrapper's, the plain backward's, the bound (the bytes at 3.35
   TB/s; the WKV recurrence's operations on the tensor cores, which a
   chunked form could use, take less) beside the operations on the f32
   pipe, and ``[scan-bwd]``'s largest errors.
11. The card's name and power limit again, then the last line
   ``{"ok": true, "device": {...}}``.

With no CUDA device, or without ``src/repro_torch`` beside this file, it
exits with a non-zero code and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, f32
#: FLOP/s outside the tensor cores, bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
SIZES = (256, 1500, 65536)
#: K2's and K3's bandwidth shape: the lanes of all 2^8 subsets of every
#: node of the reference's 10240-node scale block, in one launch (31-52 MB
#: of inputs and outputs, about the card's 50 MB L2)
BIG_LANES = 10240 * 2**8
#: the scratch write that evicts the L2 before each timed launch at
#: BIG_LANES (more than twice the L2)
L2_FLUSH_BYTES = 256 << 20
#: (need_gpus, need_cgs, cgs_per_bundle, alpha): every need size, a
#: zero-need request, an unbundled one, cnt_cg // 2, and alpha 0 / 1
REQUESTS = ((1, 1, 1, 0.5), (2, 2, 1, 0.0), (4, 4, 0, 1.0), (8, 8, 1, 0.5),
            (0, 0, 0, 0.5), (2, 4, 2, 0.3))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------------

def lanes(torch, np, spec, n, seed, dev):
    """Seeded int32 lanes with the traps: zero masks and priorities, large
    priority sums, k = K_INFEASIBLE, a random ok mask, a fully masked tile."""
    from repro_torch.kernels.topo_score import K_INFEASIBLE, TILE

    rng = np.random.default_rng(seed)
    g = rng.integers(0, spec.all_gpu_mask + 1, n).astype(np.int32)
    c = rng.integers(0, spec.all_cg_mask + 1, n).astype(np.int32)
    g[::17] = 0
    c[::19] = 0
    p = rng.integers(0, 3000 * 16, n).astype(np.int32)
    p[::7] = 0
    k = rng.integers(0, 17, n).astype(np.int32)
    k[::23] = K_INFEASIBLE
    ok = (rng.random(n) < 0.7).astype(np.int32)
    if n > TILE:
        ok[TILE:2 * TILE] = 0
    return [torch.from_numpy(x).to(dev) for x in (g, c, p, k, ok)]


def compare(torch, got, want, what: str) -> float:
    """Bitwise equality of each output pair; returns the max |difference|
    over integers and finite floats (0.0 when bitwise equal)."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{what}: output {i} is {a.dtype}{tuple(a.shape)}, plain "
              f"{b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.float32:
            fin = torch.isfinite(b)
            if bool(fin.any()):
                err = max(err, float((a[fin] - b[fin]).abs().max()))
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            if a.numel():
                err = max(err, float((a.long() - b.long()).abs().max()))
            same = torch.equal(a, b)
        check(same, f"{what}: output {i} differs from the plain version "
              f"(max |diff| {err})")
    return err


def kernel_phase(torch, np, dev) -> dict[str, float]:
    from repro_torch.core.placement import best_tier
    from repro_torch.core.topology import SPECS
    from repro_torch.kernels import topo_score as ts

    errs = {"topo_score_argmax": 0.0, "topo_score": 0.0,
            "placement_tier": 0.0}
    cases = big_cases = 0
    for si, name in enumerate(sorted(SPECS)):
        spec = SPECS[name]
        for ri, (ng, nc, cpb, alpha) in enumerate(REQUESTS):
            req = ts.TopoRequest(ng, nc, cpb, alpha=alpha)
            for n in SIZES:
                g, c, p, k, ok = lanes(torch, np, spec, n + 1,
                                       seed=100 * si + 10 * ri + n, dev=dev)
                # n lanes at offset 0 (16-byte vector path) and at offset 1
                # (scalar path: the views are 4 bytes off alignment)
                for off in (0, 1):
                    x = [t[off:off + n] for t in (g, c, p, k, ok)]
                    what = f"{name} req={ng, nc, cpb, alpha} n={n} off={off}"
                    errs["topo_score_argmax"] = max(
                        errs["topo_score_argmax"], compare(
                            torch, ts.topo_score_argmax(*x[:4], spec, req,
                                                        ok=x[4]),
                            ts.topo_score_argmax_plain(*x[:4], spec, req,
                                                       ok=x[4]),
                            "topo_score_argmax " + what))
                    errs["topo_score"] = max(errs["topo_score"], compare(
                        torch, ts.topo_score(*x[:3], spec, req),
                        ts.topo_score_plain(*x[:3], spec, req),
                        "topo_score " + what))
                    errs["placement_tier"] = max(
                        errs["placement_tier"], compare(
                            torch, [ts.placement_tier(x[0], x[1], spec, req)],
                            [ts.placement_tier_plain(x[0], x[1], spec, req)],
                            "placement_tier " + what))
                    cases += 1
            # K2 and K3 at their bandwidth shape, aligned and 4 bytes off
            g, c, p = lanes(torch, np, spec, BIG_LANES + 1,
                            seed=1000 + 100 * si + 10 * ri, dev=dev)[:3]
            for off in (0, 1):
                x = [t[off:off + BIG_LANES] for t in (g, c, p)]
                what = (f"{name} req={ng, nc, cpb, alpha} n={BIG_LANES} "
                        f"off={off}")
                errs["topo_score"] = max(errs["topo_score"], compare(
                    torch, ts.topo_score(*x, spec, req),
                    ts.topo_score_plain(*x, spec, req), "topo_score " + what))
                errs["placement_tier"] = max(errs["placement_tier"], compare(
                    torch, [ts.placement_tier(x[0], x[1], spec, req)],
                    [ts.placement_tier_plain(x[0], x[1], spec, req)],
                    "placement_tier " + what))
                big_cases += 1
            del g, c, p, x
            # placement_tier against host best_tier, every lane of n = 1500
            g, c = lanes(torch, np, spec, 1500, seed=7 + si, dev=dev)[:2]
            tier = ts.placement_tier(g, c, spec, req).cpu().tolist()
            # the best_tier flag(s) this request encodes
            for bundle in [b for b in (True, False)
                           if (nc // ng if (b and ng) else 0) == cpb]:
                want = [best_tier(spec, gi, ci, ng, nc, bundle)
                        for gi, ci in zip(g.cpu().tolist(), c.cpu().tolist())]
                check(tier == want, f"placement_tier {name} "
                      f"req={ng, nc, cpb} differs from host best_tier")
    torch_sync(dev)
    print(f"[kernels] {cases} cases x 3 kernels and {big_cases} x "
          f"(topo_score, placement_tier) at n = {BIG_LANES} bit-exact against "
          f"the plain versions; placement_tier == host best_tier", flush=True)
    return errs


# ---------------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------------

def reset_counts() -> None:
    from repro_torch.core.preemption_device import (PATH_COUNTS,
                                                    evaluate_subsets)
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels import topo_score as ts

    for w in WRAPPERS:
        w.launches = 0
        for extra in ("decode_launches", "merges", "lse_launches") + tuple(
                f"{form}_launches" for form in K4_FORMS):
            if hasattr(w, extra):
                setattr(w, extra, 0)
    evaluate_subsets.calls = 0
    ts.flextopo_imp_pallas.calls = 0
    ts.flextopo_imp_pallas.overflow = 0
    for key in PATH_COUNTS:
        PATH_COUNTS[key] = 0


#: K4's forms beside the causal one, each counted on its own as well
K4_FORMS = ("bidirectional", "prefix")


def read_counts() -> dict:
    """Each wrapper's launches (K4's also by form, as
    ``flash_attention_<form>``), the merges folded into launches (`FOLDED`),
    ``imp_pallas``' calls and host fallbacks, the per-size engines' subset
    sweeps (``evaluate_subsets``), and under ``path`` what the fused engine
    ran (``PATH_COUNTS``)."""
    from repro_torch.core.preemption_device import (PATH_COUNTS,
                                                    evaluate_subsets)
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels import topo_score as ts

    out = {w.__name__: w.launches for w in WRAPPERS}
    out.update({f"{w.__name__}_decode": w.decode_launches for w in WRAPPERS
                if hasattr(w, "decode_launches")})
    out.update({f"{w.__name__}_{form}": getattr(w, f"{form}_launches")
                for w in WRAPPERS for form in K4_FORMS
                if hasattr(w, f"{form}_launches")})
    by_name = {w.__name__: w for w in WRAPPERS}
    out.update({m: by_name[w].merges for m, w in FOLDED.items()})
    out["evaluate_subsets_calls"] = evaluate_subsets.calls
    out["imp_pallas_calls"] = ts.flextopo_imp_pallas.calls
    out["imp_pallas_overflow"] = ts.flextopo_imp_pallas.overflow
    out["path"] = dict(PATH_COUNTS)
    return out


def check_fused_launches(c: dict, what: str) -> None:
    """The fused kernels' launches in counts ``c`` equal what the engine's
    paths in ``c["path"]`` launch, and no lane-form K1 ran."""
    from repro_torch.core.preemption_device import expected_launches

    for name, k in expected_launches(c["path"]).items():
        check(c[name] == k, f"{what}: {c[name]} {name} launches, the paths "
              f"give {k} ({c['path']})")
    check(c["topo_score_argmax"] == 0 and c["imp_pallas_calls"] == 0
          and c["topo_score"] == 0,
          f"{what}: a lane form of K1 or K3 was launched")


def protocol(num_nodes, cycles, scaleups, engine, dev):
    from repro_torch.core.simulator import SimConfig, run_hit_rate_experiment

    cfg = SimConfig(num_nodes=num_nodes, seed=0, device=dev)
    reset_counts()                        # counts at 0 just before the path
    t0 = time.perf_counter()
    rep = run_hit_rate_experiment(cfg, engine, cycles=cycles,
                                  scaleups_per_cycle=scaleups)
    torch_sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()                # and read just after it
    return rep, summarize(rep, num_nodes, cycles, scaleups, wall, counts)


def summarize(rep, nodes, cycles, scaleups, wall, counts,
              tag: str = "main") -> dict:
    """The ``[main]`` (or ``[tag]``) line of one protocol run."""
    summary = {
        "nodes": nodes, "cycles": cycles, "scaleups": scaleups,
        "engine": rep.engine, "preemptions": rep.preemptions,
        "hits": rep.hits, "failures": rep.failures,
        "placed": rep.placements, "sourcing_p50_us": rep.percentile(50),
        "sourcing_p90_us": rep.percentile(90),
        "samples": len(rep.sourcing_us), "wall_s": wall, "counts": counts,
    }
    print(f"[{tag}] {json.dumps(summary)}", flush=True)
    return summary


def protocol_on(cluster, scaleups, engine, dev):
    """``protocol`` for one cycle on a cluster built beforehand (the
    10240-node one takes ~100 s to build on the card's host): cycle 0 of
    ``run_hit_rate_experiment`` — the same scale-up draw, every plan a pure
    read — so its decisions are the protocol's."""
    import random

    from repro_torch.core.scheduler import TopoScheduler
    from repro_torch.core.simulator import HitRateReport, decision_key
    from repro_torch.core.workload import table3_workloads

    workloads = {w.name: w for w in table3_workloads()}
    rep = HitRateReport(engine=engine)
    reset_counts()                        # counts at 0 just before the path
    t0 = time.perf_counter()
    sched = TopoScheduler(cluster, engine=engine, alpha=0.5)
    rng = random.Random(10_000)
    for _ in range(scaleups):
        dec = sched.plan(workloads[rng.choice(("B", "C"))]).decision
        rep.decision_keys.append(decision_key(dec))
        if dec.preempted:
            rep.preemptions += 1
            rep.hits += int(dec.hit)
            rep.sourcing_us.append(dec.sourcing_us)
        elif dec.rejected:
            rep.failures += 1
        else:
            rep.placements += 1
    torch_sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()                # and read just after it
    return rep, summarize(rep, cluster.num_nodes, 1, scaleups, wall, counts)


def torch_sync(dev) -> None:
    import torch

    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


#: the fused engine's runs: nodes, cycles, scale-ups, expected counts
BATCHED_RUNS = ((100, 2, 50, (100, 100, 0, 0)), (1024, 1, 20, None),
                (10240, 1, 10, None))


def main_path(dev, clusters) -> tuple[list[dict], dict[str, int]]:
    from repro_torch.kernels import WRAPPERS

    runs = []
    host_keys = {}
    launches = {**{w.__name__: 0 for w in WRAPPERS},
                **dict.fromkeys(FOLDED, 0)}
    for nodes, cycles, scaleups, expect in ((100, 2, 50, (100, 100, 0, 0)),
                                            (1024, 1, 20, None),
                                            (20, 3, 10, (30, 30, 0, 0))):
        fast, s_fast = protocol(nodes, cycles, scaleups, "imp_pallas", dev)
        c = s_fast["counts"]
        check(c["topo_score_argmax"] > 0,
              f"{nodes} nodes: imp_pallas never launched topo_score_argmax")
        check(c["topo_score_argmax"]
              == c["imp_pallas_calls"] - c["imp_pallas_overflow"],
              f"{nodes} nodes: {c['topo_score_argmax']} launches for "
              f"{c['imp_pallas_calls']} calls less "
              f"{c['imp_pallas_overflow']} host fallbacks")
        for name in launches:
            launches[name] += c[name]
        got = (fast.preemptions, fast.hits, fast.failures, fast.placements)
        if expect is not None:
            check(got == expect, f"{nodes} nodes: imp_pallas gave {got}, "
                  f"the reference gives {expect}")
        runs.append(s_fast)
        if nodes == 20:
            continue
        host, s_host = protocol(nodes, cycles, scaleups, "imp", dev)
        check(fast.decision_keys == host.decision_keys,
              f"{nodes} nodes: imp_pallas and imp decisions differ")
        host_keys[nodes] = host.decision_keys
        runs.append(s_host)
        print(f"[main] {nodes} nodes: {len(fast.decision_keys)} decisions "
              f"identical between imp_pallas and imp", flush=True)
    legacy_runs(dev, runs, launches, host_keys)
    batched_runs(dev, runs, launches, host_keys, clusters)
    return runs, launches, host_keys


def legacy_runs(dev, runs: list, launches: dict, host_keys: dict) -> None:
    """The per-size engines on the 100-node protocol, decision for
    decision against host ``imp``: ``imp_batched_legacy`` 2 x 50
    (100/100/0/0), ``imp_jax`` (a launch and a readback a size a node,
    ~0.1 s a plan) its first cycle, 50/50/0/0; one K3 (``topo_score``)
    launch a subset-size sweep (``evaluate_subsets``), and no other
    kernel."""
    for engine, cycles in (("imp_batched_legacy", 2), ("imp_jax", 1)):
        got, s = protocol(100, cycles, 50, engine, dev)
        c = s["counts"]
        check(c["topo_score"] > 0
              and c["topo_score"] == c["evaluate_subsets_calls"],
              f"{engine}: {c['topo_score']} topo_score launches for "
              f"{c['evaluate_subsets_calls']} subset sweeps")
        check(all(c[w] == 0 for w in c if w not in (
            "topo_score", "evaluate_subsets_calls", "path")),
              f"{engine}: another kernel was launched ({c})")
        n = 50 * cycles
        check((got.preemptions, got.hits, got.failures, got.placements)
              == (n, n, 0, 0) and got.decision_keys == host_keys[100][:n],
              f"{engine}: decisions differ from host imp")
        for name in launches:
            launches[name] += c[name]
        runs.append(s)
        print(f"[main] 100 nodes: {engine} {n} decisions identical to host "
              f"imp, {c['topo_score']} K3 launches", flush=True)


def batched_runs(dev, runs: list, launches: dict, host_keys: dict,
                 clusters: dict, plan_runs=BATCHED_RUNS) -> None:
    """The fused engine through the same protocol, decision for decision
    against host ``imp`` (run here where ``host_keys`` lacks the size);
    its launches are added to ``launches`` and its summaries to ``runs``.
    A size in ``clusters`` (one cycle) runs on that prebuilt cluster."""

    def run(nodes, cycles, scaleups, engine):
        if nodes in clusters:
            return protocol_on(clusters[nodes], scaleups, engine, dev)
        return protocol(nodes, cycles, scaleups, engine, dev)

    for nodes, cycles, scaleups, expect in plan_runs:
        fused, s_fused = run(nodes, cycles, scaleups, "imp_batched")
        c = s_fused["counts"]
        plans = cycles * scaleups
        check(c["normal_cycle"] == plans,
              f"{nodes} nodes: {c['normal_cycle']} normal_cycle launches for "
              f"{plans} plans (one each)")
        check_fused_launches(c, f"{nodes} nodes imp_batched")
        # saturated clusters: the normal cycle fails on every plan, so the
        # sweep and its tail run on every plan (over the shortlist's rows
        # above 128 rows, and over every row after an uncertain one); the
        # Table 3 mix has at most 8 victims a node, so no wide chunk runs
        path = c["path"]
        shortlisted = nodes > 128
        check(fused.placements == 0 and c["fused_argmax"]
              == plans + path["fallback"]
              and path["shortlist_plan2"] == (plans if shortlisted else 0)
              and path["certain"] + path["fallback"]
              == (plans if shortlisted else 0),
              f"{nodes} nodes: {c['fused_argmax']} fused_argmax launches "
              f"for {plans} plans with {fused.placements} placed ({path})")
        for name in launches:
            launches[name] += c[name]
        full, s_full = run(nodes, cycles, scaleups, "imp_batched_full")
        check(full.decision_keys == fused.decision_keys,
              f"{nodes} nodes: imp_batched and imp_batched_full decisions "
              "differ")
        check(s_full["counts"]["path"]["shortlist_plan2"] == 0
              and s_full["counts"]["prescreen"] == 0,
              f"{nodes} nodes: imp_batched_full ran the shortlist")
        check_fused_launches(s_full["counts"], f"{nodes} nodes "
                             "imp_batched_full")
        runs.append(s_full)
        got = (fused.preemptions, fused.hits, fused.failures,
               fused.placements)
        if expect is not None:
            check(got == expect, f"{nodes} nodes: imp_batched gave {got}, "
                  f"the reference gives {expect}")
        runs.append(s_fused)
        if nodes not in host_keys:
            host, s_host = run(nodes, cycles, scaleups, "imp")
            host_keys[nodes] = host.decision_keys
            runs.append(s_host)
        check(fused.decision_keys == host_keys[nodes],
              f"{nodes} nodes: imp_batched and imp decisions differ")
        print(f"[main] {nodes} nodes: {len(fused.decision_keys)} decisions "
              f"identical between imp_batched, imp_batched_full and imp "
              f"(shortlist: {path['certain']} certain, {path['fallback']} "
              f"fell back to the full sweep)", flush=True)


def commit_phase(dev, steps: int = 100, nodes: int = 1024) -> dict:
    """Twin 1024-node clusters, ``steps`` steps of schedule_or_preempt (B,
    C or D), rollbacks of the newest commit, and releases of a random
    instance (a direct evict): ``imp_batched`` on one, host ``imp`` on the
    other, decisions (masks included) identical at every step.  Exercises
    the row scatter and the pending-row patches."""
    import random

    from repro_torch.core.scheduler import TopoScheduler
    from repro_torch.core.simulator import (SimConfig,
                                            build_saturated_cluster,
                                            decision_key)
    from repro_torch.core.workload import table3_workloads

    wl = {w.name: w for w in table3_workloads()}
    cfg = SimConfig(num_nodes=nodes, seed=3, device=dev)
    twins = [build_saturated_cluster(cfg) for _ in range(2)]
    scheds = [TopoScheduler(twins[0], engine="imp_batched"),
              TopoScheduler(twins[1], engine="imp")]
    rng = random.Random(5)
    stack: list = [[], []]
    kinds = {"placed": 0, "preempted": 0, "rejected": 0}
    ops = {"plan": 0, "rollback": 0, "release": 0}
    reset_counts()                        # counts at 0 just before the path
    t0 = time.perf_counter()
    for step in range(steps):
        op = rng.random()
        if op < 0.15 and stack[0]:
            for s_ in stack:
                s_.pop().rollback()
            ops["rollback"] += 1
        elif op < 0.3:
            uids = sorted(twins[0].instances)
            uid = uids[rng.randrange(len(uids))]
            for c in twins:
                c.evict(uid)
            for s_ in stack:
                s_.clear()                # older commits may not reverse
            ops["release"] += 1
        else:
            name = rng.choice("BBCCD")
            decs = []
            for sched, s_ in zip(scheds, stack):
                txn = sched.plan(wl[name])
                dec = txn.commit()
                s_.append(txn)
                decs.append(decision_key(dec) + (
                    None if dec.placement is None else
                    (dec.placement.gpu_mask, dec.placement.cg_mask),))
            check(decs[0] == decs[1], f"commit step {step}: imp_batched "
                  f"{decs[0]} against imp {decs[1]}")
            kinds[decs[0][0]] += 1
            ops["plan"] += 1
    torch_sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()                # and read just after it
    check(counts["normal_cycle"] == ops["plan"],
          f"commit: {counts['normal_cycle']} normal_cycle launches for "
          f"{ops['plan']} plans")
    check(counts["fused_argmax"] == ops["plan"] + counts["path"]["fallback"],
          f"commit: {counts['fused_argmax']} fused_argmax launches for "
          f"{ops['plan']} plans ({counts['path']})")
    check_fused_launches(counts, "commit")
    out = {"nodes": nodes, "steps": steps, "ops": ops, "decisions": kinds,
           "identical": True, "wall_s": wall, "counts": counts,
           "sweep_launches_that_exit_at_once": kinds["placed"]}
    print(f"[commit] {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------------
# Phase 6: the co-location day cycle on the card
# ---------------------------------------------------------------------------------

#: the reference's host ``imp`` day at 1024 nodes x 24 h, seed 0, made with
#: the JAX package on a CPU (``repro.core.colocation.run_day_cycle(
#: ColocationConfig(num_nodes=1024, seed=0, engine="imp"))``, 344 s): its
#: scalar ``key_metrics()`` (``engine`` differs by design) and the SHA-256
#: of ``json.dumps(key_metrics()["hours"], sort_keys=True)``
DAY_1024 = {
    "seed": 0, "num_nodes": 1024, "scheduled_perf": 58212.00000000001,
    "offline_goodput": 126380.97766694226, "preemptions": 322, "hits": 322,
    "placements": 44850, "failures": 0, "requeued": 1079,
    "requeue_replanned": 1079, "completed_jobs": 39746,
    "elastic_admitted": 0, "elastic_ejected": 0, "elastic_completed": 0,
    "elastic_demoted": 0, "elastic_goodput": 0.0, "slo_violations": 0,
    "slo_attainment": 1.0}
DAY_1024_HOURS_SHA256 = (
    "2252651ceae7922a4b4fc3fb15e7efc54a4ce4eaaabdea567a74400999978cf3")
#: events of that day: the 1024-node row of ``BENCH_colocation.json``'s
#: ``scale`` block
DAY_1024_EVENTS = 107325
#: the reference's host ``imp`` day at 128 nodes x 24 h, seed 0 (same
#: origin, 10 s): the fields the port's day must give
DAY_128 = {"scheduled_perf": 7408.0, "preemptions": 40, "hits": 40,
           "placements": 5618, "requeued": 129, "requeue_replanned": 129,
           "completed_jobs": 4975}
#: the deterministic fields of one ``BENCH_colocation.json`` engine entry
BENCH_DAY_FIELDS = ("scheduled_perf", "preemptor_perf", "offline_goodput",
                    "hit_rate", "hits", "preemptions", "placements",
                    "failures", "requeued", "requeue_replanned",
                    "requeue_success_rate")
#: ``[day-trace]``: plans traced from the first plan at or after this
#: simulated hour of the 1024-node day (hour 8: the morning ramp, where
#: scale-ups preempt)
DAY_TRACE_HOUR, DAY_TRACE_PLANS = 8.0, 200


def day_config(dev, nodes: int, engine: str = "imp_batched", **kw):
    """``benchmarks/bench_colocation.py:day_config`` on ``dev``: 24 h, seed
    0, warm-up on."""
    from repro_torch.core.colocation import ColocationConfig

    return ColocationConfig(num_nodes=nodes, seed=0, engine=engine,
                            horizon_hours=24.0, warmup=True, device=dev,
                            **kw)


def scalars(km: dict) -> dict:
    return {k: v for k, v in km.items() if k not in ("engine", "hours")}


class PlanWindow:
    """Traces a window of a running day: the device time of each kernel
    (torch.profiler) over ``plans`` consecutive plans from the first plan
    at or after simulated hour ``hour``, against the window's wall time,
    then the host functions that take the most of the next ``plans`` plans
    (cProfile).  A window in which the profiler recorded no device time is
    traced again on the next plans, up to ``attempts`` times.  Installed
    over ``sim.sched.plan``, which ``plan_batch`` calls once a request."""

    def __init__(self, torch, sim, hour: float, plans: int,
                 attempts: int = 3) -> None:
        self.torch, self.sim, self.hour, self.plans = torch, sim, hour, plans
        self.attempts = attempts
        self.attempt = 0
        self.n = 0
        self.prof = self.host = None
        self.stage = "wait"            # wait | device | host | done
        self.result: dict | None = None
        self._plan = sim.sched.plan
        sim.sched.plan = self.plan

    def plan(self, *args, **kwargs):
        if self.stage == "wait" and self.sim._now >= self.hour:
            self._start_device()
        out = self._plan(*args, **kwargs)
        if self.stage in ("device", "host"):
            self.n += 1
            if self.n == self.plans:
                self._end_stage()
        return out

    def _start_device(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.attempt += 1
        self.stage, self.n = "device", 0
        self.log0 = len(self.sim.sched.sourcing_us_log)
        self.counts0 = dict(self.sim.sched.plan_counts)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def _end_stage(self) -> None:
        import cProfile
        import pstats

        if self.stage == "device":
            self.torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            self.prof.stop()
            self.result = self._device_summary(wall)
            if (self.result["device_us"]["total"] == 0
                    and self.attempt < self.attempts):
                self._start_device()
                return
            self.stage, self.n = "host", 0
            self.host = cProfile.Profile()
            self.host.enable()
        else:
            self.host.disable()
            stats = pstats.Stats(self.host).stats.items()
            top = sorted(stats, key=lambda kv: -kv[1][2])[:10]
            self.result["host_top_tottime_s"] = [
                [f"{os.path.basename(f)}:{line}({fn})", calls_, round(tt, 6)]
                for (f, line, fn), (_, calls_, tt, _, _) in top]
            # below the event loop: the plan's own functions by the time
            # spent in them and what they call
            inner = [kv for kv in stats if "repro_torch" in kv[0][0]
                     and os.path.basename(kv[0][0]) not in (
                         "colocation.py", "autoscale.py")]
            top = sorted(inner, key=lambda kv: -kv[1][3])[:12]
            self.result["host_top_cumtime_s"] = [
                [f"{os.path.basename(f)}:{line}({fn})", calls_, round(ct, 6)]
                for (f, line, fn), (_, calls_, _, ct, _) in top]
            self.stage = "done"
            self.sim.sched.plan = self._plan

    def _device_summary(self, wall: float) -> dict:
        from torch.autograd import DeviceType

        kernels: dict[str, list] = {}
        device = {"copy": 0.0, "other": 0.0}
        for ev in self.prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            names = [k for k in TRACE_KERNELS["imp_batched"] if k in ev.key]
            if names:
                got = kernels.setdefault(names[0], [0, 0.0])
                got[0] += ev.count
                got[1] += ev.device_time_total
            else:
                part = "copy" if "memcpy" in ev.key.lower() else "other"
                device[part] += ev.device_time_total
        device["kernels"] = sum(v[1] for v in kernels.values())
        device["total"] = sum(device.values())
        sched = self.sim.sched
        counts = {k: v - self.counts0[k]
                  for k, v in sched.plan_counts.items()}
        plan_us = sched.sourcing_us_log[self.log0:]
        return {
            "nodes": self.sim.cluster.num_nodes, "from_hour": self.hour,
            "at_hour": self.sim._now, "plans": self.plans,
            "plans_by_kind": counts, "attempt": self.attempt,
            "window_wall_us": wall * 1e6,
            "plan_us_sum": sum(plan_us),
            "device_us": device,
            "kernel_launches_us": {k: {"launches": v[0], "device_us": v[1],
                                       "us_a_launch": v[1] / max(1, v[0])}
                                   for k, v in sorted(kernels.items())},
            "device_busy_share": device["total"] / (wall * 1e6),
            "device_share_of_plan_time": (device["total"] / sum(plan_us)
                                          if plan_us else None),
        }


def day_run(torch, dev, cfg, trace: tuple[float, int] | None = None,
            online_factors: list | None = None, mesh=None):
    """One day through ``ColocationSim`` (what ``run_day_cycle`` runs).
    The sim is built first (its scheduler's warm-up launches are not the
    day's); the counts are set to 0 just before ``run()`` and read just
    after.  For ``imp_batched``: one ``normal_cycle`` launch a plan that
    the scheduler counts, and one ``fused_class`` and one
    ``fused_argmax`` launch a plan that may preempt (the sweep and its
    tail return at once on the device when the normal cycle placed; a
    normal-only plan is K2 alone; the Table 3 mix holds at most 8 victims a
    node, so no wide chunk runs); no lane-form K1.  Host engines launch
    nothing."""
    import numpy as np

    from repro_torch.core.colocation import ColocationSim, default_policies
    from repro_torch.core.perfmodel import relative_scheduled_factor
    from repro_torch.core.placement import achieved_tier

    sim = ColocationSim(cfg, policies=default_policies(cfg))
    if mesh is not None:
        sim.cluster.device_state(mesh=mesh)
    if online_factors is not None:
        spec = sim.cluster.spec

        def on_online(dec, event):
            inst = dec.instance
            if (event == "committed" and inst is not None
                    and inst.workload.kind == "online"):
                online_factors.append(relative_scheduled_factor(
                    spec, achieved_tier(spec, inst.gpu_mask),
                    inst.workload.gpus_per_instance))

        sim.sched.add_listener(on_online)
    window = (PlanWindow(torch, sim, *trace) if trace is not None else None)
    torch_sync(dev)
    reset_counts()                        # counts at 0 just before the day
    t0 = time.perf_counter()
    rep = sim.run()
    torch_sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()                # and read just after it
    plans = dict(sim.sched.plan_counts)
    n_plans = sum(plans.values())
    what = f"day {cfg.num_nodes} nodes {cfg.engine}"
    fused = cfg.engine in ("imp_batched", "imp_sharded")
    shards = (sim.cluster.device_state().mesh.size
              if cfg.engine == "imp_sharded" else 1)
    if fused:
        check(n_plans > 0 and counts["normal_cycle"] == n_plans * shards,
              f"{what}: {counts['normal_cycle']} normal_cycle launches for "
              f"{n_plans} plans over {shards} shards")
        check(counts["fused_argmax"] <= (plans["may_preempt"]
                                         + counts["path"]["fallback"])
              * shards,
              f"{what}: {counts['fused_argmax']} fused_argmax launches for "
              f"{plans['may_preempt']} plans that may preempt")
        check_fused_launches(counts, what)
        if cfg.engine == "imp_sharded":
            check(counts["normal_merge"] == (n_plans if shards > 1 else 0),
                  f"{what}: {counts['normal_merge']} K2 launches merged "
                  f"the earlier shards' records for {n_plans} plans over "
                  f"{shards} shards")
    else:
        check(not any(v for k, v in counts.items() if k != "path")
              and not any(counts["path"].values()),
              f"{what}: a host engine launched kernels: {counts}")
    plan_us = sim.auto.plan_us
    out = {
        "nodes": cfg.num_nodes, "engine": cfg.engine, "shards": shards,
        "horizon_hours": cfg.horizon_hours, "elastic": cfg.elastic,
        "events": sim.events_processed, "wall_s": wall,
        "events_per_s": sim.events_processed / wall,
        "requests_planned": len(plan_us),
        "plan_p50_us": float(np.percentile(plan_us, 50)),
        "plan_p90_us": float(np.percentile(plan_us, 90)),
        "fused_plans": plans if fused else None,
        "fused_plan_p50_us": (float(np.percentile(sim.sched.sourcing_us_log,
                                                   50))
                              if fused else None),
        "counts": counts, **scalars(rep.key_metrics()),
    }
    print(f"[day] {json.dumps(out)}", flush=True)
    if window is not None:
        check(window.stage == "done", f"{what}: the trace window did not "
              f"close (stage {window.stage})")
        print(f"[day-trace] {json.dumps(window.result)}", flush=True)
        out["trace"] = window.result
    return rep, out


def day_phase(torch, dev) -> dict:
    """``[day]``: the co-location day cycle on the card through
    ``imp_batched``: the committed 24-node A/B and two-level A/B against
    ``BENCH_colocation.json`` / ``BENCH_elastic.json``, the 128-node day
    against the port's host ``imp`` day and the reference's numbers, and
    the 1024-node day against the reference's host ``imp`` day, with
    ``[day-trace]`` over one window of it."""
    import hashlib

    from repro_torch.core.colocation import (compare_day_cycle,
                                             compare_two_level)
    from repro_torch.serving.elastic import ElasticConfig

    with open(os.path.join(ROOT, "BENCH_colocation.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "BENCH_elastic.json")) as f:
        bench_el = json.load(f)
    launches = dict.fromkeys(("normal_cycle", "fused_class", "fused_argmax",
                              "prescreen", "encode_delta") + MERGES, 0)
    plans = 0
    runs = []

    def counted(rep_out):
        nonlocal plans
        rep, out = rep_out
        for k in launches:
            launches[k] += out["counts"][k]
        if out["fused_plans"]:
            plans += sum(out["fused_plans"].values())
        runs.append(out)
        return rep, out

    # the committed A/B, 24 nodes: compare_day_cycle as a user calls it
    cfg24 = day_config(dev, bench["num_nodes"])
    t0 = time.perf_counter()
    ab = compare_day_cycle(cfg24, engines=("imp_batched", "godel"))
    ab_s = time.perf_counter() - t0
    for name in ("imp_batched", "godel"):
        rep = ab["reports"][name]
        for field in BENCH_DAY_FIELDS:
            check(getattr(rep, field) == bench["engines"][name][field],
                  f"day 24 nodes {name}: {field} {getattr(rep, field)!r}, "
                  f"BENCH_colocation.json {bench['engines'][name][field]!r}")
    for field in ("uplift", "preemptor_uplift", "goodput_uplift"):
        check(ab[field] == bench[field], f"day 24 nodes: {field} "
              f"{ab[field]!r}, BENCH_colocation.json {bench[field]!r}")
    # the same days again, counted, with their plan times
    factors: dict[str, list[float]] = {}
    for engine in ("imp_batched", "godel"):
        rep, _ = counted(day_run(torch, dev, day_config(dev, 24, engine),
                                 online_factors=factors.setdefault(engine,
                                                                   [])))
        check(rep.key_metrics() == ab["reports"][engine].key_metrics(),
              f"day 24 nodes {engine}: a second run gave other metrics")
        check(bool(factors[engine]),
              f"day 24 nodes {engine}: no online instance committed")
    # the two-level A/B on the same day
    t0 = time.perf_counter()
    two = compare_two_level(day_config(dev, 24, elastic_cfg=ElasticConfig()))
    two_s = time.perf_counter() - t0
    for mode, want in bench_el["modes"].items():
        rep = two["reports"][mode]
        for field, value in want.items():
            got = (rep.slo_by_class() if field == "slo_by_class"
                   else getattr(rep, field))
            check(got == value, f"two-level 24 nodes {mode}: {field} "
                  f"{got!r}, BENCH_elastic.json {value!r}")
    for field in ("goodput_uplift", "preemption_delta"):
        check(two[field] == bench_el[field], f"two-level 24 nodes: {field} "
              f"{two[field]!r}, BENCH_elastic.json {bench_el[field]!r}")
    print(f"[day] 24 nodes: compare_day_cycle (imp_batched, godel) gives "
          f"BENCH_colocation.json (uplift {ab['uplift']}, preemptor uplift "
          f"{ab['preemptor_uplift']}; {ab_s:.1f} s) and compare_two_level "
          f"gives BENCH_elastic.json, both modes ({two_s:.1f} s)", flush=True)

    # 128 nodes: imp_batched against host imp, and the reference's numbers
    fused, _ = counted(day_run(torch, dev, day_config(dev, 128)))
    host, _ = counted(day_run(torch, dev, day_config(dev, 128, "imp")))
    check(scalars(fused.key_metrics()) == scalars(host.key_metrics())
          and fused.key_metrics()["hours"] == host.key_metrics()["hours"],
          "day 128 nodes: imp_batched and imp key metrics differ")
    for field, value in DAY_128.items():
        check(getattr(fused, field) == value, f"day 128 nodes: {field} "
              f"{getattr(fused, field)!r}, the reference {value!r}")
    print("[day] 128 nodes: imp_batched key metrics identical to host imp "
          "and to the reference's", flush=True)

    # 1024 nodes: imp_batched against the reference's host imp day
    big, out = counted(day_run(torch, dev, day_config(dev, 1024),
                               trace=(DAY_TRACE_HOUR, DAY_TRACE_PLANS)))
    km = big.key_metrics()
    check(out["events"] == DAY_1024_EVENTS, f"day 1024 nodes: "
          f"{out['events']} events, the reference {DAY_1024_EVENTS}")
    check(scalars(km) == DAY_1024, f"day 1024 nodes: {scalars(km)} against "
          f"the reference's {DAY_1024}")
    digest = hashlib.sha256(json.dumps(km["hours"], sort_keys=True)
                            .encode()).hexdigest()
    check(digest == DAY_1024_HOURS_SHA256,
          f"day 1024 nodes: hour rows differ from the reference's ({digest})")
    print("[day] 1024 nodes: imp_batched key metrics and hour rows "
          "identical to the reference's host imp day", flush=True)

    # imp_sharded: the reference's 12-node, 5-hour, seed-5 segment over
    # SHARDS_D shards against imp_batched, and the 1024-node day over the
    # default mesh (the one card) against the reference's numbers
    from repro_torch.core.colocation import ColocationConfig

    seg = {}
    for engine, mesh in (("imp_batched", None),
                         ("imp_sharded", (cuda0(torch),) * SHARDS_D)):
        seg[engine], _ = counted(day_run(torch, dev, ColocationConfig(
            num_nodes=12, seed=5, engine=engine, horizon_hours=5.0,
            device=dev), mesh=mesh))
    a, b = seg["imp_batched"].key_metrics(), seg["imp_sharded"].key_metrics()
    check(a["hours"] == b["hours"] and scalars(a) == scalars(b),
          f"day 12 nodes 5 h: imp_sharded over {SHARDS_D} shards differs "
          "from imp_batched")
    big, out = counted(day_run(torch, dev, day_config(dev, 1024,
                                                      "imp_sharded")))
    km = big.key_metrics()
    digest = hashlib.sha256(json.dumps(km["hours"], sort_keys=True)
                            .encode()).hexdigest()
    check(out["events"] == DAY_1024_EVENTS and scalars(km) == DAY_1024
          and digest == DAY_1024_HOURS_SHA256,
          f"day 1024 nodes imp_sharded: {out['events']} events, hour rows "
          f"{digest}, against the reference's day")
    print(f"[day] 12 nodes 5 h: imp_sharded over {SHARDS_D} shards gives "
          f"imp_batched's hour rows; 1024 nodes: imp_sharded over the one "
          f"card gives the reference's {DAY_1024_EVENTS} events and hour "
          "rows", flush=True)
    return {"runs": runs, "launches": launches, "plans": plans,
            "factors": {k: (max(v), min(v)) for k, v in factors.items()},
            "ab_s": ab_s, "two_level_s": two_s}


def day_serve_line(day: dict, serve: dict) -> dict:
    """The last step of ``examples/colocated_serving.py``: ``[serve]``'s
    decode throughput (a batch's tokens over the decode step's P50) times
    the Fig. 2 factor of the best- and the worst-placed online instance of
    the 24-node ``imp_batched`` day, and of the ``godel`` day beside it."""
    decode_tok_s = SERVE_BATCH * 1e3 / serve["decode_p50_ms"]
    out = {"decode_tok_per_s": decode_tok_s,
           "factors": {k: {"best": b, "worst": w}
                       for k, (b, w) in day["factors"].items()},
           "scheduled_tok_per_s": {
               k: {"best": decode_tok_s * b, "worst": decode_tok_s * w}
               for k, (b, w) in day["factors"].items()}}
    print(f"[day-serve] {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------------
# Phase 3b: the fused engine's kernels against their plain versions
# ---------------------------------------------------------------------------------

#: node counts of the random resident states, and the preemptor priorities
FUSED_NODES = (100, 1024, 10240)
FUSED_THRESH = (1000, 300)
#: a SKU with 24 CoreGroups, where 16 victims with disjoint masks fit
BIG_CG = dict(name="bigcg", num_sockets=2, num_numa=8, num_cores=192,
              num_gpus=8, coregroup_size=8)
SENTINEL = 2**31 - 1


def resident_state(np, spec, rows: int, max_victims: int, seed: int,
                   cap: int = 16, min_victims: int = 0):
    """Seeded resident rows (nodestate, victims, drain) as the allocator
    leaves them: every GPU and CoreGroup free, held by one stored victim,
    or held by a non-preemptible instance (one node's masks disjoint,
    checked: K1 adds the per-NUMA counts of a subset's masks); victims
    sorted by priority, ranks a permutation; some rows sentinels, some
    truncated.  Each row stores ``min_victims`` to ``max_victims``
    victims."""
    rng = np.random.default_rng(seed)
    s = rng.integers(min_victims, max_victims + 1, rows)
    own_g = (rng.random((rows, spec.num_gpus)) * (s[:, None] + 2)).astype(
        np.int64) - 1                                  # -1 held, 0 free
    own_c = (rng.random((rows, spec.num_coregroups)) * (s[:, None] + 2)
             ).astype(np.int64) - 1
    slot = np.arange(cap)
    stored = slot[None, :] < s[:, None]
    v = np.zeros((5, rows, cap), np.int64)
    for j in range(cap):
        v[0, :, j] = ((own_g == j + 1) << np.arange(spec.num_gpus)).sum(1)
        v[1, :, j] = ((own_c == j + 1) << np.arange(spec.num_coregroups)
                      ).sum(1)
    prio = rng.choice(np.array([1, 2, 3, 200, 450, 900, 1200]), (rows, cap))
    prio = np.where(stored, prio, SENTINEL)
    v[2] = np.where(stored, np.sort(prio, axis=1), 0)
    key = np.where(stored, rng.random((rows, cap)), np.inf)
    v[3] = np.where(stored, np.argsort(np.argsort(key, axis=1), axis=1), 0)
    v[4] = stored
    v[0] *= stored
    v[1] *= stored
    ns = np.zeros((5, rows), np.int64)
    ns[0] = ((own_g == 0) << np.arange(spec.num_gpus)).sum(1)
    ns[1] = ((own_c == 0) << np.arange(spec.num_coregroups)).sum(1)
    ns[2] = np.where(rng.random(rows) < 0.03, SENTINEL, np.arange(rows))
    over = rng.random(rows) < 0.1
    ns[3] = over
    ns[4] = np.where(over, rng.integers(0, 1600, rows), SENTINEL)
    dr = np.stack([ns[0] | np.bitwise_or.reduce(v[0], axis=1),
                   ns[1] | np.bitwise_or.reduce(v[1], axis=1)])
    for f in (0, 1):         # free and victim masks pairwise disjoint
        masks = np.concatenate([ns[f][:, None], v[f]], axis=1)
        check((masks.sum(1) == np.bitwise_or.reduce(masks, axis=1)).all(),
              "resident_state: a row's masks overlap")
    return [x.astype(np.int32) for x in (ns, v, dr)]


def patch_rows(np, spec, n: int, count: int, seed: int, max_victims: int):
    """(pidx, pbuf): ``count`` sorted random rows replaced by the rows of
    another state, padded with sentinels to a power of two."""
    rng = np.random.default_rng(seed)
    nodes = np.sort(rng.choice(n, count, replace=False)).astype(np.int32)
    pns, pv, pdr = resident_state(np, spec, count, max_victims, seed + 1)
    pns[2] = nodes
    size = 1 << (count - 1).bit_length()
    pidx = np.full(size, SENTINEL, np.int32)
    pidx[:count] = nodes
    pbuf = np.zeros((size, 5 + 5 * pv.shape[2] + 2), np.int32)
    pbuf[:count] = np.concatenate(
        [pns.T, pv.transpose(1, 0, 2).reshape(count, -1), pdr.T], axis=1)
    return pidx, pbuf


def sweep_geometries(fc, m_res: int, n_res: int, m_gather: int,
                     n_gather: int) -> list[tuple[int, int, int]]:
    """Every geometry the class sweep's launcher takes for these sections,
    the wrapper's own first: up to 8 slots, 1 to 8 warps a CTA with rows
    sharing warps and with a warp a row; and the wide CTA."""
    auto = fc.sweep_geometry(m_res, n_res, m_gather, n_gather)
    out = [auto]
    if auto[0] != fc.WIDE_THREADS:
        out += [(32 * w, g, g) for g in (fc.SHARED_GROUP, 32)
                for w in range(1, 9)]
    out.append((fc.WIDE_THREADS,) * 3)
    return list(dict.fromkeys(out))


def fused_phase(torch, np, dev) -> dict[str, float]:
    """K1's resident form, its tail and K2's normal-cycle form against
    their plain versions on the card, bit for bit: random resident states
    at 100, 1024 and 10240 nodes (m_res 4 and 8, 13 gathered mid rows),
    a 16-slot state through the wide kernel, every REQUESTS entry at two
    preemptor priorities, with and without patch rows; then the skip
    path (the normal cycle placed: the sweep and the tail do nothing)."""
    from repro_torch.core.topology import RTX4090_SERVER, ServerSpec
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import normal_cycle as nck

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    errs = {"fused_class": 0.0, "fused_argmax": 0.0, "normal_cycle": 0.0}
    cases = normal_cases = forced = 0
    plans = []      # (spec, n, state, patches, gidx, m_res, m_gather, res)
    for n in FUSED_NODES:
        state = [t(x) for x in resident_state(np, RTX4090_SERVER, n, 8, n)]
        rng = np.random.default_rng(n + 1)
        gidx = np.full(16, SENTINEL, np.int32)
        gidx[:13] = rng.choice(n, 13, replace=False)
        for patched in (False, True):
            pidx, pbuf = (patch_rows(np, RTX4090_SERVER, n, 9, n + 2, 8)
                          if patched else
                          (np.zeros(0, np.int32),
                           np.zeros((0, 87), np.int32)))
            for m_res in (4, 8):
                plans.append((RTX4090_SERVER, n, state, (t(pidx), t(pbuf)),
                              t(gidx), m_res, 8, True))
    big = ServerSpec(**BIG_CG)
    state = [t(x) for x in resident_state(np, big, 40, 16, 5)]
    gidx = np.full(48, SENTINEL, np.int32)
    gidx[:40] = np.arange(40)
    gidx[40:44] = [3, 7, 11, 39]
    for patched in (False, True):
        pidx, pbuf = (patch_rows(np, big, 40, 5, 6, 16) if patched else
                      (np.zeros(0, np.int32), np.zeros((0, 87), np.int32)))
        plans.append((big, 40, state, (t(pidx), t(pbuf)), t(gidx), 16, 16,
                      False))
    for spec, n, (ns, v, dr), (pidx, pbuf), gidx, m_res, m_g, res in plans:
        for ng, ncg, cpb, alpha in REQUESTS:
            for thresh in FUSED_THRESH:
                req = fc.FusedRequest(thresh, ng, ncg, cpb, alpha)
                what = (f"{spec.name} n={n} p={pidx.shape[0]} m_res={m_res} "
                        f"m_gather={m_g} req={thresh, ng, ncg, cpb, alpha}")
                kw = dict(m_res=m_res, resident=res, m_gather=m_g, req=req,
                          spec=spec)
                cls = fc.fused_class(ns, v, dr, pidx, pbuf, gidx, **kw)
                want = fc.fused_class_plain(ns, v, dr, pidx, pbuf, gidx, **kw)
                errs["fused_class"] = max(errs["fused_class"], compare(
                    torch, [cls], [want], "fused_class " + what))
                st = fc.launch_state(ns, v, dr, pidx, pbuf, gidx, res)
                for geo in sweep_geometries(fc, m_res, st.n_res, m_g, st.g):
                    errs["fused_class"] = max(errs["fused_class"], compare(
                        torch, [fc.launch_class(st, m_res, m_g, req, spec,
                                                geometry=geo)], [want],
                        f"fused_class geometry={geo} " + what))
                    forced += 1
                seg = cls.shape[1] if res else 16
                kw = dict(resident=res, seg=seg, req=req, spec=spec)
                errs["fused_argmax"] = max(errs["fused_argmax"], compare(
                    torch,
                    [fc.fused_argmax(cls, ns, v, pidx, pbuf, gidx, **kw)],
                    [fc.fused_argmax_plain(want, ns, v, pidx, pbuf, gidx,
                                           **kw)],
                    "fused_argmax " + what))
                if thresh == FUSED_THRESH[0] and m_res in (4, 16):
                    errs["normal_cycle"] = max(errs["normal_cycle"], compare(
                        torch,
                        [nck.normal_cycle(ns, v, dr, pidx, pbuf, req=req,
                                          spec=spec)],
                        [nck.normal_cycle_plain(ns, v, dr, pidx, pbuf, req,
                                                spec)],
                        "normal_cycle " + what))
                    normal_cases += 1
                cases += 1
    # the skip path: out[0] set, the sweep returns, the tail writes zeros
    spec, n, (ns, v, dr), (pidx, pbuf), gidx = plans[0][:5]
    req = fc.FusedRequest(1000, *REQUESTS[0])
    out = torch.full((14,), 7, dtype=torch.int32, device=dev)
    out[0] = 1
    cls = fc.fused_class(ns, v, dr, pidx, pbuf, gidx, m_res=4, resident=True,
                         m_gather=8, req=req, spec=spec, skip=out[:1])
    fc.fused_argmax(cls, ns, v, pidx, pbuf, gidx, resident=True,
                    seg=cls.shape[1], req=req, spec=spec, skip=out[:1],
                    out=out[5:])
    check(out[5:].tolist() == [0] * 9 and out[:5].tolist() == [1, 7, 7, 7, 7],
          f"fused: the skip path wrote {out.tolist()}")
    torch_sync(dev)
    print(f"[fused] {cases} cases x (fused_class, fused_argmax) and "
          f"{normal_cases} x normal_cycle bit-exact against the plain versions "
          f"(N {list(FUSED_NODES)} and a 16-slot state, patch rows on/off); "
          f"fused_class also in every geometry its launcher takes, forced "
          f"({forced} launches); skip path ok", flush=True)
    return errs


#: node counts across the cluster geometry's boundaries (a warp, one CTA of
#: CTA_ROWS, 1024, the one-node-a-thread limits of 8 and 16 CTAs x 1024
#: threads, and the loop beyond them)
CLUSTER_NODES = (1, 2, 127, 128, 129, 1023, 1024, 1025, 8191, 8192, 8193,
                 16385, 40960)
#: patch rows a launch carries; "max" is MAX_PATCH_ROWS (where N allows)
CLUSTER_PATCHES = (0, 1, 9, "max")
BACK_TO_BACK = 50


def tie_table(np, rows: int, seed: int):
    """A class table that forces exact Eq. 1 ties: priority sums from {0,
    1, 2, 4} (at alpha 0.5, tier 0 with sum 2 and tier 1 with sum 1 both
    score 0.75; at alpha 0 every entry of a tier ties), k, node id and uid
    mask from small sets, so the tie chain runs down to the flat index."""
    rng = np.random.default_rng(seed)
    cls = np.zeros((15, rows), np.int32)
    cls[0:3] = rng.random((3, rows)) < 0.5
    cls[3:6] = rng.integers(0, 256, (3, rows))
    cls[6:9] = rng.choice(np.array([0, 1, 2, 4]), (3, rows))
    cls[9:12] = rng.choice(np.array([1, 2, 1 << 15]), (3, rows))
    cls[12] = rng.integers(1, 3, rows)
    cls[13] = rng.integers(0, 2**31 - 1, rows)   # the sum wraps as int32
    cls[14] = rng.integers(0, 4, rows)
    return cls


def cluster_phase(torch, np, dev) -> dict[str, float]:
    """K2's normal-cycle form and K1's tail, the two kernels that run as
    one thread-block cluster, against their plain versions on the card,
    bit for bit: every CLUSTER_NODES size on the three SKUs and the 16-slot
    state, with 0, 1, 9 and MAX_PATCH_ROWS patch rows, the tail over the
    resident segment (with 13 gathered rows) and over 16-row chunks of
    gathered rows, class tables with forced exact ties at alpha 0, 0.3 and
    0.5, more patch rows than the kernels take (raises), and BACK_TO_BACK
    launches of each (and of K2's split form, its ticket back at 0 after
    them) that must agree bit for bit.  K2 runs in the geometry its
    wrapper picks and, forced, in its split form (at least two clusters in
    one launch, the last to take the ticket placing) at every N."""
    from repro_torch.core.topology import (A100_SERVER, RTX4090_SERVER,
                                           TPU_V5E_HOST, ServerSpec)
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import normal_cycle as nck

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    errs = {"fused_class": 0.0, "fused_argmax": 0.0, "normal_cycle": 0.0}
    n_normal = n_split = n_tail = n_tie = n_sweep = 0
    specs = ((RTX4090_SERVER, 8), (A100_SERVER, 16), (TPU_V5E_HOST, 8),
             (ServerSpec(**BIG_CG), 16))
    requests = ((1000, 2, 2, 1, 0.5), (300, 1, 1, 1, 0.0))
    empty = (t(np.zeros(0, np.int32)), t(np.zeros((0, 87), np.int32)))
    keep = {}
    for si, (spec, max_v) in enumerate(specs):
        for n in CLUSTER_NODES:
            ns, v, dr = (t(x) for x in resident_state(np, spec, n, max_v,
                                                       1000 * si + n))
            rng = np.random.default_rng(n + si)
            n_g = min(13, n)
            gidx = np.full(16, SENTINEL, np.int32)
            gidx[:n_g] = rng.choice(n, n_g, replace=False)
            gidx = t(gidx)
            for count in CLUSTER_PATCHES:
                count = fc.MAX_PATCH_ROWS if count == "max" else count
                if count > n or (count == fc.MAX_PATCH_ROWS and si > 0):
                    continue
                if count:
                    pidx, pbuf = (t(x) for x in patch_rows(
                        np, spec, n, count, n + count, max_v))
                else:
                    pidx, pbuf = empty
                for thresh, ng, ncg, cpb, alpha in requests:
                    req = fc.FusedRequest(thresh, ng, ncg, cpb, alpha)
                    what = (f"{spec.name} n={n} p={pidx.shape[0]} "
                            f"req={thresh, ng, ncg, cpb, alpha}")
                    want = nck.normal_cycle_plain(ns, v, dr, pidx, pbuf, req,
                                                  spec)
                    errs["normal_cycle"] = max(errs["normal_cycle"], compare(
                        torch, [nck.normal_cycle(ns, v, dr, pidx, pbuf,
                                                 req=req, spec=spec)],
                        [want], "normal_cycle " + what))
                    n_normal += 1
                    st = fc.launch_state(ns, v, dr, pidx, pbuf, None,
                                         resident=True)
                    errs["normal_cycle"] = max(errs["normal_cycle"], compare(
                        torch, [nck.launch(st, req, spec, geometry=(
                            nck.normal_geometry(n, split_nodes=0)))],
                        [want], "normal_cycle split " + what))
                    n_split += 1
                    kw = dict(m_res=8, resident=True, m_gather=8, req=req,
                              spec=spec)
                    cls = fc.fused_class(ns, v, dr, pidx, pbuf, gidx, **kw)
                    errs["fused_class"] = max(errs["fused_class"], compare(
                        torch, [cls], [fc.fused_class_plain(
                            ns, v, dr, pidx, pbuf, gidx, **kw)],
                        "fused_class " + what))
                    n_sweep += 1
                    tkw = dict(resident=True, seg=cls.shape[1], req=req,
                               spec=spec)
                    errs["fused_argmax"] = max(errs["fused_argmax"], compare(
                        torch, [fc.fused_argmax(cls, ns, v, pidx, pbuf, gidx,
                                                **tkw)],
                        [fc.fused_argmax_plain(cls, ns, v, pidx, pbuf, gidx,
                                               **tkw)],
                        "fused_argmax resident " + what))
                    n_tail += 1
                    if n <= 1025:     # 16-row chunks of gathered rows
                        chunks = np.full(48, SENTINEL, np.int32)
                        chunks[:min(40, n)] = rng.choice(n, min(40, n),
                                                         replace=False)
                        chunks = t(chunks)
                        gkw = dict(m_res=8, resident=False, m_gather=8,
                                   req=req, spec=spec)
                        gcls = fc.fused_class(ns, v, dr, pidx, pbuf, chunks,
                                              **gkw)
                        errs["fused_class"] = max(
                            errs["fused_class"], compare(
                                torch, [gcls], [fc.fused_class_plain(
                                    ns, v, dr, pidx, pbuf, chunks, **gkw)],
                                "fused_class chunks " + what))
                        n_sweep += 1
                        ckw = dict(resident=False, seg=16, req=req,
                                   spec=spec)
                        errs["fused_argmax"] = max(
                            errs["fused_argmax"], compare(
                                torch,
                                [fc.fused_argmax(gcls, ns, v, pidx, pbuf,
                                                 chunks, **ckw)],
                                [fc.fused_argmax_plain(gcls, ns, v, pidx,
                                                       pbuf, chunks, **ckw)],
                                "fused_argmax chunks " + what))
                        n_tail += 1
                if spec is RTX4090_SERVER and n == 8193 and count == 9:
                    keep = dict(ns=ns, v=v, dr=dr, pidx=pidx, pbuf=pbuf,
                                gidx=gidx, spec=spec)
            # class tables with forced exact ties, through the tail alone
            if n in (1, 129, 1025, 8193, 40960):
                for alpha in (0.0, 0.3, 0.5):
                    req = fc.FusedRequest(1000, 1, 1, 1, alpha)
                    cls = t(tie_table(np, n, 7 * n + si))
                    tkw = dict(resident=True, seg=n, req=req, spec=spec)
                    args = (cls, ns, v, *empty, empty[0])
                    errs["fused_argmax"] = max(errs["fused_argmax"], compare(
                        torch, [fc.fused_argmax(*args, **tkw)],
                        [fc.fused_argmax_plain(*args, **tkw)],
                        f"fused_argmax ties {spec.name} n={n} alpha={alpha}"))
                    n_tie += 1
    # more patch rows than the shared-memory budget: the wrapper raises
    ns, v, dr, spec = keep["ns"], keep["v"], keep["dr"], keep["spec"]
    big = torch.zeros(2 * fc.MAX_PATCH_ROWS, dtype=torch.int32, device=dev)
    try:
        nck.normal_cycle(ns, v, dr, big, torch.zeros(
            (big.shape[0], 87), dtype=torch.int32, device=dev),
            req=fc.FusedRequest(1000, 1, 1, 1, 0.5), spec=spec)
        raised = False
    except ValueError:
        raised = True
    check(raised, "normal_cycle took more patch rows than MAX_PATCH_ROWS")
    # back to back: the same inputs give the same bits every launch, with
    # nothing carried from one launch to the next
    req = fc.FusedRequest(1000, 2, 2, 1, 0.5)
    pidx, pbuf, gidx = keep["pidx"], keep["pbuf"], keep["gidx"]
    cls = fc.fused_class(ns, v, dr, pidx, pbuf, gidx, m_res=8, resident=True,
                         m_gather=8, req=req, spec=spec)
    outs = {"normal_cycle": [], "normal_cycle split": [], "fused_argmax": [],
            "fused_class": []}
    st = fc.launch_state(ns, v, dr, pidx, pbuf, None, resident=True)
    split = nck.normal_geometry(st.n, split_nodes=0)
    for _ in range(BACK_TO_BACK):
        outs["fused_class"].append(fc.fused_class(
            ns, v, dr, pidx, pbuf, gidx, m_res=8, resident=True, m_gather=8,
            req=req, spec=spec))
        outs["normal_cycle"].append(nck.normal_cycle(
            ns, v, dr, pidx, pbuf, req=req, spec=spec))
        outs["normal_cycle split"].append(nck.launch(st, req, spec,
                                                     geometry=split))
        outs["fused_argmax"].append(fc.fused_argmax(
            cls, ns, v, pidx, pbuf, gidx, resident=True, seg=cls.shape[1],
            req=req, spec=spec))
    torch_sync(dev)
    for name, got in outs.items():
        check(all(torch.equal(got[0], x) for x in got[1:]),
              f"{name}: {BACK_TO_BACK} back-to-back launches differ")
    check(torch.equal(outs["normal_cycle split"][0], outs["normal_cycle"][0]),
          "normal_cycle: the split form differs from one cluster")
    ticket = fc.ticket(ns.device, torch.cuda.current_stream().cuda_stream)
    check(int(ticket.item()) == 0, f"the split forms' ticket is "
          f"{int(ticket.item())} after {BACK_TO_BACK} launches, not 0")
    print(f"[fused] the cluster kernels: {n_normal} normal_cycle (and "
          f"{n_split} in its split form) and "
          f"{n_tail} + {n_tie} (tie tables) fused_argmax cases, and the "
          f"{n_sweep} class sweeps that feed the tail, bit-exact "
          f"against the plain versions (N {list(CLUSTER_NODES)}, "
          f"{[s.name for s, _ in specs]}, patch rows 0/1/9/"
          f"{fc.MAX_PATCH_ROWS}); {2 * fc.MAX_PATCH_ROWS} patch rows raise; "
          f"{BACK_TO_BACK} back-to-back launches of each (and of K2's split "
          "form and the sweep) bit-identical, the ticket back at 0",
          flush=True)
    return errs


# ---------------------------------------------------------------------------------
# Phase 4: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------------

#: B, H, K, Sq, Sk, d, causal, window[, prefix]: the reference tests' five
#: shapes, the serving path's (llama3.2-1b prefill, batch 4 x 1024), a
#: head_dim-128 shape, a window whose first KV tile is fully masked for some
#: rows, a ragged Sq at the bf16 kernel's 128-row q block, a windowed
#: head_dim-128 shape whose length is not a multiple of 128, at head dim 256
#: recurrentgemma-9b's prefill and a ragged windowed Sq; then
#: seamless-m4t-medium's encoder and a cross-attention (bidirectional),
#: paligemma-3b's prefill (prefix-LM, P 256), a ragged P 100 at d 256, and
#: a prefix with a window at d 64 whose P and window cross the blocks
FLASH_SHAPES = (
    (2, 4, 2, 128, 128, 32, True, None),
    (1, 4, 1, 200, 200, 16, True, None),
    (2, 2, 2, 96, 96, 64, True, 32),
    (1, 8, 4, 64, 256, 32, False, None),
    (1, 2, 2, 257, 257, 16, True, 100),
    (4, 32, 8, 1024, 1024, 64, True, None),
    (1, 28, 4, 1500, 1500, 128, True, None),
    (1, 8, 2, 600, 600, 128, True, 100),
    (2, 16, 4, 1000, 1000, 64, True, None),
    (2, 8, 2, 777, 777, 128, True, 250),
    (4, 16, 1, 1024, 1024, 256, True, 2048),
    (2, 8, 1, 777, 777, 256, True, 250),
    (4, 16, 16, 1024, 1024, 64, False, None),
    (4, 16, 16, 777, 1024, 64, False, None),
    (4, 8, 1, 1280, 1280, 256, True, None, 256),
    (2, 8, 1, 300, 300, 256, True, None, 100),
    (2, 8, 2, 600, 600, 64, True, 100, 300),
)
#: recurrentgemma-9b's local attention at [families]' prefill (MQA, d 256)
FLASH_D256 = FLASH_SHAPES[10]
#: seamless-m4t-medium at [families]' prefill: the encoder's self-attention
#: and the decoder's cross-attention (bidirectional; here at Sq 777), and
#: the decoder's causal self-attention
SEAMLESS_ENC, SEAMLESS_CROSS = FLASH_SHAPES[12], FLASH_SHAPES[13]
SEAMLESS_SELF = (4, 16, 16, 1024, 1024, 64, True, None)
#: paligemma-3b at [families]' prefill: 256 patches and 1024 text tokens
PALIGEMMA = FLASH_SHAPES[14]
#: back-to-back launches at the serving shape that must agree bit for bit
REPEATS = 50
MAIN_FLASH = FLASH_SHAPES[5]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2.5e-2}


def mask_of(shape) -> dict:
    """The mask arguments of a ``FLASH_SHAPES`` entry."""
    return {"causal": shape[6], "window": shape[7],
            "prefix_len": shape[8] if len(shape) > 8 else None}


def form_of(shape) -> str:
    """K4's form at a shape: causal, bidirectional or prefix."""
    m = mask_of(shape)
    return ("bidirectional" if not m["causal"] else
            "prefix" if m["prefix_len"] else "causal")


def flash_inputs(torch, shape, dtype, seed):
    B, H, K, Sq, Sk, d = shape[:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in ((B, H, Sq, d), (B, K, Sk, d), (B, K, Sk, d))]


def flash_phase(torch) -> dict[str, float]:
    from repro_torch.kernels import flash_attention as fa

    errs = {}
    for i, shape in enumerate(FLASH_SHAPES):
        mask = mask_of(shape)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v = flash_inputs(torch, shape, dtype, seed=i)
            out = fa.flash_attention(q, k, v, **mask)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, **mask)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()),
                  f"flash {shape} {name}: non-finite output")
            tol = FLASH_TOL[name]
            err = float((out.float() - want.float()).abs().max())
            check(torch.allclose(out.float(), want.float(), atol=tol,
                                 rtol=tol),
                  f"flash {shape} {name}: max |diff| {err} against the "
                  f"plain version (tolerance {tol})")
            errs[name] = max(errs.get(name, 0.0), err)
            if shape == MAIN_FLASH:
                errs[f"{name}_main"] = err
            if shape[5] == 256 and form_of(shape) == "causal":
                errs[f"{name}_d256"] = max(errs.get(f"{name}_d256", 0.0),
                                           err)
            if form_of(shape) != "causal":
                key = f"{name}_{form_of(shape)}"
                errs[key] = max(errs.get(key, 0.0), err)
    print(f"[flash] {len(FLASH_SHAPES)} shapes x 2 dtypes within tolerance "
          f"of the plain version (forms: causal, windowed, bidirectional, "
          f"cross, prefix-LM): {json.dumps(errs)}", flush=True)
    q, k, v = flash_inputs(torch, MAIN_FLASH, torch.bfloat16, seed=5)
    first = fa.flash_attention(q, k, v, causal=True)
    outs = [fa.flash_attention(q, k, v, causal=True) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    same = sum(torch.equal(o, first) for o in outs)
    check(same == REPEATS, f"flash: {REPEATS - same} of {REPEATS} repeated "
          f"launches at {MAIN_FLASH[:6]} differ from the first")
    print(f"[flash] {REPEATS} back-to-back launches at {MAIN_FLASH[:6]} bf16 "
          "bit-identical", flush=True)
    return errs


#: |kernel - plain| <= BWD_TOL x the gradient's largest |plain| element, for
#: each of dq, dk, dv (the bf16 kernels round P and dS to bf16 as the plain
#: version does; the sums run in another order)
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
#: |kernel - plain| of the forward's log-sum-exp (natural units)
LSE_TOL = 1e-3
#: the backward kernels' names, as the profiler lists them: bf16 (the dQ
#: pass at every d, the dK/dV pass at d <= 128 and at d = 256) and f32
BWD_KERNELS = {"wgmma": ("bwd_wgmma_dq_kernel", "bwd_wgmma_dkv_kernel",
                         "bwd_wgmma_dkv_wide_kernel"),
               "core": ("bwd_core_dq_kernel", "bwd_core_dkv_kernel")}
#: any backward kernel's name, as the profiler lists it (each pass's
#: kernel keyed by its name)
BWD_PATTERN = r"(bwd_\w+?_kernel)"
#: K4's backward timed at llama3.2-1b's training shape, the head_dim-128
#: shape, and at head dim 256 recurrentgemma-9b's local attention and
#: paligemma-3b's prefix-LM attention (its [train] shape)
BWD_TIMED = (MAIN_FLASH, FLASH_SHAPES[6], FLASH_D256, PALIGEMMA)
#: back-to-back backward calls at each of these shapes that must agree bit
#: for bit
BWD_REPEATS = 10
BWD_REPEATED = (MAIN_FLASH, FLASH_D256, PALIGEMMA)


def flash_bwd_inputs(torch, shape, dtype, seed):
    """q, k, v of ``flash_inputs``, the forward kernel's output and
    log-sum-exp, and a seeded cotangent."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_inputs(torch, shape, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    o, lse = fa._launch(q, k, v, *mask_of(shape).values(), True)
    return q, k, v, o, lse, do


def flash_bwd_phase(torch) -> dict:
    """K4's backward against ``flash_attention_bwd_plain`` on the card at
    every ``FLASH_SHAPES`` row in f32 and bf16, on the forward kernel's
    own output and log-sum-exp (which is held to the plain forward's too);
    autograd through ``flash_attention`` against the wrapper; and
    ``BWD_REPEATS`` back-to-back calls at each of ``BWD_REPEATED``
    bit-identical."""
    from repro_torch.kernels import flash_attention as fa

    errs: dict[str, float] = {}
    for i, shape in enumerate(FLASH_SHAPES):
        mask = mask_of(shape)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v, o, lse, do = flash_bwd_inputs(torch, shape, dtype, i)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
            want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **mask)
            _, plain_lse = fa.flash_attention_plain(q, k, v, **mask,
                                                    return_lse=True)
            torch.cuda.synchronize()
            lse_err = float((lse - plain_lse).abs().max())
            check(lse_err <= LSE_TOL, f"flash {shape} {name}: the forward's "
                  f"log-sum-exp {lse_err} off the plain version's")
            errs[f"lse_{name}"] = max(errs.get(f"lse_{name}", 0.0), lse_err)
            for g, w, which in zip(got, want, ("dq", "dk", "dv")):
                check(bool(torch.isfinite(g).all()),
                      f"flash_bwd {shape} {name}: non-finite {which}")
                top = float(w.float().abs().max())
                err = float((g.float() - w.float()).abs().max())
                rel = err / max(top, 1e-30)
                errs[f"abs_{name}"] = max(errs.get(f"abs_{name}", 0.0), err)
                check(rel <= BWD_TOL[name],
                      f"flash_bwd {shape} {name}: {which} max |diff| {err} "
                      f"= {rel} of its largest element {top} (tolerance "
                      f"{BWD_TOL[name]})")
                errs[name] = max(errs.get(name, 0.0), rel)
                if shape == MAIN_FLASH:
                    errs[f"{name}_main"] = max(errs.get(f"{name}_main", 0.0),
                                               rel)
                if shape[5] == 256:
                    for key, x in ((f"{name}_d256", rel),
                                   (f"abs_{name}_d256", err)):
                        errs[key] = max(errs.get(key, 0.0), x)
    # autograd through the wrapper: the same gradients, one forward (with
    # its log-sum-exp) and one backward launch
    q, k, v, o, lse, do = flash_bwd_inputs(torch, MAIN_FLASH, torch.bfloat16,
                                           7)
    want = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    before = (fa.flash_attention.lse_launches, fa.flash_attention_bwd.launches)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    check(all(torch.equal(a, b) for a, b in zip(got, want))
          and torch.equal(out, o),
          "flash: autograd through flash_attention differs from the "
          "forward kernel and flash_attention_bwd")
    check((fa.flash_attention.lse_launches - before[0],
           fa.flash_attention_bwd.launches - before[1]) == (1, 1),
          "flash: autograd did not launch the forward with its "
          "log-sum-exp and the backward once each")
    for shape in BWD_REPEATED:
        mask = mask_of(shape)
        q, k, v, o, lse, do = flash_bwd_inputs(torch, shape, torch.bfloat16,
                                               7)
        want = fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
        outs = [fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
                for _ in range(BWD_REPEATS)]
        torch.cuda.synchronize()
        same = sum(all(torch.equal(a, b) for a, b in zip(g, want))
                   for g in outs)
        check(same == BWD_REPEATS, f"flash_bwd {shape}: {BWD_REPEATS - same}"
              f" of {BWD_REPEATS} repeated calls differ from the first")
    print(f"[flash-bwd] {len(FLASH_SHAPES)} shapes x 2 dtypes within "
          f"tolerance of flash_attention_bwd_plain (|diff| / "
          f"max |plain| of each of dq, dk, dv; tolerance "
          f"{json.dumps(BWD_TOL)}; the forward's log-sum-exp within "
          f"{LSE_TOL}): {json.dumps(errs)}; autograd through "
          f"flash_attention equal; {BWD_REPEATS} back-to-back calls at each "
          f"of {[s[:6] for s in BWD_REPEATED]} bf16 bit-identical",
          flush=True)
    return errs


def flash_bwd_timing(torch, shape=MAIN_FLASH, forward: bool = True) -> dict:
    """K4's backward at one shape (bf16, its mask): each kernel's device
    time a launch (the two passes, by name), their sum, the wrapper
    call's time, the plain version's, the bound, and the library's:
    ``torch.autograd.grad`` of ``scaled_dot_product_attention``
    (``enable_gqa``, and with K/V expanded) under the shape's own mask
    (``is_causal``; for the prefix-LM the boolean ``make_mask``).  With
    ``forward``, then the forward at the same shape with and without its
    log-sum-exp output."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import make_mask

    B, H, K, Sq, Sk, d = shape[:6]
    mask = mask_of(shape)
    q, k, v, o, lse, do = flash_bwd_inputs(torch, shape, torch.bfloat16, 99)

    def fn(): return fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
    def plain_fn(): return fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                         **mask)
    # every shape timed is causal with no window narrower than S; the
    # prefix-LM takes its boolean mask
    lib_kw = {"is_causal": True}
    if mask["prefix_len"]:
        lib_kw = {"attn_mask": make_mask(
            Sq, Sk, causal=True, window=mask["window"],
            prefix_len=mask["prefix_len"], device="cuda")[0, 0]}
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, enable_gqa=True,
                                             **lib_kw)
    def library(): return torch.autograd.grad(lib_out, leaves, do,
                                              retain_graph=True)
    ke, ve = (t.repeat_interleave(H // K, dim=1) for t in (k, v))
    exp_leaves = [x.detach().requires_grad_() for x in (q, ke, ve)]
    exp_out = F.scaled_dot_product_attention(*exp_leaves, **lib_kw)
    def library_expanded(): return torch.autograd.grad(
        exp_out, exp_leaves, do, retain_graph=True)

    # five products (S, dP, dV, dK, dQ) against the forward's two
    flops = 2.5 * 4 * d * B * H * allowed_pairs(torch, shape)
    # q, k, v, o, dO and the log-sum-exp read once; dq, dk, dv written once
    n_bytes = 2 * (3 * B * H * Sq * d + 2 * B * K * Sk * d) \
        + 4 * B * H * Sq + 2 * (B * H * Sq * d + 2 * B * K * Sk * d)
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S)
    # the library's first backward calls in a process run about twice as
    # slow as later ones (its plans being chosen), longer than event_ms'
    # warm-up
    for _ in range(30):
        library()
        library_expanded()
    ms = event_ms(torch, fn, inner=20)
    kernels = profiled_kernels_ms(torch, fn, BWD_PATTERN)
    kernel_ms = sum(kernels.values()) or None
    res = {"shape": list(shape[:6]), "dtype": "bfloat16",
           "mask": form_of(shape), "prefix_len": mask["prefix_len"],
           "form": "wgmma" if d <= 128 else
                   "wgmma; dK/dV wide: the head dim split between the "
                   "consumers, a cluster of CTAs a KV tile",
           "ms": ms, "kernel_ms": kernel_ms, "kernels_ms": kernels,
           "plain_ms": event_ms(torch, plain_fn, reps=3, inner=2),
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
           "bytes": n_bytes, **rates(flops, b_ms, ms, kernel_ms),
           "library_ms": event_ms(torch, library, reps=10, inner=10),
           "library": "torch.autograd.grad(scaled_dot_product_attention("
                      + ("attn_mask=make_mask(prefix_len=P)"
                         if mask["prefix_len"] else "is_causal=True")
                      + ", enable_gqa=True))",
           "library_kv_expanded_ms": event_ms(torch, library_expanded,
                                              reps=10, inner=10),
           "card": nvidia_smi()}
    if forward:
        res["forward"] = {}
        for with_lse in (False, True):
            def fwd_fn(w=with_lse): return fa._launch(q, k, v,
                                                      *mask.values(), w)
            res["forward"][f"lse_{str(with_lse).lower()}"] = {
                "ms": event_ms(torch, fwd_fn, inner=20),
                "kernel_ms": profiled_kernel_ms(torch, fwd_fn,
                                                "flash_bf16_kernel")}
    print(f"[flash-bwd-timing] {json.dumps(res)}", flush=True)
    return res


# ---------------------------------------------------------------------------------
# Phase 5: the serving path
# ---------------------------------------------------------------------------------

SERVE_BATCH, SERVE_SEQ, SERVE_REQUESTS, SERVE_NEW = 4, 1024, 8, 32


def checked_api(api, finite: list):
    """The same model API, recording whether each step's logits are all
    finite (one device-side flag per step, read after the run)."""
    import dataclasses

    import torch

    def prefill(p, b, cap):
        logits, caches = api.prefill(p, b, cap)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    def decode_step(p, c, t, pos):
        logits, caches = api.decode_step(p, c, t, pos)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    return dataclasses.replace(api, prefill=prefill, decode_step=decode_step)


def serve_phase(torch, np) -> tuple[dict, object, object]:
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, count_params
    from repro_torch.serving import Request, ServeEngine

    cfg = get_config("llama3.2-1b")
    api = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = api.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    finite: list = []
    engine = ServeEngine(checked_api(api, finite), params,
                         batch_size=SERVE_BATCH, seq_len=SERVE_SEQ)
    rng = np.random.default_rng(0)
    lengths = rng.integers(SERVE_SEQ // 2, SERVE_SEQ + 1, SERVE_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab, int(n), dtype=np.int32)
               for n in lengths]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                        # counts at 0 just before the path
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()                # and read just after it
    peak = torch.cuda.max_memory_allocated()
    launches = counts["flash_attention"]
    want = cfg.n_layers * -(-SERVE_REQUESTS // SERVE_BATCH)
    check(launches > 0 and launches == want,
          f"serve: {launches} flash_attention launches, expected {want} "
          f"({cfg.n_layers} layers x prefill batches)")
    check(all(len(r.output) == SERVE_NEW for r in reqs),
          f"serve: token counts {[len(r.output) for r in reqs]}")
    check(all(bool(f) for f in finite), "serve: non-finite logits")
    again = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=SERVE_NEW)
             for r in reqs[:SERVE_BATCH]]
    engine.run(again)
    check([r.output for r in again] == [r.output for r in reqs[:SERVE_BATCH]],
          "serve: the same prompts served again gave other tokens")
    dec = engine.stats["decode_s"][:2 * SERVE_NEW]
    out = {
        "model": cfg.name, "params": count_params(params),
        "layers": cfg.n_layers, "batch": SERVE_BATCH, "seq_len": SERVE_SEQ,
        "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
        "prompt_lengths": [int(n) for n in lengths], "init_s": init_s,
        "wall_s": wall, "prefill_s": engine.stats["prefill_s"][:2],
        "decode_p50_ms": 1e3 * float(np.percentile(dec, 50)),
        "decode_p90_ms": 1e3 * float(np.percentile(dec, 90)),
        "tok_per_s": SERVE_REQUESTS * SERVE_NEW / wall,
        "max_memory_allocated": peak, "counts": counts,
        "repeat_identical": True,
    }
    print(f"[serve] {json.dumps(out)}", flush=True)
    return out, api, params


def _traced(torch, fn) -> dict:
    """Run fn once under torch.profiler: its wall time, its device time by
    kernel, and the flash-attention kernel's share of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + ev.device_time_total
    total = sum(by_kernel.values())
    flash = sum(t for name, t in by_kernel.items()
                if "flash_bf16_kernel" in name)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_us": wall * 1e6, "device_us": total,
            "device_busy_share": total / (wall * 1e6), "flash_us": flash,
            "flash_share": flash / total if total else None,
            "top_us": [[name[:60], t] for name, t in top],
            "top_all": by_kernel}


def serve_trace(torch, api, params) -> dict:
    """Where one prefill (batch 4 x 1024) and one decode step spend their
    device time, by kernel: the K4 share of a prefill."""
    toks = torch.randint(1, api.cfg.vocab, (SERVE_BATCH, SERVE_SEQ),
                         device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    state = {}

    def prefill():
        state["logits"], state["caches"] = api.prefill(
            params, {"tokens": toks}, SERVE_SEQ)

    def decode():
        api.decode_step(params, state["caches"], state["logits"].argmax(-1),
                        SERVE_SEQ)

    with torch.inference_mode():
        prefill()                                    # warm
        out = {"prefill": _traced(torch, prefill)}
        decode()                                     # warm
        out["decode"] = _traced(torch, decode)
    for trace in out.values():
        del trace["top_all"]
    print(f"[serve-trace] {json.dumps(out)}", flush=True)
    return out


def decode_vs_prefill(torch, np, api, params, S: int = 1000,
                      modality: dict | None = None
                      ) -> list[tuple[float, bool]]:
    """2 sequences of S tokens (after ``modality``'s frames or patch
    embeddings, the same for every prefill), then 4 decode steps: per step
    the largest |difference| from a fresh prefill (through K4) of the
    extended sequence, and whether it is within 0.08 (atol and rtol)."""
    from repro_torch.configs import cache_capacity

    B, T = 2, 4
    cfg = api.cfg
    pos0 = cfg.frontend_len if cfg.frontend == "patch" else 0
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S + T),
                                         dtype=np.int32)).to(api.device)
    cap = cache_capacity(cfg, pos0 + S + T)
    modality = modality or {}
    out = []
    with torch.inference_mode():
        logits, caches = api.prefill(
            params, {"tokens": toks[:, :S], **modality}, cap)
        for t in range(S, S + T):
            ref, _ = api.prefill(
                params, {"tokens": toks[:, :t + 1], **modality}, cap)
            logits, caches = api.decode_step(params, caches, toks[:, t],
                                             pos0 + t)
            check(bool(torch.isfinite(logits).all()),
                  f"decode step {t}: non-finite logits")
            out.append((float((logits - ref).abs().max()),
                        torch.allclose(logits, ref, atol=0.08, rtol=0.08)))
    torch_sync(api.device)
    return out


def sensitivity(torch, api, params, tokens: int = 256) -> list[float]:
    """How the random-weight model amplifies a rounding-sized difference:
    f32 copies of the weights, the input embeddings of 1 x ``tokens``
    perturbed by 1e-6 (relative), and after each layer the relative change
    of the last token's hidden state."""
    import dataclasses

    from repro_torch.models import lm

    cfg = dataclasses.replace(api.cfg, compute_dtype=torch.float32)
    w = as_f32(params)
    gen = torch.Generator("cuda").manual_seed(3)
    toks = torch.randint(1, cfg.vocab, (1, tokens), device="cuda",
                         generator=gen)
    pos = torch.arange(tokens, dtype=torch.int32, device="cuda")[None]
    growth = []
    with torch.inference_mode():
        a = lm.embed_tokens(w, cfg, toks)
        b = a * (1 + 1e-6 * torch.randn(a.shape, device="cuda",
                                        generator=gen))
        for bp in w["blocks"]:
            a = lm._apply_attn_block(bp, cfg, a, pos, None)[0]
            b = lm._apply_attn_block(bp, cfg, b, pos, None)[0]
            growth.append(float((a[:, -1] - b[:, -1]).norm()
                                / a[:, -1].norm()))
    return growth


def serve_check(torch, np, api, params) -> dict:
    """Decode against prefill at full width.  Gated on the first 2 layers:
    the random-weight model amplifies a rounding-sized difference about
    tenfold a layer (``sensitivity``), and decode and prefill round
    differently in their matrix products (2 rows against 2000), so at full
    depth the two part whatever the attention computes; the full depth is
    recorded, not gated."""
    import dataclasses

    from repro_torch.models import build_model

    cut = dataclasses.replace(api.cfg, n_layers=2)
    cut_params = dict(params, blocks=params["blocks"][:2])
    gated = decode_vs_prefill(torch, np, build_model(cut, device="cuda"),
                              cut_params)
    for i, (err, ok) in enumerate(gated):
        check(ok, f"serve-check step {1000 + i}: decode logits max |diff| "
              f"{err} from the prefill's (tolerance 0.08), 2 layers")
    full = decode_vs_prefill(torch, np, api, params)
    out = {"layers_gated": 2, "max_diff_gated": [e for e, _ in gated],
           "layers_full": api.cfg.n_layers,
           "max_diff_full": [e for e, _ in full],
           "within_full": [ok for _, ok in full],
           "sensitivity_f32_per_layer": sensitivity(torch, api, params)}
    print(f"[serve-check] {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------------
# Phase 5b: the MoE and recurrent families, and the two examples
# ---------------------------------------------------------------------------------

FAMILY_ARCHS = ("mixtral-8x7b", "olmoe-1b-7b", "rwkv6-7b", "recurrentgemma-9b",
                "seamless-m4t-medium", "paligemma-3b")
#: ``[families]``' depth cuts: mixtral-8x7b's 32 layers hold 93 GB of bf16
#: weights, more than the card's 80 GB; 16 layers hold 47 GB
FAMILY_LAYERS = {"mixtral-8x7b": 16}
#: ``[families-check]``: the gated depth (recurrentgemma: one super-block,
#: so that the local attention is in it) and the prompt length
#: (recurrentgemma's 2100 tokens wrap its 2048-slot ring cache)
CHECK_LAYERS = {"rwkv6-7b": 2, "recurrentgemma-9b": 3}
CHECK_PROMPT = {"rwkv6-7b": 1000, "recurrentgemma-9b": 2100}
#: the MoE check's grid: hidden states in quarters, router weights in
#: 2^-10 (every product and partial sum of the router's f32 product is then
#: exact on either device, so routing can be compared bit for bit)
MOE_GRID = (4.0, 1024.0)
#: the encoder-decoder and VLM check: the depths (layers a stack) of the
#: card-against-CPU check, the first gated at 1e-4 and the others recorded
#: (``modality_check``), and the text's length (seamless's frames are as
#: many; paligemma's 256 patches come in front)
MODALITY_LAYERS = {"seamless-m4t-medium": (1, 2), "paligemma-3b": (2,)}
MODALITY_TEXT = 256


def expected_family_launches(cfg, batches: int, steps: int) -> dict:
    """The K4, ``wkv6_scan`` and ``rglru_scan`` launches of one
    ``ServeEngine.run`` on ``cfg``: K4 once an attention a prefill batch
    (decode attention is plain) — an encoder-decoder's encoder
    self-attentions and decoder cross-attentions bidirectional, its decoder
    self-attentions causal, every layer of a prefix-LM model with the
    prefix — and each scan once a layer of its kind a prefill batch and a
    decode step."""
    from repro_torch.models import lm

    if cfg.is_encdec:
        bidirectional = cfg.enc_layers + cfg.dec_layers
        return {"flash_attention": (bidirectional + cfg.dec_layers) * batches,
                "flash_attention_bidirectional": bidirectional * batches,
                "flash_attention_prefix": 0, "wkv6_scan": 0, "rglru_scan": 0}
    kind = lm.block_kind(cfg)
    blocks, tail = lm._n_scanned(cfg)
    attn = 0 if kind == "rwkv" else blocks
    rwkv = blocks if kind == "rwkv" else 0
    rglru = 2 * blocks + tail if kind == "griffin" else 0
    return {"flash_attention": attn * batches,
            "flash_attention_bidirectional": 0,
            "flash_attention_prefix": attn * batches if cfg.prefix_lm else 0,
            "wkv6_scan": rwkv * (batches + steps),
            "rglru_scan": rglru * (batches + steps)}


@contextlib.contextmanager
def moe_drops(record: list):
    """Record (tokens, dropped_fraction) of every MoE layer call inside."""
    from repro_torch.models import ffn

    inner = ffn.moe_apply

    def spy(p, cfg, x):
        out, aux = inner(p, cfg, x)
        record.append((x.shape[0] * x.shape[1], aux["dropped_fraction"]))
        return out, aux

    ffn.moe_apply = spy
    try:
        yield
    finally:
        ffn.moe_apply = inner


def as_f32(tree):
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f32(v) for v in tree]
    return tree.float()


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def family_serve(torch, np, arch: str) -> tuple[dict, object, object]:
    """``[families]``: ``arch`` at full width (depth cut by
    ``FAMILY_LAYERS``), seeded random weights made on the card, through
    ``ServeEngine`` with ``[serve]``'s protocol.  Counts at 0 just before
    ``run()``, read just after: K4 and the scans launched as
    ``expected_family_launches`` says."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, count_params
    from repro_torch.serving import Request, ServeEngine

    cfg = get_config(arch)
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
    api = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = api.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    finite: list = []
    engine = ServeEngine(checked_api(api, finite), params,
                         batch_size=SERVE_BATCH, seq_len=SERVE_SEQ)
    rng = np.random.default_rng(0)
    lengths = rng.integers(SERVE_SEQ // 2, SERVE_SEQ + 1, SERVE_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, int(n),
                                               dtype=np.int32),
                    max_new_tokens=SERVE_NEW)
            for i, n in enumerate(lengths)]
    drops: list = []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                        # counts at 0 just before the path
    t0 = time.perf_counter()
    with moe_drops(drops):
        engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()                # and read just after it
    peak = torch.cuda.max_memory_allocated()
    batches = -(-SERVE_REQUESTS // SERVE_BATCH)
    want = expected_family_launches(cfg, batches, batches * SERVE_NEW)
    for name, n in want.items():
        check(counts[name] == n, f"[families] {arch}: {counts[name]} {name} "
              f"launches, expected {n}")
    decode = {name: counts[f"{name}_decode"] for name in ("wkv6_scan",
                                                          "rglru_scan")}
    want_decode = expected_family_launches(cfg, 0, batches * SERVE_NEW)
    for name, n in decode.items():
        check(n == want_decode[name], f"[families] {arch}: {n} {name} "
              f"launches at S = 1, expected {want_decode[name]}")
    check(all(len(r.output) == SERVE_NEW for r in reqs),
          f"[families] {arch}: token counts {[len(r.output) for r in reqs]}")
    check(all(bool(f) for f in finite), f"[families] {arch}: non-finite "
          "logits")
    again = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=SERVE_NEW)
             for r in reqs[:SERVE_BATCH]]
    engine.run(again)
    check([r.output for r in again] == [r.output for r in reqs[:SERVE_BATCH]],
          f"[families] {arch}: the same prompts served again gave other "
          "tokens")
    dec = engine.stats["decode_s"][:batches * SERVE_NEW]
    out = {
        "model": cfg.name, "params": count_params(params),
        "layers": cfg.n_layers, "layers_full": get_config(arch).n_layers,
        "enc_layers": cfg.enc_layers,
        "batch": SERVE_BATCH, "seq_len": SERVE_SEQ,
        "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
        "init_s": init_s, "wall_s": wall,
        "prefill_s": engine.stats["prefill_s"][:batches],
        "decode_p50_ms": 1e3 * float(np.percentile(dec, 50)),
        "decode_p90_ms": 1e3 * float(np.percentile(dec, 90)),
        "tok_per_s": SERVE_REQUESTS * SERVE_NEW / wall,
        "max_memory_allocated": peak,
        "launches": {k: counts[k] for k in want},
        "decode_launches": decode, "repeat_identical": True,
    }
    if drops:
        L = cfg.n_layers
        pre = [float(f) for n, f in drops if n == SERVE_BATCH * SERVE_SEQ]
        out["dropped_fraction_prefill"] = [pre[i * L:(i + 1) * L]
                                           for i in range(batches)]
        out["dropped_fraction_decode_mean"] = float(np.mean(
            [float(f) for n, f in drops if n == SERVE_BATCH]))
    print(f"[families] {json.dumps(out)}", flush=True)
    return out, api, params


def recurrent_check(torch, np, arch: str, api, params) -> dict:
    """``[families-check]`` of a recurrent family: decode against a fresh
    prefill at full width, gated at 0.08 on the first ``CHECK_LAYERS``
    layers, the full depth recorded (the random-weight model is chaotic
    at depth, as ``serve_check`` says)."""
    import dataclasses

    from repro_torch.models import build_model, lm

    cut = dataclasses.replace(api.cfg, n_layers=CHECK_LAYERS[arch])
    blocks, tail = lm._n_scanned(cut)
    cut_params = {k: v for k, v in params.items() if k != "tail"}
    cut_params["blocks"] = params["blocks"][:blocks]
    if tail:
        cut_params["tail"] = params["tail"][:tail]
    S = CHECK_PROMPT[arch]
    gated = decode_vs_prefill(torch, np, build_model(cut, device=api.device),
                              cut_params, S)
    for i, (err, ok) in enumerate(gated):
        check(ok, f"[families-check] {arch} step {S + i}: decode logits max "
              f"|diff| {err} from the prefill's (tolerance 0.08), "
              f"{cut.n_layers} layers")
    full = decode_vs_prefill(torch, np, api, params, S)
    out = {"model": arch, "prompt": S, "layers_gated": cut.n_layers,
           "max_diff_gated": [e for e, _ in gated],
           "layers_full": api.cfg.n_layers,
           "max_diff_full": [e for e, _ in full],
           "within_full": [ok for _, ok in full]}
    print(f"[families-check] {json.dumps(out)}", flush=True)
    return out


def moe_check(torch, np, arch: str, api, params) -> dict:
    """``[families-check]`` of an MoE family: layer 0's MoE at full width,
    f32, on the card against the same layer on the CPU, on the hidden
    states of a 2 x 1000-token prefill (embedding, layer 0's attention
    through K4, its second norm).  On those states put on ``MOE_GRID`` the
    expert indices, the slot order, the keep mask and the capacity slots
    must be identical and the outputs within 1e-4 relative (the stable
    sort, the top-k ties and the scatter on CUDA); on the raw states the
    routing differences are counted, not gated (a 1-ulp difference of the
    two devices' router products may reorder a near tie).  Decode against
    prefill at the served depth is recorded with the prefill's dropped
    fraction beside it, not gated: a prefill's capacity drops legitimately
    differ from a decode step's."""
    import dataclasses

    from repro_torch.models import attention as attn
    from repro_torch.models import ffn
    from repro_torch.models.common import rmsnorm

    cfg = dataclasses.replace(api.cfg, compute_dtype=torch.float32)
    dev = api.device
    bp = as_f32(params["blocks"][0])
    gen = torch.Generator(dev).manual_seed(5)
    toks = torch.randint(1, cfg.vocab, (2, 1000), device=dev, generator=gen)
    xs, rs = MOE_GRID
    keys = ("expert_idx", "order", "keep", "e_safe", "pos_safe")
    out = {"model": arch}
    with torch.inference_mode():
        x = params["embed"][toks].float()
        pos = torch.arange(1000, dtype=torch.int32, device=dev)[None]
        h, _ = attn.attn_forward(bp["attn"], cfg,
                                 rmsnorm(bp["ln1"], x, cfg.rms_eps),
                                 positions=pos, causal=True,
                                 window=cfg.swa_window)
        xn = rmsnorm(bp["ln2"], x + h, cfg.rms_eps)
        grid_p = dict(bp["moe"], router=torch.round(bp["moe"]["router"] * rs)
                      / rs)
        cpu_p = {k: v.cpu() for k, v in grid_p.items()}
        xq = torch.clamp(torch.round(xn * xs) / xs, -16, 16)
        got, got_aux = ffn._moe_tokens(grid_p, cfg, xq)
        want, want_aux = ffn._moe_tokens(cpu_p, cfg, xq.cpu())
        r_gpu = ffn.moe_route(grid_p, cfg, xq.reshape(-1, cfg.d_model))
        r_cpu = ffn.moe_route(cpu_p, cfg, xq.cpu().reshape(-1, cfg.d_model))
        same = {k: torch.equal(r_gpu[k].cpu(), r_cpu[k]) for k in keys}
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        check(all(same.values()), f"[families-check] {arch}: routing on the "
              f"card differs from the CPU's: {same}")
        check(err <= 1e-4, f"[families-check] {arch}: MoE output relative "
              f"error {err} against the CPU (tolerance 1e-4)")
        raw_gpu = ffn.moe_route(bp["moe"], cfg, xn.reshape(-1, cfg.d_model))
        raw_cpu = ffn.moe_route({k: v.cpu() for k, v in bp["moe"].items()},
                                cfg, xn.cpu().reshape(-1, cfg.d_model))
        out.update({
            "tokens": 2000, "capacity": r_gpu["capacity"],
            "routing_identical": same, "max_rel_err": err,
            "dropped_fraction": [float(got_aux["dropped_fraction"]),
                                 float(want_aux["dropped_fraction"])],
            "raw_tokens_routed_differently": int(
                (raw_gpu["expert_idx"].cpu() != raw_cpu["expert_idx"])
                .any(dim=1).sum()),
            "raw_slots_placed_differently": int(
                (raw_gpu["pos_safe"].cpu() != raw_cpu["pos_safe"]).sum()),
        })
    del bp, grid_p, cpu_p
    drops: list = []
    with moe_drops(drops):
        dvp = decode_vs_prefill(torch, np, api, params)
    out.update({
        "decode_vs_prefill_layers": api.cfg.n_layers,
        "decode_vs_prefill_max_diff": [e for e, _ in dvp],
        "decode_vs_prefill_within": [ok for _, ok in dvp],
        "prefill_dropped_fraction_max": max(
            float(f) for n, f in drops if n > 2),
        "decode_dropped_fraction_max": max(
            float(f) for n, f in drops if n == 2)})
    print(f"[families-check] {json.dumps(out)}", flush=True)
    return out


def cut_model(cfg, params, layers: int):
    """``cfg`` and ``params`` cut to ``layers`` layers a stack."""
    import dataclasses

    if cfg.is_encdec:
        return (dataclasses.replace(cfg, n_layers=layers, enc_layers=layers,
                                    dec_layers=layers),
                dict(params, encoder=params["encoder"][:layers],
                     decoder=params["decoder"][:layers]))
    return (dataclasses.replace(cfg, n_layers=layers),
            dict(params, blocks=params["blocks"][:layers]))


def modality_inputs(torch, cfg, B: int, S: int, seed: int) -> dict:
    """Seeded random frames [B, S, d] (encoder-decoder) or patch
    embeddings [B, frontend_len, d] (VLM), f32 on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.is_encdec:
        return {"frames": torch.randn((B, S, cfg.d_model), generator=gen)}
    return {"prefix_embeds": torch.randn((B, cfg.frontend_len, cfg.d_model),
                                         generator=gen)}


def card_vs_cpu(torch, cfg, params, S: int) -> dict:
    """``cfg`` (f32) with ``params`` cut to its depth, on the card and on
    the CPU: prefill on seeded random frames or patch embeddings and
    2 x S tokens, then 4 decode steps.  Per step the card's largest logit
    difference from the CPU's, relative to the largest CPU logit, and the
    same for the CPU run on inputs moved by 1e-7 relative (how far the
    random-weight model's own f32 rounding noise carries)."""
    from repro_torch.configs import cache_capacity
    from repro_torch.models import build_model

    B, T = 2, 4
    pos0 = cfg.frontend_len if cfg.frontend == "patch" else 0
    cap = cache_capacity(cfg, pos0 + S + T)
    mod = modality_inputs(torch, cfg, B, S, seed=11)
    moved = {k: v * (1 + 1e-7 * torch.randn(
        v.shape, generator=torch.Generator().manual_seed(13)))
        for k, v in mod.items()}
    toks = torch.randint(1, cfg.vocab, (B, S + T),
                         generator=torch.Generator().manual_seed(12))
    weights = {"cuda": as_f32(params)}
    weights["cpu"] = to_cpu(weights["cuda"])
    runs = {}
    for run, dev, inputs in (("card", "cuda", mod), ("cpu", "cpu", mod),
                             ("cpu_moved", "cpu", moved)):
        model = build_model(cfg, device=dev)
        logits = []
        with torch.inference_mode():
            batch = {k: v.to(dev) for k, v in inputs.items()}
            out, caches = model.prefill(
                weights[dev], {"tokens": toks[:, :S].to(dev), **batch}, cap)
            logits.append(out.cpu())
            for t in range(S, S + T):
                out, caches = model.decode_step(
                    weights[dev], caches, toks[:, t].to(dev), pos0 + t)
                logits.append(out.cpu())
        runs[run] = logits
        del caches
    del weights

    def rel(name):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(runs[name], runs["cpu"])]

    return {"card_vs_cpu": rel("card"), "cpu_moved_1e-7": rel("cpu_moved")}


def modality_check(torch, np, arch: str, api, params) -> dict:
    """``[families-check]`` of the encoder-decoder and VLM families: the
    model cut to each depth of ``MODALITY_LAYERS`` (layers a stack), in
    f32, on the card (K4's f32 kernel in every form the model runs)
    against the same model on the CPU (the plain versions), ``card_vs_cpu``
    on 2 x ``MODALITY_TEXT`` tokens: each step's logits within 1e-4
    relative at the first depth; the others are recorded beside the CPU's
    own sensitivity (seamless at 2 layers a stack moves its logits by ~1e-3
    when its frames move by 1e-7, so no implementation could hold 1e-4
    there).  Then decode against a fresh prefill on the card, gated at 0.08
    on the gated depth in f32, and recorded for the served model at full
    depth (bf16; chaotic at depth, as ``serve_check`` says)."""
    import dataclasses

    from repro_torch.models import build_model

    S = MODALITY_TEXT
    depths = {}
    for i, layers in enumerate(MODALITY_LAYERS[arch]):
        cut, cut_params = cut_model(api.cfg, params, layers)
        cfg = dataclasses.replace(cut, compute_dtype=torch.float32)
        depths[layers] = card_vs_cpu(torch, cfg, cut_params, S)
        if i == 0:
            errs = depths[layers]["card_vs_cpu"]
            check(all(e <= 1e-4 for e in errs), f"[families-check] {arch}: "
                  f"logits on the card against the CPU, relative errors "
                  f"{errs} (tolerance 1e-4), {layers} layers a stack, f32")
            gated_cfg, gated_params = cfg, as_f32(cut_params)
    card_mod = {k: v.cuda() for k, v in modality_inputs(
        torch, api.cfg, 2, S, seed=11).items()}
    gated = decode_vs_prefill(torch, np, build_model(gated_cfg, device="cuda"),
                              gated_params, S, card_mod)
    for i, (err, ok) in enumerate(gated):
        check(ok, f"[families-check] {arch} step {S + i}: decode logits max "
              f"|diff| {err} from the prefill's (tolerance 0.08), "
              f"{gated_cfg.n_layers} layers a stack, f32")
    del gated_params
    full = decode_vs_prefill(torch, np, api, params, S, card_mod)
    out = {"model": arch, "text": S,
           "modality": {k: list(v.shape) for k, v in card_mod.items()},
           "layers_gated": MODALITY_LAYERS[arch][0],
           "card_vs_cpu_f32_by_layers": depths,
           "max_diff_gated": [e for e, _ in gated],
           "layers_full": api.cfg.n_layers, "enc_layers_full":
           api.cfg.enc_layers, "max_diff_full": [e for e, _ in full],
           "within_full": [ok for _, ok in full]}
    print(f"[families-check] {json.dumps(out)}", flush=True)
    return out


def families_phase(torch, np) -> dict:
    """``[families]`` and ``[families-check]`` for each of
    ``FAMILY_ARCHS``, one model on the card at a time."""
    out = {"serve": {}, "check": {}}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        serve, api, params = family_serve(torch, np, arch)
        cfg = api.cfg
        checker = (moe_check if cfg.moe is not None else
                   modality_check if cfg.is_encdec or cfg.frontend == "patch"
                   else recurrent_check)
        out["check"][arch] = checker(torch, np, arch, api, params)
        serve["phase_wall_s"] = time.perf_counter() - t0
        out["serve"][arch] = serve
        del api, params
        torch.cuda.empty_cache()
    return out


def load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(torch) -> dict:
    """``[examples]``: both port examples in process on the card.  The
    demo's lines on the card must equal its lines with ``--device cpu``
    (the kernels' plain versions, which the CPU tests hold to the
    reference's demo); the colocated example's 12-node day under
    ``imp_batched`` must give the port's host ``imp`` day's
    ``key_metrics()`` (the engine label aside)."""
    import io

    from repro_torch.core.colocation import ColocationConfig, run_day_cycle

    demo = load_example("torch_preemption_demo")
    lines, counts = {}, {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            demo.main(["--device", device])
        counts[device] = read_counts()
        lines[device] = buf.getvalue().splitlines()
    check(lines["cuda"] == lines["cpu"], "[examples] the demo's lines on "
          "the card differ from its lines on the CPU")
    check(counts["cuda"]["normal_cycle"] > 0
          and counts["cuda"]["fused_class"] > 0,
          f"[examples] the demo's imp_batched leg launched no fused kernel: "
          f"{counts['cuda']}")
    coloc = load_example("torch_colocated_serving")
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        got = coloc.main([])
    wall = time.perf_counter() - t0
    ccounts = read_counts()
    host = run_day_cycle(ColocationConfig(num_nodes=12, seed=0,
                                          horizon_hours=24.0, engine="imp",
                                          device="cuda"))
    aware = got["ab"]["reports"]["imp_batched"]
    check(dict(aware.key_metrics(), engine=None)
          == dict(host.key_metrics(), engine=None),
          "[examples] the colocated example's imp_batched day differs from "
          "host imp's")
    check(ccounts["normal_cycle"] > 0 and ccounts["flash_attention"] > 0,
          f"[examples] the colocated example launched no kernel: {ccounts}")
    out = {"demo_lines": len(lines["cuda"]), "demo_identical_to_cpu": True,
           "demo_launches": {k: counts["cuda"][k] for k in (
               "normal_cycle", "fused_class", "fused_argmax")},
           "colocated_wall_s": wall, "colocated_uplift": got["ab"]["uplift"],
           "colocated_identical_to_imp": True,
           "colocated_raw_tok_per_s": got["raw_tok_per_s"],
           "colocated_launches": {k: ccounts[k] for k in (
               "normal_cycle", "fused_class", "fused_argmax",
               "flash_attention")},
           "colocated_lines": buf.getvalue().splitlines()[1:4]}
    print(f"[examples] {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------------
# Phase 5c: the training path
# ---------------------------------------------------------------------------------

#: ``[train]``: llama3.2-1b at full width and depth through
#: ``launch.train.run``: B x S tokens of the synthetic pipeline a step
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 1024
#: [train]'s second model: paligemma-3b (K4 at d 256 under the prefix-LM
#: mask over its 256 patch positions), 4 steps, its depth cut 18 -> 8: with
#: the launcher's zero patch embeddings the prefix positions' residual
#: stays 0 at every layer, where rmsnorm's gradient is eps^-0.5, so the
#: gradient reaching them grows with depth and overflows into NaN from 12
#: layers on (finite at 10, `tools/vlm_depth.py`; the reference's own
#: gradients do the same, `tests/test_torch_loss.py`)
TRAIN_VLM, TRAIN_VLM_STEPS, TRAIN_VLM_LAYERS = "paligemma-3b", 4, 8
#: [train]'s recurrent runs (arch, steps, layers), 4 steps each at full
#: width, depth cut to what the card's 80 GB holds with f32 master weights,
#: AdamW's moments and an f32 gradient (`tools/train_depth.py`, a process
#: a depth): rwkv6-7b at 17 of 32 layers (75.0 GB; 18 take 78.5 GB of the
#: card's 79.2 alone in a process, no room for what this run keeps),
#: recurrentgemma-9b at 8 of 38 (70.6 GB: two super-blocks and the
#: two-layer rg-lru tail; 11, the next depth with that tail, runs out of
#: memory; 9 and 10 fit but drop or cut the tail)
TRAIN_RECURRENT = (("rwkv6-7b", 4, 17), ("recurrentgemma-9b", 4, 8))
#: ``[train-check]``: each arch's width in f32 at a gated and a recorded
#: depth, B x S tokens, the gated one the deepest where the CPU's own
#: movement under a 1e-7 change of the weights stays under TRAIN_CHECK_TOL:
#: llama3.2-1b at 1 and 2 layers, rwkv6-7b at 1 and 2 (the CPU's movement
#: 2.7e-4 and 2.8e-3), recurrentgemma-9b at 2 (two rg-lru tail layers,
#: 1.9e-6) and 3 (a super-block, its local attention in: 2.1e-3)
TRAIN_CHECKS = (("llama3.2-1b", 1, 2), ("rwkv6-7b", 1, 2),
                ("recurrentgemma-9b", 2, 3))
CHECK_TRAIN_BATCH, CHECK_TRAIN_SEQ = 2, 256
#: card against CPU: |diff| <= TRAIN_CHECK_TOL x the leaf's largest element
TRAIN_CHECK_TOL = 1e-3


def train_args(extra: list) -> object:
    from repro_torch.launch import train as launch

    return launch.parser().parse_args(["--device", "cuda"] + extra)


def expected_train_launches(cfg, steps: int) -> dict:
    """The kernel launches of ``steps`` training steps of the decoder-only
    ``cfg`` under ``remat="full"``, from its block kinds: each forward
    kernel twice a layer of its kind and step (the step's forward and its
    recompute), each backward kernel once.  K4 (with the log-sum-exp, and
    with the prefix where the model has one) runs in an attention layer,
    ``wkv6_scan`` in an rwkv layer, ``rglru_scan`` in an rg-lru block (two a
    griffin super-block beside its attention, one a tail layer)."""
    from repro_torch.models import lm

    kind = lm.block_kind(cfg)
    blocks, tail = lm._n_scanned(cfg)
    attn = 0 if kind == "rwkv" else blocks
    rwkv = blocks if kind == "rwkv" else 0
    rglru = 2 * blocks + tail if kind == "griffin" else 0
    return {"flash_attention": 2 * attn * steps,
            "flash_attention_lse": 2 * attn * steps,
            "flash_attention_prefix": (2 * attn * steps
                                       if cfg.frontend == "patch" else 0),
            "flash_attention_bwd": attn * steps,
            "wkv6_scan": 2 * rwkv * steps, "wkv6_scan_bwd": rwkv * steps,
            "rglru_scan": 2 * rglru * steps,
            "rglru_scan_bwd": rglru * steps}


#: the kernels a traced training step's shares add up, by name
TRAIN_TRACE = {"flash_fwd": ("flash_bf16_kernel",),
               "flash_bwd": BWD_KERNELS["wgmma"],
               "scan_fwd": ("wkv6_kernel", "rglru_kernel"),
               "scan_bwd": ("wkv6_bwd_kernel", "rglru_bwd_kernel",
                            "sum_parts_kernel")}


def train_phase(torch, np, arch: str = "llama3.2-1b",
                steps: int = TRAIN_STEPS, layers: int | None = None) -> dict:
    """``[train]``: ``launch.train.run`` on ``arch`` at full width and
    depth (or cut to ``layers``; bf16 compute, f32 master weights,
    ``remat="full"``), TRAIN_BATCH
    x TRAIN_SEQ tokens of ``SyntheticTokenPipeline(seed=0)`` a step (after
    a patch-frontend model's zero patch embeddings), for ``steps`` steps.
    Counts at 0 just before, read just after, each equal to what the
    model's block kinds imply (`expected_train_launches`).  Every loss and
    grad norm finite, the first loss below ln(vocab) + 2.  Then one step
    traced: K4's and the scans' forward and backward shares of the device
    time.  Then step 0 twice from one state's weights: bit-identical loss
    and gradients."""
    import math

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch
    from repro_torch.train.optim import tree_leaves
    from repro_torch.train.step import value_and_grad

    args = train_args(["--arch", arch, "--full", "--steps", str(steps),
                       "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                       "--ckpt-every", "0", "--log-every", "1",
                       "--seed", "0"]
                      + (["--layers", str(layers)] if layers else []))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                        # counts at 0 just before the path
    t0 = time.perf_counter()
    out = launch.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    counts["flash_attention_lse"] = fa.flash_attention.lse_launches
    peak = torch.cuda.max_memory_allocated()
    del out["state"]
    cfg, api, step_fn = launch.build(args)
    layers = cfg.n_layers
    want = expected_train_launches(cfg, steps)
    for name, n in want.items():
        check(counts[name] == n, f"[train] {arch}: {counts[name]} {name} "
              f"launches, the path implies {n} ({layers} layers x {steps} "
              "steps, each forward twice under remat)")
    check(all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]),
          f"[train] {arch}: a loss or grad norm is not finite: {out}")
    bound = math.log(cfg.vocab) + 2
    check(out["first_loss"] < bound, f"[train] {arch}: first loss "
          f"{out['first_loss']} >= ln(vocab) + 2 = {bound}")

    # one step traced, then step 0 twice from one state's weights (the
    # optimizer's moments dropped first: two gradient trees take their room)
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.train import init_train_state

    state = init_train_state(api, 0)
    data = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab,
                                             seq_len=TRAIN_SEQ,
                                             global_batch=TRAIN_BATCH, seed=0))
    batch = launch.feed(cfg, api, data.batch_at(0)["tokens"], TRAIN_BATCH,
                        TRAIN_SEQ)
    trace = _traced(torch, lambda: step_fn(state, batch))
    shares = {}
    for key, names in TRAIN_TRACE.items():
        us = sum(t for name, t in trace["top_all"].items()
                 if any(k in name for k in names))
        shares[f"{key}_us"] = us
        shares[f"{key}_share"] = us / trace["device_us"]
    params = state["params"]
    del state, trace["top_all"]
    (l0, _), g0 = value_and_grad(api, params, batch)
    (l1, _), g1 = value_and_grad(api, params, batch)
    same = torch.equal(l0, l1) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    check(same, f"[train] {arch}: step 0 twice from one state: the "
          "gradients differ")
    del g0, g1, params, batch
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = {"arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "prefix": cfg.frontend_len if cfg.frontend == "patch" else 0,
           "steps": steps, "remat": cfg.remat, "losses": out["losses"],
           "grad_norms": out["grad_norms"], "step_s": out["step_s"],
           "step_ms_p50": out["step_s_p50"] * 1e3,
           "tokens_per_s": tokens / out["step_s_p50"], "wall_s": wall,
           "max_memory_allocated": peak,
           "launches": {k: counts[k] for k in want},
           "step0_twice_bit_identical": True,
           "trace": {**trace, **shares}}
    print(f"[train] {json.dumps(res)}", flush=True)
    torch.cuda.empty_cache()
    return res


def _train_grads(torch, cfg, seed: int, moved: bool = True) -> dict:
    """``cfg``'s seeded random master weights: the loss and gradients on
    the card, on the CPU, and (with ``moved``) on the CPU with every weight
    moved by 1e-7 relative; the card's and the moved CPU's largest |diff|
    from the CPU's (the loss relative to the loss, each leaf relative to
    its largest element, and which leaf that is)."""
    from repro_torch.models import build_model, master_params
    from repro_torch.train.optim import tree_leaves, tree_map
    from repro_torch.train.step import value_and_grad

    master = master_params(build_model(cfg, device="cuda").init(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (CHECK_TRAIN_BATCH, CHECK_TRAIN_SEQ),
                         generator=gen)
    cpu = to_cpu(master)
    shifted = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=gen)), cpu) if moved else None
    runs = {}
    for name, dev, params in (("card", "cuda", master), ("cpu", "cpu", cpu),
                              ("cpu_moved", "cpu", shifted)):
        if params is None:
            continue
        api = build_model(cfg, device=dev)
        (loss, _), grads = value_and_grad(api, params,
                                          {"tokens": toks.to(dev)})
        runs[name] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)])
        del grads
    del master, cpu, shifted

    def rel(name):
        loss, grads = runs[name]
        ref_loss, ref = runs["cpu"]
        diffs = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                 for a, b in zip(grads, ref)]
        worst = max(range(len(diffs)), key=diffs.__getitem__)
        return {"loss_rel_diff": float((loss - ref_loss).abs()
                                       / ref_loss.abs()),
                "grad_max_rel_diff": diffs[worst],
                "worst_leaf": [worst, list(ref[worst].shape)]}

    return {"layers": cfg.n_layers, **rel("card")} | (
        {"cpu_moved_1e-7": rel("cpu_moved")} if moved else {})


def train_check(torch, np) -> dict:
    """``[train-check]``: each arch of TRAIN_CHECKS at its full width in
    f32, seeded random weights, CHECK_TRAIN_BATCH x CHECK_TRAIN_SEQ tokens:
    the loss and every leaf's gradient on the card (K4's and the scans' f32
    forward and backward kernels) against the CPU's (the plain versions),
    each leaf's largest |diff| relative to its largest element, beside (at
    the first depth) the CPU's own movement when every weight moves by 1e-7
    relative.  Gated at TRAIN_CHECK_TOL at the first depth; at the second
    the random-weight model's own f32 movement reaches ~1e-3 or more (for
    llama a 1e-7 change of the embedding alone moves the embedding's
    gradient by 6e-4 on the CPU; TRAIN_CHECKS), so that depth is recorded,
    not gated.  The card's gradients must have gone
    through each backward kernel once a layer of its kind."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import recurrent as rk

    bwd = (fa.flash_attention_bwd, rk.wkv6_scan_bwd, rk.rglru_scan_bwd)
    res = {"batch": CHECK_TRAIN_BATCH, "seq": CHECK_TRAIN_SEQ,
           "tolerance": TRAIN_CHECK_TOL}
    for arch, gated_layers, recorded_layers in TRAIN_CHECKS:
        runs = []
        for layers in (gated_layers, recorded_layers):
            cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                      compute_dtype=torch.float32)
            want = expected_train_launches(cfg, 1)
            before = {w.__name__: w.launches for w in bwd}
            runs.append(_train_grads(torch, cfg, seed=3,
                                     moved=layers == gated_layers))
            for w in bwd:
                got = w.launches - before[w.__name__]
                check(got == want[w.__name__], f"[train-check] {arch} at "
                      f"{layers} layers: {got} {w.__name__} launches, the "
                      f"block kinds imply {want[w.__name__]}")
        gated = runs[0]
        res[arch] = {"d_model": cfg.d_model, "gated": gated,
                     "recorded": runs[1]}
        print(f"[train-check] {json.dumps({'arch': arch, **res[arch]})}",
              flush=True)
        check(gated["loss_rel_diff"] <= TRAIN_CHECK_TOL
              and gated["grad_max_rel_diff"] <= TRAIN_CHECK_TOL,
              f"[train-check] {arch}: the card's loss or gradients off the "
              f"CPU's: {res[arch]}")
    return res


def train_resume(torch) -> dict:
    """``[train-resume]``: the smoke llama on the card (K4 at d 16): 6
    steps straight, against 6 steps with a failure injected after step 3
    (its checkpoint at 3) and a resume into a fresh state for steps 3-5:
    every leaf of the final state bit-identical.  Then
    ``examples/torch_fault_tolerant_train.py`` on the card (a supervised
    subprocess, a failure at step 8) must resume."""
    import io
    import tempfile

    from repro_torch.launch import train as launch
    from repro_torch.train.optim import tree_leaves

    base = ["--steps", "6", "--batch", "8", "--seq", "64", "--log-every",
            "10"]
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        straight = launch.run(train_args(base + ["--ckpt-every", "0",
                                                 "--ckpt-dir", tmp + "/a"]))
        counts = read_counts()
        failed = False
        try:
            launch.run(train_args(base + ["--ckpt-every", "3", "--fail-at",
                                          "3", "--ckpt-dir", tmp + "/b"]))
        except RuntimeError as exc:
            failed = "injected failure at step 3" in str(exc)
        check(failed, "[train-resume] the failure was not injected")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            resumed = launch.run(train_args(base + [
                "--ckpt-every", "0", "--resume", "--ckpt-dir", tmp + "/b"]))
        check("resumed from step 3" in buf.getvalue(),
              "[train-resume] the run did not resume from step 3")
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(straight["state"]), tree_leaves(resumed["state"])))
    check(same, "[train-resume] 3 steps, a checkpoint and 3 more differ from "
          "6 steps straight")
    check(counts["flash_attention_bwd"] == 2 * 6,
          f"[train-resume] {counts['flash_attention_bwd']} backward launches "
          "in 6 steps of 2 layers")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        log = load_example("torch_fault_tolerant_train").main([])
    res = {"bit_identical": True, "losses": straight["losses"],
           "resumed_losses": resumed["losses"],
           "backward_launches": counts["flash_attention_bwd"],
           "example_s": time.perf_counter() - t0,
           "example_resumed": "resumed from step 5" in log}
    check(res["example_resumed"], "[train-resume] the fault-tolerant example "
          f"did not resume: {log}")
    print(f"[train-resume] {json.dumps(res)}", flush=True)
    return res


def flash_bwd_row(timings: list[dict], errs: dict, launches: int,
                  d256: bool = False) -> dict:
    """K4's backward row: the first of ``timings`` at the top level, every
    one of them under ``shapes``; at d <= 128 (``MAIN_FLASH`` first, with
    the forward's times) or, with ``d256``, at head dim 256
    (``FLASH_D256`` first, the errors of the d 256 rows)."""
    main = timings[0]
    tag = "_d256" if d256 else ""
    row = {
        "name": "flash_attention_bwd" + tag, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "replaces_fn": "the gradient of flash_attention (the reference's "
                       "pallas_call has no custom_vjp; its training "
                       "differentiates the XLA attention)",
        "launches": launches, "on_main_path": launches > 0,
        "max_abs_err": errs[f"abs_bfloat16{tag}"],
        "max_abs_err_f32": errs[f"abs_float32{tag}"],
        "max_rel_err": errs[f"bfloat16{tag}"],
        "max_rel_err_f32": errs[f"float32{tag}"],
        **{k: v for k, v in main.items() if k not in ("forward", "card")},
        "shapes": [{k: v for k, v in t.items() if k not in ("forward", "card")}
                   for t in timings]}
    if "forward" in main:
        row["forward_with_lse"] = main["forward"]
    return row


# ---------------------------------------------------------------------------------
# Phase 3c: the view-delta encoder, the prescreen, batch sessions
# ---------------------------------------------------------------------------------

#: ``[delta]``: servers of the random cluster, random views drawn on it
DELTA_NODES, DELTA_VIEWS = 1024, 48
#: ``[shortlist]``: rows of the random resident states, and the k each
#: prescreen case takes (every row as the last)
PRESCREEN_ROWS = (1024, 10240)
PRESCREEN_K = (1, 128, None)
#: ``[shortlist]``'s further states (rows, kind, slots a row): rows that no
#: cluster of 8 or 16 CTAs divides evenly, the 40960 rows of
#: `cluster_sweep`'s largest size, every row's bound tied (the select
#: resolves on rows alone), and 20 slots a row (32 lanes a row)
PRESCREEN_EXTRA = ((1021, "random", 16), (10237, "tied", 16),
                   (40960, "random", 16), (40960, "tied", 16),
                   (4099, "random", 20))
#: ``[shortlist]``'s states whose CTAs' rows outgrow a CTA's shared memory,
#: their keys through global scratch (rows, k): one cluster at k 256 (whose
#: CTAs' lists outgrow it too), and the split form at k 128 on the fewest
#: rows, doubling from 131075, at which they do
#: (`prescreen.prescreen_geometry`)
PRESCREEN_WIDE = ((140000, 256), (131075, 128))
#: ``[batch]``: the batch of preemptors (Table 3 B and C)
BATCH_NAMES = ("B", "C", "B", "B", "C", "B", "C", "B")


def delta_cluster(dev, nodes: int, seed: int):
    """A seeded cluster of ``nodes`` 24-CoreGroup servers (`BIG_CG`):
    Table 3 C and D instances on the GPUs, with holes, and one-CoreGroup
    preemptible jobs on most free CoreGroups, so that some rows hold more
    than 16 victims (the encoder's host fallback).  Returns the cluster and
    the workloads a view binds: ``{"D": ..., "cpu": ...}``."""
    import random

    from repro_torch.core.cluster import Cluster
    from repro_torch.core.placement import Placement
    from repro_torch.core.topology import ServerSpec
    from repro_torch.core.workload import WorkloadSpec, table3_workloads

    wl = {w.name: w for w in table3_workloads()}
    cpu = WorkloadSpec("cpu-only", priority=150, gpus_per_instance=0,
                       cores_per_instance=8, preemptible=True,
                       critical=False, kind="offline")
    rng = random.Random(seed)
    cluster = Cluster(ServerSpec(**BIG_CG), nodes, device=dev)
    for node in range(nodes):
        free = list(range(8))
        rng.shuffle(free)
        while free:
            two = len(free) >= 2 and rng.random() < 0.4
            g = [free.pop(), free.pop()] if two else [free.pop()]
            if rng.random() < 0.2:
                continue
            mask = sum(1 << x for x in g)
            cluster.bind(wl["C" if two else "D"], node,
                         Placement(mask, mask, 0))
        for c in range(8, 24):
            if rng.random() < 0.6:
                cluster.bind(cpu, node, Placement(0, 1 << c, 0))
    return cluster, {"D": wl["D"], "cpu": cpu}


def random_view(rng, cluster, wls, ops: int):
    """A `ClusterView` with ``ops`` random planned evictions, binds (a D
    instance or a one-CoreGroup job on free bits) and cancelled binds."""
    from repro_torch.core.cluster import ClusterView
    from repro_torch.core.placement import Placement

    view = ClusterView(cluster)
    uids = sorted(cluster.instances)
    added: list[int] = []
    for _ in range(ops):
        op = rng.random()
        if op < 0.4:
            uid = rng.choice(uids)
            if uid not in view._evicted:
                view.plan_evict(uid)
        elif op < 0.55 and added:
            view.plan_evict(added.pop(rng.randrange(len(added))))
        else:
            node = rng.randrange(cluster.num_nodes)
            fg, fc = view.free_masks(node)
            if rng.random() < 0.5 and fg & fc:
                bit = (fg & fc) & -(fg & fc)
                added.append(view.plan_bind(wls["D"], node, Placement(
                    bit, bit, 0)).uid)
            elif fc >> 8:
                bit = (fc >> 8 & -(fc >> 8)) << 8
                added.append(view.plan_bind(wls["cpu"], node, Placement(
                    0, bit, 0)).uid)
    return view


def delta_phase(torch, np, dev) -> dict:
    """``[delta]``: the view-delta encoder on the card against its plain
    version on the same inputs and against the host ``encode_row``
    packing of every delta and pending row, bit for bit, on
    `DELTA_VIEWS` random views of a `DELTA_NODES`-server cluster (rows past
    cap and pending rows among them); then the host time of a plan's patch
    rows through a `ViewDelta` (descriptors, one upload, one launch)
    against ``encode_row`` of every delta row and a packed upload, and the
    encoder's time at a typical shape."""
    import random

    from repro_torch.core.cluster import ViewDelta, encode_row
    from repro_torch.core.preemption_device import (_patch_plan, _patch_rows,
                                                    _stage, _upload)
    from repro_torch.kernels import view_delta as vdk

    cluster, wls = delta_cluster(dev, DELTA_NODES, seed=5)
    dcs = cluster.device_state().sync()
    cap = dcs.cap
    rng = random.Random(9)
    err = 0.0
    cases = dense = host = pending = 0
    vd_us, host_us = [], []
    shape = None
    for case in range(DELTA_VIEWS):
        if case % 4 == 3:           # committed changes, left pending
            for uid in rng.sample(sorted(cluster.instances), 5):
                cluster.evict(uid)
            dcs.sync(flush=False)
        view = random_view(rng, cluster, wls, rng.randrange(2, 60))
        torch_sync(dev)
        t0 = time.perf_counter()
        vd = ViewDelta(view, dcs.mirror, dcs.pending)
        st = _stage(dcs, vd)
        torch_sync(dev)
        vd_us.append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        rows = {n: encode_row(view, n, cap) for n in view.delta_nodes()}
        left = sorted(set(dcs.pending) - set(rows))
        p, pidx, pbuf = _patch_rows(rows, dcs.mirror, left, cap)
        _upload(dcs, np.concatenate([pidx, pbuf.ravel()]))
        torch_sync(dev)
        host_us.append((time.perf_counter() - t0) * 1e6)
        check(st.pidx_host.tolist() == pidx.tolist()
              and np.array_equal(st.pbuf.cpu().numpy(), pbuf),
              f"delta view {case}: the staged patch rows differ from host "
              "encode_row")
        hidx, desc, adds, hpos, hbuf = _patch_plan(dcs, vd)
        if desc is None:
            continue
        up = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in (desc, adds, hpos, hbuf)]
        got = vdk.encode_delta(dcs.nodestate, dcs.victims, *up, p=len(hidx))
        want = vdk.encode_delta_plain(dcs.nodestate, dcs.victims, *up,
                                      p=len(hidx))
        err = max(err, compare(torch, [got], [want],
                               f"encode_delta view {case}"))
        check(np.array_equal(got.cpu().numpy(), pbuf),
              f"encode_delta view {case}: differs from host encode_row")
        cases += 1
        dense += desc.shape[1]
        host += len(hpos)
        pending += len(left)
        if shape is None and desc.shape[1] >= 4 and len(hpos):
            shape = (up, len(hidx), desc.shape[1], adds.shape[2], len(hpos))
    check(cases > 0 and host > 0 and pending > 0,
          f"delta: {cases} encoded views, {host} host rows, {pending} "
          "pending rows (the draw must hold each)")
    out = {"nodes": DELTA_NODES, "views": DELTA_VIEWS, "encoded_views": cases,
           "dense_rows": dense, "host_rows": host, "pending_rows": pending,
           "max_abs_err": err,
           "host_us_view_delta_p50": float(np.percentile(vd_us, 50)),
           "host_us_encode_row_p50": float(np.percentile(host_us, 50))}
    up, p, d, a, h = shape
    fn = lambda: vdk.encode_delta(dcs.nodestate, dcs.victims, *up, p=p)
    plain = lambda: vdk.encode_delta_plain(dcs.nodestate, dcs.victims, *up,
                                           p=p)
    width = 5 + 5 * cap + 2
    # read: a dense row's descriptors, adds, resident free masks and every
    # slot's five fields; a host row and its place; written: p rows
    n_bytes = 4 * (d * (7 + 4 * a + 2 + 5 * cap) + h * (width + 1)
                   + p * width)
    b_ms, b_by = bound_ms(n_bytes, d * 32 * 32 * 4)
    kernel_ms = profiled_kernel_ms(torch, fn, "encode_delta_kernel")
    out["timing"] = {"p": p, "dense_rows": d, "adds": a, "host_rows": h,
                     "ms": event_ms(torch, fn), "kernel_ms": kernel_ms,
                     "plain_ms": event_ms(torch, plain, reps=5, inner=5),
                     "bytes": n_bytes, "bound_ms": b_ms, "bound_by": b_by}
    print(f"[delta] {json.dumps(out)}", flush=True)
    return out


def tie_state(np, spec, rows: int, seed: int):
    """`resident_state` with three rows in four copies of a row before
    them (node ids kept): exact ties of the prescreen's bound."""
    ns, v, dr = resident_state(np, spec, rows, 10, seed)
    rng = np.random.default_rng(seed + 3)
    for r in range(1, rows):
        if rng.random() < 0.75:
            ns[[0, 1, 3, 4], r] = ns[[0, 1, 3, 4], r - 1]
            v[:, r], dr[:, r] = v[:, r - 1], dr[:, r - 1]
    return ns, v, dr


def tied_state(np, spec, rows: int, seed: int):
    """Resident rows that are all free and hold no victim (node ids kept,
    some sentinels): one bound for every row that enters, so the select
    resolves on rows alone."""
    ns, v, dr = resident_state(np, spec, rows, 0, seed)
    ns[0] = dr[0] = (1 << spec.num_gpus) - 1
    ns[1] = dr[1] = (1 << spec.num_coregroups) - 1
    ns[3], ns[4] = 0, SENTINEL
    return ns, v, dr


def shortlist_kernel_phase(torch, np, dev) -> dict:
    """``[shortlist]``, the kernel: the prescreen on the card against its
    plain version on the same inputs, bit for bit (the top-K rows in
    order and the bits of ``excl_ub``), at `PRESCREEN_ROWS` rows of the
    RTX 4090 and the 24-CoreGroup SKU, random and tie-heavy states,
    without and with patch rows, random representatives with 37 forced
    rows, every REQUESTS entry at two preemptor priorities, k in
    `PRESCREEN_K`; then `PRESCREEN_EXTRA`'s states (ragged segments,
    40960 rows, every bound tied, 20 slots a row) at k 1, 128 and every
    row, and `PRESCREEN_WIDE`'s, with the selected keys (``sel``) held too;
    every instance of the kernel (`prescreen.prescreen_geometry`'s form)
    must have run; then the skip path."""
    from repro_torch.core.topology import RTX4090_SERVER, ServerSpec
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import prescreen as psk

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    err = 0.0
    cases = 0
    device = torch.cuda.current_device()
    forms = set()

    def held(args, kw, what, with_sel=False):
        nonlocal err, cases
        forms.add(psk.prescreen_geometry(args[0].shape[1], kw["k"],
                                         device)[3])
        sel = (torch.zeros(kw["k"], dtype=torch.int64, device=dev)
               if with_sel else None)
        err = max(err, compare(torch, [psk.prescreen(*args, **kw, sel=sel)],
                               [psk.prescreen_plain(*args, **kw)], what))
        if with_sel:
            check(torch.equal(sel, psk.prescreen_sel_plain(*args, **kw)),
                  f"{what}: sel differs from its plain version")
        cases += 1

    for rows in PRESCREEN_ROWS:
        for spec in (RTX4090_SERVER, ServerSpec(**BIG_CG)):
            for tie in (False, True):
                seed = rows + 7 * tie + (spec.name == "bigcg")
                ns, v, _ = (tie_state if tie else
                            lambda np_, sp, r, s: resident_state(
                                np_, sp, r, 10, s))(np, spec, rows, seed)
                rng = np.random.default_rng(seed)
                rep = t((rng.random(rows) < 0.6).astype(np.int32))
                forced = t(np.sort(rng.choice(rows, 37, replace=False))
                           .astype(np.int32))
                ns, v = t(ns), t(v)
                for patched in (False, True):
                    pidx, pbuf = (patch_rows(np, spec, rows, 19, seed, 10)
                                  if patched else
                                  (np.zeros(0, np.int32),
                                   np.zeros((0, 87), np.int32)))
                    pidx, pbuf = t(pidx), t(pbuf)
                    for ng, ncg, cpb, alpha in REQUESTS:
                        for thresh in FUSED_THRESH:
                            req = fc.FusedRequest(thresh, ng, ncg, cpb,
                                                  alpha)
                            for k in PRESCREEN_K:
                                k = k or rows
                                held((ns, v, pidx, pbuf, rep, forced),
                                     dict(k=k, req=req, spec=spec),
                                     f"prescreen {spec.name} rows={rows} "
                                     f"tie={tie} p={pidx.shape[0]} k={k} "
                                     f"req={thresh, ng, ncg, cpb, alpha}")
    extra = 0
    for rows, kind, cap in PRESCREEN_EXTRA:
        spec = RTX4090_SERVER
        seed = rows + cap
        ns, v, _ = (tied_state(np, spec, rows, seed) if kind == "tied" else
                    resident_state(np, spec, rows, 10, seed, cap=cap))
        rng = np.random.default_rng(seed)
        rep = t((rng.random(rows) < 0.6).astype(np.int32))
        forced = t(np.sort(rng.choice(rows, 37, replace=False))
                   .astype(np.int32))
        ns, v = t(ns), t(v)
        width = 5 + 5 * cap + 2
        patches = [(np.zeros(0, np.int32), np.zeros((0, width), np.int32))]
        if cap == 16:
            patches.append(patch_rows(np, spec, rows, 19, seed, 10))
        for pidx, pbuf in patches:
            pidx, pbuf = t(pidx), t(pbuf)
            for ng, ncg, cpb, alpha in REQUESTS[:2]:
                req = fc.FusedRequest(1000, ng, ncg, cpb, alpha)
                for k in PRESCREEN_K:
                    k = k or rows
                    held((ns, v, pidx, pbuf, rep, forced),
                         dict(k=k, req=req, spec=spec),
                         f"prescreen rows={rows} {kind} cap={cap} "
                         f"p={pidx.shape[0]} k={k} "
                         f"req={ng, ncg, cpb, alpha}", with_sel=True)
                    extra += 1
    wide = []
    for rows, k in PRESCREEN_WIDE:
        while (not psk.prescreen_geometry(rows, k, device)[3] & 1
               and rows < 1 << 22):
            rows *= 2
        spec = RTX4090_SERVER
        ns, v, _ = resident_state(np, spec, rows, 10, rows)
        rng = np.random.default_rng(rows)
        rep = t((rng.random(rows) < 0.6).astype(np.int32))
        forced = t(np.sort(rng.choice(rows, 37, replace=False))
                   .astype(np.int32))
        ns, v = t(ns), t(v)
        req = fc.FusedRequest(1000, *REQUESTS[0])
        for pidx, pbuf in ((np.zeros(0, np.int32), np.zeros((0, 87),
                                                            np.int32)),
                           patch_rows(np, spec, rows, 19, rows, 10)):
            pidx, pbuf = t(pidx), t(pbuf)
            held((ns, v, pidx, pbuf, rep, forced),
                 dict(k=k, req=req, spec=spec),
                 f"prescreen rows={rows} k={k} p={pidx.shape[0]} "
                 f"geometry={psk.prescreen_geometry(rows, k, device)}",
                 with_sel=True)
        wide.append((rows, k, psk.prescreen_geometry(rows, k, device)))
    check(forms == {0, 1, 2, 3}, f"prescreen: the kernel instances that "
          f"ran, {sorted(forms)}, are not all four (bit 0: the keys in "
          "global scratch, bit 1: the CTAs' lists)")
    # the skip path: nothing is written
    out = torch.full((129,), 7, dtype=torch.int32, device=dev)
    psk.prescreen(ns, v, pidx, pbuf, rep, forced, k=128, req=req, spec=spec,
                  skip=torch.ones(1, dtype=torch.int32, device=dev), out=out)
    check(out.tolist() == [7] * 129, "prescreen: the skip path wrote")
    torch_sync(dev)
    print(f"[shortlist] prescreen: {cases} cases bit-exact against the plain "
          f"version (rows {list(PRESCREEN_ROWS)}, k 1 / 128 / every row, "
          f"patch rows on/off, ties, forced rows; {extra} of them on "
          f"{[e[:2] for e in PRESCREEN_EXTRA]} with sel; (rows, k, (ctas, "
          f"clusters, scratch words, form)) {wide}); instances "
          f"{sorted(forms)}; skip path ok", flush=True)
    return {"prescreen": err}


def topk_keys(torch, np, psk, args, req, spec, dev):
    """Every row's prescreen key (`prescreen.keys_of`, 0 for a row that does
    not enter) as int64 with the top bit flipped, so that signed order is
    the keys' order: the input of `torch.topk`, the library call that
    computes the select's function (the flip done here, outside the timed
    call)."""
    ns, v, pidx, pbuf, rep, forced = args
    rows = psk._rows(ns, v, pidx, pbuf, rep, forced, 0)
    ub, ok = psk._bounds(*rows, req=req, spec=spec)
    keys = psk.keys_of(ub, np.arange(ns.shape[1]))
    keys[~ok.cpu().numpy()] = 0
    keys ^= np.uint64(1 << 63)
    return torch.from_numpy(keys.view(np.int64).copy()).to(dev)


def prescreen_row(torch, np, dev, clusters, err, launches, plans) -> dict:
    """The prescreen's row of the ``{"kernels"}`` line: at the main path's
    shape (preemptor B on the saturated 1024- and 10240-node clusters,
    their class representatives, k = 128, no patch rows), one launch of
    ``prescreen_cluster_kernel`` in the form the wrapper picks
    (`prescreen.prescreen_geometry`), beside ``torch.topk`` of the same
    keys."""
    from repro_torch.core.preemption_device import _request
    from repro_torch.core.workload import table3_workloads
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import prescreen as psk

    wl = {w.name: w for w in table3_workloads()}["B"]
    shapes = []
    for n in sorted(clusters):
        dcs = clusters[n].device_state().sync()
        spec = clusters[n].spec
        req = _request(spec, wl, 0.5)
        rep = dcs.rep_classes()[1]
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        pbuf = torch.zeros((0, 87), dtype=torch.int32, device=dev)
        args = (dcs.nodestate, dcs.victims, empty, pbuf, rep, empty)
        fn = lambda: psk.prescreen(*args, k=128, req=req, spec=spec)
        plain = lambda: psk.prescreen_plain(*args, k=128, req=req, spec=spec)
        flipped = topk_keys(torch, np, psk, args, req, spec, dev)
        stored = (dcs.victims[4] != 0)
        elig = int((stored & (dcs.victims[2] < wl.priority)).sum())
        cap = dcs.cap
        # read: a row's 5 node fields, priority and stored flag of every
        # slot, the masks of its eligible slots, its representative flag;
        # written: k + 1 int32
        n_bytes = 4 * (n * (5 + 2 * cap + 1) + 2 * elig + 129)
        # two tiers a row: per NUMA node two popcounts and a few word ops
        n_ops = n * 2 * (12 * spec.num_numa + 20)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        kernel_ms = profiled_kernel_ms(torch, fn, "prescreen_cluster_kernel")
        device = dcs.nodestate.device.index
        ctas = fc.max_cluster_ctas(device)
        shapes.append({"rows": n, "k": 128,
                       "classes": int(dcs.rep_classes()[0].sum()),
                       "ctas": ctas,
                       "clusters": psk.prescreen_geometry(n, 128,
                                                          device)[1],
                       "ms": event_ms(torch, fn), "kernel_ms": kernel_ms,
                       "plain_ms": event_ms(torch, plain, reps=5, inner=3),
                       "library_ms": event_ms(
                           torch, lambda: torch.topk(flipped, 129)),
                       "bytes": n_bytes, "int_ops": n_ops, "bound_ms": b_ms,
                       "bound_by": b_by,
                       "bound_share": b_ms / (kernel_ms or 1e9)})
    main = shapes[0]
    return {"name": "prescreen", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topo_score.cu",
            "kernel": "prescreen_cluster_kernel",
            "replaces": "src/repro/core/preemption_jax.py:839",
            "replaces_fn": "_prescreen_core (an XLA program; no Pallas "
                           "kernel)",
            "launches": launches["prescreen"],
            "on_main_path": launches["prescreen"] > 0,
            "launches_per_plan": launches["prescreen"] / plans,
            "max_abs_err": err, "shape": [main["rows"]], "ms": main["ms"],
            "kernel_ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_share": main["bound_share"],
            "library_ms": main["library_ms"],
            "library": "torch.topk(keys ^ (1 << 63), k + 1)",
            "shapes": shapes}


def delta_row(delta: dict, launches, plans) -> dict:
    """The encoder's row of the ``{"kernels"}`` line (`delta_phase`)."""
    tm = delta["timing"]
    return {"name": "encode_delta", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topo_score.cu",
            "replaces": "src/repro/core/cluster.py:810",
            "replaces_fn": "encode_delta_core (an XLA program; no Pallas "
                           "kernel)",
            "launches": launches["encode_delta"],
            "on_main_path": launches["encode_delta"] > 0,
            "launches_per_plan": launches["encode_delta"] / plans,
            "max_abs_err": delta["max_abs_err"],
            "shape": [tm["p"], tm["dense_rows"], tm["host_rows"]],
            "ms": tm["ms"], "kernel_ms": tm["kernel_ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"],
            "bound_share": tm["bound_ms"] / (tm["kernel_ms"] or tm["ms"]),
            "library_ms": None}


def batch_phase(torch, dev, clusters) -> dict:
    """``[batch]``: an 8-request ``plan_batch`` (`BATCH_NAMES`) on the
    saturated 1024- and 10240-node clusters through ``imp_batched``'s
    session, decision for decision against sequential single plans on a
    shared view (and candidate count for candidate count against
    ``imp_batched_full``'s, which sweep every row as the session does; at
    1024 nodes also against host ``imp``'s ``plan_batch``); the counts set to 0 just
    before each batch and read just after, held to the paths' launches.
    A second identical batch reuses the session."""
    from repro_torch.core.cluster import ClusterView
    from repro_torch.core.preemption_device import expected_launches
    from repro_torch.core.scheduler import TopoScheduler
    from repro_torch.core.simulator import decision_key
    from repro_torch.core.workload import table3_workloads

    wl = {w.name: w for w in table3_workloads()}
    batch = [wl[n] for n in BATCH_NAMES]
    out = {}
    launches = dict.fromkeys(("normal_cycle", "fused_class", "fused_argmax",
                              "prescreen", "encode_delta"), 0)
    for n in sorted(clusters):
        cluster = clusters[n]
        sched = TopoScheduler(cluster, engine="imp_batched", alpha=0.5)
        rows = []
        for rep in range(2):
            torch_sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            txns = sched.plan_batch(batch)
            torch_sync(dev)
            wall = time.perf_counter() - t0
            c = read_counts()
            want = expected_launches(c["path"])
            for name, k in want.items():
                check(c[name] == k, f"batch {n} nodes: {c[name]} {name} "
                      f"launches, the paths give {k} ({c['path']})")
            check(c["path"]["merge"] + c["path"]["merge_normal"] > 0,
                  f"batch {n} nodes: no session plan ({c['path']})")
            check(c["path"]["sessions"] == (1 if rep == 0 else 0),
                  f"batch {n} nodes: {c['path']['sessions']} sessions built "
                  f"in round {rep}")
            for name in launches:
                launches[name] += c[name]
            rows.append({"wall_us_per_plan": wall * 1e6 / len(batch),
                         "counts": c})
        keys = [decision_key(t.decision) for t in txns]
        cands = [t.decision.num_candidates for t in txns]
        view = ClusterView(cluster)
        t0 = time.perf_counter()
        singles = [sched.plan(w, view=view) for w in batch]
        seq_us = (time.perf_counter() - t0) * 1e6 / len(batch)
        check(keys == [decision_key(t.decision) for t in singles],
              f"batch {n} nodes: session decisions differ from sequential "
              "single plans")
        # the full sweep's single plans count every row's candidates, as
        # the session does (a shortlisted plan counts its k rows')
        full = TopoScheduler(cluster, engine="imp_batched_full", alpha=0.5)
        view = ClusterView(cluster)
        singles = [full.plan(w, view=view) for w in batch]
        check(keys == [decision_key(t.decision) for t in singles]
              and cands == [t.decision.num_candidates for t in singles],
              f"batch {n} nodes: session decisions or candidate counts "
              "differ from imp_batched_full's sequential single plans")
        if n <= 1024:
            host = TopoScheduler(cluster, engine="imp", alpha=0.5)
            check(keys == [decision_key(t.decision)
                           for t in host.plan_batch(batch)],
                  f"batch {n} nodes: session decisions differ from host imp")
        out[n] = {"plans": len(batch), "kinds": [k[0] for k in keys],
                  "rounds": rows, "sequential_us_per_plan": seq_us}
        print(f"[batch] {n} nodes: {json.dumps(out[n])}", flush=True)
    return {"runs": out, "launches": launches}


# ---------------------------------------------------------------------------------
# Phase 3c: the sharded state (imp_sharded) and its merges
# ---------------------------------------------------------------------------------

#: shard counts and node counts of the merges' checks (13 and 10240 are
#: not multiples of 3 or 8: the last shard holds pad rows)
SHARD_COUNTS = (1, 2, 3, 4, 8)
SHARD_NODES = (13, 1024, 10240)
#: shards of the decisions' and the day's second mesh on the one card
SHARDS_D = 4
#: (nodes, shards) where every shard runs K2 in its split form
SPLIT_SHARDS = ((81920, 2), (81920, 3))
MERGES = ("tail_merge", "normal_merge", "prescreen_select")
#: the merges that run inside the last shard's launch of a kernel, by the
#: wrapper whose ``merges`` counts them
FOLDED = {"tail_merge": "fused_argmax", "normal_merge": "normal_cycle"}


def cuda0(torch):
    return torch.device("cuda", torch.cuda.current_device())


def _split_patches(torch, np, pidx, pbuf, shards, dev):
    """Each shard's run of the sorted patch rows (global ids), on ``dev``."""
    real = pidx[pidx != SENTINEL]
    out = []
    for s in shards:
        mine = (real >= s.base) & (real < s.base + s.rows)
        out.append((torch.from_numpy(real[mine].copy()).to(dev),
                    torch.from_numpy(pbuf[:len(real)][mine].copy()).to(dev)))
    return out


def same_tier_cls(np, ns):
    """The same-tier case (four rows, two shards): shard 0's survivors are
    all tier 0 at one f32 score (priority sums 2^25 and 3 * 2^23, 0.5 at
    alpha 0.5), shard 1 holds a tier-1 survivor at that score (sum 2).
    Shard 0 alone would refine by priority sum; the global chain must
    not (row 0 wins, by k)."""
    cls = np.zeros((15, 4), np.int32)
    cls[14] = ns[2, :4]
    cls[0, 0], cls[6, 0], cls[12, 0] = 1, 2**25, 1
    cls[0, 1], cls[6, 1], cls[12, 1] = 1, 3 * 2**23, 2
    cls[1, 2], cls[7, 2], cls[12, 2] = 1, 2, 3
    return cls


def shard_kernel_phase(torch, np, dev) -> dict[str, float]:
    """``[sharded]``, the kernels: each merge against its plain version on
    the same records, bit for bit (the last shard's tail and K2 with the
    earlier shards' records against the last shard's plain record form
    merged by ``tail_merge_plain`` / ``normal_merge_plain``; K2 also
    forced into its split form), and the merged result against the
    unsharded kernels over all rows: D in `SHARD_COUNTS` shards on the one
    card, N in `SHARD_NODES` (pad rows where D does not divide N), patch
    rows on several shards, gathered rows across shards and sentinels, the
    tail over the resident segment and over 16-row chunks, class tables
    with forced exact ties and the same-tier case, the prescreen at k = 1
    and 128; then K2 over `SPLIT_SHARDS`, every shard in its split form.
    The shard forms of the tail, K2 and the prescreen (their records,
    ``sel``) are held to their plain versions too.  Over one shard there is
    nothing to merge: the shard's launches are held to the unsharded ones
    and no merge case is counted."""
    from repro_torch.core import cluster_parallel as cp
    from repro_torch.core.topology import SPECS
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import normal_cycle as nck
    from repro_torch.kernels import prescreen as psk

    spec = SPECS["rtx4090"]
    errs = dict.fromkeys(MERGES, 0.0)
    cases = dict.fromkeys(MERGES, 0)
    c0 = cuda0(torch)
    reqs = (fc.FusedRequest(1000, 2, 2, 1, 0.5),
            fc.FusedRequest(300, 4, 4, 0, 0.0),
            fc.FusedRequest(1000, 1, 1, 1, 1.0))

    def same(got, want, what, name):
        errs[name] = max(errs[name], compare(torch, [got], [want], what))
        cases[name] += 1

    def usorted(x):
        return np.sort(x.cpu().numpy().view(np.uint64))

    for n in SHARD_NODES:
        ns, v, dr = resident_state(np, spec, n, 8, seed=n)
        pidx, pbuf = patch_rows(np, spec, n, min(9, n - 1), n + 7, 8)
        rng = np.random.default_rng(n)
        gidx = rng.choice(n, 12, replace=False).astype(np.int32)
        gidx = np.append(gidx, SENTINEL).astype(np.int32)
        chunks = rng.choice(n, min(29, n), replace=False).astype(np.int32)
        chunks = np.concatenate([chunks, np.full(3, SENTINEL, np.int32)])
        for d in SHARD_COUNTS:
            mesh = cp.Mesh((c0,) * d)
            shards = cp._shards_of(mesh, ns, v, dr)
            rows = shards[0].rows
            n_rows = rows * d
            g_ns, g_v, g_dr = (torch.cat([getattr(s, f) for s in shards], 1)
                               for f in ("nodestate", "victims", "drain"))
            rep = (rng.random(n_rows) < 0.7).astype(np.int32)
            rep[n:] = 0
            forced = np.unique(rng.choice(n, 5)).astype(np.int32)
            rep_d = torch.from_numpy(rep).to(c0)
            forced_d = torch.from_numpy(forced).to(c0)
            for patched in ((False, True) if n == 13 else (True,)):
                if patched:
                    gp = (torch.from_numpy(pidx).to(c0),
                          torch.from_numpy(pbuf).to(c0))
                else:
                    gp = (torch.zeros(0, dtype=torch.int32, device=c0),
                          torch.zeros((0, pbuf.shape[1]), dtype=torch.int32,
                                      device=c0))
                sp = _split_patches(torch, np, pidx if patched
                                    else pidx[:0], pbuf, shards, c0)
                for req in (reqs if n < 10240 else reqs[:2]):
                    what = f"N={n} D={d} patched={patched} req={req}"
                    # the normal cycle: the earlier shards' records, then
                    # the last shard's K2 merging them (one cluster, and
                    # forced split: the ticket's last cluster reads them)
                    prior = (torch.empty((d - 1, nck.part_records(rows, c0),
                                          4), dtype=torch.int32, device=c0)
                             if d > 1 else None)
                    for k, s in enumerate(shards[:-1]):
                        a = (s.nodestate, s.victims, s.drain, *sp[k])
                        nck.normal_cycle_part(*a, req=req, spec=spec,
                                              base=s.base, out=prior[k])
                        if prior.shape[1] == 2:
                            check(torch.equal(prior[k], nck.normal_part_plain(
                                *a, req, spec, s.base)),
                                f"normal_cycle_part {what} shard {k}")
                    last = shards[-1]
                    la = (last.nodestate, last.victims, last.drain, *sp[-1])
                    got = nck.normal_cycle(*la, req=req, spec=spec,
                                           base=last.base, prior=prior)
                    want = nck.normal_merge_plain(
                        [*([] if prior is None else prior),
                         nck.normal_part_plain(*la, req, spec, last.base)],
                        req, spec)
                    st = fc.launch_state(*la, None, resident=True,
                                         base=last.base)
                    split = nck.launch(st, req, spec, prior=prior,
                                       geometry=nck.normal_geometry(
                                           rows, split_nodes=0))
                    if d > 1:
                        same(got, want, "normal_merge " + what,
                             "normal_merge")
                        same(split, want, "normal_merge split " + what,
                             "normal_merge")
                    check(torch.equal(got, want) and torch.equal(split, want)
                          and torch.equal(got, nck.normal_cycle(
                              g_ns, g_v, g_dr, *gp, req=req, spec=spec)),
                          f"sharded normal cycle {what} differs from its "
                          "plain compose or from K2 over every row")
                    # the sweep's tail: resident + gathered, then chunks
                    for resident, gi, seg in ((True, gidx, None),
                                              (False, chunks, 16)):
                        g_t = torch.from_numpy(gi).to(c0)
                        kw = dict(m_res=8, resident=resident, m_gather=8,
                                  req=req, spec=spec)
                        segs = 1 if resident else -(-len(gi) // seg)
                        part = torch.empty((d, segs, fc.PART_FIELDS),
                                           dtype=torch.int32, device=c0)
                        for k, s in enumerate(shards):
                            a = (s.nodestate, s.victims, *sp[k], g_t)
                            cls = fc.fused_class(s.nodestate, s.victims,
                                                 s.drain, *sp[k], g_t,
                                                 base=s.base, **kw)
                            sh = ((rows, s.base, n_rows - rows) if resident
                                  else (0, 0, 0))
                            sg = cls.shape[1] if resident else seg
                            fc.fused_argmax(cls, *a, resident=resident,
                                            seg=sg, req=req, spec=spec,
                                            base=s.base, shard=sh,
                                            out=part[k])
                            check(torch.equal(part[k], fc.fused_argmax_plain(
                                cls, *a, resident=resident, seg=sg, req=req,
                                spec=spec, base=s.base, shard=sh)),
                                f"fused_argmax shard form {what} shard {k}")
                            if k == d - 1 and d > 1:    # the last: merged
                                got = fc.fused_argmax(
                                    cls, *a, resident=resident, seg=sg,
                                    req=req, spec=spec, base=s.base,
                                    shard=sh, prior=part[:-1].contiguous())
                            elif k == d - 1:
                                got = fc.fused_argmax(
                                    cls, *a, resident=resident, seg=sg,
                                    req=req, spec=spec)
                        if d > 1:
                            same(got, fc.tail_merge_plain(part,
                                                          req.alpha > 0),
                                 "tail_merge " + what, "tail_merge")
                        cls = fc.fused_class(g_ns, g_v, g_dr, *gp, g_t, **kw)
                        want = fc.fused_argmax(
                            cls, g_ns, g_v, *gp, g_t, resident=resident,
                            seg=cls.shape[1] if resident else seg, req=req,
                            spec=spec)
                        check(torch.equal(got, want), f"sharded tail {what} "
                              f"resident={resident} differs from the tail "
                              "over every row")
                    # the prescreen and the union
                    for k_top in (1, 128):
                        kk = min(k_top, n_rows)
                        kd = min(kk, rows)
                        keys = torch.empty((d, kd), dtype=torch.int64,
                                           device=c0)
                        outs = torch.empty((d, kd + 1), dtype=torch.int32,
                                           device=c0)
                        for k, s in enumerate(shards):
                            a = (s.nodestate, s.victims, *sp[k],
                                 rep_d[s.base:s.base + rows], forced_d)
                            psk.prescreen(*a, k=kd, req=req, spec=spec,
                                          out=outs[k], base=s.base,
                                          sel=keys[k])
                            check(torch.equal(outs[k], psk.prescreen_plain(
                                *a, k=kd, req=req, spec=spec, base=s.base))
                                and np.array_equal(usorted(keys[k]), usorted(
                                    psk.prescreen_sel_plain(
                                        *a, k=kd, req=req, spec=spec,
                                        base=s.base))),
                                f"prescreen shard form {what} k={kd}")
                        got = psk.prescreen_select(keys, k=kk,
                                                   excl=outs[:, kd])
                        same(got, psk.prescreen_select_plain(
                            keys, kk, outs[:, kd]),
                            f"prescreen_select {what} k={kk}",
                            "prescreen_select")
                        check(torch.equal(got, psk.prescreen(
                            g_ns, g_v, *gp, rep_d, forced_d, k=kk, req=req,
                            spec=spec)), f"sharded prescreen {what} k={kk} "
                            "differs from the prescreen over every row")
            # forced exact ties: tie tables and the same-tier case, over the
            # shards' rows (no sweep: the table is the tail's input)
            tables = [tie_table(np, n_rows, n + d)]
            if n == 13 and d == 2:
                tables = [same_tier_cls(np, ns)] + tables
            for cls_h in tables:
                m_rows = cls_h.shape[1] // d
                if m_rows * d != cls_h.shape[1]:
                    continue
                cls_h[14] = np.concatenate([s.nodestate[2].cpu().numpy()
                                            for s in shards])[:cls_h.shape[1]]
                for alpha in (0.0, 0.5):
                    req = fc.FusedRequest(1000, 2, 2, 1, alpha)
                    e = (torch.zeros(0, dtype=torch.int32, device=c0),
                         torch.zeros((0, pbuf.shape[1]), dtype=torch.int32,
                                     device=c0))
                    part = torch.empty((d, 1, fc.PART_FIELDS),
                                       dtype=torch.int32, device=c0)
                    sub = cp._shards_of(mesh, *(x[:, :cls_h.shape[1]].cpu()
                                                for x in (g_ns, g_v, g_dr)))
                    for k, s in enumerate(sub):
                        c = torch.from_numpy(np.ascontiguousarray(
                            cls_h[:, k * m_rows:(k + 1) * m_rows])).to(c0)
                        sh = (m_rows, s.base, cls_h.shape[1] - m_rows)
                        a = (s.nodestate, s.victims, *e, e[0])
                        fc.fused_argmax(c, *a, resident=True, seg=m_rows,
                                        req=req, spec=spec, base=s.base,
                                        shard=sh, out=part[k])
                        check(torch.equal(part[k], fc.fused_argmax_plain(
                            c, *a, resident=True, seg=m_rows, req=req,
                            spec=spec, base=s.base, shard=sh)),
                            f"fused_argmax shard form, tie table N={n} D={d}")
                    if d > 1:
                        got = fc.fused_argmax(
                            c, *a, resident=True, seg=m_rows, req=req,
                            spec=spec, base=s.base, shard=sh,
                            prior=part[:-1].contiguous())
                        same(got, fc.tail_merge_plain(part, alpha > 0),
                             f"tail_merge tie table N={n} D={d}",
                             "tail_merge")
                    else:
                        got = fc.fused_argmax(c, *a, resident=True,
                                              seg=m_rows, req=req, spec=spec)
                    full = torch.from_numpy(cls_h).to(c0)
                    want = fc.fused_argmax(
                        full, g_ns[:, :cls_h.shape[1]].contiguous(),
                        g_v[:, :cls_h.shape[1]].contiguous(), *e, e[0],
                        resident=True, seg=cls_h.shape[1], req=req,
                        spec=spec)
                    check(torch.equal(got, want), f"sharded tail, tie table "
                          f"N={n} D={d} alpha={alpha}, differs from the tail "
                          "over every row")
                    if cls_h.shape[1] == 4 and alpha == 0.5:
                        check(tuple(got[0, :3].tolist()) == (1, 0, 0),
                              f"the same-tier case picked {got[0].tolist()}")
    # every shard in K2's split form: the earlier shards' records are their
    # clusters' minima, which the last shard's ticket reads through L2
    for n, d in SPLIT_SHARDS:
        ns, v, dr = resident_state(np, spec, n, 8, seed=n + d)
        shards = cp._shards_of(cp.Mesh((c0,) * d), ns, v, dr)
        rows = shards[0].rows
        e = (torch.zeros(0, dtype=torch.int32, device=c0),
             torch.zeros((0, 87), dtype=torch.int32, device=c0))
        prior = torch.empty((d - 1, nck.part_records(rows, c0), 4),
                            dtype=torch.int32, device=c0)
        check(prior.shape[1] > 2, f"K2 over {rows} rows a shard is not split")
        for req in reqs[:2]:
            for k, s in enumerate(shards[:-1]):
                nck.normal_cycle_part(s.nodestate, s.victims, s.drain, *e,
                                      req=req, spec=spec, base=s.base,
                                      out=prior[k])
            last = shards[-1]
            la = (last.nodestate, last.victims, last.drain, *e)
            got = nck.normal_cycle(*la, req=req, spec=spec, base=last.base,
                                   prior=prior)
            want = nck.normal_merge_plain(
                [*prior, nck.normal_part_plain(*la, req, spec, last.base)],
                req, spec)
            same(got, want, f"normal_merge split N={n} D={d} req={req}",
                 "normal_merge")
            full = [torch.from_numpy(x).to(c0) for x in (ns, v, dr)]
            check(torch.equal(got, nck.normal_cycle(*full, *e, req=req,
                                                    spec=spec)),
                  f"K2 over {d} split shards of {n} nodes differs from K2 "
                  "over every row")
    torch_sync(dev)
    print(f"[sharded] merges bit-exact against their plain versions and the "
          f"unsharded kernels over every row: {json.dumps(cases)} cases "
          f"(D {list(SHARD_COUNTS)}, N {list(SHARD_NODES)}; K2 split in "
          f"every shard at {list(SPLIT_SHARDS)}); the shard forms of the "
          "tail, K2 and the prescreen equal their plain versions",
          flush=True)
    return errs


def full_keys_on(cluster, scaleups, engine, dev, install=None):
    """`protocol_on`'s plans (cycle 0 of the protocol, pure reads) with
    ``engine``, the state installed by ``install(cluster)`` first when
    given: ``(summary, [(decision key, masks, candidates)], resolved
    engine)``; the counts set to 0 just before, read just after."""
    import random

    from repro_torch.core.scheduler import TopoScheduler
    from repro_torch.core.simulator import HitRateReport, decision_key
    from repro_torch.core.workload import table3_workloads

    workloads = {w.name: w for w in table3_workloads()}
    rep = HitRateReport(engine=engine)
    if install is not None:
        install(cluster)
    keys = []
    torch_sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    sched = TopoScheduler(cluster, engine=engine, alpha=0.5)
    rng = random.Random(10_000)
    for _ in range(scaleups):
        dec = sched.plan(workloads[rng.choice(("B", "C"))]).decision
        keys.append(decision_key(dec) + (
            None if dec.placement is None else
            (dec.placement.gpu_mask, dec.placement.cg_mask),
            dec.num_candidates))
        rep.decision_keys.append(decision_key(dec))
        if dec.preempted:
            rep.preemptions += 1
            rep.hits += int(dec.hit)
            rep.sourcing_us.append(dec.sourcing_us)
        elif dec.rejected:
            rep.failures += 1
        else:
            rep.placements += 1
    torch_sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    return (summarize(rep, cluster.num_nodes, 1, scaleups, wall, counts,
                      "sharded"), keys, sched.engine)


def check_sharded_launches(c: dict, plans: int, shards: int,
                           what: str) -> None:
    """A sharded run's launches: what its paths give (each shard's
    pipeline counted once a shard), D K2 launches a plan of which one
    merges over D > 1 shards (none over one), a merged tail a plan that
    sweeps, and no lane-form K1.  No merge has a launch of its own: no
    wrapper launches one, and the build holds no such kernel."""
    check_fused_launches(c, what)
    path = c["path"]
    merged = plans if shards > 1 else 0
    check(c["normal_merge"] == merged and c["normal_cycle"]
          == plans * shards and c["tail_merge"] >= merged
          and c["tail_merge"] * shards <= c["fused_argmax"]
          and (shards > 1 or not any(c[m] for m in MERGES))
          and path["plan2"] + path["shortlist_plan2"] == plans * shards,
          f"{what}: {c['normal_cycle']} K2 launches, {c['normal_merge']} of "
          f"them merging, and {c['tail_merge']} merging tails for {plans} "
          f"plans over {shards} shards ({path})")


def random_cluster(seed: int, nodes: int, dev):
    """The reference's randomized parity cluster
    (``tests/test_fused_sourcing.py:random_cluster``) on ``dev``."""
    import random

    from repro_torch.core.cluster import Cluster
    from repro_torch.core.placement import Placement
    from repro_torch.core.topology import SPECS
    from repro_torch.core.workload import table3_workloads

    wl = {w.name: w for w in table3_workloads()}
    rng = random.Random(seed)
    cluster = Cluster(SPECS["rtx4090"], nodes, device=dev)
    for node in range(nodes):
        free = list(range(8))
        rng.shuffle(free)
        while free:
            if len(free) >= 2 and rng.random() < 0.4:
                g, w = [free.pop(), free.pop()], wl["C"]
            else:
                g, w = [free.pop()], wl["D"]
            if rng.random() < 0.2:
                continue
            mask = sum(1 << x for x in g)
            cluster.bind(w, node, Placement(mask, mask, 0))
    return cluster


def randomized_sequences(torch, dev, shards: int = 8, trials: int = 5):
    """The reference's randomized sequences (``tests/test_distributed.py``:
    8 plans with commits and rollbacks, then a 4-request ``plan_batch``) at
    5, 11 and 13 nodes: ``imp_sharded`` over ``shards`` shards on the one
    card against host ``imp``, decisions, masks and candidate counts."""
    import random

    from repro_torch.core.scheduler import TopoScheduler
    from repro_torch.core.simulator import decision_key
    from repro_torch.core.workload import table3_workloads

    wl = {w.name: w for w in table3_workloads()}
    c0 = cuda0(torch)

    def seq(sched, seed):
        ops = random.Random(seed)
        out = []

        def key(dec):
            return decision_key(dec) + (
                None if dec.placement is None else
                (dec.placement.gpu_mask, dec.placement.cg_mask),
                dec.num_candidates)

        for _ in range(8):
            txn = sched.plan(wl[ops.choice("BCD")], allow_normal=True)
            out.append(key(txn.decision))
            if txn.decision.kind != "reject":
                r = ops.random()
                if r < 0.5:
                    txn.commit()
                elif r < 0.75:
                    txn.commit()
                    txn.rollback()
        out.extend(key(t.decision) for t in sched.plan_batch(
            [wl[ops.choice("BC")] for _ in range(4)]))
        return out

    rng = random.Random(7)
    done = []
    for _ in range(trials):
        seed, nodes = rng.randrange(10_000), rng.choice((5, 11, 13))
        host = seq(TopoScheduler(random_cluster(seed, nodes, dev),
                                 engine="imp"), seed)
        cluster = random_cluster(seed, nodes, dev)
        cluster.device_state(mesh=(c0,) * shards)
        got = seq(TopoScheduler(cluster, engine="imp_sharded"), seed)
        check(got == host, f"randomized sequence seed {seed}, {nodes} nodes, "
              f"{shards} shards: imp_sharded differs from host imp")
        done.append([seed, nodes])
    return done


def unshard(cluster, state) -> None:
    """Put the unsharded ``state`` back on ``cluster`` in place of the
    installed one, listening again for invalidations (the plans since it
    was replaced were pure reads, so its tensors are current)."""
    cur = cluster._device_state
    if cur is not state:
        cluster.remove_dirty_listener(cur._mark_dirty)
        cluster.add_dirty_listener(state._mark_dirty)
        cluster._device_state = state


def sharded_phase(torch, dev, clusters: dict, host_keys: dict,
                  scaleups: dict | None = None) -> dict:
    """``[sharded]``, the decisions: ``imp_sharded`` and
    ``imp_sharded_full`` over the default mesh (D = 1, the one card) and
    over `SHARDS_D` shards of it, on the saturated 100-, 1024- and
    10240-node clusters (cycle 0 of the protocol, pure reads), each decision
    (masks and candidate count included) identical to ``imp_batched_full``'s
    and ``imp_batched``'s on the unsharded state, and the decision keys to
    host ``imp``'s; ``TopoScheduler(engine="auto")`` at 10240 nodes
    resolves to ``imp_sharded`` and decides the same; the randomized
    sequences at 5, 11 and 13 nodes over 8 shards.  Each cluster's
    unsharded state is put back after its sharded runs."""
    from repro_torch.core.simulator import SimConfig, build_saturated_cluster

    c0 = cuda0(torch)
    scaleups = scaleups or {100: 50, 1024: 20, 10240: 10}
    launches = dict.fromkeys(("normal_cycle", "fused_class", "fused_argmax",
                              "prescreen", "encode_delta") + MERGES, 0)
    plans = 0
    runs = []
    built = {100: build_saturated_cluster(SimConfig(num_nodes=100, seed=0,
                                                    device=dev))}
    for n in sorted(scaleups):
        cluster = clusters.get(n) or built[n]
        s = scaleups[n]
        orig = cluster.device_state().sync()
        ref = {}
        for engine in ("imp_batched_full", "imp_batched"):
            summary, ref[engine], _ = full_keys_on(cluster, s, engine, dev)
            check([k[:5] for k in ref[engine]] == host_keys[n][:s],
                  f"{n} nodes: {engine} decisions differ from host imp")
            runs.append(summary)
        for shards in (1, SHARDS_D):
            mesh = (c0,) * shards
            for engine in ("imp_sharded", "imp_sharded_full"):
                summary, keys, _ = full_keys_on(
                    cluster, s, engine, dev,
                    install=lambda c, m=mesh: c.device_state(mesh=m))
                check(cluster.device_state().mesh.size == shards,
                      f"{n} nodes: the state is not over {shards} shards")
                want = ref[engine.replace("sharded", "batched")]
                check(keys == want, f"{n} nodes, {shards} shards: {engine} "
                      "decisions, masks or candidate counts differ from the "
                      "unsharded engine's")
                c = summary["counts"]
                check_sharded_launches(c, s, shards,
                                       f"{n} nodes {engine} D={shards}")
                for name in launches:
                    launches[name] += c[name]
                plans += s
                summary["shards"] = shards
                runs.append(summary)
        if n == 10240:
            unshard(cluster, orig)          # a fresh default mesh for auto
            summary, keys, engine = full_keys_on(cluster, s, "auto", dev)
            check(engine == "imp_sharded" and keys == ref["imp_batched"],
                  f"10240 nodes: auto resolved to {engine} or decided "
                  "otherwise than imp_batched")
            check(cluster.device_state().mesh.devices == (c0,),
                  "auto's default mesh is not the one card")
            check_sharded_launches(summary["counts"], s, 1, "auto")
            for name in launches:
                launches[name] += summary["counts"][name]
            plans += s
            summary["shards"] = 1
            runs.append(summary)
        # the unsharded state back for the phases that follow (every plan
        # above was a pure read)
        unshard(cluster, orig)
        print(f"[sharded] {n} nodes: imp_sharded and imp_sharded_full over "
              f"1 and {SHARDS_D} shards decide as imp_batched and "
              f"imp_batched_full (masks, candidate counts) and host imp"
              + ("; auto resolves to imp_sharded" if n == 10240 else ""),
              flush=True)
    seqs = randomized_sequences(torch, dev)
    print(f"[sharded] randomized sequences over 8 shards identical to host "
          f"imp: {json.dumps(seqs)}", flush=True)
    for name in MERGES:
        check(launches[name] > 0, f"[sharded]: {name} never launched")
    return {"runs": runs, "launches": launches, "plans": plans}


def fold_ms(torch, with_fn, without_fn, kernel) -> dict:
    """The time a merge folded into a launch adds: the launch with the
    earlier shards' records (``with_fn``) less the same launch without them
    (``without_fn``), in device time from torch.profiler and in CUDA-event
    time a call, each measured in the order with, without, without,
    with."""
    got = {"with": [], "without": []}
    for form in ("with", "without", "without", "with"):
        fn = with_fn if form == "with" else without_fn
        got[form].append((profiled_kernel_ms(torch, fn, kernel),
                          event_ms(torch, fn)))
    dev = {f: [k for k, _ in v] for f, v in got.items()}
    ev = {f: statistics.mean(e for _, e in v) for f, v in got.items()}
    kern = ({f: statistics.mean(v) for f, v in dev.items()}
            if all(None not in v for v in dev.values()) else None)
    return {"kernel_ms": None if kern is None
            else kern["with"] - kern["without"],
            "ms": ev["with"] - ev["without"],
            "launch_kernel_ms": dev["with"], "without_kernel_ms":
            dev["without"], "launch_ms": ev["with"],
            "without_ms": ev["without"]}


def merge_rows(torch, np, dev, errs, launches, plans, clusters) -> list[dict]:
    """The merges' rows of the ``{"kernels"}`` line, at the main path's
    shapes: preemptor B on the saturated 10240-node cluster over
    `SHARDS_D` shards (the records of a plan: the tail's, K2's and the
    prescreen's keys at k = 128).  The tail's and K2's merges have no
    launch of their own: their rows give the time the fold adds to the
    last shard's launch (`fold_ms`), no standalone launch, and the merges
    made on the main path.  Bound: the records read and the winner written
    over the card's memory rate; their operations (a few compares a
    record; for the union select, a comparison sort of its D k keys, more
    than a select needs) take less.  The union select's library call is
    ``torch.topk`` of the same keys (top bit flipped outside the timed
    call); no PyTorch call computes the other two."""
    from repro_torch.core import cluster_parallel as cp
    from repro_torch.core.preemption_device import _request
    from repro_torch.core.workload import table3_workloads
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import normal_cycle as nck
    from repro_torch.kernels import prescreen as psk

    wl = {w.name: w for w in table3_workloads()}["B"]
    cluster = clusters[10240]
    spec = cluster.spec
    req = _request(spec, wl, 0.5)
    c0 = cuda0(torch)
    dcs = cluster.device_state().sync()
    mesh = cp.Mesh((c0,) * SHARDS_D)
    shards = cp._shards_of(mesh, dcs.nodestate.cpu().numpy(),
                           dcs.victims.cpu().numpy(),
                           dcs.drain.cpu().numpy())
    rows = shards[0].rows
    n_rows = rows * SHARDS_D
    e = (torch.zeros(0, dtype=torch.int32, device=c0),
         torch.zeros((0, dcs.victims.shape[2] * 5 + 7), dtype=torch.int32,
                     device=c0))
    part = torch.empty((SHARDS_D, 1, fc.PART_FIELDS), dtype=torch.int32,
                       device=c0)
    recs = torch.empty((SHARDS_D, nck.part_records(rows, c0), 4),
                       dtype=torch.int32, device=c0)
    k = 128
    keys = torch.empty((SHARDS_D, k), dtype=torch.int64, device=c0)
    outs = torch.empty((SHARDS_D, k + 1), dtype=torch.int32, device=c0)
    rep = dcs.rep_classes()[0]
    for i, s in enumerate(shards):
        cls = fc.fused_class(s.nodestate, s.victims, s.drain, *e, e[0],
                             m_res=8, resident=True, m_gather=8, req=req,
                             spec=spec, base=s.base)
        fc.fused_argmax(cls, s.nodestate, s.victims, *e, e[0], resident=True,
                        seg=rows, req=req, spec=spec, base=s.base,
                        shard=(rows, s.base, n_rows - rows), out=part[i])
        nck.normal_cycle_part(s.nodestate, s.victims, s.drain, *e, req=req,
                              spec=spec, base=s.base, out=recs[i])
        r = torch.from_numpy(np.pad(rep, (0, n_rows - len(rep)))[
            s.base:s.base + rows].astype(np.int32)).to(c0)
        psk.prescreen(s.nodestate, s.victims, *e, r, e[0], k=k, req=req,
                      spec=spec, out=outs[i], base=s.base, sel=keys[i])
    torch_sync(dev)
    last = shards[-1]
    tail_kw = dict(resident=True, seg=rows, req=req, spec=spec,
                   base=last.base, shard=(rows, last.base, n_rows - rows))
    prior_part = part[:-1].contiguous()
    prior_recs = recs[:-1].contiguous()
    la = (last.nodestate, last.victims, last.drain, *e)
    u = SHARDS_D * k
    #: the reference's sharded programs whose cross-shard collectives each
    #: merge stands in for
    replaces = {"tail_merge": 398, "normal_merge": 427,
                "prescreen_select": 458}
    folds = {
        "tail_merge": (
            lambda: fc.fused_argmax(cls, *la[:2], *e, e[0], prior=prior_part,
                                    **tail_kw),
            lambda: fc.fused_argmax(cls, *la[:2], *e, e[0], **tail_kw),
            lambda: fc.tail_merge_plain(part, True),
            "fused_argmax_kernel", "fused_argmax_kernel<true, true> (the "
            "last shard's tail, with the earlier shards' records)",
            prior_part.numel() * 4 + 9 * 4, SHARDS_D * 32, [SHARDS_D, 1]),
        "normal_merge": (
            lambda: nck.normal_cycle(*la, req=req, spec=spec, base=last.base,
                                     prior=prior_recs),
            lambda: nck.normal_cycle(*la, req=req, spec=spec,
                                     base=last.base),
            lambda: nck.normal_merge_plain(recs, req, spec),
            "normal_cycle_kernel", "normal_cycle_kernel<false, true> (the "
            "last shard's K2, with the earlier shards' records)",
            prior_recs.numel() * 4 + 5 * 4,
            recs.shape[0] * recs.shape[1] * 32, [SHARDS_D, recs.shape[1]])}
    check(torch.equal(folds["tail_merge"][0]()[0], folds["tail_merge"][2]()[0])
          and torch.equal(folds["normal_merge"][0](),
                          folds["normal_merge"][2]()),
          "the folded merges at the timing shape differ from their plain "
          "versions")
    out = []
    for name, (fn, without, plain, sym, into, n_bytes, n_ops,
               shape) in folds.items():
        b_ms, b_by = bound_ms(n_bytes, n_ops, INT_OPS_PER_S)
        t = fold_ms(torch, fn, without, sym)
        added = t["kernel_ms"] if t["kernel_ms"] is not None else t["ms"]
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topo_score.cu",
            "kernel": into, "folded": True, "standalone_launches": 0,
            "replaces": "src/repro/core/cluster_parallel.py:"
                        f"{replaces[name]}",
            "replaces_fn": "the cross-shard collectives XLA inserts into "
                           "the sharded fused programs (no Pallas kernel)",
            "launches": launches[name], "on_main_path": launches[name] > 0,
            "launches_per_plan": launches[name] / plans,
            "max_abs_err": errs[name], "shape": shape, **t,
            "plain_ms": event_ms(torch, plain, reps=5, inner=3),
            "bytes": n_bytes, "int_ops": n_ops, "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_share": b_ms / added if added > 0 else None,
            "library_ms": None})
    name = "prescreen_select"
    fn = lambda: psk.prescreen_select(keys, k=k, excl=outs[:, k])  # noqa
    n_bytes = u * 8 + SHARDS_D * 4 + (k + 1) * 4
    b_ms, b_by = bound_ms(n_bytes, u * int(np.ceil(np.log2(u))),
                          INT_OPS_PER_S)
    ms = event_ms(torch, fn)
    kernel_ms = profiled_kernel_ms(torch, fn, "prescreen_union_kernel")
    flipped = keys.reshape(-1) ^ torch.tensor(-2**63, dtype=torch.int64,
                                              device=c0)
    out.append({
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topo_score.cu",
        "kernel": "prescreen_union_kernel",
        "replaces": f"src/repro/core/cluster_parallel.py:{replaces[name]}",
        "replaces_fn": "the cross-shard collectives XLA inserts into "
                       "the sharded fused programs (no Pallas kernel)",
        "launches": launches[name], "on_main_path": launches[name] > 0,
        "launches_per_plan": launches[name] / plans,
        "max_abs_err": errs[name], "shape": [SHARDS_D, k], "ms": ms,
        "kernel_ms": kernel_ms,
        "plain_ms": event_ms(torch, lambda: psk.prescreen_select_plain(
            keys, k, outs[:, k]), reps=5, inner=3),
        "bytes": n_bytes, "int_ops": u * int(np.ceil(np.log2(u))),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_share": b_ms / (kernel_ms or ms),
        "library_ms": event_ms(torch, lambda: torch.topk(flipped, k + 1)),
        "library": "torch.topk(keys ^ (1 << 63), k + 1)"})
    return out


# ---------------------------------------------------------------------------------
# Phase 7: timing and bounds
# ---------------------------------------------------------------------------------

def event_ms(torch, fn, reps: int = 15, inner: int = 40) -> float:
    """Median over reps of the CUDA-event time of `inner` calls, per call."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def l2_flush(torch):
    """A function that writes L2_FLUSH_BYTES of scratch on the card, so
    that the next launch finds none of its inputs in the L2."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                          device="cuda")
    return lambda: scratch.fill_(1)


def flushed_event_ms(torch, fn, flush, reps: int = 30) -> float:
    """Median CUDA-event time of one call of `fn`, each after `flush`
    (outside the events)."""
    for _ in range(3):
        flush()
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush()
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def profiled_kernels_ms(torch, fn, pattern: str, calls: int = 40,
                        attempts: int = 3, before=None) -> dict[str, float]:
    """Device time per launch of each kernel whose name matches the regular
    expression `pattern` (keyed by its first group), from torch.profiler;
    empty where the profiler records no device time for any.  `before`,
    where given, runs ahead of each call (an L2 flush, whose kernel is not
    counted).  The profiler has come back without the device records of
    the ctypes-launched kernels now and then (one of six fused timings in a
    run), so an empty window is profiled again, up to ``attempts`` times."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        total: dict[str, float] = {}
        count: dict[str, int] = {}
        for ev in prof.key_averages():
            m = re.search(pattern, ev.key)
            if m:
                k = m.group(1)
                total[k] = total.get(k, 0.0) + getattr(
                    ev, "device_time_total", getattr(ev, "cuda_time_total",
                                                     0.0))
                count[k] = count.get(k, 0) + ev.count
        if any(count.values()) and sum(total.values()) > 0:
            return {k: total[k] / count[k] / 1e3 for k in total if count[k]}
    return {}


def profiled_kernel_ms(torch, fn, kernel, calls: int = 40,
                       attempts: int = 3, before=None):
    """Device time per launch of `kernel` from torch.profiler, or None where
    the profiler records no device time for it; `kernel` a tuple of names,
    each launched once a call of `fn`: the sum of their times a launch."""
    import re

    names = kernel if isinstance(kernel, tuple) else (kernel,)
    split = profiled_kernels_ms(
        torch, fn, "(" + "|".join(re.escape(k) for k in names) + ")", calls,
        attempts, before)
    return sum(split.values()) if split else None


def bound_ms(n_bytes: float, flops: float,
             flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rates(flops: float, b_ms: float, ms: float, kernel_ms) -> dict:
    """The function's operations over the kernel's time in TFLOP/s, and
    the share of the bound it reaches: by the device time a launch where
    the profiler gave one, else by the time a call."""
    t = kernel_ms or ms
    return {"tflops": flops / t / 1e9, "bound_share": b_ms / t}


def timing_phase(torch, np, dev, errs, launches, plans: dict) -> list[dict]:
    """The lane kernels' rows; ``plans`` the plans of each kernel's path
    (by name, ``None`` for the rest)."""
    from repro_torch.core.topology import RTX4090_SERVER as spec
    from repro_torch.kernels import topo_score as ts

    req = ts.TopoRequest(2, 2, 1, alpha=0.5)
    rows = []
    per_kernel = {
        # name: (reference function, its line, CUDA kernel symbol, bytes
        #        per lane, f32 operations per lane, main-path shape)
        "topo_score_argmax": ("topo_score_argmax_pallas", 214,
                              "topo_score_argmax_kernel", 28, 4, 256),
        "topo_score": ("topo_score_pallas", 178, "topo_score_kernel", 20, 4,
                       256),
        "placement_tier": ("placement_tier_pallas", 285,
                           "placement_tier_kernel", 12, 0, 1024),
    }
    flush = l2_flush(torch)
    for name, (ref_fn, ref_line, sym, bpl, fpl, main_n) in per_kernel.items():
        shapes = []
        # K2 and K3 also at 1024 lanes and their bandwidth shape
        big = (1024, BIG_LANES) if name != "topo_score_argmax" else ()
        for n in sorted({main_n, *SIZES, *big}):
            g, c, p, k, ok = lanes(torch, np, spec, n, seed=n, dev=dev)
            if name == "topo_score_argmax":
                def fn(): return ts.topo_score_argmax(g, c, p, k, spec, req, ok=ok)
                def plain(): return ts.topo_score_argmax_plain(g, c, p, k, spec, req, ok=ok)
                extra = 16 * -(-n // ts.TILE)   # per-tile outputs
            elif name == "topo_score":
                def fn(): return ts.topo_score(g, c, p, spec, req)
                def plain(): return ts.topo_score_plain(g, c, p, spec, req)
                extra = 0
            else:
                def fn(): return ts.placement_tier(g, c, spec, req)
                def plain(): return ts.placement_tier_plain(g, c, spec, req)
                extra = 0
            b_ms, b_by = bound_ms(bpl * n + extra, fpl * n)
            cold = n == BIG_LANES       # each launch after an L2 flush
            # the plain version takes ~5 ms a call: ten calls time it
            plain_ms = event_ms(torch, plain, reps=5, inner=2)
            if cold:
                ms = flushed_event_ms(torch, fn, flush)
            else:
                ms = event_ms(torch, fn)
            before = flush if cold else None
            kernel_ms = profiled_kernel_ms(torch, fn, sym, before=before)
            shapes.append({
                "n": n, "l2_flushed": cold, "ms": ms, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, **rates(fpl * n, b_ms, ms, kernel_ms)})
            if big and n in (1024, BIG_LANES):
                shapes[-1]["kernel_ms_tier"] = tier_forms(
                    torch, fn, (sym,), before=before)
        main = next(s for s in shapes if s["n"] == main_n)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topo_score.cu",
            "replaces": f"src/repro/kernels/topo_score.py:{ref_line}",
            "replaces_fn": ref_fn,
            "launches": launches[name], "on_main_path": launches[name] > 0,
            "launches_per_plan": launches[name] / plans.get(name,
                                                            plans[None]),
            "max_abs_err": errs[name], "shape": [main_n],
            "ms": main["ms"], "kernel_ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "tflops": main["tflops"],
            "bound_share": main["bound_share"], "library_ms": None,
            "shapes": shapes,
        })
    return rows


#: an upper rate for the integer work of the fused kernels: the card's f32
#: rate (the published table gives none for int32, whose pipes are no
#: faster), so the operations bound stays a lower bound
INT_OPS_PER_S = F32_FLOP_PER_S


def sweep_ops(torch, ns, v, dr, m: int, gate: bool, req, spec) -> float:
    """Integer operations the class sweep needs on these rows: every
    subset of a row's eligible slots (rows that pass Filtering and the
    gate), at 6 a set slot (fold, sums, bit scan) plus 12 a NUMA node, 4 a
    socket and 20 for the tier, count and key updates (fused_class_kernel
    in csrc/topo_score.cu)."""
    from repro_torch.core.placement_device import best_tier_counts, spec_slices

    sl = spec_slices(spec, ns.device)
    tier, _, _ = best_tier_counts(dr[0], dr[1], req.need_gpus, req.need_cgs,
                                  req.cgs_per_bundle, sl)
    ok = (tier < 3) & (ns[2] < SENTINEL)
    elig = (v[4] != 0) & (v[2] < req.thresh)
    if gate:
        ok &= (elig.sum(1) <= m) & ~((ns[3] != 0) & (ns[4] < req.thresh))
    k = elig[:, :m].sum(1).to(torch.float64)
    per = 12 * spec.num_numa + 4 * spec.num_sockets + 20
    ops = torch.where(ok, 2.0 ** k * per + 6 * k * 2.0 ** (k - 1), 0.0)
    return float(ops.sum())


def fused_rows(torch, np, dev, errs, launches, plans, clusters,
               sweep) -> list[dict]:
    """The fused engine's kernels at the main path's shapes (preemptor B on
    the saturated 1024- and 10240-node clusters, no patch rows): time per
    call as the engine calls them (one launch state for the plan's chain;
    ``ms_checked``: each call checks its tensors), device time per launch,
    plain version, bound; K2's and the tail's rows carry ``sweep``
    (`cluster_sweep`), and K2's shapes its device time in both forms."""
    from repro_torch.core.preemption_device import (_pad_idx, _request,
                                                    split_fused_nodes)
    from repro_torch.core.workload import table3_workloads
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import normal_cycle as nck

    wl = {w.name: w for w in table3_workloads()}["B"]
    shapes = {"fused_class": [], "fused_argmax": [], "normal_cycle": []}
    for n in sorted(clusters):
        dcs = clusters[n].device_state().sync()
        spec = clusters[n].spec
        req = _request(spec, wl, 0.5)
        split = split_fused_nodes(dcs, {}, wl.priority)
        gidx = torch.from_numpy(_pad_idx(split.mid) if split.mid else
                                np.zeros(0, np.int32)).to(dev)
        pidx = torch.zeros(0, dtype=torch.int32, device=dev)
        pbuf = torch.zeros((0, 87), dtype=torch.int32, device=dev)
        ns, v, dr = dcs.nodestate, dcs.victims, dcs.drain
        cap, rows = v.shape[2], n + gidx.shape[0]
        kw = dict(m_res=split.m_res, resident=True, m_gather=8, req=req,
                  spec=spec)
        cls = fc.fused_class(ns, v, dr, pidx, pbuf, gidx, **kw)
        tkw = dict(resident=True, seg=rows, req=req, spec=spec)
        win = fc.fused_argmax(cls, ns, v, pidx, pbuf, gidx,
                              **tkw).reshape(-1).tolist()
        n_mid = len(split.mid)
        # the sweep reads a resident row's 5 node fields, its 2 drain masks,
        # priority and stored of every slot and GPU mask, CG mask and rank
        # of its first m_res; a gathered row its index, 2 node fields, the
        # drain and the same slots at m_gather 8 (a pad index only itself);
        # it writes 15 int32 a row
        class_bytes = (n * (5 + 2 + 2 * cap + 3 * split.m_res)
                       + n_mid * (1 + 2 + 2 + 2 * cap + 3 * 8)
                       + (gidx.shape[0] - n_mid) + 15 * rows) * 4
        # the tail reads 12 class fields a row (any, priority sum, uid mask
        # of each tier, k, count, node id), then the winner's combo id, its
        # free masks and the GPU and CG masks of its k victims; it writes 9
        k_win = bin(win[3] & 0xFFFFFFFF).count("1")
        tail_bytes = (12 * rows + 1 + (win[1] >= n) + 2 + 2 * k_win + 9) * 4
        st = fc.launch_state(ns, v, dr, pidx, pbuf, None, resident=True)
        ops = sweep_ops(torch, ns, v, dr, split.m_res, True, req, spec)
        if split.mid:
            g = gidx[:len(split.mid)].long()
            ops += sweep_ops(torch, ns[:, g], v[:, g], dr[:, g], 8, False,
                             req, spec)
        def fresh(fn):
            """fn with its launch state checked anew each call."""
            def call():
                fc.launch_state.cache_clear()
                return fn()
            return call

        cls_fn = lambda: fc.fused_class(ns, v, dr, pidx, pbuf, gidx, **kw)
        tail_fn = lambda: fc.fused_argmax(cls, ns, v, pidx, pbuf, gidx,
                                          **tkw)
        k2_fn = lambda: nck.normal_cycle(ns, v, dr, pidx, pbuf, req=req,
                                         spec=spec)
        work = {
            "fused_class": (
                cls_fn, fresh(cls_fn),
                lambda: fc.fused_class_plain(ns, v, dr, pidx, pbuf, gidx,
                                             **kw),
                "fused_class_kernel", class_bytes, ops),
            "fused_argmax": (
                tail_fn, fresh(tail_fn),
                lambda: fc.fused_argmax_plain(cls, ns, v, pidx, pbuf, gidx,
                                              **tkw),
                "fused_argmax_kernel", tail_bytes, 3 * rows * 20),
            "normal_cycle": (
                k2_fn, fresh(k2_fn),
                lambda: nck.normal_cycle_plain(ns, v, dr, pidx, pbuf, req,
                                               spec),
                K2_KERNELS, 3 * n * 4 + 20,
                n * (12 * spec.num_numa + 4 * spec.num_sockets + 20)),
        }
        for name, (fn, checked, plain, sym, n_bytes, n_ops) in work.items():
            b_ms, b_by = bound_ms(n_bytes, n_ops, INT_OPS_PER_S)
            ms = event_ms(torch, fn)
            kernel_ms = profiled_kernel_ms(torch, fn, sym)
            shapes[name].append({
                "nodes": n, "rows": rows, "m_res": split.m_res,
                "mid_rows": len(split.mid), "ms": ms,
                "ms_checked": event_ms(torch, checked), "kernel_ms": kernel_ms,
                "plain_ms": event_ms(torch, plain, reps=5, inner=3),
                "bytes": n_bytes, "int_ops": n_ops, "bound_ms": b_ms,
                "bound_by": b_by,
                "bound_share": b_ms / (kernel_ms or ms)})
        shapes["normal_cycle"][-1]["kernel_ms_tier"] = tier_forms(
            torch, k2_fn, K2_KERNELS)
        shapes["fused_class"][-1]["kernel_ms_tier"] = tier_forms(
            torch, cls_fn, ("fused_class_kernel",))
        sweep_st = fc.launch_state(ns, v, dr, pidx, pbuf, gidx, True)
        shapes["fused_class"][-1]["kernel_ms_geometry"] = {
            str(list(g)): profiled_kernel_ms(
                torch, lambda g=g: fc.launch_class(
                    sweep_st, split.m_res, 8, req, spec, geometry=g),
                "fused_class_kernel")
            for g in sweep_geometries(fc, split.m_res, n, 8, sweep_st.g)}
        shapes["fused_argmax"][-1]["kernel_ms_tier"] = tier_forms(
            torch, tail_fn, ("fused_argmax_kernel",))
        most = fc.max_cluster_ctas(st.device)
        shapes["normal_cycle"][-1]["kernel_ms_forms"] = {
            form: profiled_kernel_ms(torch, lambda g=g: nck.launch(
                st, req, spec, geometry=g), K2_KERNELS)
            for form, g in (("one_cluster", nck.normal_geometry(
                n, most, split_nodes=n)), ("split", nck.normal_geometry(
                    n, most, split_nodes=0)))}
    ref = {"fused_class": ("topo_score_argmax_pallas", 214,
                           "resident form: preemption_jax.py:445 "
                           "_fused_class_core"),
           "fused_argmax": ("topo_score_argmax_pallas", 214,
                            "its tail: preemption_jax.py:567 "
                            "_fused_argmax_core + placement_jax.py:295 "
                            "winner_place"),
           "normal_cycle": ("placement_tier_pallas", 285,
                            "normal-cycle form: placement_jax.py:247 "
                            "normal_cycle_core")}
    rows_out = []
    for name, got in shapes.items():
        main = got[0]                       # 1024 nodes: the main path's
        fn_name, line, form = ref[name]
        rows_out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topo_score.cu",
            "replaces": f"src/repro/kernels/topo_score.py:{line}",
            "replaces_fn": f"{fn_name} ({form})",
            "launches": launches[name], "on_main_path": launches[name] > 0,
            "launches_per_plan": launches[name] / plans,
            "max_abs_err": errs[name], "shape": [main["rows"]],
            "ms": main["ms"], "kernel_ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "bound_share": main["bound_share"], "library_ms": None,
            "shapes": got,
        })
        if name in sweep:
            rows_out[-1]["geometry_sweep"] = sweep[name]
    return rows_out


#: eligible victims a row of `sweep_timing`'s states, and their rows
SWEEP_E = (1, 2, 3, 4, 5, 6, 7, 8)
SWEEP_ROWS = 10240


def sweep_timing(torch, np, dev) -> dict:
    """The class sweep's device time a launch on random RTX 4090 states of
    `SWEEP_ROWS` rows in which every row stores exactly e victims, all
    eligible (preemptor priority 2000), for e in `SWEEP_E` (m_res 8, no
    patch or gathered rows); and the wide form on three 16-row chunks of
    A100 rows with 9 to 16 eligible victims (m 16), as the engine
    dispatches them.  Each beside its bound (`sweep_ops`, the bytes of
    ``fused_rows``) and checked against the plain version."""
    from repro_torch.core.topology import A100_SERVER, RTX4090_SERVER
    from repro_torch.kernels import fused_class as fc

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    empty = (t(np.zeros(0, np.int32)), t(np.zeros((0, 87), np.int32)))
    out = {"e_states": [], "wide": None}
    req = fc.FusedRequest(2000, 2, 2, 1, 0.5)
    spec = RTX4090_SERVER
    for e in SWEEP_E:
        ns, v, dr = (t(x) for x in resident_state(
            np, spec, SWEEP_ROWS, e, 77 + e, min_victims=e))
        kw = dict(m_res=8, resident=True, m_gather=8, req=req, spec=spec)
        fn = lambda: fc.fused_class(ns, v, dr, *empty, empty[0], **kw)
        compare(torch, [fn()], [fc.fused_class_plain(ns, v, dr, *empty,
                                                     empty[0], **kw)],
                f"fused_class e={e}")
        n_bytes = (SWEEP_ROWS * (5 + 2 + 2 * v.shape[2] + 3 * 8)
                   + 15 * SWEEP_ROWS) * 4
        b_ms, b_by = bound_ms(n_bytes, sweep_ops(torch, ns, v, dr, 8, True,
                                                 req, spec), INT_OPS_PER_S)
        out["e_states"].append({
            "e": e, "rows": SWEEP_ROWS,
            "geometry": list(fc.sweep_geometry(8, SWEEP_ROWS, 8, 0,
                                               fc.sm_count(0))),
            "ms": event_ms(torch, fn, reps=7),
            "kernel_ms": profiled_kernel_ms(torch, fn, "fused_class_kernel"),
            "bound_ms": b_ms, "bound_by": b_by})
    spec = A100_SERVER
    ns, v, dr = (t(x) for x in resident_state(np, spec, 64, 16, 91,
                                              min_victims=9))
    gidx = t(np.arange(0, 64, 4, dtype=np.int32).repeat(3)[:48] + np.tile(
        np.arange(3, dtype=np.int32), 16))
    kw = dict(m_res=16, resident=False, m_gather=16, req=req, spec=spec)
    fn = lambda: fc.fused_class(ns, v, dr, *empty, gidx, **kw)
    compare(torch, [fn()], [fc.fused_class_plain(ns, v, dr, *empty, gidx,
                                                 **kw)], "fused_class wide")
    g = gidx.long()
    n_bytes = (48 * (1 + 2 + 2 + 2 * v.shape[2] + 3 * 16) + 15 * 48) * 4
    b_ms, b_by = bound_ms(n_bytes, sweep_ops(torch, ns[:, g], v[:, g],
                                             dr[:, g], 16, False, req, spec),
                          INT_OPS_PER_S)
    out["wide"] = {
        "spec": spec.name, "rows": 48, "m": 16,
        "eligible": [int(x) for x in (v[4, g] != 0).sum(1).tolist()],
        "ms": event_ms(torch, fn, reps=7),
        "plain_ms": event_ms(torch, lambda: fc.fused_class_plain(
            ns, v, dr, *empty, gidx, **kw), reps=3, inner=1),
        "kernel_ms": profiled_kernel_ms(torch, fn, "fused_class_kernel"),
        "bound_ms": b_ms, "bound_by": b_by}
    print(f"[sweep-timing] {json.dumps(out)}", flush=True)
    return out


def launch_floor(torch) -> dict:
    """An empty kernel (one warp), launched through the same ctypes path
    as the kernels and timed the same ways: how much of a kernel's few
    microseconds is the launch."""
    from repro_torch.kernels import fused_class as fc

    lib = fc.lib()
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        code = lib.empty_launch(stream)
        check(code == 0, f"empty_launch: CUDA error {code}")

    out = {"ms": event_ms(torch, fn),
           "kernel_ms": profiled_kernel_ms(torch, fn, "empty_kernel")}
    print(f"[floor] empty kernel {json.dumps(out)}", flush=True)
    return out


#: K2's kernel: one launch in the one-cluster and in the split form
K2_KERNELS = ("normal_cycle_kernel",)
#: the define that builds every kernel of csrc/topo_score.cu on tier_of
#: (the reference's rule written out, tier_score) in place of fused_tier:
#: the yardstick the tier function is timed against
TIER_YARDSTICK = ("FUSED_TIER_BY_TIER_SCORE",)


@contextlib.contextmanager
def launching_from(library):
    """Inside the block every wrapper of csrc/topo_score.cu's kernels
    launches from ``library`` (a build of it with the same interface)."""
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import normal_cycle as nck
    from repro_torch.kernels import topo_score as ts

    saved = fc.lib, nck.lib, ts._lib
    fc.lib = nck.lib = ts._lib = lambda: library
    try:
        yield
    finally:
        fc.lib, nck.lib, ts._lib = saved


def yardstick_lib():
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import topo_score as ts

    return fc.bind(ts.bind(_build.load("topo_score", TIER_YARDSTICK)))


def tier_forms(torch, fn, kernels, before=None) -> dict[str, list]:
    """Device time a call of ``fn`` launched from this build (fused_tier)
    and from the yardstick build (tier_of), in the order A, B, B, A, each
    call after ``before`` where given; the two builds' outputs must agree
    bit for bit."""
    yard = yardstick_lib()
    got = {"fused_tier": [], "tier_of": []}
    outs = {}
    for form in ("fused_tier", "tier_of", "tier_of", "fused_tier"):
        ctx = (launching_from(yard) if form == "tier_of"
               else contextlib.nullcontext())
        with ctx:
            got[form].append(profiled_kernel_ms(torch, fn, kernels,
                                                before=before))
            out = fn()
            outs[form] = [x.clone() for x in (
                out if isinstance(out, tuple) else (out,))]
    check(all(torch.equal(*(x.view(torch.int32) if x.is_floating_point()
                            else x for x in pair))
              for pair in zip(outs["fused_tier"], outs["tier_of"])),
          f"{kernels}: the fused_tier and tier_of builds disagree")
    return got
#: node counts of `cluster_sweep`
SWEEP_NODES = (128, 1024, 4096, 8192, 10240, 12288, 16384, 24576, 40960)


def cluster_sweep(torch, np, dev) -> dict[str, list]:
    """Device time a call of K2's normal-cycle form (one cluster, and split)
    and of K1's tail on random resident states from 128 to 40960 nodes (RTX
    4090 servers, preemptor B's request), without and with 9 patch rows:
    how the cluster kernels' time grows with N, where K2's split form
    overtakes one cluster (`normal_cycle.SPLIT_NODES`), and what patch rows
    add."""
    from repro_torch.core.topology import RTX4090_SERVER as spec
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import normal_cycle as nck

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    req = fc.FusedRequest(1000, 2, 2, 1, 0.5)
    out = {"normal_cycle": [], "fused_argmax": []}
    for n in SWEEP_NODES:
        ns, v, dr = (t(x) for x in resident_state(np, spec, n, 8, n))
        gidx = t(np.zeros(0, np.int32))
        for count in (0, 9):
            if count:
                pidx, pbuf = (t(x) for x in patch_rows(np, spec, n, count,
                                                       n + 5, 8))
            else:
                pidx, pbuf = gidx, t(np.zeros((0, 87), np.int32))
            cls = fc.fused_class(ns, v, dr, pidx, pbuf, gidx, m_res=8,
                                 resident=True, m_gather=8, req=req,
                                 spec=spec)
            st = fc.launch_state(ns, v, dr, pidx, pbuf, None, resident=True)
            most = fc.max_cluster_ctas(st.device)
            k2 = {form: nck.normal_geometry(n, most, split_nodes=cut)
                  for form, cut in (("one_cluster", n), ("split", 0))}
            row = {"nodes": n, "patch_rows": count,
                   "auto": list(nck.normal_geometry(n, most))}
            for form, g in k2.items():
                fn = (lambda g=g: nck.launch(st, req, spec, geometry=g))
                row[form] = {"geometry": list(g),
                             "ms": event_ms(torch, fn, reps=7),
                             "kernel_ms": profiled_kernel_ms(torch, fn,
                                                             K2_KERNELS)}
            row["tier_forms"] = tier_forms(
                torch, lambda: nck.normal_cycle(ns, v, dr, pidx, pbuf,
                                                req=req, spec=spec),
                K2_KERNELS)
            out["normal_cycle"].append(row)
            fn = (lambda: fc.fused_argmax(cls, ns, v, pidx, pbuf, gidx,
                                          resident=True, seg=n, req=req,
                                          spec=spec))
            out["fused_argmax"].append({
                "nodes": n, "patch_rows": count,
                "ctas_threads": list(fc.cluster_geometry(
                    n, fc.TAIL_THREADS, most)),
                "ms": event_ms(torch, fn, reps=7),
                "kernel_ms": profiled_kernel_ms(torch, fn,
                                                "fused_argmax_kernel"),
                "tier_forms": tier_forms(torch, fn,
                                         ("fused_argmax_kernel",))})
    print(f"[cluster-sweep] {json.dumps(out)}", flush=True)
    return out


def allowed_pairs(torch, shape) -> int:
    """The (query, key) pairs the shape's mask allows, counted on the
    reference's ``make_mask``."""
    from repro_torch.models.attention import make_mask

    Sq, Sk = shape[3], shape[4]
    m = mask_of(shape)
    return int(make_mask(Sq, Sk, causal=m["causal"], window=m["window"],
                         prefix_len=m["prefix_len"]).sum())


def flash_timing(torch, shape) -> dict:
    """Kernel, plain version and library call at one shape (bf16, its
    mask): the operations on the pairs the mask allows, the bytes of q, k,
    v read once and the output written once.  The library call is
    ``scaled_dot_product_attention``: ``is_causal`` for the causal mask
    (every shape timed causal has no window narrower than S), none for the
    bidirectional one, the boolean ``make_mask`` for the prefix-LM one."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import make_mask

    B, H, K, Sq, Sk, d = shape[:6]
    mask = mask_of(shape)
    q, k, v = flash_inputs(torch, shape, torch.bfloat16, seed=99)
    lib_kw = {"is_causal": mask["causal"]}
    if mask["prefix_len"]:
        lib_kw = {"attn_mask": make_mask(
            Sq, Sk, causal=True, window=mask["window"],
            prefix_len=mask["prefix_len"], device="cuda")[0, 0]}

    def fn(): return fa.flash_attention(q, k, v, **mask)
    def plain_fn(): return fa.flash_attention_plain(q, k, v, **mask)
    def library(): return F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **lib_kw)
    ke, ve = (t.repeat_interleave(H // K, dim=1) for t in (k, v))
    def library_expanded(): return F.scaled_dot_product_attention(
        q, ke, ve, **lib_kw)

    flops = 4 * d * B * H * allowed_pairs(torch, shape)
    n_bytes = 2 * (2 * B * H * Sq * d + 2 * B * K * Sk * d)
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S)
    ms = event_ms(torch, fn, inner=20)
    kernel_ms = profiled_kernel_ms(torch, fn, "flash_bf16_kernel")
    return {
        "shape": list(shape[:6]), "form": form_of(shape),
        "prefix_len": mask["prefix_len"], "ms": ms, "kernel_ms": kernel_ms,
        "plain_ms": event_ms(torch, plain_fn, reps=5, inner=5),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
        "bytes": n_bytes, **rates(flops, b_ms, ms, kernel_ms),
        "library_ms": event_ms(torch, library, reps=10, inner=10),
        "library_kv_expanded_ms": event_ms(torch, library_expanded, reps=10,
                                           inner=10)}


def flash_row(torch, errs, launches) -> dict:
    main = flash_timing(torch, MAIN_FLASH)
    wide = flash_timing(torch, FLASH_SHAPES[6])
    seamless_self = flash_timing(torch, SEAMLESS_SELF)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "replaces_fn": "flash_attention",
        "launches": launches, "on_main_path": launches > 0,
        "max_abs_err": errs["bfloat16"], "max_abs_err_f32": errs["float32"],
        "shape": main["shape"], "dtype": "bfloat16",
        "ms": main["ms"], "kernel_ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "tflops": main["tflops"],
        "bound_share": main["bound_share"], "library_ms": main["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True)",
        "library_kv_expanded_ms": main["library_kv_expanded_ms"],
        "shapes": [main, wide, seamless_self],
    }


def flash_form_row(torch, errs, form: str, launches: int) -> dict:
    """K4 in one of its other forms, at the shape [families] gives it:
    bidirectional at seamless-m4t-medium's encoder (and timed at the
    cross-attention shape), prefix-LM at paligemma-3b's prefill."""
    shapes = {"bidirectional": (SEAMLESS_ENC, SEAMLESS_CROSS),
              "prefix": (PALIGEMMA,)}[form]
    timed = [flash_timing(torch, shape) for shape in shapes]
    main = timed[0]
    return {
        "name": f"flash_attention_{form}", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "replaces_fn": "flash_attention" + (
            "; src/repro/models/attention.py:135 _gqa_attend_chunked"
            if form == "prefix" else ""),
        "launches": launches, "on_main_path": launches > 0,
        "max_abs_err": errs[f"bfloat16_{form}"],
        "max_abs_err_f32": errs[f"float32_{form}"], **main,
        "dtype": "bfloat16",
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   + ("enable_gqa=True)" if form == "bidirectional" else
                      "attn_mask=make_mask(prefix_len=P), enable_gqa=True)"),
        "shapes": timed}


#: ``wkv6_scan``'s row: rwkv6-7b's prefill (B, S, H); ``rglru_scan``'s:
#: recurrentgemma-9b's (B, S, R)
WKV_SHAPE = (4, 1024, 64)
RGLRU_SHAPE = (4, 1024, 4096)
#: the sequence lengths each scan is also held to its plain version at,
#: from a carried state: a decode step, and a prefill that ends inside a
#: chunk of either kernel; ``chunk_check_s`` adds each kernel's chunk
#: boundaries
SCAN_CHECK_S = (1, 1023)
#: |kernel - plain| <= SCAN_TOL * max |plain|, f32 (the kernels sum in
#: other orders than the plain versions: the WKV kernel by chunks, its
#: products as split TF32 on the tensor cores; the rg-lru's slices compose)
SCAN_TOL = 1e-5
#: peak TF32 tensor-core rate of an H100 SXM (dense)
TF32_FLOP_PER_S = 495e12


def chunk_check_s(name: str) -> tuple[int, ...]:
    """S at which ``name`` is held to its plain version: SCAN_CHECK_S and,
    for the kernel's chunk of L steps, L - 1, L, L + 1, a ragged 2L + 3
    and the row's own S."""
    from repro_torch.kernels import recurrent as rk

    L = rk.WKV_CHUNK if name == "wkv6_scan" else rk.RG_CHUNK
    full = (WKV_SHAPE if name == "wkv6_scan" else RGLRU_SHAPE)[1]
    return tuple(sorted({*SCAN_CHECK_S, L - 1, L, L + 1, 2 * L + 3, full}))


def scan_inputs(torch, name: str, S: int, seed: int, dtype=None,
                extreme: bool = False) -> tuple:
    """Seeded inputs of one scan at its row's shape with S steps, r/k/v
    (or x) in ``dtype`` (bf16 by default); the carried state (s0, h0) is
    non-zero.  ``extreme``: the WKV log-decays are each at the model's clip
    top 6 (w exactly 0), at its floor -10 (w = 1 - 4.5e-5) or drawn as
    usual, mixed within every chunk; the rg-lru's softplus(lam) is 30
    (a = 0 in f32 where the gate opens), 1e-13 (a = 1 in f32) or drawn, a
    channel each, under gates drawn 4x wider."""
    from repro_torch.kernels import recurrent as rk

    dtype = dtype or torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def pick(shape, a, b):
        """a where a draw is below -0.43, b above 0.43, else -1 (a third
        each)."""
        z = rn(*shape)
        return torch.where(z < -0.43, a, torch.where(z > 0.43, b, -1.0))

    if name == "wkv6_scan":
        B, _, H = WKV_SHAPE
        hd = rk.HEAD
        r, k, v = ((0.5 * rn(B, S, H, hd)).to(dtype) for _ in range(3))
        logw = rn(B, S, H, hd).clamp(-10, 6) - 2
        if extreme:
            sel = pick((B, S, H, hd), 6.0, -10.0)
            logw = torch.where(sel < 0, logw, sel)
        w = torch.exp(-torch.exp(logw))
        return r, k, v, w, 0.5 * rn(H, hd), 0.1 * rn(B, H, hd, hd)
    B, _, R = RGLRU_SHAPE
    scale = 4.0 if extreme else 1.0
    gr, gi = scale * rn(B, S, R), scale * rn(B, S, R)
    xc = rn(B, S, R).to(dtype)
    sp = torch.nn.functional.softplus(rn(R) + 3)
    if extreme:
        sel = pick((R,), 30.0, 1e-13)
        sp = torch.where(sel < 0, sp, sel)
    return gr, gi, xc, sp, rn(B, R)


def scan_error(torch, name: str, fn, plain_fn) -> tuple[float, float]:
    """The largest |kernel - plain| over both outputs, checked against
    SCAN_TOL times the plain outputs' largest magnitude."""
    got, want = fn(), plain_fn()
    torch.cuda.synchronize()
    err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    scale = max(float(p.abs().max()) for p in want)
    check(all(bool(torch.isfinite(g).all()) for g in got)
          and err <= SCAN_TOL * scale,
          f"{name}: max |diff| {err} against the plain version "
          f"(tolerance {SCAN_TOL} x {scale})")
    return err, scale


def scan_checks(torch, name: str, wrap, plain) -> dict:
    """``name`` against its plain version at every S of
    ``chunk_check_s``, in bf16 and f32 (r/k/v or x), on drawn inputs and
    on the extreme ones: {case: (max |diff|, tolerance)}."""
    out = {}
    seed = 11
    for dtype in (torch.bfloat16, torch.float32):
        for extreme in (False, True):
            for steps in chunk_check_s(name):
                x = scan_inputs(torch, name, steps, seed, dtype, extreme)
                seed += 1
                err, scale = scan_error(
                    torch, f"{name} S={steps} {dtype} extreme={extreme}",
                    lambda: wrap(*x), lambda: plain(*x))
                key = (f"{steps}{'' if dtype == torch.bfloat16 else '_f32'}"
                       f"{'_extreme' if extreme else ''}")
                out[key] = {"max_abs_err": err,
                            "tolerance": SCAN_TOL * scale}
    return out


def scan_work(name: str, B: int, S: int, W: int) -> dict:
    """The bytes (inputs read once, outputs written once) and operations
    of one call at (B, S, H or R), by the units that do them.  WKV: the
    recurrence's f32 operations (r S and the bonus 2 hd^2 + 5 hd, the state
    update 3 hd^2 a (b, h) and step) beside the chunked form's, whose
    products Q S (3 TF32 passes), A V and K^T V (2 each, v exact) run on
    the tensor cores and whose decay pass (P, A below the diagonal, K, D:
    3 operations a (t, s < t, channel), 2 a (t, channel)) on the f32
    pipe; a step after the last whole chunk is the recurrence's.  The
    rg-lru: 19 f32 operations an element, the exp and sqrt counted as
    one."""
    from repro_torch.kernels import recurrent as rk

    if name == "wkv6_scan":
        hd, L = rk.HEAD, rk.WKV_CHUNK
        whole = S // L * L
        n_bytes = (3 * B * S * W * hd * 2 + 2 * B * S * W * hd * 4
                   + W * hd * 4 + 2 * B * W * hd * hd * 4)
        rec = B * W * S * (5 * hd * hd + 5 * hd)
        tf32 = B * W * whole * 2 * (3 * hd * hd + 2 * L * hd + 2 * hd * hd)
        f32 = (B * W * (whole // L) * (3 * L * (L - 1) // 2 * hd
                                       + 4 * L * hd)
               + B * W * (S - whole) * (5 * hd * hd + 5 * hd))
        return {"bytes": n_bytes, "flops": rec, "tf32_flops": tf32,
                "f32_flops": f32}
    n_bytes = B * S * W * (4 + 4 + 2 + 4) + W * 4 + 2 * B * W * 4
    return {"bytes": n_bytes, "flops": 19 * B * S * W, "tf32_flops": 0,
            "f32_flops": 19 * B * S * W}


def scan_bound(work: dict) -> tuple[float, str]:
    """The least time of a call: the larger of its bytes at the memory's
    rate and its operations at the rate of the units that do them."""
    times = {"bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3,
             "operations": max(work["tf32_flops"] / TF32_FLOP_PER_S,
                               work["f32_flops"] / F32_FLOP_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def scan_rows(torch, launches: dict, decode_launches: dict) -> list[dict]:
    """The two scans against their plain versions on the card
    (``scan_checks``), then the prefill of the row and a decode step at
    its (B, H or R), each timed and bounded (``scan_work``)."""
    from repro_torch.kernels import recurrent as rk

    B, S, H = WKV_SHAPE
    B_, S_, R = RGLRU_SHAPE
    cases = (
        ("wkv6_scan", ("wkv6_kernel", "wkv6_kernel"), rk.wkv6_scan,
         rk.wkv6_scan_plain, (B, S, H),
         {"B": B, "S": S, "H": H, "hd": rk.HEAD, "dtype": "bfloat16"},
         "src/repro/models/recurrent.py:125 (lax.scan of "
         "rwkv_timemix_forward; XLA, no Pallas kernel)"),
        ("rglru_scan", ("rglru_kernel", "rglru_step_kernel"), rk.rglru_scan,
         rk.rglru_scan_plain, (B_, S_, R),
         {"B": B_, "S": S_, "R": R, "dtype": "bfloat16"},
         "src/repro/models/recurrent.py:234 (lax.associative_scan of "
         "rglru_block_forward, with _rglru_gates :205; XLA, no Pallas "
         "kernel)"),
    )
    rows = []
    for name, kernels, wrap, plain, (b, s, width), shape, replaces in cases:
        checked = scan_checks(torch, name, wrap, plain)
        for steps, kernel, suffix in ((s, kernels[0], ""),
                                      (1, kernels[1], "_decode")):
            x = scan_inputs(torch, name, steps, 7 + steps)
            err, scale = scan_error(torch, f"{name}{suffix}",
                                    lambda: wrap(*x), lambda: plain(*x))

            def fn(): return wrap(*x)
            def plain_fn(): return plain(*x)
            ms = event_ms(torch, fn, reps=10, inner=5 if steps > 1 else 40)
            kernel_ms = profiled_kernel_ms(torch, fn, kernel, calls=10)
            work = scan_work(name, b, steps, width)
            b_ms, b_by = scan_bound(work)
            count = (launches[name] if not suffix
                     else decode_launches[name])
            row = {
                "name": name + suffix, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/recurrent.cu",
                "replaces": replaces, "kernel": kernel, "launches": count,
                "on_main_path": count > 0, "max_abs_err": err,
                "tolerance": SCAN_TOL * scale, "shape": {**shape, "S": steps},
                "ms": ms, "kernel_ms": kernel_ms,
                "plain_ms": event_ms(torch, plain_fn, reps=3,
                                     inner=1 if steps > 1 else 10),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_ms_bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3,
                "bound_ms_f32_recurrence": work["flops"] / F32_FLOP_PER_S
                * 1e3, **work, **rates(work["flops"], b_ms, ms, kernel_ms),
                "library_ms": None}
            if not suffix:
                row["checked"] = checked
            if name == "wkv6_scan" and not suffix:
                # one CTA an SM: the kernel's time is its per-CTA latency
                x1 = tuple(t[:1] if t.dim() == 4 else t for t in x)
                row["kernel_ms_b1"] = profiled_kernel_ms(
                    torch, lambda: wrap(*x1), kernel, calls=10)
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------------
# The scans' backward: [scan-bwd] and their rows
# ---------------------------------------------------------------------------------

#: ``[scan-bwd]``: the S at which each backward kernel is held to its plain
#: version: one step, either side of its chunk (16 WKV steps, 32 rg-lru
#: steps), a ragged 2L + 3, for the WKV either side of a checkpoint segment
#: (``WKV_BWD_SEGMENT`` = 6 chunks) and the training S
SCAN_BWD_S = {"wkv6_scan_bwd": (1, 15, 16, 17, 35, 95, 96, 97, 1024),
              "rglru_scan_bwd": (1, 31, 32, 33, 67, 1024)}
#: |kernel - plain| <= SCAN_BWD_TOL x the gradient's largest |plain| (the
#: kernels sum in other orders than the plain versions); a bf16 gradient
#: (dr, dk, dv; dxc) also within its own rounding of the f32 result,
#: BF16_ROUNDING x |plain| an element
SCAN_BWD_TOL = 1e-5
BF16_ROUNDING = 2.0 ** -8
#: launches at the training shape that must be bit-identical
SCAN_BWD_REPEATS = 10
#: each backward's gradients, those in the compute dtype, and its kernels
#: (the sweep: for the WKV the chunked form, a CTA a (b, h); then the sum
#: over the batch)
SCAN_BWD = {
    "wkv6_scan_bwd": (("dr", "dk", "dv", "dw", "du", "ds0"),
                      ("dr", "dk", "dv"),
                      ("wkv6_bwd_kernel", "sum_parts_kernel")),
    "rglru_scan_bwd": (("dgr", "dgi", "dxc", "dsp", "dh0"), ("dxc",),
                       ("rglru_bwd_kernel", "sum_parts_kernel"))}


def scan_bwd_inputs(torch, name: str, S: int, seed: int, dtype=None,
                    extreme: bool = False) -> tuple:
    """Seeded inputs of a backward kernel at its scan's row shape with S
    steps: the forward's (`scan_inputs`, non-zero s0 and h0; WKV
    ``extreme``: log-decays at both ends of the clip, mixed within every
    chunk), for the rg-lru the forward kernel's output h and, ``extreme``,
    gr at -20 or +20 in a third of the elements each (a = 1 - 1e-7, where
    the sqrt's slope is steep, or 1 in f32, where it is infinite); then
    f32 cotangents of both outputs, non-zero."""
    from repro_torch.kernels import recurrent as rk

    wkv = name.startswith("wkv6")
    x = scan_inputs(torch, "wkv6_scan" if wkv else "rglru_scan", S, seed,
                    dtype, extreme and wkv)
    gen = torch.Generator("cuda").manual_seed(seed + 1000)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if wkv:
        B, _, H = WKV_SHAPE
        return (*x, rn(B, S, H, rk.HEAD), 0.1 * rn(B, H, rk.HEAD, rk.HEAD))
    gr, gi, xc, sp, h0 = x
    if extreme:
        z = rn(*gr.shape)
        gr = torch.where(z < -0.43, -20.0, torch.where(z > 0.43, 20.0, gr))
    with torch.no_grad():
        hs, _ = rk.rglru_scan(gr, gi, xc, sp, h0)
    B, _, R = RGLRU_SHAPE
    return gr, gi, xc, sp, h0, hs, rn(B, S, R), rn(B, R)


def grad_error(torch, what: str, got, want, rounding: bool) -> dict:
    """``got`` against the plain version's f32 ``want``: where ``want`` is
    finite, |got - want| <= SCAN_BWD_TOL x max |want| (+ BF16_ROUNDING x
    |want| with ``rounding``); the non-finite elements (an infinite slope)
    the same in both, NaN for NaN and inf for inf of the same sign."""
    g, w = got.float(), want.float()
    fin = torch.isfinite(w)
    inf = torch.isinf(w)
    same = (torch.equal(fin, torch.isfinite(g))
            and torch.equal(torch.isnan(w), torch.isnan(g))
            and torch.equal(g[inf], w[inf]))
    mag = w[fin].abs()
    diff = (g[fin] - w[fin]).abs()
    scale = float(mag.max()) if mag.numel() else 0.0
    allowed = SCAN_BWD_TOL * scale + (BF16_ROUNDING * mag if rounding
                                      else 0.0)
    err = float(diff.max()) if diff.numel() else 0.0
    check(same and bool((diff <= allowed).all()),
          f"{what}: max |diff| {err} against the plain version (tolerance "
          f"{SCAN_BWD_TOL} x {scale}{' + bf16 rounding' if rounding else ''}"
          f"; non-finite elements the same: {same})")
    return {"max_abs_err": err, "rel": err / scale if scale else 0.0,
            "nonfinite": int((~fin).sum())}


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (NaN too)."""
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


def scan_bwd_check(torch, rk, name: str, failures: list | None = None
                   ) -> dict:
    """``[scan-bwd]``'s check of one backward kernel: module ``rk``'s
    wrapper ``name`` against its plain version at every S of SCAN_BWD_S,
    r/k/v (or x) in bf16 and f32, on drawn and extreme inputs
    (`scan_bwd_inputs`), every gradient by `grad_error`; then
    SCAN_BWD_REPEATS launches at the training shape in bf16, bit-identical.
    Returns, per compute dtype, the largest error relative to its
    gradient's largest element.  A failed check raises `SmokeFailure`, or,
    with a list ``failures``, appends its message there."""

    def attempt(fn, *args):
        try:
            return fn(*args)
        except SmokeFailure as err:
            if failures is None:
                raise
            failures.append(str(err))
            return None

    grads, narrow, _ = SCAN_BWD[name]
    wrap, plain = getattr(rk, name), getattr(rk, name + "_plain")
    worst = {"bfloat16": 0.0, "float32": 0.0}
    abs_err = dict(worst)
    nonfinite = 0
    seed = 101
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        for extreme in (False, True):
            for S in SCAN_BWD_S[name]:
                x = scan_bwd_inputs(torch, name, S, seed, dtype, extreme)
                seed += 1
                got = wrap(*x)
                want = plain(*[t.float() for t in x])
                torch.cuda.synchronize()
                for gname, g, p in zip(grads, got, want):
                    e = attempt(
                        grad_error, torch, f"[scan-bwd] {name} S={S} {tag} "
                        f"extreme={extreme} {gname}", g, p,
                        dtype == torch.bfloat16 and gname in narrow)
                    if e is None:
                        continue
                    worst[tag] = max(worst[tag], e["rel"])
                    abs_err[tag] = max(abs_err[tag], e["max_abs_err"])
                    nonfinite += e["nonfinite"]
                del got, want, x
    x = scan_bwd_inputs(torch, name, SCAN_BWD_S[name][-1], 7)
    first = wrap(*x)
    for _ in range(SCAN_BWD_REPEATS - 1):
        again = wrap(*x)
        attempt(check, all(same_bits(torch, a, b)
                           for a, b in zip(first, again)),
                f"[scan-bwd] {name}: {SCAN_BWD_REPEATS} launches on one "
                "input are not bit-identical")
    del x, first, again
    torch.cuda.empty_cache()
    return {"cases": 4 * len(SCAN_BWD_S[name]),
            "max_rel_err": worst, "max_abs_err": abs_err,
            "nonfinite_elements_matched": nonfinite,
            "bit_identical_launches": SCAN_BWD_REPEATS}


def scan_bwd_phase(torch) -> dict:
    """``[scan-bwd]``: `scan_bwd_check` of each backward kernel of the
    package."""
    from repro_torch.kernels import recurrent as rk

    out = {name: scan_bwd_check(torch, rk, name) for name in SCAN_BWD}
    print(f"[scan-bwd] {json.dumps(out)}", flush=True)
    return out


def scan_bwd_work(name: str, B: int, S: int, W: int) -> dict:
    """Bytes (inputs read once, outputs written once; r/k/v or x in bf16)
    and operations of one backward call at (B, S, H or R), for
    `scan_bound`.  WKV: the recurrence's f32 operations a (b, h) and step
    (the states rebuilt, 3 hd^2; dr, dk, dv and dw, 2 hd^2 each; G's
    update, 3 hd^2), which a chunked form runs on the tensor cores as split
    TF32 (three passes); beside them this kernel's chunked form as it runs
    at bf16: its split-TF32 products (``form_tf32_flops``; p = 2 hd^2 L, one
    64 x 64 x L product: a chunk walked back takes C 2 x p/4, dQraw 3 p,
    dKraw 2 p, dV 3 x p/4 + 3 p, G 3 p, the half chunks' U and V 3 x p/8
    each and A's cross block 3 x p/8 (16-row tiles, half of them empty),
    107 p / 8 in all; each chunk run forward, in the first pass and the
    segments' rebuilds, 2 p) and its f32 operations on the CUDA cores
    (``form_f32_flops``, about 1730 a channel and chunk walked back: the
    row walk and the two walks within each half chunk, the decay products,
    rd and G's update; about 160 a chunk run forward).  The rg-lru: ~43 f32
    operations an element (the gates recomputed, the chain rule)."""
    from repro_torch.kernels import recurrent as rk

    if name == "wkv6_scan_bwd":
        hd, L, M = rk.HEAD, rk.WKV_CHUNK, rk.WKV_BWD_SEGMENT
        n = B * S * W * hd
        n_bytes = (n * (3 * 2 + 4 + 4) + n * (3 * 2 + 4) + 2 * W * hd * 4
                   + 3 * B * W * hd * hd * 4)
        flops = 14 * B * W * S * hd * hd
        nch = -(-S // L)
        nseg = -(-nch // M)
        forward = max(nch - 1, 0) + max(nseg - 1, 0) * (M - 1)
        p = 2 * hd * hd * L
        return {"bytes": n_bytes, "flops": flops, "tf32_flops": 3 * flops,
                "f32_flops": 0,
                "form_tf32_flops": B * W * (nch * 107 * p // 8
                                            + forward * 2 * p),
                "form_f32_flops": B * W * hd * (nch * 1730 + forward * 160)}
    n = B * S * W
    n_bytes = n * (4 + 4 + 2 + 4 + 4 + 4 + 4 + 2) + 2 * W * 4 + 3 * B * W * 4
    return {"bytes": n_bytes, "flops": 43 * n, "tf32_flops": 0,
            "f32_flops": 43 * n, "form_tf32_flops": 0, "form_f32_flops": 43 * n}


def scan_bwd_rows(torch, errs: dict, launches: dict) -> list[dict]:
    """The two backward kernels at the training shape (B 4, S 1024, H 64
    or R 4096, bf16): µs a call, each kernel's device µs a call, the plain
    version's µs, the bound (`scan_bound` of `scan_bwd_work`), the
    recurrence's operations on the f32 pipe and this form's on the f32
    pipe and the tensor cores beside it, the WKV's checkpoint bytes
    (written and read), the errors of ``[scan-bwd]`` and the launches of
    ``[train]``."""
    from repro_torch.kernels import recurrent as rk

    rows = []
    for name, (b, s, width), replaces in (
            ("wkv6_scan_bwd", WKV_SHAPE,
             "src/repro/models/recurrent.py:125 (the autodiff of the "
             "lax.scan of rwkv_timemix_forward; XLA, no Pallas kernel)"),
            ("rglru_scan_bwd", RGLRU_SHAPE,
             "src/repro/models/recurrent.py:234 (the autodiff of the "
             "lax.associative_scan of rglru_block_forward, with "
             "_rglru_gates :205; XLA, no Pallas kernel)")):
        _, _, kernels = SCAN_BWD[name]
        wrap, plain = getattr(rk, name), getattr(rk, name + "_plain")
        x = scan_bwd_inputs(torch, name, s, 7)
        xf = [t.float() for t in x]

        def fn(): return wrap(*x)
        def plain_fn(): return plain(*xf)
        ms = event_ms(torch, fn, reps=10, inner=5)
        split = profiled_kernels_ms(
            torch, fn, "(" + "|".join(kernels) + ")", calls=10)
        work = scan_bwd_work(name, b, s, width)
        b_ms, b_by = scan_bound(work)
        kernel_ms = sum(split.values()) if split else None
        err = errs[name]
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/recurrent_bwd.cu",
            "replaces": replaces, "kernel": kernels[0],
            "launches": launches[name], "on_main_path": launches[name] > 0,
            "max_abs_err": err["max_abs_err"]["bfloat16"],
            "max_abs_err_f32": err["max_abs_err"]["float32"],
            "max_rel_err": err["max_rel_err"]["bfloat16"],
            "max_rel_err_f32": err["max_rel_err"]["float32"],
            "shape": {"B": b, "S": s, ("H" if name.startswith("wkv6")
                                       else "R"): width,
                      "dtype": "bfloat16"},
            "ms": ms, "kernel_ms": kernel_ms, "kernel_ms_by_kernel": split,
            "plain_ms": event_ms(torch, plain_fn, reps=3, inner=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_ms_f32_recurrence": work["flops"] / F32_FLOP_PER_S * 1e3,
            "bound_ms_f32_form": work["form_f32_flops"] / F32_FLOP_PER_S
            * 1e3,
            "bound_ms_tf32_form": work["form_tf32_flops"] / TF32_FLOP_PER_S
            * 1e3,
            **work, **rates(work["flops"], b_ms, ms, kernel_ms),
            "library_ms": None}
        if name == "wkv6_scan_bwd":
            row["checkpoint_bytes"] = 2 * 4 * \
                rk._bwd_lib().wkv6_scan_bwd_workspace(b, width, s)
        del x, xf
        torch.cuda.empty_cache()
        rows.append(row)
    return rows


def flash_d256_row(torch, errs, launches: int) -> dict:
    """K4 at head dim 256: recurrentgemma-9b's local attention at its
    prefill (B 4, H 16, MQA, S 1024, bf16; the 2048 window spans it)."""
    t = flash_timing(torch, FLASH_D256)
    return {
        "name": "flash_attention_d256", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "replaces_fn": "flash_attention", "launches": launches,
        "on_main_path": launches > 0,
        "max_abs_err": errs["bfloat16_d256"],
        "max_abs_err_f32": errs["float32_d256"], **t,
        "dtype": "bfloat16",
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True)"}


#: the CUDA kernels of each traced engine's plan
TRACE_KERNELS = {"imp_pallas": ("topo_score_argmax_kernel",),
                 "imp_batched": ("fused_class_kernel", "fused_argmax_kernel",
                                 "normal_cycle_kernel",
                                 "prescreen_cluster_kernel",
                                 "prescreen_union_kernel",
                                 "encode_delta_kernel")}


def trace_phase(torch, dev, engine: str = "imp_pallas", nodes: int = 1024,
                cluster=None, plans: int = 1, attempts: int = 3) -> dict:
    """Where a plan's time goes on a saturated cluster: the device time of
    its kernels and copies (torch.profiler) over ``plans`` plans against
    their sourcing wall time, and the host functions that take the most of
    an untraced plan (cProfile).  A window in which the profiler recorded
    no device time is traced again, up to ``attempts`` times."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.scheduler import TopoScheduler
    from repro_torch.core.simulator import SimConfig, build_saturated_cluster
    from repro_torch.core.workload import table3_workloads
    from repro_torch.kernels import topo_score as ts

    wl = {w.name: w for w in table3_workloads()}["B"]
    if cluster is None:
        cluster = build_saturated_cluster(SimConfig(num_nodes=nodes, seed=0,
                                                    device=dev))
    sched = TopoScheduler(cluster, engine=engine)
    untraced_us = [sched.plan(wl).decision.sourcing_us for _ in range(3)]
    for attempt in range(1, attempts + 1):
        calls = ts.flextopo_imp_pallas.calls
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_us = sum(sched.plan(wl).decision.sourcing_us
                            for _ in range(plans))
            torch.cuda.synchronize()
        filtered = (ts.flextopo_imp_pallas.calls - calls) // plans
        device = {"kernel": 0.0, "copy": 0.0, "other": 0.0}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            part = ("kernel"
                    if any(k in ev.key for k in TRACE_KERNELS[engine])
                    else "copy" if "memcpy" in ev.key.lower() else "other")
            device[part] += ev.device_time_total
        if sum(device.values()) > 0:
            break
    prof_host = cProfile.Profile()
    prof_host.enable()
    sched.plan(wl)
    prof_host.disable()
    stats = pstats.Stats(prof_host)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]
    out = {
        "engine": engine, "nodes": nodes, "preemptor": "B",
        "filtered_nodes": filtered if engine == "imp_pallas" else None,
        "sourcing_us_untraced": untraced_us, "traced_plans": plans,
        "trace_attempts": attempt, "sourcing_us_traced": traced_us / plans,
        "device_us": {k: v / plans for k, v in device.items()},
        "device_busy_share": (sum(device.values()) / traced_us
                              if sum(device.values()) > 0 else None),
        "host_top_tottime_s": [
            [f"{os.path.basename(f)}:{line}({fn})", calls_, round(tt, 6)]
            for (f, line, fn), (_, calls_, tt, _, _) in top],
    }
    print(f"[trace] {json.dumps(out)}", flush=True)
    return out


def build_all() -> None:
    """Build every CUDA source, one nvcc process each, all started together;
    then count the Hopper instructions of the bf16 flash-attention kernels
    and the scans' local-memory accesses (spills), tensor-core products and
    registers."""
    from repro_torch.kernels import _build

    def one(target):
        t0 = time.perf_counter()
        log = _build.build(*target)
        return target, time.perf_counter() - t0, log

    targets = (("topo_score", ()), ("flash_attention", ()),
               ("topo_score", TIER_YARDSTICK), ("recurrent", ()),
               ("recurrent_bwd", ()), ("flash_attention_bwd", ()))
    logs = {}
    with concurrent.futures.ThreadPoolExecutor(len(targets)) as pool:
        for (name, defines), secs, log in pool.map(one, targets):
            logs[(name, defines)] = log
            flags = "".join(f" -D{d}" for d in defines)
            print(f"[build] {name}.cu{flags}: {secs:.2f} s\n{log.strip()}",
                  flush=True)
    counts = sass_counts(_build._target("flash_attention")[1],
                         r"flash_bf16_kernelILi(\d+)E", SASS_OPS)
    print(f"[build] flash_bf16_kernel SASS (head dim: counts): "
          f"{json.dumps(counts)}", flush=True)
    check(len(counts) == 5, f"flash_bf16_kernel: {len(counts)} of 5 head "
          "dims found in the SASS")
    for d, c in counts.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
              f"flash_bf16_kernel<{d}> has no wgmma or no TMA load: {c}")
    lib = _build._target("flash_attention_bwd")[1]
    counts = sass_counts(lib, BWD_SASS, SASS_OPS + ("LDL", "STL"))
    print(f"[build] backward wgmma kernels' SASS (kernel: counts): "
          f"{json.dumps(counts)}; registers: "
          f"{json.dumps(ptxas_registers(logs[('flash_attention_bwd', ())], BWD_SASS))}",
          flush=True)
    dq, dkv, wide = BWD_KERNELS["wgmma"]
    want = sorted([f"{dq}ILi{d}E" for d in (16, 32, 64, 128, 256)]
                  + [f"{dkv}ILi{d}E{form}" for d in (16, 32, 64, 128)
                     for form in ("Lb0E", "Lb1E")]
                  + [wide])
    check(sorted(counts) == want, f"{sorted(counts)} in the backward's "
          f"SASS, {want} expected")
    for name, c in counts.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
              f"{name} has no wgmma or no TMA load: {c}")
    core = sass_counts(lib, r"(bwd_core_d(?:q|kv)_kernelI\w+?E)", ())
    print(f"[build] backward CUDA-core kernels: {sorted(core)}", flush=True)
    check(len(core) == 10 and not any("bfloat16" in k for k in core),
          f"{sorted(core)}: the CUDA-core forms must be f32 only, at each "
          "of the five head dims (bf16 runs on wgmma at every d)")
    counts = sass_counts(_build._target("recurrent")[1], SCAN_KERNELS,
                         ("LDL", "STL", "HMMA"))
    print(f"[build] scan kernels' local memory and tensor-core SASS "
          f"(kernel: counts): {json.dumps(counts)}", flush=True)
    check(len(counts) == 6, f"{sorted(counts)} of the scans' six kernel "
          "instances found in the SASS")
    for name, c in counts.items():
        check(c["LDL"] == 0 and c["STL"] == 0,
              f"{name} spills to local memory: {c}")
        check((c["HMMA"] > 0) == name.startswith("wkv6"),
              f"{name}: {c['HMMA']} tensor-core products (the WKV kernel's "
              "run on them, the rg-lru's have none)")
    regs = ptxas_registers(logs[("recurrent", ())], SCAN_KERNELS)
    print(f"[build] scan kernels' registers (kernel: registers): "
          f"{json.dumps(regs)}", flush=True)
    counts = sass_counts(_build._target("recurrent_bwd")[1],
                         SCAN_BWD_KERNELS,
                         ("LDL", "STL", "ATOMG", "RED", "HMMA"))
    regs = ptxas_registers(logs[("recurrent_bwd", ())], SCAN_BWD_KERNELS)
    print(f"[build] scan backward kernels' local memory, atomics and "
          f"tensor-core SASS (kernel: counts): {json.dumps(counts)}; "
          f"registers: {json.dumps(regs)}", flush=True)
    check(sorted(counts) == sorted(SCAN_BWD_FORMS),
          f"{sorted(counts)} in the scan backward's SASS, "
          f"{sorted(SCAN_BWD_FORMS)} expected")
    for name, c in counts.items():
        check(not any(c[op] for op in ("LDL", "STL", "ATOMG", "RED")),
              f"{name} spills to local memory or holds a global atomic: {c}")
        check((c["HMMA"] > 0) == name.startswith("wkv6"),
              f"{name}: {c['HMMA']} tensor-core products (the WKV "
              "backward's run on them, the others have none)")
    regs = ptxas_registers(logs[("topo_score", ())], PRESCREEN_KERNELS)
    print(f"[build] prescreen and encoder registers (kernel: registers): "
          f"{json.dumps(regs)}", flush=True)
    counts = sass_counts(_build._target("topo_score")[1],
                         r"((?:normal_cycle|fused_argmax)_kernelILb[01]ELb[01]E"
                         r"|\w*merge_kernel)", ATOMIC_OPS)
    print(f"[build] cluster kernels' atomics SASS (kernel: counts): "
          f"{json.dumps(counts)}", flush=True)
    check(sorted(counts) == sorted(CLUSTER_FORMS),
          f"{sorted(counts)} in the SASS: the cluster kernels' "
          f"instances {sorted(CLUSTER_FORMS)} and no shard merge of a "
          "launch of its own")
    for name, c in counts.items():
        check(sum(c.values()) == CLUSTER_FORMS[name],
              f"{name} holds {sum(c.values())} global atomics, "
              f"{CLUSTER_FORMS[name]} expected (K2's split form takes one "
              f"ticket): {c}")
    counts = sass_counts(_build._target("topo_score")[1],
                         r"(fused_class_kernelILb[01]ELb[01]E|"
                         r"topo_score_argmax_kernel)", K1_OPS)
    print(f"[build] K1 SASS (kernel: counts): {json.dumps(counts)}",
          flush=True)
    check(len(counts) == 4, f"{sorted(counts)} of K1's four kernels found "
          "in the SASS")
    for name, c in counts.items():
        # REDUX: the redux.sync merges; I2F...RP: the conversion that opens
        # an integer division; MUFU.RCP in the lane form is the Eq. 1
        # score's IEEE reciprocal (__fdiv_rn), which the sweep lacks
        check(c["REDUX"] > 0 and c["I2F_RP"] == 0,
              f"{name}: no redux or an integer division: {c}")
        check(name == "topo_score_argmax_kernel" or c["MUFU.RCP"] == 0,
              f"{name} holds a reciprocal: {c}")
    lane = sass_counts(_build._target("topo_score")[1],
                       r"((?:topo_score|placement_tier)_kernelILb[01]E)",
                       K1_OPS)
    print(f"[build] K2/K3 lane SASS (kernel: counts): {json.dumps(lane)}",
          flush=True)
    check(len(lane) == 4, f"{sorted(lane)} of the lane kernels' four forms "
          "found in the SASS")
    rcp = counts["topo_score_argmax_kernel"]["MUFU.RCP"]
    for name, c in lane.items():
        check(c["I2F_RP"] == 0 and c["LDL"] == 0 and c["STL"] == 0,
              f"{name}: an integer division or local memory: {c}")
        # K2 has no reciprocal; K3's are the Eq. 1 score's, as many as K1's
        # lane form has for its one score (at most that for each of the
        # five the vector form writes: four a step and the last lanes)
        most = 0 if name.startswith("placement") else (
            rcp if name.endswith("ILb0E") else 5 * rcp)
        check(c["MUFU.RCP"] <= most and (most == 0) == (c["MUFU.RCP"] == 0),
              f"{name} holds a reciprocal beyond the score's: {c}")


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG")
#: the backward's wgmma kernels in the SASS and the ptxas log (the dQ
#: kernel at d 16-256; the dK/dV kernel at d 16-128 in its two forms,
#: 128-row CTAs and cluster pairs, and the wide one at d 256)
BWD_SASS = r"(bwd_wgmma_d(?:q|kv|kv_wide)_kernel(?:ILi\d+E(?:Lb[01]E)?)?)"
#: the cluster kernels' instances and the global atomics each may hold:
#: K2 <split, merging the earlier shards' records> (the split form's ticket
#: is one atomic), the tail <a shard's, merging> (unsharded, an earlier
#: shard's records, the last shard's merge)
CLUSTER_FORMS = {"normal_cycle_kernelILb0ELb0E": 0,
                 "normal_cycle_kernelILb0ELb1E": 0,
                 "normal_cycle_kernelILb1ELb0E": 1,
                 "normal_cycle_kernelILb1ELb1E": 1,
                 "fused_argmax_kernelILb0ELb0E": 0,
                 "fused_argmax_kernelILb1ELb0E": 0,
                 "fused_argmax_kernelILb1ELb1E": 0}
#: global atomics and reductions (generic, global, fire-and-forget)
ATOMIC_OPS = ("ATOMG", "ATOM", "RED")
#: K1's kernels: warp reductions, shuffles, reciprocals, the rounding
#: conversion (I2F...RP) with which nvcc opens an integer division, and
#: local-memory loads and stores
K1_OPS = ("REDUX", "SHFL", "MUFU.RCP", "I2F_RP", "LDL", "STL")


#: the prescreen's and the encoder's kernel instances in the ptxas log
PRESCREEN_KERNELS = (r"((?:prescreen_cluster|prescreen_union|encode_delta)"
                     r"_kernel(?:ILb[01]E(?:Lb[01]E)?)?)")
#: the scans' kernel instances in the SASS and the ptxas log
SCAN_KERNELS = (r"((?:wkv6|rglru|rglru_step)_kernelI"
                r"(?:f|13__nv_bfloat16)E)")
#: the scans' backward kernel instances (the sweeps and the sums over CTAs)
SCAN_BWD_KERNELS = (r"((?:wkv6_bwd|rglru_bwd|sum_parts)_kernelI"
                    r"(?:f|13__nv_bfloat16)E)")
#: the instances `SCAN_BWD_KERNELS` must find: each sweep in f32 and bf16,
#: the sum over the batch (du's, dsp's) in f32
SCAN_BWD_FORMS = ("wkv6_bwd_kernelIfE", "wkv6_bwd_kernelI13__nv_bfloat16E",
                  "rglru_bwd_kernelIfE", "rglru_bwd_kernelI13__nv_bfloat16E",
                  "sum_parts_kernelIfE")


def ptxas_registers(log: str, function: str) -> dict[str, int] | str:
    """Registers a thread of each kernel whose name matches ``function``
    (keyed by its first group), from ``nvcc -Xptxas -v`` output; the log
    itself where the library was cached and nothing was compiled."""
    import re

    if log == "cached":
        return log
    regs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            f = re.search(function, m.group(1))
            cur = f.group(1) if f else None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            regs[cur] = int(m.group(1))
            cur = None
    return regs


def sass_counts(lib, function: str, ops) -> dict[str, dict[str, int]]:
    """Per function whose name matches ``function`` (keyed by its first
    group), the count of each of ``ops`` in ``cuobjdump -sass`` of the
    built library."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts: dict[str, dict[str, int]] = {}
    cur = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            m = re.search(function, line)
            cur = counts.setdefault(m.group(1), dict.fromkeys(ops, 0)) \
                if m else None
        elif cur is not None:
            for op in ops:
                pat = (r"\bI2F(\.\w+)*\.RP\b" if op == "I2F_RP"
                       else rf"\b{re.escape(op)}\b")
                if re.search(pat, line):
                    cur[op] += 1
    return counts


def run() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # full f32 products in the plain versions, and bf16 products that sum
    # in f32 throughout (no bf16 split-K reductions), as the reference's
    # XLA dots do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    dev = "cuda"
    times: dict[str, float] = {}
    last = [time.perf_counter()]

    def lap(name: str) -> None:
        """The seconds since the previous lap, as ``times[name]``."""
        now = time.perf_counter()
        times[name] = round(now - last[0], 1)
        last[0] = now

    smi = nvidia_smi()
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    build_all()
    lap("build")

    from repro_torch.core.simulator import SimConfig, build_saturated_cluster

    errs = kernel_phase(torch, np, dev)
    errs.update(fused_phase(torch, np, dev))
    for name, err in cluster_phase(torch, np, dev).items():
        errs[name] = max(errs[name], err)
    delta = delta_phase(torch, np, dev)
    errs["encode_delta"] = delta["max_abs_err"]
    errs.update(shortlist_kernel_phase(torch, np, dev))
    errs.update(shard_kernel_phase(torch, np, dev))
    lap("kernel_phases")
    t0 = time.perf_counter()
    big = {10240: build_saturated_cluster(SimConfig(num_nodes=10240, seed=0,
                                                    device=dev))}
    print(f"[main] built the 10240-node cluster in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lap("cluster_10240")
    runs, launches, host_keys = main_path(dev, big)
    lap("main")
    plans = sum(r["cycles"] * r["scaleups"] for r in runs
                if r["engine"] == "imp_pallas")
    legacy_plans = sum(r["cycles"] * r["scaleups"] for r in runs
                       if r["engine"] in ("imp_batched_legacy", "imp_jax"))
    fused_plans = sum(r["cycles"] * r["scaleups"] for r in runs
                      if r["engine"] == "imp_batched")
    clusters = {1024: build_saturated_cluster(SimConfig(num_nodes=1024,
                                                        seed=0, device=dev)),
                **big}
    lap("cluster_1024")
    batch = batch_phase(torch, dev, clusters)
    for name, n in batch["launches"].items():
        launches[name] += n
    fused_plans += sum(r["plans"] * len(r["rounds"])
                       for r in batch["runs"].values())
    lap("batch")
    commit_phase(dev)
    lap("commit")
    sharded = sharded_phase(torch, dev, clusters, host_keys)
    lap("sharded")
    for name, n in sharded["launches"].items():
        launches[name] += n
    fused_plans += sharded["plans"]
    day = day_phase(torch, dev)
    lap("day")
    for name, n in day["launches"].items():
        launches[name] += n
    fused_plans += day["plans"]
    for name in ("prescreen", "encode_delta", "topo_score") + MERGES:
        check(launches[name] > 0, f"the main path never launched {name}")
    flash_errs = flash_phase(torch)
    bwd_errs = flash_bwd_phase(torch)
    scan_bwd = scan_bwd_phase(torch)
    serve, api, params = serve_phase(torch, np)
    day_serve = day_serve_line(day, serve)
    serve_trace(torch, api, params)
    check_errs = serve_check(torch, np, api, params)
    del api, params
    torch.cuda.empty_cache()
    lap("flash_serve")
    families = families_phase(torch, np)
    lap("families")
    examples = examples_phase(torch)
    lap("examples")
    train = train_phase(torch, np)
    train_vlm = train_phase(torch, np, TRAIN_VLM, TRAIN_VLM_STEPS,
                            TRAIN_VLM_LAYERS)
    train_rec = {arch: train_phase(torch, np, arch, steps, layers)
                 for arch, steps, layers in TRAIN_RECURRENT}
    lap("train")
    train_chk = train_check(torch, np)
    lap("train_check")
    resume = train_resume(torch)
    lap("train_resume")
    rows = timing_phase(torch, np, dev, errs, launches,
                        {"topo_score": legacy_plans, None: plans})
    lap("timing")
    rows.append(flash_row(torch, flash_errs,
                          serve["counts"]["flash_attention"]))
    fam = families["serve"]
    rows.append(flash_d256_row(
        torch, flash_errs,
        fam["recurrentgemma-9b"]["launches"]["flash_attention"]))
    for form in K4_FORMS:
        rows.append(flash_form_row(
            torch, flash_errs, form,
            sum(f["launches"][f"flash_attention_{form}"]
                for f in fam.values())))
    bwd_timed = [flash_bwd_timing(torch, shape, forward=shape == MAIN_FLASH)
                 for shape in BWD_TIMED]
    rows.append(flash_bwd_row(
        [t for t in bwd_timed if t["shape"][5] <= 128], bwd_errs,
        train["launches"]["flash_attention_bwd"]))
    rows.append(flash_bwd_row(
        [t for t in bwd_timed if t["shape"][5] == 256], bwd_errs,
        train_vlm["launches"]["flash_attention_bwd"], d256=True))
    rows.extend(scan_rows(torch, *({
        name: sum(f[key][name] for f in fam.values())
        for name in ("wkv6_scan", "rglru_scan")}
        for key in ("launches", "decode_launches"))))
    rows.extend(scan_bwd_rows(torch, scan_bwd, {
        name: sum(t["launches"][name] for t in train_rec.values())
        for name in SCAN_BWD}))
    lap("flash_timing")
    rows.extend(fused_rows(torch, np, dev, errs, launches, fused_plans,
                           clusters, cluster_sweep(torch, np, dev)))
    rows.append(prescreen_row(torch, np, dev, clusters, errs["prescreen"],
                              launches, fused_plans))
    rows.append(delta_row(delta, launches, fused_plans))
    rows.extend(merge_rows(torch, np, dev, errs, launches, sharded["plans"]
                           + day["plans"], clusters))
    lap("fused_rows")
    sweep = sweep_timing(torch, np, dev)
    floor = launch_floor(torch)
    for row in rows:
        if row["name"] in day["launches"]:
            row["day_launches"] = day["launches"][row["name"]]
        if row["name"] == "fused_class":
            row.update(sweep)
    trace_phase(torch, dev)
    for n, cluster in clusters.items():
        trace_phase(torch, dev, "imp_batched", n, cluster, plans=20)
    lap("traces")
    print(f"[times] seconds a phase {json.dumps(times)}", flush=True)
    sourcing = {f"{r['engine']}@{r['nodes']}": [r["sourcing_p50_us"],
                                                r["sourcing_p90_us"]]
                for r in runs}
    print(f"[sourcing] P50/P90 us {json.dumps(sourcing)}", flush=True)
    p50 = {k: v[0] for k, v in sourcing.items()}
    day_keys = ("events", "wall_s", "events_per_s", "requests_planned",
                "plan_p50_us", "plan_p90_us")
    print(json.dumps({"sourcing_p50_us": p50,
                      "day": {f"{r['engine']}@{r['nodes']}"
                              + (f"x{r['shards']}" if r["shards"] > 1
                                 else ""): {k: r[k] for k in day_keys}
                              for r in day["runs"]},
                      "day_trace_busy_share": next(
                          r["trace"]["device_busy_share"] for r in day["runs"]
                          if "trace" in r),
                      "day_serve": day_serve["scheduled_tok_per_s"][
                          "imp_batched"],
                      "serve": {k: serve[k] for k in (
                          "prefill_s", "decode_p50_ms", "decode_p90_ms",
                          "tok_per_s", "max_memory_allocated")},
                      "serve_check": check_errs,
                      "families": {a: {k: f[k] for k in (
                          "layers", "init_s", "prefill_s", "decode_p50_ms",
                          "decode_p90_ms", "tok_per_s",
                          "max_memory_allocated")}
                                   for a, f in fam.items()},
                      "examples": {k: examples[k] for k in (
                          "colocated_uplift", "colocated_raw_tok_per_s")},
                      "train": {k: train[k] for k in (
                          "step_ms_p50", "tokens_per_s",
                          "max_memory_allocated", "losses", "launches")},
                      "train_flash_bwd_share": train["trace"][
                          "flash_bwd_share"],
                      "train_vlm": {k: train_vlm[k] for k in (
                          "arch", "layers", "step_ms_p50", "tokens_per_s",
                          "max_memory_allocated", "losses", "launches")},
                      "train_vlm_flash_bwd_share": train_vlm["trace"][
                          "flash_bwd_share"],
                      "train_recurrent": {a: {k: t[k] for k in (
                          "layers", "step_ms_p50", "tokens_per_s",
                          "max_memory_allocated", "losses", "launches")}
                          | {k: t["trace"][k] for k in (
                              "scan_fwd_share", "scan_bwd_share",
                              "flash_bwd_share")}
                          for a, t in train_rec.items()},
                      "train_check": {a: {k: train_chk[a][k] for k in (
                          "gated", "recorded")} for a, _, _ in TRAIN_CHECKS},
                      "train_resume_bit_identical": resume["bit_identical"],
                      "empty_kernel_ms": floor["kernel_ms"],
                      "shortlist": {f"{r['engine']}@{r['nodes']}":
                                    {k: r["counts"]["path"][k]
                                     for k in ("certain", "fallback")}
                                    for r in runs
                                    if r["engine"] == "imp_batched"},
                      "sharded_sourcing_us": {
                          f"{r['engine']}@{r['nodes']}x{r.get('shards', 0)}":
                          [r["sourcing_p50_us"], r["sourcing_p90_us"]]
                          for r in sharded["runs"]},
                      "day_shortlist": {f"{r['engine']}@{r['nodes']}":
                                        {k: r["counts"]["path"][k] for k in (
                                            "shortlist_plan2", "certain",
                                            "fallback", "sessions",
                                            "merge", "merge_normal",
                                            "encoded")}
                                        for r in day["runs"]
                                        if r["engine"] == "imp_batched"},
                      "delta_host_us": {k: delta[k] for k in (
                          "host_us_view_delta_p50",
                          "host_us_encode_row_p50")},
                      "batch_us_per_plan": {
                          n: [r["wall_us_per_plan"] for r in b["rounds"]]
                          + [b["sequential_us_per_plan"]]
                          for n, b in batch["runs"].items()},
                      "card": smi}),
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run this script "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    try:
        return run()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
