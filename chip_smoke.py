#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N] [--profile]
    python3 chip_smoke.py --against DIR [DIR ...] [--only LABEL]

The main path is ASURA STEP 2 -- placing a batch of u32 datum ids against
one versioned segment table -- reached two ways: bulk placement through
``PlacementEngine`` and the batched serving step ``RequestStreamDriver``;
then the migration, baseline and failure-domain paths, the modules
through which users meet placement (data pipeline, elastic coordinator,
checkpoint store, durability simulator), the multi-card sweep, the
language-model serving path that routes its requests with ASURA, the
training path that reads ASURA-placed data shards and keeps ASURA-placed
checkpoints, the MoE models (mixtral-8x22b, deepseek-v2-236b) on both,
the recurrent, RWKV and encoder-decoder families (recurrentgemma-9b,
rwkv6-3b, whisper-large-v3) on both, and the sharded model path on a
(data, model) mesh.
The deployment follows the repository's own Fig. 5 evaluation points
(``benchmarks/calc_time.py``): a heterogeneous 4096-node cluster with
capacities drawn from ``--seed`` in [0.5, 2.0), and one 10,000-node
cluster.  Phases (each passes or raises; any failure exits non-zero):

  1. card name and power limit; build the CUDA kernels from the sources
     in this checkout; registers, stack frame and spill bytes (``-Xptxas
     -v``) of B5, B6, the fan-out, B8, B1, B9, B2, B3, B4, the
     ADDITION-NUMBER kernel, TW, SC and the bin update;
  2. the fused placement kernel against its plain-torch twin on the card,
     exact equality, emit_nodes both ways: 2**20 + 13 ids on both
     clusters, and the forced tail (max_draws 0 and 1);
  3. the replica kernel against its twin, R in {1, 3, 5} (and R = 12,
     the lane-rows path), emit_nodes both ways, with the stats vector, on
     both clusters (ladders deeper than the kernel's register levels) and
     at max_draws 1;
  4. bulk main path: ``PlacementEngine(cluster)`` on the card,
     ``place_nodes_device`` on 2**24 ids and ``place_replica_nodes_device``
     at R = 3 under ``torch.cuda.set_sync_debug_mode("error")``; one
     table upload, both kernels launched, CUDA-event timings;
  5. serving main path: batch 65,536, 2**20 keys, Zipf(1.1), R = 3, pow2,
     instrumented, 16 steps under sync-debug "error"; counts, live nodes
     and the metrics slab checked, and everything equal to a CPU driver
     (the twins) at the same seed;
     5b. the selection-word kernel (TW, ``lane_words_cuda``) against its
         twin on the card, n_words 1 and 2, four (seed, step) pairs, the
         edge lanes (0, 1, 511, 2**31 - 1, 2**31, 2**31 + 12345,
         2**32 - 1) and 2**20 + 13 lanes that cross 2**32; then its time
         at a benchmark serving batch's 2**22 lanes beside the twin's;
     5c. the select-and-count kernel (SC, ``select_count_cuda``) and the
         bin update (``count_update_cuda``) against their twins on the
         card: every policy at R = 1, 3 and 5, -1 slots and fully invalid
         rows, pad lanes, a strided word column, a transposed owners plane,
         a 10,001-bin plane in shared memory and a 69,955-bin one beyond
         it, a batch with 30 % of its lanes on one record; then SC's time
         at a benchmark serving batch's 2**22 lanes (R = 3, pow2, 10,001
         bins) beside the twin's and the traffic bound, and the update's;
  7. the two-version diff kernels (B3, B4) against their twins on the
     card, exact: the 4096-node cluster before and after adding a node of
     capacity 1.0, before and after removing one, an add that reuses the
     freed hole, and 1024 nodes joining (top level 12 -> 13) and the same
     tables swapped (the top goes down), on 2**20 + 13 ids; a small
     cluster whose add lifts the top level by one (also swapped) and by
     two; one version as both tables (both rows equal); a forced tail
     (max_draws 1); B4 at R = 1, 3, 9, 12;
  8. migration main path on the 4096-node cluster: ``MigrationPlanner``
     ``plan_stream`` over 2**24 tracked ids in 16 chunks of 2**20 (add
     event, CUDA events, sync-debug "error"), ``plan`` with and without
     the ADDITION-NUMBER prefilter (identical plans), ``plan_replicas`` at
     R = 3 for the add and for a removal, ASURA's invariants on every plan
     (an add moves rows only to the new node, a removal only from the
     removed one); then ``ReplicaRouter.begin_scale_migration`` (add,
     R = 3, ingress 64) over the 2**20 serving keys (its replica plan
     timed again on the cached tables with and without the prefilter,
     identical) and one instrumented
     ``serve_migrating`` batch (65,536, Zipf 1.1, pow2) per mover round
     until the window drains, plus one ``superstep_migrating(4)`` held to
     4 ``serve_migrating`` calls of a second driver.  The same sequence at
     2**18 tracked ids and batch 4096 runs on the card and on the CPU (the
     twins); plans, round matrices, chosen nodes, counts, queue, qhist,
     the metrics slab and the window's ADDITION-NUMBER prefilter counters
     must agree bit for bit;
     8c. the ADDITION-NUMBER kernel against its twin on phase 8's v0
         table with the trace's extended ladder: R = 1 and 3 on 2**20 + 13
         ids, R = 9 (picks in scratch rows) and max_draws 2 (forced -1
         lanes) on 2**16; ``PlacementEngine.addition_numbers_device``
         under sync-debug "error" (one launch) against the twin; the
         kernel's time at 2**24 ids (R = 3) and at 2**20 + 13 beside the
         twin's there, and the work this run's data needs (B2 at the
         extended top makes the trace's draws);
  9. the paper's baselines (consistent hashing, random slicing, weighted
     rendezvous), under sync-debug "error" wherever a device path runs:
     9a. the lookup kernels B5 (ch), B6 (rs) against their twins on
         2**20 + 13 ids on both clusters, plus ids whose hashes land on,
         and next to, every table point (``fmix32`` inverted); B7 (wrh)
         on 2**16 + 13 ids on the 4096-node cluster and on a 4097-node one
         (a padding tail); the fan-out kernel at R in {1, 3, 5, 12} with
         its [reprobes] stat, and at R = 6 on a 4-node cluster (slots stay
         -1); B5, B6 and the fan-out on synthetic tables at every edge of
         their staged search (the index stride the launcher picks, equal
         keys across bucket boundaries, lengths not a multiple of the
         stride, an unaligned table, the largest table staged whole), with
         ids on, above and below every index key, each launch plan held to
         ``kernels/launch.py``; all exact;
     9b. bulk: ``PlacementEngine(cluster, algorithm=alg)`` on the card,
         ``place_nodes_device`` and ``place_replica_nodes_device`` (R = 3)
         on 2**24 ids (2**20 for wrh, O(N) per id), median of 10 CUDA-event
         timings; one upload per (algorithm, version), and the ASURA
         engine's artifact still cached after it placed all three;
     9c. serving: ``Router(caps, algorithm=alg).stream_driver`` at the
         phase-5 configuration, 16 instrumented steps, ``superstep(4)``
         held to 4 ``step()`` calls; the same driver at batch 4096 on the
         card and on the CPU must agree in chosen nodes, counts, queue,
         qhist and slab (``baseline.reprobes`` included);
     9d. movement: ``plan_scale_event`` on the 2**20 serving keys, add
         node 4096 (capacity 1.0), then remove node 2048; moved share
         beside the capacity share and the wrong-direction counts (0 for
         ch and wrh); the rs plans must equal the CPU run's;
  10. failure-domain-aware (two-level) placement on three deployments:
      the 4096-node cluster in 64 racks of 64 (``node_id // 64``), the
      reference durability benchmark's 12 domains x 8 nodes
      (``benchmarks/durability.py``), and a ragged one (1 to 128 nodes
      per domain, so the domains' top levels differ):
      10a. kernel B8 against its twin on 2**20 + 13 ids, R in {1, 3, 5}
           on 64x64 and ragged, R = 3 on 12x8, R = D + 1 on 4 domains
           (-1 planes), and max_draws=1 (the per-domain tail on the lanes
           that miss); R = 9 on 64x64 and R in {1, 3, 9} and max_draws=1
           on the 10,000-node cluster in racks of 64 (2**18 ids at R = 9),
           and the 64x64 domain ladder started 4 levels higher (more draws
           reach the counters B8 keeps in local memory); B9 against
           ``place_ref`` on the flat 4096-node table, also at max_draws=1
           (-1 lanes); all exact;
      10b. bulk: ``place_replica_pairs_device`` (R = 3) and
           ``place_nodes_device`` on the 64x64 hierarchy, B9 alone on the
           flat table, 2**24 ids, median of 10 CUDA-event timings, under
           sync-debug "error";
      10c. serving: ``Router({rack: {node: capacity}}).stream_driver``,
           the phase-5 configuration uninstrumented (the reference has no
           stats plane in this mode), 16 steps and ``superstep(4)`` under
           sync-debug "error"; card == CPU at batch 4096;
      10d. movement on the 2**20 serving keys: add a node (capacity 1.0)
           to rack 7, remove node 2048, remove rack 40 --
           ``diff_replica_domains_device`` (CUDA events) and
           ``MigrationPlanner.plan_replicas`` (R = 3) per event, with the
           two-level invariants checked; ``route_replica_pairs`` on 2**18
           keys equal to the CPU's;
  11. the consumers of placement at full width, under ``--seed``:
      11a. ``ShardedDataset`` of 2**24 shards on the 4096 ingest hosts,
           ``DataPipeline`` for 8 of them; one bincount over the card's
           owners (every shard owned once); add a host, then remove host
           2048: every pipeline's ``refresh_membership`` gained / lost sets
           equal B3's diff on all 2**24 ids; batches drawn; the ownership
           sweep timed (CUDA events and host wall);
      11b. ``ElasticCoordinator`` over 2**20 tracked ids, R = 1 and 3:
           add / remove plans equal to the brute-force diff (owners placed
           at both versions on the card), a live add drained, a live add
           rolled back, a live removal (its rollback refused) drained, the
           owner table equal to the placement after each; ``ch``, ``rs``,
           ``wrh`` add / remove at R = 1; host wall time of each event and
           of the host ADDITION-NUMBER trace;
      11c. ``AsuraCheckpointStore`` of 256 nodes (capacities the first 256
           drawn), R = 3, a 1 GiB state of tensors on the card (16 f32
           leaves of 4096 x 4096, a bf16 and a ragged leaf): save,
           ``save_async`` with the state updated in place right after the
           call, restores byte-exact; 2 nodes failed and restored, then
           each removed and repaired (copies only of chunks it held, every
           chunk back on its replica set); a live add drained; ``add_node``
           moving the minimal copies; GiB/s of save and restore (host wall);
      11d. the durability simulator (``compare_policies``, R = 3, and
           ``movement_on_node_add``): ``benchmarks/durability.py``'s QUICK
           configuration, whose integers must equal ``BENCH_durability.json``
           (read from the file), its FULL one, and the 4096 nodes in 64
           racks of 64 at 2**20 objects over a tenth of a year;
      11e. the sequence of 11a-11d at 2**18 ids on 64 nodes (a 4 MiB
           state, QUICK durability) on the card and on the CPU: owned
           shards, batches, MovePlans, drain rounds, blobs per node,
           reports and movement must agree bit for bit;
  12. the multi-card sweep (``repro_torch.launch.placement_mesh``):
      12a. ``ShardedSweep`` over a world-size-1 NCCL group at full width:
           ``place_nodes`` and ``histogram`` under all four algorithms
           (2**24 ids, wrh 2**20), the replica histogram at R = 3,
           ``diff_nodes_device`` / ``diff_replicas_device`` and
           ``movement_matrix`` at R = 1 and 3 on phase 8's add over its
           2**24 tracked ids, ``plan`` / ``plan_replicas`` /
           ``plan_stream(mesh=)``, and mesh serving at the phase-5
           configuration (ASURA instrumented, 16 steps; CH, 4 steps; the
           64 x 64 racks through B8, 16 steps; each then ``superstep(4)``);
           every result equal to the same engine's single-card call, each
           pair timed in turns by CUDA events (the difference is the
           collectives' cost at world size 1);
      12b. ``python -m repro_torch.launch.placement_mesh --selftest`` on 4
           processes sharing the card over gloo (2**20 + 13 ids, serving
           batch 4096): every rank's sharded results equal its
           single-card path; rank 0 reports ``mesh.host_staged``;
  13. the dense language-model serving path, smollm-135m at full width
      (30 layers, d_model 576, 9 query / 3 KV heads, vocab 49,152; weights
      drawn from ``--seed``):
      13a. ASURA routing of 2**20 session ids over 6 replicas through
           ``place_nodes_device`` (B1): replica 3 removed, exactly its
           sessions move; standby 6 added, every moved session goes to it;
      13b. ``repro_torch.launch.serve`` with the reference's defaults (4
           replicas, 64 requests, batch 8, decode 8, cache 64): decode ms
           per step (CUDA events), tokens/s, and ``torch.profiler``'s idle
           share and launches per decode step;
      13c. decode at the decode_32k shape cut to batch 64 (48.3 GB of K
           and V): 8 steps from position 32,767 against a full cache; step
           ms, tokens/s, peak memory and the bytes bound;
      13d. prefill at 1 x 32,768 (blockwise attention) and 8 x 4,096
           (dense): ms, tokens/s, peak memory, the bf16 FLOP bound;
      13e. the card against the port on the CPU, same weights (a 16-token
           prefill and 4 decode steps at batch 2), and a 1,024-token
           blockwise prefill against the dense one on the card: logits
           within 2e-2 x max |logits|, greedy tokens equal wherever the
           top-2 margin exceeds that;
  14. the dense language-model training path, smollm-135m at full width:
      14a. ``repro_torch.launch.train`` at its defaults (batch 8 x 128, 20
           steps, an async save every 10; the pipeline's ownership sweep
           on B1, the store's chunks on B2): the loss must improve; two of
           the six store nodes fail and the last save restores bit for bit
           (one B2 launch per chunk); the pipeline's shards and every
           stored chunk's replica set held to B1's and B2's twins;
           ``torch.profiler``'s idle share and launches per CLI step;
      14b. one train step on the card against an fp32 run on the CPU of
           the same weights and batch (2 x 128), the CPU's bf16 run the
           control: the loss, ``grad_norm`` and the moments ``m`` and ``v``,
           each within ``LM_NOISE_FACTOR`` x the control's distance, and
           the card's new parameters against AdamW recomputed in float64
           from its own ``m`` and ``v`` (``UPDATE_ULPS``), on the CLI's
           trained weights and 1 more draw;
      14c. a train_4k step cut to batch 32 (4 microbatches of 8, remat
           "nothing"): the step-0 loss near ln(vocab), host syncs counted
           under sync debug "warn", step ms (CUDA events), tokens/s, peak
           memory, the profiler's idle share and kernels per step, and the
           bf16 FLOP bound (3x the forward, the head at every position);
  15. the MoE language models at full width, depth cut (widths, heads,
      experts, top-k, capacity factor, vocab and window as published):
      15a. mixtral-8x22b cut to 2 layers: the serving CLI (``--layers 2``,
           routing on B1 held to its twin, a fresh cache per batch of 8, 8
           decode steps); decode at batch 8 against a full 4,096-slot
           window ring whose index starts 3 slots before its end (the steps
           cross the wrap); prefill 8 x 4,096 (dense) and 1 x 16,384
           (blockwise, the window masking): step ms, tok/s, peak memory,
           the profiler's kernels per step and idle share, the share of
           assignments dropped at capacity per layer;
      15b. deepseek-v2-236b cut to 1 dense + 1 MoE layer: the same, with
           decode against a compressed (latent) cache of 4,096 positions
           (its bytes printed) and prefill 1 x 4,096 (dense, heads in
           groups) and 1 x 16,384 (blockwise on padded values);
      15c. the reduced configs of both families on the card against the
           CPU, 4 weight draws, prefill 8 x 64 (two dispatch groups) and 4
           decode steps at batch 8: the fp32-compute runs route alike
           except within ``ROUTE_EPS_FP32`` of the CPU's top-k gap and
           agree on logits at rtol 1e-4 / atol 1e-5 on the rows no flip
           reached; the card's bf16 routes are the CPU bf16 run's except
           within ``ROUTE_EPS_BF16``, and on the rows no flip reached its
           logits are held to the CPU's fp32 run as 13e holds them; the
           route-flip shares printed;
      15d. one training step per family at the reduced size (2 x 128) held
           as 14b holds it, at ``MOE_TRAIN_FACTOR``, and the training CLI
           for mixtral at ``--reduced`` (B1 pipeline, B2 store): its loss
           must fall;
  16. the recurrent, RWKV and encoder-decoder families at full width
      (recurrentgemma-9b, rwkv6-3b, whisper-large-v3: every width, head,
      LRU width, window, chunk, frame count and vocab as published):
      16a. each through the serving CLI at its defaults and full depth
           (routing on B1 held to its twin, batch 8, 8 decode steps, cache
           64): step ms, tok/s, the bytes bound (bf16 weights and cache;
           whisper also the FLOPs of its per-step cross K / V recompute),
           the profiler's kernels per step and idle share;
      16b. long_500k for the two subquadratic families: batch 1, a cache
           made for 524,288 positions (recurrentgemma's 2,048-slot rings
           filled through position 524,286, the recurrent states random),
           16 steps from 524,287 (the rings wrap) beside the same steps
           against a 64-position cache, in turns (64, long, long, 64; 8
           steps a turn), with both caches' bytes;
      16c. prefill 8 x 4,096 (whisper's over 8 x 1,500 zero frames, and its
           encoder alone): ms, peak memory, the FLOP bound;
      16d. the reduced configs on the card against the CPU, 4 weight draws,
           prefill 8 x 300 and 20 decode steps (whisper's ``enc_out`` its
           own encoding of random frames): fp32 logits at rtol 1e-4 / atol
           1e-5, bf16 held as 13e at ``REC_NOISE_FACTOR``;
      16e. one training step per family at the reduced size (2 x 128, 4
           draws) held as 15d at ``REC_TRAIN_FACTOR``; one timed step at
           full width with the depth cut to fit the card (recurrentgemma
           one super-block, rwkv6 8 layers, whisper whole), 2 x 4,096,
           beside its FLOP bound, with peak memory; the training CLI for
           whisper at ``--reduced`` (frames; B1 pipeline, B2 store): its
           loss must fall;
 17. the sharded model path (``launch.{mesh,shardings,dryrun}``):
      17a. smollm-135m at full width on an NCCL world-size-1 (data, model)
           mesh, batch 8 x 512 from ``DataPipeline`` ownership (B1): one
           train step (AdamW from a warm-up of one step), a prefill and 4
           decode steps (sync-debug "error") against the unsharded steps
           on the card, at the limits ``SHARD_*`` (PERF.md section 6); the
           new parameters against AdamW in float64 (``UPDATE_ULPS``, with
           two controls that must fail it), step ms of both;
      17b. the dry run of ``DRY_CELL`` on a fake 16x16 group on this host:
           per-device argument / output / temp / peak bytes against the
           card's memory, FLOPs, collective bytes by kind; then the reduced
           ``DRY_MULTI_POD`` training cell on a fake 2x16x16 group (the
           batch on the flattened (pod, data) axis) under this host's torch;
      17c. ``python -m repro_torch.launch.shardings --selftest``: 4 CPU
           gloo ranks on a 2x2 mesh under this host's torch, started
           after 17a's timed steps and run beside 17b;
  6. (printed last) one JSON line per kernel (B1-B9, the fan-out, the
     ADDITION-NUMBER trace, TW and SC): launches on the main paths (phases 4, 5, 8,
     9b-9d, 10b-10d, 11a-11d, 12a,
     13a-13b, 14a, 15a-15b, 15d, 16a, 16e, 17a), time at
     the bulk size, the twin's time, the least time the card could take
     for the same work (an ASURA ladder hashing each distinct level's seed
     once per lane, with the count that hashes it at every consult beside
     it; for B3 / B4 one walk of the deeper ladder, with the count of two
     complete walks beside it), and for B5 / B6 the time of
     ``torch.searchsorted``.

``--profile`` also traces 4 serving steps, 4 ``serve_migrating``
batches on the drained window, 4 serving steps under each baseline, 4
hierarchical serving steps and 4 two-level diffs of phase 10d's add with
``torch.profiler`` and prints the
device busy time per batch, the idle share and the kernels that fill it
(PERF.md section 5).

``--against DIR [DIR ...]`` runs no phase: it imports the ``repro_torch``
of the checkout in each DIR beside this one, builds them, and times every
kernel of this checkout and of each other one on the same inputs at the
bulk sizes in turns (theirs, ours, ours, theirs; outputs must be equal),
with each build's ptxas numbers; B2 at R = 3 with and without the stats
vector and at R = 1; B3 and B4 on the add, the removal and the
1024-node scale-out (top change); the ADDITION-NUMBER kernel on phase
8c's extended ladder at R = 3 (2**24 and 2**20 ids) and R = 1 (2**20).
``--only LABEL`` (repeatable) keeps the kernels whose label starts with
LABEL, and builds only their libraries.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a CUDA card, or without the package beside this script, it
exits non-zero before printing any result.  Every integer result is
compared with zero tolerance: the placement stack is exact integer math.
The language model's float logits (phases 13, 15 and 16) and training
step (phases 14b, 15d and 16e) are held to the tolerances stated there.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent

LADDER_NODES = 4096  # benchmarks/calc_time.py LADDER_NODES
HUGE_NODES = 10_000  # benchmarks/calc_time.py HUGE_NODES[0]
CHECK_IDS = (1 << 20) + 13
BULK_IDS = 1 << 24
TIMED_CALLS = 10
SERVE_BATCH = 1 << 16
SERVE_KEYS = 1 << 20
SERVE_STEPS = 16

# Published peaks of one H100 SXM (NVIDIA data sheet; at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
# int32 ALU: 132 SMs x 64 INT32 lanes x 1.98 GHz boost, from the same data
# sheet's SM count and clock that give its 67 TFLOP/s FP32 row
# (132 x 128 FP32 lanes x 2 x 1.98 GHz).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 ops per consulted ladder level when every consult hashes its
# level's seed anew (two fmix32 at 8 ops each + seed add, counter
# multiply, xor, counter tick), and per draw (floor shift, fraction shift,
# bound and length compares).  The seed is a function of (id, level)
# alone, so the least work hashes it once per distinct level a lane
# consults (fmix32 + seed add) and then spends one fmix32, the counter
# multiply, xor and tick per consult.
OPS_PER_LEVEL = 20
OPS_PER_SEED = 9
OPS_PER_CONSULT = OPS_PER_LEVEL - OPS_PER_SEED
OPS_PER_DRAW = 4
SOURCE = "src/repro_torch/kernels/csrc/asura_place.cu"
SOURCE_BASELINES = "src/repro_torch/kernels/csrc/baselines.cu"
SOURCE_HIER = "src/repro_torch/kernels/csrc/hierarchy.cu"
SOURCE_TRAFFIC = "src/repro_torch/kernels/csrc/traffic.cu"
BASELINES = ("ch", "rs", "wrh")
# kernel -> (the TPU kernel it replaces, its CUDA source), B1-B9 in order
REPLACES = {
    "place_fused": ("src/repro/kernels/asura_place.py:510", SOURCE),
    "place_replicas": ("src/repro/kernels/asura_place.py:396", SOURCE),
    "diff_nodes": ("src/repro/kernels/asura_place.py:578", SOURCE),
    "diff_replicas": ("src/repro/kernels/asura_place.py:669", SOURCE),
    "ch_place": ("src/repro/kernels/baselines.py:303", SOURCE_BASELINES),
    "rs_place": ("src/repro/kernels/baselines.py:319", SOURCE_BASELINES),
    "wrh_place": ("src/repro/kernels/baselines.py:335", SOURCE_BASELINES),
    "hier_replicas": ("src/repro/kernels/hierarchy.py:349", SOURCE_HIER),
    "place": ("src/repro/kernels/asura_place.py:455", SOURCE),
}
KERNELS = tuple(REPLACES)
FANOUT = "baseline_replicas"  # no TPU kernel: the reference's jnp loop
FANOUT_OF = "src/repro/kernels/baselines.py:389"
AN = "addition_numbers"  # no TPU kernel: the reference's jnp ADDITION-NUMBER trace
AN_OF = "src/repro/kernels/ref.py:312"
AN_CHUNK = 1 << 20  # the ids of one trace on the main path (a plan chunk, a window)
TW = "lane_words"  # no TPU kernel: the reference draws the serving words with jax.random
TW_OF = "src/repro/serve/traffic.py:119"
# B4 with the per-slot alignment of its two sets as its epilogue: the
# reference's diff_replicas_pallas, then its jnp _align_replica_sets
B4A = "diff_replicas_aligned"
B4A_OF = "src/repro/kernels/asura_place.py:669 + src/repro/kernels/ops.py:399"
TW_LANES = 1 << 22  # the lanes of a benchmark serving batch (chipbench's serve-ycsbc)
SC = "select_count"  # no TPU kernel: the reference's jnp select + histogram in one jit
SC_OF = "src/repro/serve/stream.py:667"
SOURCE_SERVE = "src/repro_torch/kernels/csrc/serve.cu"
SC_BINS = 10_001  # the load planes of the benchmark's 10,000-node cluster
# int32 operations of one SC lane at R = 3, pow2, estimated from the code:
# two u32 remainders by a runtime R (~20 each), the slot and address
# arithmetic, the two load compares and selects, the ballot, the match,
# the leader test and the shared add
SC_OPS = 60
# launches between one pair of CUDA events when TW is timed back to back: a
# lone launch on an idle card also times the host's launch (~20 us), which
# is over half of TW's own time
TW_BACK_TO_BACK = 50
# int32 operations of one Threefry-2x32 evaluation in csrc/traffic.cu: 20
# rounds of an add, a funnel shift and an xor; the first key injection's
# two adds and five more of two adds each (the round constant folded into
# a three-input add); the third key word's two xors folded into one
THREEFRY_OPS = 20 * 3 + 2 + 5 * 2 + 1
# the trace's min-key update of an unused draw: k <, k ==, f <, and, or, two
# selects
MIN_KEY_OPS = 7
WRH_IDS = 1 << 20  # bulk wrh: O(N) per id
WRH_CHECK_IDS = (1 << 16) + 13
CPU_STEPS = 2  # card-vs-CPU serving: 2 step() calls, then superstep(2)
SMALL_CAPS = [1.0, 2.0, 0.5, 1.5]  # R = 6 on 4 nodes: slots stay -1
# int32 operations of the baseline kernels, from their code: fmix32 (three
# xor-shifts, two multiplies), one binary-search step (midpoint, load
# address, compare, two selects), the wrap and owner gather, a fan-out
# draw (two fmix32, level add, counter multiply, xor), and one WRH pair
# (salt add, two fmix32, the Q16 log: 7 to normalise, 6 per squaring
# step, 3 to finish; the valid / better compares and two selects) plus
# its two f32 operations (the int->float convert and the multiply).
FMIX_OPS = 8
SEARCH_OPS = 5
GATHER_OPS = 3
DRAW_OPS = 20
WRH_PAIR_OPS = 1 + 2 * FMIX_OPS + (7 + 16 * 6 + 3) + 4
WRH_PAIR_F32 = 2
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, FP32 outside the tensor cores
PLAN_CHUNKS = 16  # plan_stream chunks (2**20 ids each at 2**24 tracked ids)
WINDOW_INGRESS = 64  # rows the new node may receive per mover round
MIN_ROUNDS = 8
SMALL_TRACKED = 1 << 18  # the card-vs-CPU run of phase 8
SMALL_BATCH = 4096
RACK = 64  # nodes per domain of the full-width hierarchy: node_id // 64
DURABILITY_LAYOUT = (12, 8)  # benchmarks/durability.py FULL: 12 domains x 8 nodes
RAGGED_DOMAINS = 40  # 1 to 128 nodes each
HIER_ADD_RACK, HIER_GONE_RACK = 7, 40
DEEP_LEVELS = 4  # phase 10a: levels added on top of a domain ladder
SCALE_OUT = 1024  # the full-width top-change event: 4096 -> 5120 nodes, top 12 -> 13
# phase 11, the consumers of placement
CONSUMER_HOSTS = 8  # DataPipelines driven: hosts k * N / 8 (the removed host N / 2 among them)
SHARD_TOKENS = 2048  # tokens per shard
SHARD_VOCAB = 50_257  # the GPT-2 vocabulary
BATCH_PER_HOST, SEQ_LEN = 8, 1024
TRACKED = 1 << 20  # ids the elastic coordinator tracks
STORE_NODES = 256  # checkpoint store nodes, capacities the first 256 of the 4096 drawn
STATE_LEAVES, STATE_SIDE = 16, 4096  # f32 leaves of 4096 x 4096: 1 GiB, plus bf16 and ragged
CUT_IDS, CUT_NODES = 1 << 18, 64  # phase 11e, on the card and on the CPU
# 64 racks x 64: ~1,400 node failures per simulated year, each a host scan;
# a tenth of a year (cut from a quarter to make room for phase 16)
RACK_YEARS = 0.1
# benchmarks/durability.py QUICK and FULL, and the 4096 nodes in racks of 64
_MTTF = dict(mttf_node_years=3.0, mttf_domain_years=15.0, seed=7)
DURABILITY = {
    "quick": dict(n_domains=6, nodes_per_domain=4, n_objects=20_000, years=10.0, **_MTTF),
    "full": dict(n_domains=12, nodes_per_domain=8, n_objects=200_000, years=20.0, **_MTTF),
    "racks": dict(n_objects=1 << 20, years=RACK_YEARS, **_MTTF),
}


# phase 12, the multi-card sweep
MESH_RANKS = 4  # 12b: processes sharing the one card over gloo
MESH_BATCH = 4096  # 12b: serving batch (cut from 65,536)
MESH_TIMED = 5  # 12a: CUDA-event calls per turn (single, mesh, mesh, single)
MESH_TIMEOUT = 600  # 12b: seconds before the ranks are stopped
# phase 13, the dense language-model serving path (smollm-135m at full width)
LM_SESSIONS = 1 << 20  # 13a: session ids routed
LM_REPLICAS = 6  # 13a: examples/serve_routing.py's replicas; 3 dies, standby 6 joins
LM_CLI = ["--arch", "smollm-135m", "--replicas", "4", "--replica-id", "0", "--requests", "64",
          "--batch", "8", "--decode-len", "8", "--cache-len", "64"]  # the reference's defaults
LM_PROFILED = 8  # 13b: decode steps traced by torch.profiler
# 13c: the decode_32k shape (32,768 cached positions) at batch 64, cut from
# 128: 128 x 32,768 x 30 layers x 768 B of K and V is 96.6 GB, over the 80
# GB card; 64 is 48.3 GB
DECODE_32K = (64, 32_768)
DECODE_STEPS = 8
# 13d: prefill_32k at batch 1, cut from 32 (one KV chunk's fp32 scores are
# 1.2 GB per sequence; the blockwise path), and a 4,096 prompt at batch 8
# (the dense path)
PREFILLS = ((1, 32_768), (8, 4_096))
LM_CARD_CPU = (2, 16, 4)  # 13e: batch, prompt length, decode steps on the card and the CPU
LM_BLOCKWISE = (2, 1_024, 512)  # 13e: batch, prompt length, blockwise threshold
# 13e: max |card bf16 - fp32| <= this x max |CPU bf16 - fp32| of the same
# logits; sound runs read 0.82-1.17 over 12 weight draws (PERF.md section 6).
# 14b holds one train step's loss, grad_norm and moments m and v the same
# way; its first runs read 0.0016-1.12 over 16 readings (loss, grad_norm, m,
# and the parameter update, which saturates and is now held to AdamW instead)
LM_NOISE_FACTOR = 2.0
LM_DRAWS = 3  # 13e: weight draws held besides the CLI's (seeds 1 .. LM_DRAWS, on the CPU)
# phase 14, the dense language-model training path (smollm-135m at full width)
TRAIN_CLI = ["--arch", "smollm-135m"]  # 14a: the CLI's defaults: batch 8 x 128, 20 steps, save every 10
TRAIN_FAILED = (1, 3)  # 14a: store nodes down for the restore (2 of 6, R = 3)
TRAIN_CARD_CPU = (2, 128)  # 14b: batch, sequence of the one step on the card and the CPU
# 14b: weight draws held besides the CLI's (seeds 1 .. TRAIN_DRAWS, on the
# CPU); one (three before phase 16 was added; each took ~13 s of the script)
TRAIN_DRAWS = 1
UPDATE_ULPS = 4  # 14b: the card's new parameters against AdamW's update in float64
# 14c: train_4k at full width and sequence with the batch cut from 256 to 32
# (256 rows would take ~8x the 32-row step, past the script's time limit),
# in 4 microbatches of 8 under remat "nothing"; a warm-up step, then timed ones
TRAIN_4K = (32, 4_096, 4)
TRAIN_TIMED = 2
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor-core rate
# phase 15, the MoE language models (mixtral-8x22b, deepseek-v2-236b) at full
# width with the depth cut to 2 layers (5.41 B and 5.36 B parameters: 30 GiB
# as fp32 master plus bf16 working copy; 56 and 60 layers would need 0.28 and
# 0.47 TB in bf16 alone)
MOE_ARCHS = ("mixtral-8x22b", "deepseek-v2-236b")
MOE_CLI = ["--layers", "2", "--replicas", "4", "--replica-id", "0", "--requests", "64",
           "--batch", "8", "--decode-len", "8", "--cache-len", "64"]  # the CLI's defaults
MOE_WRAP = (8, 4_096, 3)  # batch, cache positions, slots before the ring's end where decode starts
MOE_PREFILLS = {"mixtral-8x22b": ((8, 4_096), (1, 16_384)),
                "deepseek-v2-236b": ((1, 4_096), (1, 16_384))}
MOE_CARD_CPU = (8, 64, 4)  # 15c: batch, prompt length (2 dispatch groups), decode steps
MOE_DRAWS = 3  # 15c / 15d: weight draws besides seed 0 (seeds 1 .. MOE_DRAWS, on the CPU)
# 15c: a route may differ between two runs only where the truth's smallest
# gap among a token's top k + 1 logits is within this x its largest |logit|:
# 8 bf16 steps (every flip the CPU tests saw between the reference's and the
# port's bf16 runs lay within it), and for fp32 runs far above fp32 rounding
ROUTE_EPS_BF16 = 2.0**-5
ROUTE_EPS_FP32 = 2.0**-14
# 15d: the MoE families' training readings (loss, grad_norm, m, v) as 14b's,
# at twice the largest of 32 CPU readings (the reference's bf16 step against
# the port's, both ways, 4 draws x 2 families: v 2.03; m 1.27, grad_norm 0.68)
MOE_TRAIN_FACTOR = 4.0
MOE_TRAIN = (2, 128)
MOE_TRAIN_CLI = ["--arch", "mixtral-8x22b", "--reduced"]  # 20 steps of 8 x 128, a save at 10
# phase 16, the recurrent, RWKV and encoder-decoder families at full width
# and depth (9.40 B, 3.10 B and 1.60 B parameters: 56.4, 18.6 and 9.6 GB as
# fp32 master plus bf16 working copy)
REC_ARCHS = ("recurrentgemma-9b", "rwkv6-3b", "whisper-large-v3")
REC_CLI = ["--replicas", "4", "--replica-id", "0", "--requests", "64", "--batch", "8",
           "--decode-len", "8", "--cache-len", "64"]  # the CLI's defaults
LONG_500K = (1, 524_288)  # 16b: the long_500k cell's batch and positions
REC_PREFILL = (8, 4_096)  # 16c
REC_CARD_CPU = (8, 300, 20)  # 16d: batch, prompt (three RWKV chunks, one padded), decode steps
REC_DRAWS = 3  # 16d / 16e: weight draws besides seed 0 (seeds 1 .. REC_DRAWS, on the CPU)
# 16d: max |card bf16 - fp32| <= this x max |CPU bf16 - fp32|; on the CPU the
# reference's bf16 run held to the port's fp32 with the port's bf16 the
# control, and the reverse, read at most 1.6582 over 504 readings (4 draws x
# 3 families x 21 stages x 2; tests/torch_bf16_readings.py, PERF.md section 6)
REC_NOISE_FACTOR = 3.0
# 16e: the training readings as 15d's; the CPU readings of the same kind
# reached 2.3897 (rwkv6's v) over 96
REC_TRAIN_FACTOR = 5.0
REC_TRAIN = (2, 128)
REC_TRAIN_FULL = (2, 4_096)  # 16e: batch x sequence of the timed full-width step
# 16e: depth kept for the full-width step, so that the fp32 master, gradient,
# both moments and AdamW's new trees (~28 bytes a parameter) fit the card:
# one (rec, rec, attn) super-block beside the tied 1.05 B embedding, 8 of
# rwkv6's 32 layers, whisper whole (~48, ~29 and ~45 GB)
REC_TRAIN_LAYERS = {"recurrentgemma-9b": 3, "rwkv6-3b": 8}
REC_TRAIN_CLI = ["--arch", "whisper-large-v3", "--reduced"]  # frames; 20 steps of 8 x 128
# phase 17, the sharded model path (PERF.md section 6 states these limits)
SHARD_ARCH = "smollm-135m"
SHARD_BATCH = (8, 512)  # 17a: the pipeline's batch x sequence (train, prefill; the decode cache)
SHARD_DECODE = 4  # 17a: decode steps under sync-debug "error"
SHARD_TIMED = 3  # 17a: CUDA-event calls per step kind
SHARD_LOSS_RTOL = 1e-5  # 17a: the reference's own sharded-vs-unsharded loss tolerance
SHARD_GNORM_RTOL = 1e-3  # 17a: grad_norm (the card's earlier runs read 1.97e-4)
SHARD_M_RTOL = 0.1  # 17a: AdamW's m, each leaf against its own max |m| (CPU rehearsal <= 0.0130)
SHARD_V_RTOL = 0.2  # 17a: AdamW's v (~0.05 g^2), likewise (CPU rehearsal <= 0.0190)
DRY_CELL = ("mixtral-8x22b", "decode_32k")  # 17b (train_4k takes ~3 min on the host: PERF.md section 5)
DRY_MULTI_POD = ("rwkv6-3b", "train_4k")  # 17b, reduced, on 2x16x16 (ROADMAP C3)
SELFTEST_TIMEOUT = 600  # 17c
CONV_MACS = 4  # RG-LRU's depthwise conv width
RWKV_CHUNK_LEN = 128  # RWKV6's WKV chunk
PLAN_FIELDS = ("ids", "src", "dst", "index", "slot", "src_slot")


def scale_out(np, cluster) -> None:
    """The full-width top-change event: SCALE_OUT nodes join the 4096-node
    cluster, capacities drawn as its own, in [0.5, 2.0)."""
    caps = np.random.default_rng(1).uniform(0.5, 2.0, SCALE_OUT)
    for i, cap in enumerate(caps):
        cluster.add_node(LADDER_NODES + i, float(cap))


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(torch, fn, reps: int) -> list[float]:
    """Per-call device times (ms) of ``fn`` by CUDA events, after one
    warm-up call."""
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in zip(starts, ends)]


def timed(torch, dev, fn):
    """(``fn()``, its ms): CUDA events on the card (the first call, no
    warm-up: for a twin that takes seconds), the host clock elsewhere."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        return fn(), 1e3 * (time.perf_counter() - t0)
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    result = fn()
    e.record()
    torch.cuda.synchronize()
    return result, s.elapsed_time(e)


def mismatches(torch, a, b) -> tuple[int, int]:
    """(number of differing entries, max |a - b|) of two integer tensors."""
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.uint32:
        from repro_torch.kernels.u32 import as_u32

        a, b = as_u32(a), as_u32(b)
    a, b = a.to(torch.int64), b.to(torch.int64)
    diff = (a - b).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


class uncounted:
    """Launches inside this block (checks against twins, timing) are put
    back out of the main path's launch counts on exit."""

    def __init__(self, launches: dict):
        self.launches = launches

    def __enter__(self):
        self.saved = dict(self.launches)

    def __exit__(self, *exc):
        self.launches.update(self.saved)
        return False


class sync_guard:
    """``torch.cuda.set_sync_debug_mode("error")`` on a CUDA device; a
    no-op on the CPU."""

    def __init__(self, torch, dev):
        self.torch, self.on = torch, dev.type == "cuda"

    def __enter__(self):
        if self.on:
            self.torch.cuda.synchronize()
            self.torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        if self.on:
            self.torch.cuda.set_sync_debug_mode(0)
        return False


def ladder_work(torch, stats, top_level: int) -> tuple[int, int]:
    """(consulted levels, draws) from a [depth_hist..., nonconv] vector."""
    from repro_torch.kernels.ref import DEPTH_BINS
    from repro_torch.kernels.u32 import as_u32

    hist = as_u32(stats[:DEPTH_BINS]).cpu()
    depth = torch.arange(DEPTH_BINS, dtype=torch.int64)
    return int((hist * depth).sum()), int(hist.sum())


def high_stops(torch, stats, n_segs: int, top_level: int, s_log2: int = 1) -> int:
    """Draws of a [depth_hist..., nonconv] vector that stop at a level
    above the table, where every number is a miss past it (k >= 2**(s +
    L - 1) >= n_segs): those of depth 1 .. the count of such levels."""
    from repro_torch.kernels.ref import DEPTH_BINS
    from repro_torch.kernels.u32 import as_u32

    low = max(1, (n_segs - 1).bit_length() - s_log2 + 1)  # the lowest such level
    above = max(0, top_level - low + 1)
    return int(as_u32(stats[:DEPTH_BINS]).cpu()[1:above + 1].sum())


def distinct_levels(ids, len32, node_of, top_level: int, R: int, max_draws: int = 128) -> int:
    """Distinct ladder levels the lanes of a replica placement consult,
    summed over lanes (the plain-torch twin counts them; not timed)."""
    from repro_torch.kernels.ref import place_replicas_ref

    _, levels = place_replicas_ref(ids, len32, node_of, top_level=top_level,
                                   max_draws=max_draws, n_replicas=R, emit_levels=True)
    return int(levels)


def ladder_ops(consults: int, distinct: int) -> tuple[int, int]:
    """int32 ops of a ladder's consults: (each distinct level's seed hashed
    once, every consult hashing its seed)."""
    return OPS_PER_CONSULT * consults + OPS_PER_SEED * distinct, OPS_PER_LEVEL * consults


def profile_steps(torch, step, steps: int, warm: bool = True) -> dict:
    """Device busy time per serving step and the kernels that fill it, from
    a ``torch.profiler`` trace of ``steps`` calls of ``step`` (after one
    untraced unless ``warm`` is false)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list[float]] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
    busy_us = sum(sum(v) for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    return {
        "wall_ms_per_step": wall_us / steps / 1e3,
        "busy_ms_per_step": busy_us / steps / 1e3,
        "kernels_per_step": sum(len(v) for v in by_name.values()) / steps,
        "top": [(name[:60], sum(v) / steps / 1e3, len(v) // steps) for name, v in top],
    }


def print_profile(prof: dict) -> None:
    busy, wall = prof["busy_ms_per_step"], prof["wall_ms_per_step"]
    if busy > 0:
        print(f"  profiler: {wall:.4f} ms wall / {busy:.4f} ms device busy per step "
              f"(idle share {1 - busy / wall:.4f}), "
              f"{prof['kernels_per_step']:.0f} kernels per step")
        for name, ms_step, n in prof["top"]:
            print(f"    {ms_step:9.4f} ms/step {n:4d}x  {name}")
    else:
        print("  profiler: device time not measured (no CUDA events in the trace)")


def bound(bytes_moved: float, ops: float, f32_ops: float = 0.0) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S + f32_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# (label, library, pattern of the mangled kernel names): the kernels whose
# registers, stack frame and spills phase 1 prints
PTXAS_KERNELS = (
    ("ch_place", "baselines", r"13lookup_kernelINS_8ChLookup"),
    ("rs_place", "baselines", r"13lookup_kernelINS_8RsLookup"),
    (f"{FANOUT} ch", "baselines", r"15replicas_kernelINS_8ChLookupE"),
    (f"{FANOUT} rs", "baselines", r"15replicas_kernelINS_8RsLookupE"),
    (f"{FANOUT} wrh", "baselines", r"15replicas_kernelINS_9WrhLookupE"),
    ("hier_replicas", "hierarchy", r"20hier_replicas_kernelI"),
    ("place_fused", "asura_place", r"18place_fused_kernelE"),
    ("place", "asura_place", r"12place_kernelE"),
    ("place_replicas", "asura_place", r"21place_replicas_kernelI"),
    ("diff_nodes", "asura_place", r"17diff_nodes_kernel"),
    ("diff_replicas", "asura_place", r"20diff_replicas_kernelI"),
    (AN, "asura_place", r"23addition_numbers_kernelI"),
    (TW, "traffic", r"17lane_words_kernelI"),
    (SC, "serve", r"19select_count_kernelI"),
    ("count_update", "serve", r"19count_update_kernel"),
)


def ptxas_rows(report_of) -> list[tuple[str, str, dict]]:
    """(label, variant, ptxas numbers) of every instantiation of the
    PTXAS_KERNELS, from ``report_of(library) -> build.parse_ptxas``
    output; the variant names the slots' template bound (RMAX; 0 keeps
    them in rows), for B8 the staged or global branch and for B4 the
    alignment epilogue ("align")."""
    import re

    rows = []
    for label, lib, pattern in PTXAS_KERNELS:
        for sym, numbers in sorted(report_of(lib).items()):
            if not re.search(pattern, sym):
                continue
            staged = re.search(r"ILb([01])E", sym)
            rmax = re.search(r"Li(\d+)E(Lb[01]E)?E", sym)
            variant = " ".join(filter(None, (
                staged and ("staged" if staged.group(1) == "1" else "global"),
                rmax and f"{'n_words' if label == TW else 'RMAX'}={rmax.group(1)}",
                rmax and rmax.group(2) == "Lb1E" and "align")))
            rows.append((label, variant, numbers))
    return rows


def print_ptxas(report_of, tag: str = "ptxas") -> None:
    for label, variant, x in ptxas_rows(report_of):
        print(f"  {tag} {label:22s} {variant:18s} {x.get('registers')} registers, "
              f"{x.get('stack')} B stack frame, {x.get('spill_stores')} B spill stores, "
              f"{x.get('spill_loads')} B spill loads")


def unfmix32(np, h):
    """Ids whose MurmurHash3 finalizer is ``h`` (the finalizer inverted)."""
    h = h.astype(np.uint64)
    h ^= h >> 16
    h = (h * pow(0xC2B2AE35, -1, 2**32)) & 0xFFFFFFFF
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EBCA6B, -1, 2**32)) & 0xFFFFFFFF
    h ^= h >> 16
    return h.astype(np.uint32)


def search_edges() -> tuple:
    """(keys, equal-key run length, offset) of the synthetic search tables
    of phase 9a: the 4096-node ring's size, one not a multiple of its
    stride, the 10,000-node ring's size, an unaligned view of one (scalar
    bucket loads), the largest table staged whole, one key more (S = 2),
    and S = 8 with a ragged last bucket."""
    from repro_torch.kernels import launch

    whole = launch.INDEX_BUDGET // launch.KEY_BYTES
    return ((409_600, 6, 0), (409_603, 0, 0), (1_000_064, 5, 0), (1_000_003, 0, 1),
            (whole, 0, 0), (whole + 1, 2, 0), (4 * whole + 5, 3, 0))


def search_table(np, n: int, seed: int, runs: int):
    """A sorted u32 table of ``n`` keys and random owners; with ``runs``,
    runs of equal keys straddle every index bucket boundary of the stride
    the launcher picks for ``n``, and the last ``runs`` keys are the
    0xFFFFFFFF padding."""
    from repro_torch.kernels import launch

    rng = np.random.default_rng(seed + n)
    keys = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    if runs:
        S = 1 << launch.index_shift(n)
        for b in range(max(S, 2), n - runs, S):
            keys[b - runs // 2: b + runs - runs // 2] = keys[b - runs // 2]
        keys[-runs:] = np.uint32(0xFFFFFFFF)
        keys = np.sort(keys)
    return keys, rng.integers(0, LADDER_NODES, n).astype(np.int32)


def index_edge_ids(np, keys):
    """Ids hashing to every key of the sampled index the launcher stages
    for ``keys``, one above and one below each, 0 and 0xFFFFFFFF."""
    from repro_torch.kernels import launch

    idx = keys[:: 1 << launch.index_shift(keys.shape[0])].astype(np.int64)
    h = np.concatenate([[0, 2**32 - 1], idx - 1, idx, idx + 1])
    return unfmix32(np, np.unique(np.clip(h, 0, 2**32 - 1)))


def search_plan(tb, alg: str, keys, n: int, R: int) -> dict:
    """The CH / RS launcher's plan for ``n`` ids, held to its statement
    in ``launch.baseline_plan``."""
    from repro_torch.kernels import launch

    plan = tb.launch_plan(alg, keys, n, n_replicas=R)
    stated = launch.baseline_plan(alg, n, keys.shape[0], plan["sms"], plan["blocks_per_sm"])
    require(plan == stated, f"{alg} launch plan {plan} != its statement {stated}")
    return plan


def plan_text(plan: dict) -> str:
    return (f"S={1 << plan['shift']} index {plan['smem']} B, grid {plan['grid']} x "
            f"{plan['block']} ({plan['blocks_per_sm']} per SM)")


def edge_ids(np, points):
    """Ids hashing to 0, 0xFFFFFFFF and to every table point and its
    neighbours (duplicated points once)."""
    p = points.astype(np.int64)
    h = np.concatenate([[0, 1, 2**32 - 2, 2**32 - 1], p - 1, p, p + 1])
    return unfmix32(np, np.unique(np.clip(h, 0, 2**32 - 1)))


def run(seed: int, dev, profile: bool = False) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import AsuraParams, PlacementEngine, make_cluster
    from repro_torch.kernels import asura_place as ap
    from repro_torch.kernels import build, ref
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import RequestStreamDriver

    rng = np.random.default_rng(seed)
    caps = {
        LADDER_NODES: rng.uniform(0.5, 2.0, LADDER_NODES),
        HUGE_NODES: rng.uniform(0.5, 2.0, HUGE_NODES),
    }

    def ids_on(n: int):
        return torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(dev)

    worst = {name: 0 for name in KERNELS + (FANOUT, AN, TW, B4A, SC)}
    t_run = time.perf_counter()

    def elapsed(done: str) -> None:
        print(f"  [{done} done {time.perf_counter() - t_run:.1f} s into the run]")

    def hold(name: str, what: str, got, want) -> None:
        bad, err = mismatches(torch, got, want)
        worst[name] = max(worst[name], err)
        print(f"  {name:15s} {what:44s} {bad} mismatches")
        require(bad == 0, f"{name} disagrees with its twin: {what}")

    # -- phase 1: card, build ------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"phase 1: built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    print_ptxas(build.ptxas_report)

    # -- phase 2: fused placement kernel vs twin -----------------------------
    print(f"phase 2: place_fused_cuda vs twin, {CHECK_IDS} ids, exact")
    ids = ids_on(CHECK_IDS)
    cases = [(n, AsuraParams()) for n in (LADDER_NODES, HUGE_NODES)]
    cases += [(LADDER_NODES, AsuraParams(max_draws=d)) for d in (0, 1)]
    for n_nodes, params in cases:
        art = PlacementEngine(make_cluster(caps[n_nodes], params), device=dev)._device_artifact()
        tabs = (art.len32_dev, art.cum_hi_dev, art.cum_lo_dev, art.node_of_dev)
        kw = dict(top_level=art.top_level, s_log2=params.s_log2, max_draws=params.max_draws)
        if params.max_draws <= 1:
            tail = int((ref.place_ref(ids, art.len32_dev, **kw) < 0).sum())
            print(f"  forced tail max_draws={params.max_draws}: {tail} of {CHECK_IDS} lanes")
        for emit in (False, True):
            hold("place_fused", f"{n_nodes} nodes {params} nodes={emit}",
                 ap.place_fused_cuda(ids, *tabs, emit_nodes=emit, **kw),
                 ref.place_fused_ref(ids, *tabs, emit_nodes=emit, **kw))

    # -- phase 3: replica kernel vs twin -------------------------------------
    print("phase 3: place_replicas_cuda vs twin, exact, with stats")
    for n_nodes, max_draws in ((LADDER_NODES, 128), (HUGE_NODES, 128), (LADDER_NODES, 1)):
        art = PlacementEngine(make_cluster(caps[n_nodes]), device=dev)._device_artifact()
        kw = dict(top_level=art.top_level, s_log2=1, max_draws=max_draws)
        for R, n in ((1, CHECK_IDS), (3, CHECK_IDS), (5, CHECK_IDS), (12, 1 << 16)):
            sub = ids[:n]
            for emit in (False, True):
                out, st = ap.place_replicas_cuda(sub, art.len32_dev, art.node_of_dev,
                                                 n_replicas=R, emit_nodes=emit,
                                                 emit_stats=True, **kw)
                out_t, st_t = ref.place_replicas_fused_ref(sub, art.len32_dev, art.node_of_dev,
                                                           n_replicas=R, emit_nodes=emit,
                                                           emit_stats=True, **kw)
                what = (f"{n_nodes} nodes (top {art.top_level}) max_draws={max_draws} R={R} "
                        f"{n} ids nodes={emit}")
                hold("place_replicas", what, out, out_t)
                hold("place_replicas", f"{what} stats", st, st_t)

    # -- phase 4: bulk main path ---------------------------------------------
    print(f"phase 4: PlacementEngine on the card, {BULK_IDS} ids")
    cluster = make_cluster(caps[LADDER_NODES])
    engine = PlacementEngine(cluster)
    require(engine.device.type == "cuda", f"engine placed on {engine.device}")
    art = engine.artifact()  # the one table upload, outside the sync guard
    bulk = ids_on(BULK_IDS)
    torch.cuda.synchronize()
    ev = {k: [] for k in ("place_fused", "place_replicas")}
    outs = {}
    ap.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(1 + TIMED_CALLS):
            for name, call in (
                ("place_fused", lambda: engine.place_nodes_device(bulk)),
                ("place_replicas", lambda: engine.place_replica_nodes_device(bulk, 3)),
            ):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                outs[name] = call()
                e.record()
                ev[name].append((s, e))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    bulk_launches = dict(ap.LAUNCHES)
    torch.cuda.synchronize()
    print(f"  launches {bulk_launches}, uploads {engine.uploads}")
    require(engine.uploads == 1, f"engine uploaded {engine.uploads} tables")
    require(bulk_launches["place_fused"] > 0 and bulk_launches["place_replicas"] > 0,
            "a kernel was not launched")
    ms = {k: statistics.median(s.elapsed_time(e) for s, e in v[1:]) for k, v in ev.items()}
    for k in ms:
        print(f"  {k:15s} median {ms[k]:.4f} ms over {TIMED_CALLS} calls, "
              f"{BULK_IDS / ms[k] * 1e3:.4g} ids/s")
    tabs = (art.len32_dev, art.cum_hi_dev, art.cum_lo_dev, art.node_of_dev)
    kw = dict(top_level=art.top_level, s_log2=1, max_draws=128)
    plain = {}
    want = ref.place_fused_ref(bulk, *tabs, emit_nodes=True, **kw)
    hold("place_fused", "engine place_nodes_device", outs["place_fused"], want)
    plain["place_fused"] = statistics.median(cuda_ms(
        torch, lambda: ref.place_fused_ref(bulk, *tabs, emit_nodes=True, **kw), 2))
    want = ref.place_replicas_fused_ref(bulk, art.len32_dev, art.node_of_dev, n_replicas=3,
                                        emit_nodes=True, emit_stats=False, **kw)
    hold("place_replicas", "engine place_replica_nodes_device R=3", outs["place_replicas"], want)
    plain["place_replicas"] = statistics.median(cuda_ms(
        torch, lambda: ref.place_replicas_fused_ref(
            bulk, art.len32_dev, art.node_of_dev, n_replicas=3, emit_nodes=True,
            emit_stats=False, **kw), 2))
    # the work this run's data needs, read from the replica kernel's stats
    # (at R = 1 it makes exactly the fused kernel's draws; its unfilled
    # lanes are the fused kernel's tail lanes)
    n_segs = art.n_segs
    _, st1 = ap.place_replicas_cuda(bulk, art.len32_dev, art.node_of_dev, n_replicas=1,
                                    emit_stats=True, **kw)
    _, st3 = ap.place_replicas_cuda(bulk, art.len32_dev, art.node_of_dev, n_replicas=3,
                                    emit_stats=True, **kw)
    levels1, draws1 = ladder_work(torch, st1, art.top_level)
    tail1 = int(st1[ref.DEPTH_BINS].view(torch.int32))
    levels3, draws3 = ladder_work(torch, st3, art.top_level)
    seeds1, seeds3 = (distinct_levels(bulk, art.len32_dev, art.node_of_dev, art.top_level, R)
                      for R in (1, 3))
    search = (n_segs - 1).bit_length()
    # a tail lane hashes one level-(top + 1) draw: a seed and a consult
    rest1 = OPS_PER_LEVEL * tail1 + OPS_PER_DRAW * draws1 + 6 * search * tail1
    bytes1, bytes3 = 8 * BULK_IDS + 16 * n_segs, 4 * BULK_IDS + 4 * 3 * BULK_IDS + 8 * n_segs
    (ops1, old1), (ops3, old3) = ladder_ops(levels1, seeds1), ladder_ops(levels3, seeds3)
    work = {"place_fused": (bytes1, ops1 + rest1),
            "place_replicas": (bytes3, ops3 + (OPS_PER_DRAW + 3) * draws3)}
    unseeded = {"place_fused": (bytes1, old1 + rest1),
                "place_replicas": (bytes3, old3 + (OPS_PER_DRAW + 3) * draws3)}
    print(f"  work: R=1 {levels1} levels of {seeds1} distinct / {draws1} draws / {tail1} tail "
          f"lanes; R=3 {levels3} levels of {seeds3} distinct / {draws3} draws")

    # -- phase 5: serving main path ------------------------------------------
    print(f"phase 5: RequestStreamDriver batch {SERVE_BATCH}, {SERVE_KEYS} keys, "
          f"zipf 1.1, R=3, pow2, {SERVE_STEPS} steps")
    cfg = dict(batch=SERVE_BATCH, n_keys=SERVE_KEYS, law="zipf", alpha=1.1,
               n_replicas=3, policy="pow2", seed=seed)
    metrics = MetricsRegistry()
    driver = RequestStreamDriver(engine, metrics=metrics, **cfg)
    torch.cuda.synchronize()
    chosen, step_ev = [], []
    ap.reset_launches()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(SERVE_STEPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            chosen.append(driver.step())
            e.record()
            step_ev.append((s, e))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    serve_launches = dict(ap.LAUNCHES)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / SERVE_STEPS
    step_ms = [s.elapsed_time(e) for s, e in step_ev]
    print(f"  launches {serve_launches}, uploads {engine.uploads}, "
          f"step_traces {driver.step_traces}")
    require(serve_launches["place_replicas"] > 0, "serving did not launch the replica kernel")
    require(serve_launches[SC] == serve_launches["count_update"] == SERVE_STEPS,
            f"serving launched SC {serve_launches[SC]} and the bin update "
            f"{serve_launches['count_update']} times in {SERVE_STEPS} steps")
    require(engine.uploads == 1, f"engine uploaded {engine.uploads} tables")
    counts = driver.load_counts()
    require(int(counts.sum()) == SERVE_STEPS * SERVE_BATCH, f"counts sum {counts.sum()}")
    live = torch.tensor(sorted(cluster.nodes), device=dev, dtype=torch.int32)
    require(bool(torch.isin(torch.stack(chosen), live).all()), "a request went to a dead node")
    snap = metrics.snapshot()
    require(np.array_equal(snap["serve.served"].astype(np.int64), counts.astype(np.int64)),
            "slab serve.served != load_counts")
    skew, p99 = driver.load_skew(), driver.queue_p99()
    print(f"  step median {statistics.median(step_ms):.4f} ms (CUDA events), "
          f"{wall_ms:.4f} ms wall incl. enqueue; load_skew {skew:.6f}, queue_p99 {p99}")
    t0 = time.perf_counter()
    cpu_metrics = MetricsRegistry(device="cpu")
    cpu = RequestStreamDriver(
        PlacementEngine(make_cluster(caps[LADDER_NODES]), device="cpu"),
        metrics=cpu_metrics, **cfg,
    )
    for i in range(SERVE_STEPS):
        bad, _ = mismatches(torch, chosen[i].cpu(), cpu.step())
        require(bad == 0, f"step {i}: {bad} chosen nodes differ from the CPU driver")
    for name in ("counts", "queue", "qhist"):
        bad, _ = mismatches(torch, getattr(driver, name).cpu(), getattr(cpu, name))
        require(bad == 0, f"{name} differs from the CPU driver")
    cpu_snap = cpu_metrics.snapshot()
    for name, v in snap.items():
        require(np.array_equal(np.asarray(v), np.asarray(cpu_snap[name])),
                f"slab {name} differs from the CPU driver")
    print(f"  equal to the CPU driver (twins) in chosen, counts, queue, qhist and slab "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    if profile:
        print_profile(profile_steps(torch, RequestStreamDriver(engine, **cfg).step, 4))
    tw = phase5b(torch, dev, hold)
    sc = phase5c(torch, np, dev, hold)

    elapsed("phases 1-5")

    # -- phase 7: diff kernels vs twins ---------------------------------------
    diff_work = phase7(torch, np, dev, caps[LADDER_NODES], ids, hold)
    elapsed("phase 7")

    # -- phase 8: migration main path ----------------------------------------
    print(f"phase 8: migration path, {LADDER_NODES} nodes, {BULK_IDS} tracked ids, "
          f"{SERVE_KEYS} keys, batch {SERVE_BATCH}")
    ap.reset_launches()
    big = migration_path(torch, np, dev, caps[LADDER_NODES], n_tracked=BULK_IDS,
                         n_keys=SERVE_KEYS, batch=SERVE_BATCH, seed=seed,
                         profile=profile)
    mig_launches = big.pop("launches")
    print(f"  launches {mig_launches}")
    require(mig_launches["diff_nodes"] > 0 and mig_launches[B4A] > 0
            and mig_launches["place_replicas"] > 0 and mig_launches[AN] > 0,
            "the migration path did not launch B2, B3, the aligned B4 and the "
            "ADDITION-NUMBER kernel")
    print(f"phase 8b: the same sequence at {SMALL_TRACKED} tracked ids, batch "
          f"{SMALL_BATCH}, on the card and on the CPU")
    t0 = time.perf_counter()
    card, host = (
        migration_path(torch, np, where, caps[LADDER_NODES], n_tracked=SMALL_TRACKED,
                       n_keys=SMALL_TRACKED, batch=SMALL_BATCH, seed=seed, quiet=True)
        for where in (dev, torch.device("cpu"))
    )
    card.pop("launches")
    host.pop("launches")
    require(card.keys() == host.keys(), "phase 8b results differ in keys")
    for key, a in card.items():
        b = host[key]
        same = np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
        require(same, f"phase 8b: {key} differs between the card and the CPU")
    print(f"  equal on the card and the CPU in {len(card)} results, {card['rounds']} rounds "
          f"(plans, round matrices, chosen, counts, queue, qhist, slab, the window's "
          f"prefilter scanned / kept {card['window.prefilter_scanned']} / "
          f"{card['window.prefilter_kept']}; {time.perf_counter() - t0:.1f} s)")
    elapsed("phases 8, 8b")
    an_work = phase8c(torch, np, dev, caps[LADDER_NODES], ids, bulk, hold)
    elapsed("phase 8c")

    # -- phase 9: the baselines ----------------------------------------------
    base = phase9(torch, np, dev, caps, seed, ids, bulk, hold, profile)
    elapsed("phase 9")

    # -- phase 10: failure-domain-aware placement ----------------------------
    hier = phase10(torch, np, dev, caps, seed, ids, bulk, hold, profile)
    elapsed("phase 10")

    # -- phase 11: the consumers of placement ---------------------------------
    consumer_launches = phase11(torch, np, dev, caps[LADDER_NODES], seed)
    elapsed("phase 11")

    # -- phase 12: the multi-card sweep ---------------------------------------
    mesh_launches = phase12(torch, np, dev, caps[LADDER_NODES], seed, bulk)
    elapsed("phase 12")

    # -- phase 13: the dense language-model serving path ----------------------
    lm_launches = phase13(torch, np, dev, seed)
    elapsed("phase 13")

    # -- phase 14: the dense language-model training path ---------------------
    train_launches = phase14(torch, np, dev, seed)
    elapsed("phase 14")

    # -- phase 15: the MoE language models ------------------------------------
    moe_launches = phase15(torch, np, dev, seed)
    elapsed("phase 15")

    # -- phase 16: the recurrent, RWKV and encoder-decoder families -----------
    rec_launches = phase16(torch, np, dev, seed)
    elapsed("phase 16")

    # -- phase 17: the sharded model path --------------------------------------
    shard_launches = phase17(torch, np, dev, seed)
    elapsed("phase 17")

    # -- B3-B9 and the fan-out: times, twins, work ----------------------------
    for part in (diff_work, base, hier, an_work, tw, sc):
        ms.update(part["ms"])
        plain.update(part["plain"])
        work.update(part["work"])
        unseeded.update(part.get("unseeded", {}))
    library = base["library"]

    # -- phase 6: the kernels line -------------------------------------------
    main_paths = (bulk_launches, serve_launches, mig_launches, *base["launches"],
                  *hier["launches"], consumer_launches, mesh_launches, lm_launches,
                  train_launches, moe_launches, rec_launches, shard_launches)
    kernels = []
    no_tpu_kernel = {FANOUT: (FANOUT_OF, SOURCE_BASELINES), AN: (AN_OF, SOURCE),
                     TW: (TW_OF, SOURCE_TRAFFIC), B4A: (B4A_OF, SOURCE),
                     SC: (SC_OF, SOURCE_SERVE)}
    for name in KERNELS + (FANOUT, AN, TW, B4A, SC):
        b_ms, b_by = bound(*work[name])
        # B4's launches in either form: the main paths' replica diffs align
        counted = (name, B4A) if name == "diff_replicas" else (name,)
        launches = sum(part.get(k, 0) for part in main_paths for k in counted)
        replaces, source = REPLACES.get(name) or no_tpu_kernel[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": worst[name], "ms": ms[name], "plain_ms": plain[name],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library.get(name),
        }
        if name == FANOUT:
            entry["note"] = ("no TPU counterpart: the reference runs this R-way "
                             "fan-out as a jnp loop; times are ch at R=3")
            entry["ms_by_algorithm"] = base["fanout_ms"]
        if name == AN:
            entry["note"] = ("no TPU counterpart: the reference computes this trace in "
                             f"jnp; R=3 on the extended ladder; plain_ms on {CHECK_IDS} ids, "
                             f"where the kernel takes {an_work['ms_small']:.4f} ms")
        if name == TW:
            entry["note"] = ("no TPU counterpart: the reference draws these words with "
                             f"jax.random in jnp; n_words=1 on {TW_LANES} lanes (route_batch's "
                             "form); n_words=2 (step()'s) beside it")
            entry.update(tw["two_words"])
        if name == SC:
            entry["note"] = ("no TPU counterpart: the reference selects and counts in one jit "
                             f"of jnp ops; R=3, pow2, {TW_LANES} lanes, {SC_BINS} bins; the bin "
                             "update beside it")
            entry.update(sc["update"])
        if name == B4A:
            entry["note"] = ("B4 with the per-slot alignment as its epilogue, R=3 on the add; "
                             "plain_ms B4's twin then ops.align_replica_sets")
            entry["b4_ms"] = ms["diff_replicas"]
            entry["two_step_ms"] = diff_work["two_step"]
        if name in unseeded:
            entry["bound_unseeded_ms"] = bound(*unseeded[name])[0]
        if name in diff_work["two_walks"]:
            entry["bound_two_walks_ms"] = diff_work["two_walks"][name]
        kernels.append(entry)
        lib = "" if entry["library_ms"] is None else f", library {entry['library_ms']:.4f} ms"
        if "ms_n_words_2" in entry:
            lib += (f" ({entry['ms_in_a_row']:.4f} ms a launch in a row); n_words=2 "
                    f"{entry['ms_n_words_2']:.4f} ms ({entry['ms_in_a_row_n_words_2']:.4f}) vs "
                    f"bound {entry['bound_ms_n_words_2']:.4f} ms, twin "
                    f"{entry['plain_ms_n_words_2']:.2f} ms")
        if "bound_unseeded_ms" in entry:
            lib += f", bound hashing every consult's seed {entry['bound_unseeded_ms']:.4f} ms"
        if "bound_two_walks_ms" in entry:
            lib += f", two-walk bound {entry['bound_two_walks_ms']:.4f} ms"
        if "two_step_ms" in entry:
            lib += (f"; B4 alone {entry['b4_ms']:.4f} ms, B4 then ops.align_replica_sets "
                    f"{entry['two_step_ms']:.4f} ms")
        if "update_ms" in entry:
            lib += (f" ({entry['ms_in_a_row']:.4f} ms a launch in a row); the bin update "
                    f"{entry['update_ms']:.4f} ms, its twin {entry['update_plain_ms']:.4f} ms")
        print(f"phase 6: {name}: 0 mismatches, {launches} launches on the main paths, "
              f"{ms[name]:.4f} ms vs bound {b_ms:.4f} ms ({b_by}), twin {plain[name]:.2f} ms"
              f"{lib}")
        require(launches > 0, f"{name} was not launched on the main paths")
    return {"kernels": kernels}


def phase5b(torch, dev, hold) -> dict:
    """The selection-word kernel (TW) against its twin on the card, exact;
    then its CUDA-event time at TW_LANES lanes, n_words 1 and 2, a lone
    launch and TW_BACK_TO_BACK launches in a row (per launch), beside the
    twin's and the bound.  Its launches here are not the main path's."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.traffic import lane_words_cuda
    from repro_torch.serve.traffic import fold_in, prng_key
    from repro_torch.serve.traffic import lane_words_twin as twin

    print(f"phase 5b: {TW} (TW) vs its twin on the card, n_words 1 and 2, exact; "
          f"timed at {TW_LANES} lanes")
    edge = torch.tensor([0, 1, 511, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1],
                        dtype=torch.int64, device=dev)
    # lanes crossing 2**31 and 2**32 (a mesh rank's global lanes wrap mod 2**32)
    ragged = torch.arange(CHECK_IDS, dtype=torch.int64, device=dev) * 4099 + 2**31 - 2**20
    lanes = torch.arange(TW_LANES, dtype=torch.int64, device=dev)
    ms, in_row, plain, work = {}, {}, {}, {}
    with uncounted(LAUNCHES):
        for seed, step in ((0, 0), (7, 1), (2**31 - 1, 1000), (-5, 0)):
            key = fold_in(prng_key(seed), step)
            for nw in (1, 2):
                for what, x in (("edge lanes", edge), (f"{CHECK_IDS} lanes", ragged)):
                    hold(TW, f"seed {seed} step {step} n_words={nw} {what}",
                         lane_words_cuda(key, x, nw), twin(key, x, nw))
        key = fold_in(prng_key(0), 0)
        for nw in (1, 2):
            ms[nw] = statistics.median(cuda_ms(
                torch, lambda: lane_words_cuda(key, lanes, nw), TIMED_CALLS))
            in_row[nw] = statistics.median(cuda_ms(
                torch, lambda: [lane_words_cuda(key, lanes, nw) for _ in range(TW_BACK_TO_BACK)],
                TIMED_CALLS)) / TW_BACK_TO_BACK
            plain[nw] = statistics.median(cuda_ms(torch, lambda: twin(key, lanes, nw), 2))
            work[nw] = ((8 + 8 * nw) * TW_LANES, ((1 + nw) * THREEFRY_OPS + nw) * TW_LANES)
            print(f"  n_words={nw}: {ms[nw]:.4f} ms a lone launch, {in_row[nw]:.4f} ms a launch "
                  f"of {TW_BACK_TO_BACK} in a row (CUDA events, median of {TIMED_CALLS}), "
                  f"bound {bound(*work[nw])[0]:.4f} ms ({bound(*work[nw])[1]}), "
                  f"twin {plain[nw]:.2f} ms")
    b2, by2 = bound(*work[2])
    return {"ms": {TW: ms[1]}, "plain": {TW: plain[1]}, "work": {TW: work[1]},
            "two_words": {"ms_in_a_row": in_row[1], "ms_n_words_2": ms[2],
                          "ms_in_a_row_n_words_2": in_row[2], "plain_ms_n_words_2": plain[2],
                          "bound_ms_n_words_2": b2, "bound_by_n_words_2": by2}}


def sc_operands(torch, np, dev, n: int, R: int, n_bins: int, seed: int,
                holes: bool = False, hot: float = 0.0):
    """(owners, words, counts) on ``dev`` for SC: (n, R) int32 nodes below
    ``n_bins`` (with ``holes`` 15 % -1 slots and 2 % fully invalid rows;
    ``hot`` of the lanes on the first lane's record), (n,) int64 u32 words,
    (n_bins,) int32 start-of-batch counts with ties."""
    rng = np.random.default_rng(seed)
    owners = rng.integers(0, n_bins, (n, R)).astype(np.int32)
    if holes:
        owners[rng.random((n, R)) < 0.15] = -1
        owners[rng.random(n) < 0.02] = -1
    if hot:
        owners[rng.random(n) < hot] = owners[0]
    words = rng.integers(0, 2**32, n, dtype=np.uint32).astype(np.int64)
    counts = rng.integers(0, 50, n_bins).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (owners, words, counts))


def phase5c(torch, np, dev, hold) -> dict:
    """SC and the bin update against their twins on the card, exact; then
    SC's CUDA-event time at TW_LANES lanes, R = 3, pow2, SC_BINS bins (a
    lone launch and TW_BACK_TO_BACK in a row, per launch), beside the
    twin's and the traffic bound; the update's time at SC_BINS bins.  Its
    launches here are not the main path's."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.serve import count_update_cuda, select_count_cuda
    from repro_torch.serve.stream import POLICIES, count_update_twin, select_count_twin

    print(f"phase 5c: {SC} (SC) and count_update vs their twins on the card, exact; "
          f"timed at {TW_LANES} lanes")
    plane_bins = 232_448 // 4 + 11_843  # past an H100 block's shared memory
    with uncounted(LAUNCHES):
        for policy in POLICIES:
            for R in (1, 3, 5):
                for what, n_bins, kw in (
                    ("dense", SC_BINS, {}), ("holes, pad", SC_BINS, dict(holes=True)),
                    ("30% on one record", SC_BINS, dict(hot=0.3)),
                    ("global bins", plane_bins, dict(holes=True)),
                ):
                    owners, words, counts = sc_operands(torch, np, dev, CHECK_IDS, R, n_bins,
                                                        R, **kw)
                    n_valid = CHECK_IDS - (1000 if what.endswith("pad") else 0)
                    start = (counts % 7).contiguous()
                    want_hist = start.clone()
                    args = dict(policy=policy, n_replicas=R, n_valid=n_valid)
                    want = select_count_twin(owners, words, counts, want_hist, **args)
                    for form, o, w in (
                        ("", owners, words),
                        (", strided words, (R, n) owners", owners.T.contiguous().T,
                         torch.stack([words, words], 1)[:, 1]),
                    ):
                        hist = start.clone()
                        got = select_count_cuda(o, w, counts, hist, **args)
                        hold(SC, f"{policy} R={R} {what}{form}", got, want)
                        hold(SC, f"  its histogram", hist, want_hist)
        hist = torch.randint(0, 1000, (SC_BINS,), dtype=torch.int32, device=dev)
        counts = torch.randint(0, 2**31 - 1, (SC_BINS,), dtype=torch.int32, device=dev)
        queue = torch.randint(0, 800, (SC_BINS,), dtype=torch.int32, device=dev)
        service = torch.full((SC_BINS,), 420, dtype=torch.int32, device=dev)
        rows = torch.zeros((2, SC_BINS), dtype=torch.int32, device=dev)
        want = count_update_twin(hist.clone(), counts, queue, service, rows[0])
        got = count_update_cuda(hist, counts, queue, service, rows[1])
        hold(SC, "count_update counts", got[0], want[0])
        hold(SC, "count_update queue and its ring row", torch.stack([got[1], rows[1]]),
             torch.stack([want[1], rows[0]]))
        require(not bool(hist.any()), "count_update left the histogram non-zero")

        owners, words, counts = sc_operands(torch, np, dev, TW_LANES, 3, SC_BINS, 0, hot=0.038)
        hist = torch.zeros(SC_BINS, dtype=torch.int32, device=dev)
        args = dict(policy="pow2", n_replicas=3, n_valid=TW_LANES)
        ms = statistics.median(cuda_ms(
            torch, lambda: select_count_cuda(owners, words, counts, hist, **args), TIMED_CALLS))
        in_row = statistics.median(cuda_ms(
            torch, lambda: [select_count_cuda(owners, words, counts, hist, **args)
                            for _ in range(TW_BACK_TO_BACK)], TIMED_CALLS)) / TW_BACK_TO_BACK
        plain = statistics.median(cuda_ms(
            torch, lambda: select_count_twin(owners, words, counts, hist, **args), TIMED_CALLS))
        work = ((3 * 4 + 8 + 4) * TW_LANES, SC_OPS * TW_LANES)
        queue = torch.zeros(SC_BINS, dtype=torch.int32, device=dev)
        service = torch.full((SC_BINS,), 420, dtype=torch.int32, device=dev)
        update = statistics.median(cuda_ms(
            torch, lambda: count_update_cuda(hist, counts, queue, service, rows[1]),
            TIMED_CALLS))
        update_plain = statistics.median(cuda_ms(
            torch, lambda: count_update_twin(hist, counts, queue, service, rows[0]),
            TIMED_CALLS))
    print(f"  SC: {ms:.4f} ms a lone launch, {in_row:.4f} ms a launch of {TW_BACK_TO_BACK} "
          f"in a row (CUDA events, median of {TIMED_CALLS}), bound {bound(*work)[0]:.4f} ms "
          f"({bound(*work)[1]}), twin {plain:.4f} ms; shared plane {4 * SC_BINS} B dynamic")
    print(f"  count_update: {update:.4f} ms a lone launch at {SC_BINS} bins, twin "
          f"{update_plain:.4f} ms")
    return {"ms": {SC: ms}, "plain": {SC: plain}, "work": {SC: work},
            "update": {"ms_in_a_row": in_row, "update_ms": update,
                       "update_plain_ms": update_plain, "shared_plane_bytes": 4 * SC_BINS}}


def phase7(torch, np, dev, caps, ids, hold) -> dict:
    """B3 and B4 against their twins on the card, B4's aligned launch
    against B4 then ``ops.align_replica_sets``; then their times, twin
    times and work at 2**24 ids on the add event."""
    from repro_torch.core import AsuraParams, PlacementEngine, make_cluster
    from repro_torch.kernels import asura_place as ap
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import align_replica_sets

    n = len(caps)
    victim = n // 2

    def event_artifacts(caps, params, event):
        """(art_a, art_b) around ``event(cluster)``, v pinned first."""
        cluster = make_cluster(caps, params)
        engine = PlacementEngine(cluster, device=dev)
        engine.artifact()
        v0 = cluster.version
        event(cluster)
        return engine._device_artifact_for(v0), engine._device_artifact_for(cluster.version)

    def add(c):
        c.add_node(n, 1.0)

    def remove(c):
        c.remove_node(victim)

    cases = [
        ("add", caps, AsuraParams(), add),
        ("remove", caps, AsuraParams(), remove),
        ("tail max_draws=1 add", caps, AsuraParams(max_draws=1), add),
        ("top change 14 -> 17 segs", [0.75] * 14, AsuraParams(),
         lambda c: c.add_node(14, 3.0)),
        ("top +2 14 -> 33 segs", [0.75] * 14, AsuraParams(),
         lambda c: c.add_node(14, 19.0)),
        (f"scale-out {n} -> {n + SCALE_OUT} nodes", caps, AsuraParams(),
         lambda c: scale_out(np, c)),
    ]
    print(f"phase 7: diff_nodes_cuda / diff_replicas_cuda vs twins, {ids.shape[0]} ids, exact; "
          "diff_replicas_aligned_cuda vs ops.align_replica_sets of diff_replicas_cuda")
    arts = {}
    for name, cc, params, event in cases:
        arts[name] = (event_artifacts(cc, params, event), params)
    # the top changes swapped (the top goes down), and one version as both
    (a, b), _ = arts["top change 14 -> 17 segs"]
    arts["top down 17 -> 14 segs"] = ((b, a), AsuraParams())
    (a, b), _ = arts[f"scale-out {n} -> {n + SCALE_OUT} nodes"]
    arts[f"scale-in {n + SCALE_OUT} -> {n} nodes"] = ((b, a), AsuraParams())
    (a, _), _ = arts["add"]
    arts["same version (A = B)"] = ((a, a), AsuraParams())
    # the reused hole: from the removal's table, an add reuses the number
    cluster = make_cluster(caps)
    cluster.remove_node(victim)
    engine = PlacementEngine(cluster, device=dev)
    engine.artifact()
    v_holes = cluster.version
    new = cluster.add_node(n, 0.7)
    require(new[0] < n, f"the add did not reuse a freed number: {new}")
    arts["reuse hole"] = ((engine._device_artifact_for(v_holes),
                           engine._device_artifact_for(cluster.version)), AsuraParams())
    for name, shift in (("top change 14 -> 17 segs", 1), ("top +2 14 -> 33 segs", 2),
                        ("top down 17 -> 14 segs", -1),
                        (f"scale-out {n} -> {n + SCALE_OUT} nodes", 1),
                        (f"scale-in {n + SCALE_OUT} -> {n} nodes", -1)):
        (a, b), _ = arts[name]
        require(b.top_level - a.top_level == shift, f"{name}: top {a.top_level} -> {b.top_level}")
    print("  segments (top levels) " + ", ".join(
        f"{k}: {x.n_segs} ({x.top_level}) -> {y.n_segs} ({y.top_level})"
        for k, ((x, y), _) in arts.items()))
    for name, ((a, b), params) in arts.items():
        kw = dict(top_a=a.top_level, top_b=b.top_level, s_log2=params.s_log2,
                  max_draws=params.max_draws)
        tabs = (a.len32_dev, a.cum_hi_dev, a.cum_lo_dev, a.node_of_dev,
                b.len32_dev, b.cum_hi_dev, b.cum_lo_dev, b.node_of_dev)
        got = ap.diff_nodes_cuda(ids, *tabs, **kw)
        hold("diff_nodes", name, got, ref.diff_fused_ref(ids, *tabs, **kw))
        if a is b:
            require(torch.equal(got[0], got[1]), f"{name}: the two rows differ")
        rtabs = (a.len32_dev, a.node_of_dev, b.len32_dev, b.node_of_dev)
        for R in (1, 3, 9, 12):
            sub = ids if R < 9 else ids[: 1 << 16]
            got = ap.diff_replicas_cuda(sub, *rtabs, n_replicas=R, **kw)
            hold("diff_replicas", f"{name} R={R}", got,
                 ref.diff_replicas_fused_ref(sub, *rtabs, n_replicas=R, **kw))
            if a is b:
                require(torch.equal(got[0], got[1]), f"{name} R={R}: the two rows differ")
            aligned = ap.diff_replicas_aligned_cuda(sub, *rtabs, n_replicas=R, **kw)
            require(aligned[0].dtype == torch.bool
                    and all(t.is_contiguous() and t.shape == (sub.shape[0], R) for t in aligned),
                    f"{name} R={R}: aligned outputs of the wrong form")
            hold(B4A, f"{name} R={R}", torch.stack([t.to(torch.int32) for t in aligned]),
                 torch.stack([t.to(torch.int32) for t in align_replica_sets(got[0], got[1])]))

    # times at 2**24 ids on the add event, and the work this data needs
    (a, b), params = arts["add"]
    bulk = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2**32, BULK_IDS, dtype=np.uint32)).to(dev)
    kw = dict(top_a=a.top_level, top_b=b.top_level, s_log2=1, max_draws=128)
    tabs = (a.len32_dev, a.cum_hi_dev, a.cum_lo_dev, a.node_of_dev,
            b.len32_dev, b.cum_hi_dev, b.cum_lo_dev, b.node_of_dev)
    rtabs = (a.len32_dev, a.node_of_dev, b.len32_dev, b.node_of_dev)
    out = {"ms": {}, "plain": {}, "work": {}}
    with uncounted(ap.LAUNCHES):
        out["ms"]["diff_nodes"] = statistics.median(cuda_ms(
            torch, lambda: ap.diff_nodes_cuda(bulk, *tabs, **kw), TIMED_CALLS))
        out["ms"]["diff_replicas"] = statistics.median(cuda_ms(
            torch, lambda: ap.diff_replicas_cuda(bulk, *rtabs, n_replicas=3, **kw),
            TIMED_CALLS))
        out["plain"]["diff_nodes"] = statistics.median(cuda_ms(
            torch, lambda: ref.diff_fused_ref(bulk, *tabs, **kw), 2))
        out["plain"]["diff_replicas"] = statistics.median(cuda_ms(
            torch, lambda: ref.diff_replicas_fused_ref(bulk, *rtabs, n_replicas=3, **kw), 2))
        out["ms"][B4A] = statistics.median(cuda_ms(
            torch, lambda: ap.diff_replicas_aligned_cuda(bulk, *rtabs, n_replicas=3, **kw),
            TIMED_CALLS))
        out["two_step"] = statistics.median(cuda_ms(
            torch, lambda: align_replica_sets(*ap.diff_replicas_cuda(
                bulk, *rtabs, n_replicas=3, **kw)), TIMED_CALLS))
        out["plain"][B4A] = statistics.median(cuda_ms(
            torch, lambda: align_replica_sets(*ref.diff_replicas_fused_ref(
                bulk, *rtabs, n_replicas=3, **kw)), 2))
        # one walk of the deeper ladder serves both tables: its consulted
        # levels are at least the larger table's; every draw of each table
        # is tested (and B4's hits gathered) and each table's tail resolved
        fused_ops, rep_ops, segs = 0, 0, 0
        levels, seeds = {1: [], 3: []}, {1: [], 3: []}
        for art in (a, b):
            lk = dict(top_level=art.top_level, s_log2=1, max_draws=128, emit_stats=True)
            _, st1 = ap.place_replicas_cuda(bulk, art.len32_dev, art.node_of_dev,
                                            n_replicas=1, **lk)
            _, st3 = ap.place_replicas_cuda(bulk, art.len32_dev, art.node_of_dev,
                                            n_replicas=3, **lk)
            levels1, draws1 = ladder_work(torch, st1, art.top_level)
            tail1 = int(st1[ref.DEPTH_BINS].view(torch.int32))
            levels3, draws3 = ladder_work(torch, st3, art.top_level)
            search = (art.n_segs - 1).bit_length()
            fused_ops += OPS_PER_LEVEL * tail1 + OPS_PER_DRAW * draws1 + 6 * search * tail1
            rep_ops += (OPS_PER_DRAW + 3) * draws3
            levels[1].append(levels1)
            levels[3].append(levels3)
            for R in (1, 3):
                seeds[R].append(distinct_levels(bulk, art.len32_dev, art.node_of_dev,
                                                art.top_level, R))
            segs += art.n_segs
            print(f"  work on v{art.version} ({art.n_segs} segs): R=1 {levels1} levels of "
                  f"{seeds[1][-1]} distinct / {draws1} draws / {tail1} tail lanes; R=3 "
                  f"{levels3} levels of {seeds[3][-1]} distinct / {draws3} draws")
    nodes_bytes = 4 * BULK_IDS + 2 * 4 * BULK_IDS + 16 * segs
    replicas_bytes = 4 * BULK_IDS + 2 * 4 * 3 * BULK_IDS + 8 * segs
    # the aligned launch writes moved (1 B) and src, dst, src_slot (4 B
    # each) a slot, and its epilogue compares each slot with the other set
    aligned_bytes = 4 * BULK_IDS + 13 * 3 * BULK_IDS + 8 * segs
    aligned_ops = rep_ops + 2 * 3 * 3 * BULK_IDS
    out["unseeded"] = {}
    for name, R, nbytes, ops in (("diff_nodes", 1, nodes_bytes, fused_ops),
                                 ("diff_replicas", 3, replicas_bytes, rep_ops),
                                 (B4A, 3, aligned_bytes, aligned_ops)):
        new, old = ladder_ops(max(levels[R]), max(seeds[R]))
        out["work"][name] = (nbytes, ops + new)
        out["unseeded"][name] = (nbytes, ops + old)
    # the earlier count, two complete walks, so that its ratios still compare
    out["two_walks"] = {
        "diff_nodes": bound(nodes_bytes, fused_ops + OPS_PER_LEVEL * sum(levels[1]))[0],
        "diff_replicas": bound(replicas_bytes, rep_ops + OPS_PER_LEVEL * sum(levels[3]))[0],
    }
    for k in ("diff_nodes", "diff_replicas", B4A):
        print(f"  {k:15s} median {out['ms'][k]:.4f} ms over {TIMED_CALLS} calls on "
              f"{BULK_IDS} ids (R=3 for replicas), twin {out['plain'][k]:.2f} ms")
    print(f"  B4 then ops.align_replica_sets: median {out['two_step']:.4f} ms")
    return out


def phase8c(torch, np, dev, caps, ids, bulk, hold) -> dict:
    """The ADDITION-NUMBER kernel against its twin on phase 8's v0 table,
    the engine's trace under sync-debug "error", and the kernel's time and
    work at 2**24 ids (R = 3)."""
    from repro_torch.core import PlacementEngine, make_cluster
    from repro_torch.kernels import asura_place as ap
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import addition_numbers_top

    engine = PlacementEngine(make_cluster(caps), device=dev)
    art = engine.artifact()
    top = addition_numbers_top(art.top_level)  # the ladder the engine's trace uses
    tabs = (art.len32_dev, art.node_of_dev)
    small = ids[: 1 << 16]
    print(f"phase 8c: addition_numbers_cuda vs twin on the {len(caps)}-node v0 table "
          f"(top {art.top_level}, the trace's ladder from {top}), exact")
    out = {"ms": {}, "plain": {}, "work": {}, "unseeded": {}}
    with uncounted(ap.LAUNCHES):
        for R, sub, max_draws in ((3, ids, 128), (1, ids, 128), (9, small, 128),
                                  (1, small, 2), (3, small, 2)):
            kw = dict(top_level=top, s_log2=1, max_draws=max_draws, n_replicas=R)
            got = ap.addition_numbers_cuda(sub, *tabs, **kw)
            if R == 3 and max_draws == 128:  # the twin's time on this check, one call
                kernel = got
                want, out["plain"][AN] = timed(torch, dev, lambda: ref.addition_numbers_ref(
                    sub, *tabs, **kw))
            else:
                want = ref.addition_numbers_ref(sub, *tabs, **kw)
            hold(AN, f"R={R} {sub.shape[0]} ids max_draws={max_draws} "
                     f"({int((got < 0).sum())} lanes -1)", got, want)
        kw = dict(top_level=top, s_log2=1, max_draws=128, n_replicas=3)
        before = ap.LAUNCHES[AN]
        with sync_guard(torch, dev):
            got = engine.addition_numbers_device(ids, n_replicas=3)
        require(ap.LAUNCHES[AN] == before + 1, "addition_numbers_device did not launch once")
        hold(AN, "engine addition_numbers_device R=3 (sync-debug error) vs the kernel's",
             got, kernel)
        out["ms"][AN] = statistics.median(cuda_ms(
            torch, lambda: ap.addition_numbers_cuda(bulk, *tabs, **kw), TIMED_CALLS))
        out["ms_small"] = statistics.median(cuda_ms(
            torch, lambda: ap.addition_numbers_cuda(ids, *tabs, **kw), TIMED_CALLS))
        # B2 at the trace's top makes the trace's draws (the same loop, cap
        # and stop at R nodes): its stats give the consults and draws, its
        # filled slots the used draws; every other draw takes the min key
        _, st = ap.place_replicas_cuda(bulk, *tabs, emit_stats=True, **kw)
        consults, draws = ladder_work(torch, st, top)
        high = high_stops(torch, st, art.n_segs, top)
        unused = draws - (3 * BULK_IDS - int(st[ref.DEPTH_BINS].view(torch.int32)))
        distinct = distinct_levels(bulk, *tabs, top, 3)
    nbytes = 8 * BULK_IDS + 8 * art.n_segs
    # a draw that stops above the table is a miss known from its level: its
    # consults and one min of the level's stops; only the others take the
    # draw's ops and the table test, and the unused ones the min-key update
    rest = (high + (OPS_PER_DRAW + 3) * (draws - high)
            + MIN_KEY_OPS * (unused - high))
    seeded, unseeded = ladder_ops(consults, distinct)
    out["work"][AN] = (nbytes, seeded + rest)
    out["unseeded"][AN] = (nbytes, unseeded + rest)
    print(f"  work at R=3: {consults} levels of {distinct} distinct / {draws} draws "
          f"({high} stopping above the table) / {unused} unused draws; median {out['ms'][AN]:.4f} ms over {TIMED_CALLS} calls "
          f"on {BULK_IDS} ids, {out['ms_small']:.4f} ms on {ids.shape[0]}, where the twin "
          f"takes {out['plain'][AN]:.2f} ms")
    return out


def migration_path(torch, np, dev, caps, *, n_tracked: int, n_keys: int, batch: int,
                   seed: int, quiet: bool = False, profile: bool = False) -> dict:
    """The migration sequence of phase 8 on ``dev`` -> its results (host
    arrays and ints, for the card-vs-CPU comparison) and ``launches``, the
    kernel launch counts of the run (checks against twins excluded)."""
    from repro_torch.core import make_cluster
    from repro_torch.kernels import asura_place as ap
    from repro_torch.migrate import MigrationPlanner
    from repro_torch.obs import MetricsRegistry, TraceLedger
    from repro_torch.serve import Router, TrafficModel

    say = (lambda *a, **k: None) if quiet else print
    prefilter = ("planner.prefilter_scanned", "planner.prefilter_kept")
    cuda = dev.type == "cuda"
    res: dict = {}
    n = len(caps)
    victim = n // 2
    total_cap = float(np.sum(caps)) + 1.0
    start_launches = dict(ap.LAUNCHES)

    # -- bulk planning: add node n (capacity 1.0), then remove the victim --
    cluster = make_cluster(caps, device=dev)
    engine = cluster.engine
    engine.artifact()
    v0 = cluster.version
    new_segs = cluster.add_node(n, 1.0)
    v1 = cluster.version
    engine.artifact()  # pin v1 before the removal
    cluster.remove_node(victim)
    v2 = cluster.version
    tracked = np.random.default_rng(seed + 8).integers(0, 2**32, n_tracked, dtype=np.uint32)
    planner = MigrationPlanner(engine)
    chunk = n_tracked // PLAN_CHUNKS
    chunks = list(planner.chunked(torch.from_numpy(tracked).to(dev), chunk))
    if cuda:
        s_ev, e_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with sync_guard(torch, dev):
        if cuda:
            s_ev.record()
        parts = [p[1:] for p in planner.plan_stream(chunks, v0, v1)]
        if cuda:
            e_ev.record()
    if cuda:
        torch.cuda.synchronize()
        res_ms = s_ev.elapsed_time(e_ev)
        with sync_guard(torch, dev), uncounted(ap.LAUNCHES):
            s_ev.record()
            fused = [p[1:] for p in planner.plan_stream(chunks, v0, v1, fuse=PLAN_CHUNKS)]
            e_ev.record()
        torch.cuda.synchronize()
        fused_ms = s_ev.elapsed_time(e_ev)
        for a, b in zip(parts, fused):
            require(all(torch.equal(x, y) for x, y in zip(a, b)),
                    "plan_stream fuse=16 differs from fuse=1")
    moved = torch.cat([m for m, _, _ in parts])
    src = torch.cat([x for _, x, _ in parts])
    dst = torch.cat([x for _, _, x in parts])
    n_moved = int(moved.sum())
    require(bool((dst[moved] == n).all()), "plan_stream: an add moved a row elsewhere")
    res["stream_src"], res["stream_dst"] = src.cpu().numpy(), dst.cpu().numpy()
    if cuda:
        say(f"  plan_stream: {PLAN_CHUNKS} chunks of {chunk}: {n_moved} moved "
            f"({n_moved / n_tracked:.6f} of ids; the new node holds "
            f"{1.0 / total_cap:.6f} of the capacity), {res_ms:.4f} ms (CUDA events); "
            f"fuse={PLAN_CHUNKS} (one launch) {fused_ms:.4f} ms, equal")
    t0 = time.perf_counter()
    plan = planner.plan(tracked, v0, v1)
    t_plan = time.perf_counter() - t0
    pre_ledger = TraceLedger()
    t0 = time.perf_counter()
    plan_pre = MigrationPlanner(engine, ledger=pre_ledger).plan(
        tracked, v0, v1, max_new_seg=max(new_segs))
    t_pre = time.perf_counter() - t0
    scanned, kept = (pre_ledger.counter(k) for k in prefilter)
    require(scanned == n_tracked and 0 < kept < scanned,
            f"the prefilter scanned {scanned} and kept {kept} of {n_tracked} ids")
    t0 = time.perf_counter()
    rep_add = planner.plan_replicas(tracked, v0, v1, 3)
    rep_rm = planner.plan_replicas(tracked, v1, v2, 3)
    t_rep = time.perf_counter() - t0
    fields = ("ids", "src", "dst", "index", "slot", "src_slot")
    for f in fields:
        require(np.array_equal(getattr(plan, f), getattr(plan_pre, f)),
                f"the prefiltered plan differs in {f}")
    require(plan.n_moves == n_moved, "plan and plan_stream disagree")
    require(bool((plan.dst == n).all()), "add plan: a row moves elsewhere than the new node")
    require(bool((rep_add.dst == n).all()), "add replica plan: a row moves elsewhere")
    require(bool((rep_rm.src == victim).all()), "removal plan: a row moves from a live node")
    require(rep_rm.n_moves > 0 and rep_add.n_moves > 0, "an event moved nothing")
    say(f"  plan {t_plan:.3f} s, prefiltered plan {t_pre:.3f} s (identical, "
        f"{plan.n_moves} rows; the prefilter kept {kept} of {scanned} ids for the diff); "
        f"plan_replicas R=3 add + removal {t_rep:.3f} s")
    say(f"  invariants hold: add rows all to node {n}, removal rows all from node "
        f"{victim}; replica moved share add {rep_add.moved_fraction:.6f} vs capacity "
        f"share {1.0 / total_cap:.6f}, removal {rep_rm.moved_fraction:.6f} vs "
        f"{caps[victim] / total_cap:.6f}")
    for name, p in (("plan", plan), ("rep_add", rep_add), ("rep_rm", rep_rm)):
        for f in fields:
            res[f"{name}.{f}"] = getattr(p, f)

    # -- live window: serve through an add, R = 3 ----------------------------
    router = Router({i: float(c) for i, c in enumerate(caps)}, device=dev)
    cfg = dict(batch=batch, n_keys=n_keys, law="zipf", alpha=1.1, n_replicas=3,
               policy="pow2", seed=seed, n_bins=n + 1)
    metrics = MetricsRegistry(device=dev)
    driver = router.stream_driver(metrics=metrics, **cfg)
    second = router.stream_driver(metrics=MetricsRegistry(device=dev), **cfg)
    keys = TrafficModel.ids_from_ranks(
        torch.arange(n_keys, dtype=torch.int64), driver.traffic.id_salt
    ).numpy().astype(np.uint32)
    window_ledger = TraceLedger()
    t0 = time.perf_counter()
    mig = router.begin_scale_migration(keys, add=(n, 1.0), n_replicas=3,
                                       ingress=WINDOW_INGRESS, ledger=window_ledger)
    t_begin = time.perf_counter() - t0
    if cuda:
        # the window's plan again on its two (now cached) tables, with the
        # prefilter the window ran and without it, alternated
        wplanner = MigrationPlanner(router.engine)
        max_seg = max(router.cluster.nodes[n].segments)
        t_window = {max_seg: [], None: []}
        with uncounted(ap.LAUNCHES):
            for pre in (max_seg, None) * 3:
                t0 = time.perf_counter()
                again = wplanner.plan_replicas(keys, mig.v_from, mig.v_to, 3, max_new_seg=pre)
                t_window[pre].append(time.perf_counter() - t0)
                for f in ("ids", "src", "dst", "index", "slot", "src_slot"):
                    require(np.array_equal(getattr(again, f), getattr(mig.state.plan, f)),
                            f"the window's plan again (max_new_seg={pre}) differs in {f}")
        say(f"  window's plan again on cached tables: prefiltered "
            f"{', '.join(f'{t:.4f}' for t in t_window[max_seg])} s, unfiltered "
            f"{', '.join(f'{t:.4f}' for t in t_window[None])} s (identical plans)")
    for k in prefilter:
        res[f"window.{k.split('.')[1]}"] = window_ledger.counter(k)
    require(res["window.prefilter_scanned"] == n_keys
            and 0 < res["window.prefilter_kept"] < n_keys,
            "the window's add did not prefilter its keys")
    say(f"  window: {mig.state.plan.n_moves} replica rows to move ({t_begin:.3f} s to plan; "
        f"the prefilter kept {res['window.prefilter_kept']} of {n_keys} keys)")
    rounds, chosen_all, ids_all, ev = 0, [], [], []
    while not mig.done:
        res[f"round{rounds}"] = repr(sorted(mig.round().items()))
        rounds += 1
        mig.state.pending_replicas_device()  # the round's one upload
        with sync_guard(torch, dev):
            if cuda:
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
            ids, chosen = driver.serve_migrating(mig)
            if cuda:
                e.record()
                ev.append((s, e))
            if rounds == 2:
                ids4, chosen4 = driver.superstep_migrating(mig, 4)
            with uncounted(ap.LAUNCHES):  # the second driver only checks
                if rounds == 2:
                    one = [second.serve_migrating(mig) for _ in range(5)]
                else:
                    second.serve_migrating(mig)
        with uncounted(ap.LAUNCHES):
            served = mig.route_replicas_device(ids)
            require(bool((served >= 0).all()), "a served set holds -1")
            require(bool(((served[:, 0] != served[:, 1]) & (served[:, 0] != served[:, 2])
                          & (served[:, 1] != served[:, 2])).all()),
                    "a served set repeats a node")
            require(bool((served == chosen[:, None]).any(dim=1).all()),
                    "a chosen node is outside its served set")
        if rounds == 2:
            require(torch.equal(one[0][1], chosen), "the second driver drifted")
            require(torch.equal(torch.stack([c for _, c in one[1:]]), chosen4)
                    and torch.equal(torch.stack([i for i, _ in one[1:]]), ids4),
                    "superstep_migrating(4) differs from 4 serve_migrating calls")
            chosen_all.append(chosen4.reshape(-1))
            ids_all.append(ids4.reshape(-1))
        chosen_all.append(chosen)
        ids_all.append(ids)
    launches = {k: v - start_launches[k] for k, v in ap.LAUNCHES.items()}
    require(rounds >= MIN_ROUNDS or quiet, f"the window drained in {rounds} rounds")
    steps = driver.steps_done
    counts = driver.load_counts()
    require(int(counts.sum()) == steps * batch, f"counts sum {counts.sum()} != {steps} x {batch}")
    for name in ("counts", "queue", "qhist"):
        require(torch.equal(getattr(driver, name), getattr(second, name)),
                f"the two drivers differ in {name}")
    res["rounds"] = rounds
    res["chosen"] = torch.cat(chosen_all).cpu().numpy()
    res["ids"] = torch.cat(ids_all).cpu().numpy()
    res["counts"] = counts
    res["queue"] = driver.queue.cpu().numpy()
    res["qhist"] = driver.qhist.cpu().numpy()
    for name, v in metrics.snapshot().items():
        res[f"slab.{name}"] = np.asarray(v)
    if cuda:
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in ev]
        say(f"  {rounds} rounds, one serve_migrating batch each (+ superstep_migrating(4) "
            f"at round 2, equal to 4 serve_migrating calls of a second driver); "
            f"serve_migrating mean {statistics.mean(ms):.4f} ms, median "
            f"{statistics.median(ms):.4f} ms (CUDA events); {steps} batches, "
            f"load_skew {driver.load_skew():.6f}")
        say(f"  served sets pairwise distinct, free of -1, chosen inside; B2 launches "
            f"per window batch {launches['place_replicas'] / steps:.3f}")
    res["launches"] = launches
    if profile and cuda:
        print("  profiler over serve_migrating on the drained window (uncounted):")
        with uncounted(ap.LAUNCHES):
            print_profile(profile_steps(torch, lambda: second.serve_migrating(mig), 4))
    return res


def phase9(torch, np, dev, caps, seed, ids, bulk, hold, profile: bool = False) -> dict:
    """The paper's baselines on the card: 9a kernels against twins, 9b
    bulk, 9c serving, 9d movement.  Returns the kernels' times, twin and
    library times, work, and the launch counts of the main paths."""
    from repro_torch.core import PlacementEngine, make_cluster
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import baselines as tb
    from repro_torch.kernels import baselines_ref as tr
    from repro_torch.kernels.ref import fmix32
    from repro_torch.kernels.u32 import as_u32
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import Router, TrafficModel

    kernel = {"ch": "ch_place", "rs": "rs_place", "wrh": "wrh_place"}
    n = LADDER_NODES
    victim = n // 2
    out = {"ms": {}, "plain": {}, "library": {}, "work": {}, "fanout_ms": {}}

    def artifact(alg, cc, history=False):
        """A device artifact of ``alg`` on a cluster of capacities ``cc``;
        with ``history`` rs is built, then rebalanced for an add of node
        len(cc) and a removal of node len(cc) // 2."""
        cluster = make_cluster(cc)
        eng = PlacementEngine(cluster, device=dev, algorithm=alg)
        if history:
            eng.artifact()
            cluster.add_node(len(cc), 1.0)
            eng.artifact()
            cluster.remove_node(len(cc) // 2)
        return eng._device_artifact()

    # -- 9a: kernels against twins -------------------------------------------
    print(f"phase 9a: baseline kernels vs twins on the card, exact")
    with uncounted(LAUNCHES):
        for alg in ("ch", "rs"):
            for n_nodes in (LADDER_NODES, HUGE_NODES):
                hist = alg == "rs" and n_nodes == LADDER_NODES
                art = artifact(alg, caps[n_nodes], history=hist)
                edge = torch.from_numpy(edge_ids(np, art.keys)).to(dev)
                sub = torch.cat([ids, edge])
                place = getattr(tb, f"{kernel[alg]}_cuda")
                plan = search_plan(tb, alg, art.keys_dev, sub.shape[0], 0)
                hold(kernel[alg], f"{n_nodes} nodes, {art.n_entries} entries, "
                     f"{ids.shape[0]}+{edge.shape[0]} edge ids, {plan_text(plan)}",
                     place(sub, art.keys_dev, art.vals_dev),
                     tr.LOOKUPS[alg](sub, art.keys_dev, art.vals_dev))
        for alg in ("ch", "rs"):  # the staged search at every kind of bucket edge
            for n_keys, runs, offset in search_edges():
                keys, owners = search_table(np, n_keys + offset, seed, runs)
                if alg == "rs":
                    keys[0] = 0  # random slicing's first interval starts at 0
                k = torch.from_numpy(keys).to(dev)[offset:]
                v = torch.from_numpy(owners).to(dev)[offset:]
                sub = torch.cat([ids[: 1 << 16], torch.from_numpy(
                    index_edge_ids(np, keys[offset:])).to(dev)])
                what = (f"{n_keys} keys{' (unaligned)' if offset else ''}, runs {runs}, "
                        f"{plan_text(search_plan(tb, alg, k, sub.shape[0], 0))}, "
                        f"{sub.shape[0]} ids")
                place = getattr(tb, f"{kernel[alg]}_cuda")
                hold(kernel[alg], what, place(sub, k, v), tr.LOOKUPS[alg](sub, k, v))
                search_plan(tb, alg, k, sub.shape[0], 3)
                got, st = tb.baseline_replicas_cuda(alg, sub, k, v, n_replicas=3,
                                                    emit_stats=True)
                want, st_t = tr.baseline_replicas_lookup(alg, sub, k, v, n_replicas=3,
                                                         emit_stats=True)
                hold(FANOUT, f"{alg} R=3 on {what}", got, want)
                hold(FANOUT, f"{alg} R=3 on {n_keys} keys [reprobes]", st, st_t)
        tail_caps = np.concatenate([caps[n], [1.0]])  # 4097 nodes: a padding tail
        for cc in (caps[n], tail_caps):
            art = artifact("wrh", cc)
            sub = ids[:WRH_CHECK_IDS]
            hold("wrh_place", f"{len(cc)} nodes ({art.keys_dev.shape[0]} padded), "
                 f"{WRH_CHECK_IDS} ids",
                 tb.wrh_place_cuda(sub, art.keys_dev, art.vals_dev),
                 tr.wrh_lookup(sub, art.keys_dev, art.vals_dev))
        for alg in BASELINES:
            art = artifact(alg, caps[n], history=alg == "rs")
            for R in (1, 3, 5, 12):
                m = WRH_CHECK_IDS if alg == "wrh" else (CHECK_IDS if R < 12 else 1 << 16)
                sub = ids[:m]
                got, st = tb.baseline_replicas_cuda(alg, sub, art.keys_dev, art.vals_dev,
                                                    n_replicas=R, emit_stats=True)
                want, st_t = tr.baseline_replicas_lookup(alg, sub, art.keys_dev, art.vals_dev,
                                                         n_replicas=R, emit_stats=True)
                hold(FANOUT, f"{alg} R={R} {m} ids", got, want)
                hold(FANOUT, f"{alg} R={R} {m} ids [reprobes] {int(as_u32(st)[0])}", st, st_t)
            small = artifact(alg, SMALL_CAPS)
            sub = ids[: 1 << 16]
            got, st = tb.baseline_replicas_cuda(alg, sub, small.keys_dev, small.vals_dev,
                                                n_replicas=6, emit_stats=True)
            want, st_t = tr.baseline_replicas_lookup(alg, sub, small.keys_dev, small.vals_dev,
                                                     n_replicas=6, emit_stats=True)
            short = int((got < 0).sum())
            hold(FANOUT, f"{alg} R=6 on 4 nodes, {short} slots -1", got, want)
            hold(FANOUT, f"{alg} R=6 on 4 nodes [reprobes]", st, st_t)
            require(short >= 2 * sub.shape[0], f"{alg}: R=6 on 4 nodes filled too many slots")

    # -- 9b: bulk, per algorithm ----------------------------------------------
    print(f"phase 9b: PlacementEngine(algorithm=...) on the card, {BULK_IDS} ids "
          f"({WRH_IDS} for wrh), R=3")
    cluster = make_cluster(caps[n])
    asura = PlacementEngine(cluster)
    asura_art = asura.artifact()
    engines = {alg: PlacementEngine(cluster, algorithm=alg) for alg in BASELINES}
    arts = {alg: engines[alg].artifact() for alg in BASELINES}  # uploads, unguarded
    size = {alg: WRH_IDS if alg == "wrh" else BULK_IDS for alg in BASELINES}
    ev = {(alg, what): [] for alg in BASELINES for what in ("nodes", "replicas")}
    res = {}
    torch.cuda.synchronize()
    LAUNCHES.update({k: 0 for k in LAUNCHES})
    with sync_guard(torch, dev):
        for alg in BASELINES:
            sub = bulk[: size[alg]]
            for _ in range(1 + TIMED_CALLS):
                for what, call in (
                    ("nodes", lambda: engines[alg].place_nodes_device(sub)),
                    ("replicas", lambda: engines[alg].place_replica_nodes_device(sub, 3)),
                ):
                    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    s.record()
                    res[alg, what] = call()
                    e.record()
                    ev[alg, what].append((s, e))
    bulk_launches = dict(LAUNCHES)
    torch.cuda.synchronize()
    print(f"  launches {({k: v for k, v in bulk_launches.items() if v})}")
    for alg in BASELINES:
        require(engines[alg].uploads == 1, f"{alg} engine uploaded {engines[alg].uploads}")
        for what in ("nodes", "replicas"):
            t = statistics.median(s.elapsed_time(e) for s, e in ev[alg, what][1:])
            print(f"  {alg:3s} {what:8s} median {t:.4f} ms over {TIMED_CALLS} calls on "
                  f"{size[alg]} ids, {size[alg] / t * 1e3:.4g} ids/s")
            if what == "nodes":
                out["ms"][kernel[alg]] = t
            else:
                out["fanout_ms"][alg] = t
    out["ms"][FANOUT] = out["fanout_ms"]["ch"]
    with uncounted(LAUNCHES):
        for alg in BASELINES:  # ASURA's engine places all three; its table stays
            asura.place_nodes_device(bulk[:4096], algorithm=alg)
        require(asura.uploads == 4, f"the ASURA engine uploaded {asura.uploads} tables")
        require(asura.artifact_for(cluster.version, "asura") is asura_art,
                "a baseline upload displaced the ASURA artifact")
        for alg in BASELINES:
            art = arts[alg]
            m = size[alg] if alg != "wrh" else min(size[alg], 1 << 16)
            sub = bulk[:m]
            hold(kernel[alg], f"engine place_nodes_device {m} ids",
                 res[alg, "nodes"][:m], tr.LOOKUPS[alg](sub, art.keys_dev, art.vals_dev))
            hold(FANOUT, f"{alg} engine place_replica_nodes_device R=3 {m} ids",
                 res[alg, "replicas"][:m],
                 tr.baseline_replicas_lookup(alg, sub, art.keys_dev, art.vals_dev,
                                             n_replicas=3))
            # twin times: at the bulk size for ch / rs, at 2**16 ids for wrh
            out["plain"][kernel[alg]] = statistics.median(cuda_ms(
                torch, lambda: tr.LOOKUPS[alg](sub, art.keys_dev, art.vals_dev), 2))
            if alg != "wrh":  # the one torch call doing their search
                h = fmix32(as_u32(sub))
                table = as_u32(art.keys_dev)
                out["library"][kernel[alg]] = statistics.median(cuda_ms(
                    torch, lambda: torch.searchsorted(table, h, right=alg == "rs"),
                    TIMED_CALLS))
            # the work this run's data needs
            sub = bulk[: size[alg]]
            _, st = tb.baseline_replicas_cuda(alg, sub, art.keys_dev, art.vals_dev,
                                              n_replicas=3, emit_stats=True)
            reprobes = int(as_u32(st)[0])
            n_pad, N = art.keys_dev.shape[0], size[alg]
            table_bytes = 8 * n_pad
            if alg == "wrh":
                lookup_ops, lookup_f32 = n_pad * WRH_PAIR_OPS + GATHER_OPS, n_pad * WRH_PAIR_F32
            else:
                lookup_ops, lookup_f32 = FMIX_OPS + n_pad.bit_length() * SEARCH_OPS + GATHER_OPS, 0
            out["work"][kernel[alg]] = (8 * N + table_bytes, N * lookup_ops, N * lookup_f32)
            fan = (16 * N + table_bytes, (N + reprobes) * lookup_ops
                   + reprobes * (DRAW_OPS + 3), (N + reprobes) * lookup_f32)
            print(f"  {alg:3s} work: {n_pad} padded entries, {lookup_ops} int32 ops per "
                  f"lookup; R=3 fan-out {reprobes} reprobes ({reprobes / N:.4f} per id); "
                  f"twin {out['plain'][kernel[alg]]:.2f} ms on {m} ids"
                  + (f", torch.searchsorted {out['library'][kernel[alg]]:.4f} ms"
                     if alg != "wrh" else ""))
            if alg == "ch":
                out["work"][FANOUT] = fan
                out["plain"][FANOUT] = statistics.median(cuda_ms(
                    torch, lambda: tr.baseline_replicas_lookup(
                        alg, sub, art.keys_dev, art.vals_dev, n_replicas=3), 2))

    # -- 9c: serving, per algorithm -------------------------------------------
    print(f"phase 9c: Router(algorithm=...).stream_driver batch {SERVE_BATCH}, "
          f"{SERVE_KEYS} keys, zipf 1.1, R=3, pow2, {SERVE_STEPS} steps")
    rcaps = {i: float(c) for i, c in enumerate(caps[n])}
    cfg = dict(batch=SERVE_BATCH, n_keys=SERVE_KEYS, law="zipf", alpha=1.1,
               n_replicas=3, policy="pow2", seed=seed)
    serve_launches = {}
    for alg in BASELINES:
        router = Router(rcaps, algorithm=alg)
        metrics = MetricsRegistry()
        driver = router.stream_driver(metrics=metrics, **cfg)
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        chosen, step_ev = [], []
        t0 = time.perf_counter()
        with sync_guard(torch, dev):
            for _ in range(SERVE_STEPS):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                chosen.append(driver.step())
                e.record()
                step_ev.append((s, e))
        for k, v in LAUNCHES.items():
            serve_launches[k] = serve_launches.get(k, 0) + v - before[k]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / SERVE_STEPS
        step_ms = statistics.median(s.elapsed_time(e) for s, e in step_ev)
        counts = driver.load_counts()
        require(int(counts.sum()) == SERVE_STEPS * SERVE_BATCH, f"{alg}: counts sum {counts.sum()}")
        live = torch.tensor(sorted(router.cluster.nodes), device=dev, dtype=torch.int32)
        require(bool(torch.isin(torch.stack(chosen), live).all()), f"{alg}: a dead node served")
        snap = metrics.snapshot()
        require(np.array_equal(snap["serve.served"].astype(np.int64), counts.astype(np.int64)),
                f"{alg}: slab serve.served != load_counts")
        reprobes = int(snap["baseline.reprobes"])
        require(reprobes > 0, f"{alg}: no reprobes counted")
        with uncounted(LAUNCHES):
            second = router.stream_driver(metrics=MetricsRegistry(), **cfg)
            with sync_guard(torch, dev):
                four = second.superstep(4)
            require(torch.equal(four, torch.stack(chosen[:4])),
                    f"{alg}: superstep(4) differs from 4 step() calls")
            if profile:
                print(f"  {alg} serving under the profiler (uncounted):")
                print_profile(profile_steps(torch, second.step, 4))
        print(f"  {alg:3s} step median {step_ms:.4f} ms (CUDA events), {wall:.4f} ms wall; "
              f"load_skew {driver.load_skew():.6f}, queue_p99 {driver.queue_p99()}, "
              f"reprobes {reprobes} ({reprobes / (SERVE_STEPS * SERVE_BATCH):.4f} per request); "
              f"superstep(4) == 4 steps")
    require(serve_launches.get(FANOUT, 0) == 3 * SERVE_STEPS,
            f"serving launched the fan-out {serve_launches.get(FANOUT)} times")
    small = dict(cfg, batch=SMALL_BATCH)
    for alg in BASELINES:
        t0 = time.perf_counter()
        got = []
        with uncounted(LAUNCHES):
            for where in (dev, torch.device("cpu")):
                reg = MetricsRegistry(device=where)
                d = Router(rcaps, algorithm=alg, device=where).stream_driver(metrics=reg, **small)
                with sync_guard(torch, where):
                    cs = [d.step() for _ in range(CPU_STEPS)] + [d.superstep(2)]
                got.append(([c.cpu() for c in cs] + [d.counts.cpu(), d.queue.cpu(),
                                                     d.qhist.cpu()], reg.snapshot()))
        (a, sa), (b, sb) = got
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"{alg}: the card's driver differs from the CPU's")
        require(sa.keys() == sb.keys() and all(np.array_equal(np.asarray(sa[k]), np.asarray(sb[k]))
                                               for k in sa), f"{alg}: slab differs from the CPU's")
        print(f"  {alg:3s} batch {SMALL_BATCH}: card == CPU in chosen, counts, queue, qhist, "
              f"slab (reprobes {int(sa['baseline.reprobes'])}; "
              f"{time.perf_counter() - t0:.1f} s)")

    # -- 9d: movement, per algorithm ------------------------------------------
    keys = TrafficModel.ids_from_ranks(
        torch.arange(SERVE_KEYS, dtype=torch.int64), TrafficModel(SERVE_KEYS, seed=seed).id_salt
    ).numpy().astype(np.uint32)
    total = float(np.sum(caps[n])) + 1.0
    print(f"phase 9d: plan_scale_event on {SERVE_KEYS} keys: add node {n} (capacity 1.0), "
          f"then remove node {victim}")
    before = dict(LAUNCHES)
    plans = {}
    for alg in BASELINES:
        router = Router(rcaps, algorithm=alg)
        t0 = time.perf_counter()
        add = router.plan_scale_event(keys, add=(n, 1.0))
        rm = router.plan_scale_event(keys, remove=victim)
        dt = time.perf_counter() - t0
        plans[alg] = (add.moved_sessions, rm.moved_sessions)
        wrong_add = sum(dst != n for _, dst in add.moved_sessions.values())
        wrong_rm = sum(src != victim for src, _ in rm.moved_sessions.values())
        print(f"  {alg:3s} add: moved {add.n_reprefills / SERVE_KEYS:.6f} of keys (capacity "
              f"share {1.0 / total:.6f}), {wrong_add} rows to another node; removal: moved "
              f"{rm.n_reprefills / SERVE_KEYS:.6f} (capacity share {caps[n][victim] / total:.6f}), "
              f"{wrong_rm} rows from another node; {dt:.3f} s")
        require(add.n_reprefills > 0 and rm.n_reprefills > 0, f"{alg}: an event moved nothing")
        if alg != "rs":
            require(wrong_add == 0 and wrong_rm == 0, f"{alg} moved rows the wrong way")
    move_launches = {k: v - before[k] for k, v in LAUNCHES.items()}
    with uncounted(LAUNCHES):
        t0 = time.perf_counter()
        cpu = Router(rcaps, algorithm="rs", device="cpu")
        cpu_plans = (cpu.plan_scale_event(keys, add=(n, 1.0)).moved_sessions,
                     cpu.plan_scale_event(keys, remove=victim).moved_sessions)
        require(cpu_plans == plans["rs"], "rs: the card's plans differ from the CPU's")
        print(f"  rs plans equal to the CPU run's ({time.perf_counter() - t0:.1f} s)")
    out["launches"] = (bulk_launches, serve_launches, move_launches)
    return out


def hier_topologies(np, caps, seed, huge=None) -> dict:
    """The phase-10 deployments as ``{domain: {node: capacity}}``: the
    4096-node cluster in racks of 64, the durability benchmark's 12 x 8,
    a ragged one (1 to 128 nodes per domain, capacities from the seed in
    [0.5, 2.0)), 4 domains of 3 (for R = D + 1) and, given ``huge``
    capacities, the 10,000-node cluster in racks of 64 (157 racks: tables
    too large for B8's staged variant)."""
    n_dom, per = DURABILITY_LAYOUT
    rng = np.random.default_rng(seed + 10)
    ragged, nid = {}, 0
    for d, size in enumerate(rng.integers(1, 129, RAGGED_DOMAINS)):
        ragged[d] = {nid + i: float(c) for i, c in enumerate(rng.uniform(0.5, 2.0, size))}
        nid += int(size)
    return {
        "64x64": {d: {n: float(caps[n]) for n in range(d * RACK, (d + 1) * RACK)}
                  for d in range(len(caps) // RACK)},
        "12x8": {d: {d * per + i: 1.0 for i in range(per)} for d in range(n_dom)},
        "ragged": ragged,
        "4 domains": {d: {3 * d + i: 1.0 for i in range(3)} for d in range(4)},
        **({} if huge is None else {f"{len(huge)} nodes": {
            d: {n: float(huge[n]) for n in range(d * RACK, min((d + 1) * RACK, len(huge)))}
            for d in range(-(-len(huge) // RACK))}}),
    }


def hier_tail_lanes(torch, art, ids, R: int) -> int:
    """Level-2 placements of a (2, R, n) max_draws=1 run that take the
    per-domain tail: the filled slots whose one draw misses."""
    from repro_torch.core.rng import GOLDEN
    from repro_torch.kernels.hierarchy_ref import next_asura_vartop
    from repro_torch.kernels.ref import fmix32, place_replicas_ref
    from repro_torch.kernels.u32 import M32, as_u32, mul32

    t = art.tables_dev
    slots = place_replicas_ref(ids, t[0], t[1], top_level=art.top_level, max_draws=1,
                               n_replicas=R, emit_nodes=True).long()
    lens, tops, dids = as_u32(t[2]), t[6].long(), t[7].long()
    tail = 0
    for r in range(R):
        slot = slots[:, r][slots[:, r] >= 0]
        lane = as_u32(ids)[slots[:, r] >= 0]
        salted = fmix32(lane ^ mul32(dids[slot] & M32, GOLDEN))
        ctr = torch.zeros((art.max_top + 1, slot.shape[0]), dtype=torch.int64, device=ids.device)
        k, f, _ = next_asura_vartop(salted, ctr, tops[slot], art.max_top, 1)
        hit = (k < art.s_pad) & (f < lens[slot * art.s_pad + k.clamp(max=art.s_pad - 1)])
        tail += int((~hit).sum())
    return tail


def hier_work(torch, art, ids, R: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """(bytes, int32 operations) kernel B8 needs for ``ids`` at R: level 1
    is B2's work on the domain table, level 2 B1's on each replica's
    domain row (draws and tails counted per domain from B2's stats at
    R = 1 on the salted ids routed there), plus per replica the salt
    (xor, multiply, fmix32) and three gathers; each distinct level's seed
    hashed once, and beside it every consult hashing its seed."""
    from repro_torch.core.rng import GOLDEN
    from repro_torch.kernels import asura_place as ap
    from repro_torch.kernels.ref import DEPTH_BINS, fmix32
    from repro_torch.kernels.u32 import M32, as_u32, to_u32

    t = art.tables_dev
    slots, st = ap.place_replicas_cuda(ids, t[0], t[1], top_level=art.top_level,
                                       n_replicas=R, emit_nodes=True, emit_stats=True)
    levels, draws = ladder_work(torch, st, art.top_level)
    ops, old = ladder_ops(levels, distinct_levels(ids, t[0], t[1], art.top_level, R))
    rest = (OPS_PER_DRAW + 3) * draws
    lane_ids = as_u32(ids)
    for r in range(R):
        col = slots[:, r].long()
        for s in torch.unique(col[col >= 0]).tolist():
            row = slice(s * art.s_pad, (s + 1) * art.s_pad)
            salt = (int(t[7][s]) * GOLDEN) & M32
            salted = to_u32(fmix32(lane_ids[col == s] ^ salt))
            top = int(t[6][s])
            _, st1 = ap.place_replicas_cuda(salted, t[2][row], t[3][row], top_level=top,
                                            n_replicas=1, emit_stats=True)
            lv, dr = ladder_work(torch, st1, top)
            tail = int(st1[DEPTH_BINS].view(torch.int32))
            new1, old1 = ladder_ops(lv, distinct_levels(salted, t[2][row], t[3][row], top, 1))
            ops, old = ops + new1, old + old1
            rest += (OPS_PER_LEVEL * tail + OPS_PER_DRAW * dr
                     + 6 * art.s_pad.bit_length() * tail)
    n = ids.shape[0]
    rest += n * R * (FMIX_OPS + 2 + 3 * GATHER_OPS)
    table_bytes = 8 * t[0].shape[0] + 16 * t[2].shape[0] + 8 * t[6].shape[0]
    nbytes = 4 * n + 8 * R * n + table_bytes
    return (nbytes, ops + rest), (nbytes, old + rest)


def phase10(torch, np, dev, all_caps, seed, ids, bulk, hold, profile: bool = False) -> dict:
    """Failure-domain-aware placement on the card: 10a B8 and B9 against
    their twins, 10b bulk, 10c serving, 10d movement.  Returns the two
    kernels' times, twin times, work and the main paths' launch counts."""
    from repro_torch.core import HierarchicalCluster, PlacementEngine, make_cluster
    from repro_torch.kernels import LAUNCHES, ref
    from repro_torch.kernels import asura_place as ap
    from repro_torch.kernels.hierarchy import hier_place_replicas_cuda
    from repro_torch.kernels.hierarchy_ref import hier_place_replicas_ref
    from repro_torch.migrate import MigrationPlanner
    from repro_torch.serve import Router, TrafficModel

    caps = all_caps[LADDER_NODES]
    huge = f"{HUGE_NODES} nodes"
    topo = hier_topologies(np, caps, seed, all_caps[HUGE_NODES])
    out = {"ms": {}, "plain": {}, "work": {}, "unseeded": {}}

    def hier(t, where=dev):
        h = HierarchicalCluster(device=where)
        for d, members in t.items():
            for node, cap in members.items():
                h.add_node(d, node, cap)
        return h

    def statics(art, **kw):
        return dict(top_level=art.top_level, max_top=art.max_top, s_pad=art.s_pad,
                    s_log2=1, **kw)

    # -- 10a: kernels against twins ------------------------------------------
    print(f"phase 10a: hier_place_replicas_cuda (B8) and place_cuda (B9) vs twins, "
          f"{ids.shape[0]} ids, exact")
    arts = {name: hier(t).engine.hier_artifact() for name, t in topo.items()}
    for name, art in arts.items():
        tops = sorted(set(art.tables_dev[6][: art.n_domains].tolist()))
        print(f"  {name}: {art.n_domains} domains, {len(art.node_domain)} nodes, domain "
              f"table top level {art.top_level}, per-domain top levels {tops}, s_pad {art.s_pad}")
    require(len(set(arts["ragged"].tables_dev[6][: arts["ragged"].n_domains].tolist())) > 2,
            "the ragged hierarchy has too few distinct top levels")
    cases = [("64x64", R, 128, 0) for R in (1, 3, 5)] + [("ragged", R, 128, 0) for R in (1, 3, 5)]
    cases += [("12x8", 3, 128, 0), ("4 domains", 5, 128, 0), ("64x64", 3, 1, 0), ("ragged", 3, 1, 0)]
    cases += [("64x64", 9, 128, 0)] + [(huge, R, 128, 0) for R in (1, 3, 9)]
    cases += [(huge, 3, 1, 0), ("64x64", 3, 128, DEEP_LEVELS)]
    with uncounted(LAUNCHES):
        for name, R, md, extra in cases:
            art = arts[name]
            sub = ids if R <= 5 else ids[: 1 << 18]
            kw = statics(art, max_draws=md, n_replicas=R)
            kw["top_level"] += extra
            want = hier_place_replicas_ref(sub, *art.tables_dev, **kw)
            short = int((want[0] < 0).sum())
            what = f"{name} R={R} max_draws={md}: {short} slots -1"
            if extra:
                what = f"{name} R={R}, domain ladder {extra} levels deeper: {short} slots -1"
            if md == 1:
                what += f", {hier_tail_lanes(torch, art, sub, R)} tails"
            hold("hier_replicas", what, hier_place_replicas_cuda(sub, *art.tables_dev, **kw),
                 want)
            if name == "4 domains":
                require(short == sub.shape[0] and bool((want[0, :4] >= 0).all()),
                        "R = D + 1: only the last slot of every lane may stay -1")
            elif md == 128 and not extra:
                require(short == 0, f"{name} R={R}: a slot stayed -1")
        flat = PlacementEngine(make_cluster(caps), device=dev)._device_artifact()
        for md in (128, 1):
            kw = dict(top_level=flat.top_level, s_log2=1, max_draws=md)
            want = ref.place_ref(ids, flat.len32_dev, **kw)
            hold("place", f"{LADDER_NODES} nodes max_draws={md}: {int((want < 0).sum())} "
                 "lanes -1", ap.place_cuda(ids, flat.len32_dev, **kw), want)

    # -- 10b: bulk ------------------------------------------------------------
    print(f"phase 10b: PlacementEngine(HierarchicalCluster) on the card, {len(caps) // RACK} racks x {RACK}, "
          f"{BULK_IDS} ids; B9 on the flat table")
    h = hier(topo["64x64"])
    engine = h.engine
    require(engine.device.type == "cuda", f"engine placed on {engine.device}")
    art = engine.hier_artifact()  # the one upload, outside the sync guard
    calls = (
        ("hier_replicas", lambda: engine.place_replica_pairs_device(bulk, 3)),
        ("hier_nodes", lambda: engine.place_nodes_device(bulk)),
        ("place", lambda: ap.place_cuda(bulk, flat.len32_dev, top_level=flat.top_level)),
    )
    ev = {name: [] for name, _ in calls}
    res = {}
    torch.cuda.synchronize()
    LAUNCHES.update({k: 0 for k in LAUNCHES})
    with sync_guard(torch, dev):
        for _ in range(1 + TIMED_CALLS):
            for name, call in calls:
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                res[name] = call()
                e.record()
                ev[name].append((s, e))
    bulk_launches = dict(LAUNCHES)
    torch.cuda.synchronize()
    print(f"  launches {({k: v for k, v in bulk_launches.items() if v})}, uploads {engine.uploads}")
    require(engine.uploads == 1, f"engine uploaded {engine.uploads} tables")
    require(bulk_launches["hier_replicas"] == 2 * (1 + TIMED_CALLS)
            and bulk_launches["place"] == 1 + TIMED_CALLS
            and sum(bulk_launches.values()) == 3 * (1 + TIMED_CALLS),
            "bulk calls launched other than one kernel each")
    for name, _ in calls:
        t = statistics.median(s.elapsed_time(e) for s, e in ev[name][1:])
        if name != "hier_nodes":
            out["ms"][name] = t
        print(f"  {name:13s} median {t:.4f} ms over {TIMED_CALLS} calls, "
              f"{BULK_IDS / t * 1e3:.4g} ids/s, 1 launch per call")
    with uncounted(LAUNCHES):
        kw3 = statics(art, max_draws=128, n_replicas=3)
        want = hier_place_replicas_ref(bulk, *art.tables_dev, **kw3)
        hold("hier_replicas", "engine place_replica_pairs_device R=3", res["hier_replicas"], want)
        d = want[0]
        require(bool(((d[0] != d[1]) & (d[0] != d[2]) & (d[1] != d[2])).all()),
                "replica domains repeat")
        want1 = hier_place_replicas_ref(bulk, *art.tables_dev, **statics(art, max_draws=128,
                                                                          n_replicas=1))
        hold("hier_replicas", "engine place_nodes_device", res["hier_nodes"], want1[1, 0])
        want = ref.place_ref(bulk, flat.len32_dev, top_level=flat.top_level)
        hold("place", "place_cuda bulk", res["place"], want)
        out["plain"]["hier_replicas"] = statistics.median(cuda_ms(
            torch, lambda: hier_place_replicas_ref(bulk, *art.tables_dev, **kw3), 2))
        out["plain"]["place"] = statistics.median(cuda_ms(
            torch, lambda: ref.place_ref(bulk, flat.len32_dev, top_level=flat.top_level), 2))
        out["work"]["hier_replicas"], out["unseeded"]["hier_replicas"] = hier_work(
            torch, art, bulk, 3)
        _, st1 = ap.place_replicas_cuda(bulk, flat.len32_dev, flat.node_of_dev,
                                        top_level=flat.top_level, n_replicas=1, emit_stats=True)
        levels1, draws1 = ladder_work(torch, st1, flat.top_level)
        new1, old1 = ladder_ops(levels1, distinct_levels(bulk, flat.len32_dev, flat.node_of_dev,
                                                         flat.top_level, 1))
        nbytes = 8 * BULK_IDS + 4 * flat.n_segs
        out["work"]["place"] = (nbytes, new1 + OPS_PER_DRAW * draws1)
        out["unseeded"]["place"] = (nbytes, old1 + OPS_PER_DRAW * draws1)
    print(f"  twins: B8 {out['plain']['hier_replicas']:.2f} ms, B9 {out['plain']['place']:.2f} ms; "
          f"B8 work {out['work']['hier_replicas'][1] / BULK_IDS:.1f} int32 ops per id at R=3")

    # -- 10c: serving ---------------------------------------------------------
    print(f"phase 10c: Router({len(caps) // RACK} racks).stream_driver batch {SERVE_BATCH}, {SERVE_KEYS} keys, "
          f"zipf 1.1, R=3, pow2, uninstrumented, {SERVE_STEPS} steps + superstep(4)")
    cfg = dict(batch=SERVE_BATCH, n_keys=SERVE_KEYS, law="zipf", alpha=1.1,
               n_replicas=3, policy="pow2", seed=seed)
    router = Router(topo["64x64"])
    driver = router.stream_driver(**cfg)
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    chosen, step_ev = [], []
    t0 = time.perf_counter()
    with sync_guard(torch, dev):
        for _ in range(SERVE_STEPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            chosen.append(driver.step())
            e.record()
            step_ev.append((s, e))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / SERVE_STEPS
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        s.record()
        four = driver.superstep(4)
        e.record()
    torch.cuda.synchronize()
    super_wall = (time.perf_counter() - t0) * 1e3
    serve_launches = {k: v - before[k] for k, v in LAUNCHES.items()}
    step_ms = statistics.median(s_.elapsed_time(e_) for s_, e_ in step_ev)
    require(serve_launches["hier_replicas"] == SERVE_STEPS + 4,
            f"serving launched B8 {serve_launches['hier_replicas']} times")
    counts = driver.load_counts()
    require(int(counts.sum()) == (SERVE_STEPS + 4) * SERVE_BATCH, f"counts sum {counts.sum()}")
    live = torch.tensor(sorted(art.node_domain), device=dev, dtype=torch.int32)
    require(bool(torch.isin(torch.cat([torch.stack(chosen), four]), live).all()),
            "a request went to a dead node")
    with uncounted(LAUNCHES):
        second = router.stream_driver(**cfg)
        with sync_guard(torch, dev):
            second_four = second.superstep(4)
        require(torch.equal(second_four, torch.stack(chosen[:4])),
                "superstep(4) differs from 4 step() calls")
        if profile:
            print("  hierarchical serving under the profiler (uncounted):")
            print_profile(profile_steps(torch, second.step, 4))
    print(f"  step median {step_ms:.4f} ms (CUDA events), {wall:.4f} ms wall; superstep(4) "
          f"{s.elapsed_time(e):.4f} ms (CUDA events), {super_wall:.4f} ms wall; load_skew "
          f"{driver.load_skew():.6f}, queue_p99 {driver.queue_p99()}; launches "
          f"{({k: v for k, v in serve_launches.items() if v})}; a second driver's "
          f"superstep(4) == its first 4 steps")
    t0 = time.perf_counter()
    got = []
    with uncounted(LAUNCHES):
        for where in (dev, torch.device("cpu")):
            d = Router(topo["64x64"], device=where).stream_driver(**dict(cfg, batch=SMALL_BATCH))
            with sync_guard(torch, where):
                cs = [d.step() for _ in range(CPU_STEPS)] + [d.superstep(2)]
            got.append([c.cpu() for c in cs] + [d.counts.cpu(), d.queue.cpu(), d.qhist.cpu()])
    require(all(torch.equal(a, b) for a, b in zip(*got)),
            "the hierarchical driver on the card differs from the CPU's")
    print(f"  batch {SMALL_BATCH}: card == CPU in chosen ({CPU_STEPS} steps + superstep(2)), "
          f"counts, queue, qhist ({time.perf_counter() - t0:.1f} s)")

    # -- 10d: movement --------------------------------------------------------
    keys = TrafficModel.ids_from_ranks(
        torch.arange(SERVE_KEYS, dtype=torch.int64), TrafficModel(SERVE_KEYS, seed=seed).id_salt
    ).numpy().astype(np.uint32)
    keys_dev = torch.from_numpy(keys).to(dev)
    h = hier(topo["64x64"])
    engine = h.engine
    planner = MigrationPlanner(engine)
    new_node, victim = len(caps), len(caps) // 2
    total = float(np.sum(caps))
    gone_cap = float(np.sum(caps[HIER_GONE_RACK * RACK:(HIER_GONE_RACK + 1) * RACK]))
    events = (
        (f"add node {new_node} (1.0) to rack {HIER_ADD_RACK}", "add", HIER_ADD_RACK,
         lambda: h.add_node(HIER_ADD_RACK, new_node, 1.0), 1.0 / (total + 1.0)),
        (f"remove node {victim} from rack {victim // RACK}", "node", victim // RACK,
         lambda: h.remove_node(victim // RACK, victim), caps[victim] / (total + 1.0)),
        (f"remove rack {HIER_GONE_RACK}", "domain", HIER_GONE_RACK,
         lambda: h.remove_domain(HIER_GONE_RACK), gone_cap / (total + 1.0 - caps[victim])),
    )
    print(f"phase 10d: movement on {SERVE_KEYS} keys, R=3: "
          + "; ".join(label for label, *_ in events))
    before = dict(LAUNCHES)
    for label, kind, dom, apply, share in events:
        engine.hier_artifact()  # pin v before the change
        v0 = h.version
        with uncounted(LAUNCHES):  # read only by the rack-removal check
            held = engine.place_replica_pairs_device(keys_dev, 3)
        apply()
        engine.hier_artifact()  # the v+1 upload, outside the guard
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with sync_guard(torch, dev):
            s.record()
            moved, src, dst, _, src_dom, dst_dom = engine.diff_replica_domains_device(
                keys_dev, v0, h.version, 3)
            e.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = planner.plan_replicas(keys, v0, h.version, 3)
        t_plan = time.perf_counter() - t0
        n_moved = int(moved.sum())
        require(plan.n_moves == n_moved > 0, f"{label}: plan {plan.n_moves} rows, diff {n_moved}")
        with uncounted(LAUNCHES):  # read only by the distinct-domain check
            after = engine.place_replica_pairs_device(keys_dev, 3)[0]
        require(bool(((after[0] != after[1]) & (after[0] != after[2])
                      & (after[1] != after[2])).all()), f"{label}: replica domains repeat")
        if kind == "add":
            intra = moved & (src_dom == dom)
            require(bool((dst_dom[moved] == dom).all()), f"{label}: a row left for another rack")
            require(bool((dst[intra] == new_node).all()), f"{label}: an in-rack move missed the new node")
            note = f"all to rack {dom}, {int(intra.sum())} in-rack rows all to node {new_node}"
        elif kind == "node":
            require(bool((src_dom[moved] == dom).all()), f"{label}: a row left another rack")
            note = f"all from rack {dom}"
        else:
            copies = (held[0].T == dom).sum(dim=1)
            require(torch.equal(moved.sum(dim=1), copies), f"{label}: moved != the rack's copies")
            note = f"exactly the rack's {int(copies.sum())} copies"
        print(f"  {label}: diff {s.elapsed_time(e):.4f} ms (CUDA events), plan_replicas "
              f"{t_plan:.3f} s, {n_moved} rows moved ({n_moved / (3 * SERVE_KEYS):.6f} of the "
              f"replica mass, capacity share {share:.6f}), {note}; replica domains distinct")
        if profile and kind == "add":
            print("  the add's diff_replica_domains_device under the profiler (uncounted):")
            with uncounted(LAUNCHES):
                print_profile(profile_steps(torch, lambda: engine.diff_replica_domains_device(
                    keys_dev, v0, h.version, 3), 4))
    small = keys[: 1 << 18]
    card = Router(topo["64x64"]).route_replica_pairs(small, 3)
    move_launches = {k: v - before[k] for k, v in LAUNCHES.items()}
    require(move_launches["hier_replicas"] > 0, "movement did not launch B8")
    t0 = time.perf_counter()
    with uncounted(LAUNCHES):
        host = Router(topo["64x64"], device="cpu").route_replica_pairs(small, 3)
    require(np.array_equal(card, host), "route_replica_pairs differs between the card and the CPU")
    print(f"  route_replica_pairs on {small.shape[0]} keys: card == CPU "
          f"({time.perf_counter() - t0:.1f} s); launches "
          f"{({k: v for k, v in move_launches.items() if v})}")
    out["launches"] = (bulk_launches, serve_launches, move_launches)
    return out


def card_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (every
    phase-11 timing is printed beside it); "cpu" on the host."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def wall(fn):
    """(result, host seconds) of ``fn()``; the result stays where it is."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def durability_topology(n_domains: int, nodes_per_domain: int) -> dict:
    """``benchmarks/durability.py``'s topology: unit capacities, node id
    ``domain * nodes_per_domain + i``."""
    return {d: {d * nodes_per_domain + i: 1.0 for i in range(nodes_per_domain)}
            for d in range(n_domains)}


def consumers(torch, np, dev, caps, seed, *, shards: int, tracked: int, store_nodes: int,
              leaves: int, side: int, durability: tuple, quiet: bool = False) -> dict:
    """The consumers of placement on ``dev`` (phase 11a-11d) -> their
    results as host values, for the card-vs-CPU comparison of 11e.  Each
    sub-phase raises on a wrong result; checks against brute force run
    ``uncounted``."""
    from repro_torch.checkpoint import AsuraCheckpointStore, CheckpointManager
    from repro_torch.core import align_replica_sets, make_cluster
    from repro_torch.data import DataPipeline, ShardedDataset
    from repro_torch.kernels import LAUNCHES
    from repro_torch.runtime import ElasticCoordinator
    from repro_torch.runtime.durability import compare_policies, movement_on_node_add

    say = (lambda *a, **k: None) if quiet else print
    card = card_line(dev)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rng = np.random.default_rng(seed + 11)
    res: dict = {}
    n = len(caps)
    victim = n // 2

    # -- 11a: the sharded data pipeline ---------------------------------------
    say(f"phase 11a: ShardedDataset of {shards} shards on {n} ingest hosts, DataPipeline "
        f"for {CONSUMER_HOSTS} of them ({card})")
    cluster = make_cluster(caps, device=dev)
    engine = cluster.engine
    ds = ShardedDataset(n_shards=shards, tokens_per_shard=SHARD_TOKENS, vocab=SHARD_VOCAB)
    hosts = [k * n // CONSUMER_HOSTS for k in range(CONSUMER_HOSTS)]
    pipes, t_own = wall(lambda: {h: DataPipeline(ds, cluster, h, batch_per_host=BATCH_PER_HOST,
                                                 seq_len=SEQ_LEN, seed=seed) for h in hosts})
    shard_ids = torch.arange(shards, dtype=torch.int64, device=dev)
    with uncounted(LAUNCHES):
        owners = engine.place_nodes_device(shard_ids)
        per_node = torch.bincount(owners.long(), minlength=n + 2).cpu().numpy()
    require(int(per_node.sum()) == shards and int(owners.min()) >= 0, "a shard has no owner")
    require(set(np.nonzero(per_node)[0].tolist()) <= set(cluster.nodes), "a shard on no node")
    for h, p in pipes.items():
        require(len(p.owned_shards) == per_node[h], f"host {h} owns {len(p.owned_shards)} "
                f"shards, the bincount says {per_node[h]}")
    say(f"  every shard owned exactly once; {len(hosts)} pipelines built in {t_own:.4f} s "
        f"(host wall, one placement sweep each)")
    if cuda:
        with uncounted(LAUNCHES):
            times = cuda_ms(torch, lambda: engine.place_nodes_device(shard_ids), 5)
            _, t_sweep = wall(lambda: pipes[hosts[0]]._compute_owned())
        say(f"  ownership sweep: B1 over {shards} shard ids median {statistics.median(times):.4f} "
            f"ms (CUDA events); one pipeline's whole sweep (id upload, B1, the bool mask to "
            f"the host, the index) {t_sweep * 1e3:.4f} ms host wall")
    for label, event, new_pipe in (("add host", lambda: cluster.add_node(n, 1.0), n),
                                   ("remove host", lambda: cluster.remove_node(victim), None)):
        engine.artifact()  # pin v for the diff below
        v_from = cluster.version
        event()
        if new_pipe is not None:
            pipes[new_pipe] = DataPipeline(ds, cluster, new_pipe, batch_per_host=BATCH_PER_HOST,
                                           seq_len=SEQ_LEN, seed=seed)
        changes, t_ref = wall(lambda: {h: p.refresh_membership() for h, p in pipes.items()})
        with uncounted(LAUNCHES):
            moved, src, dst = (x.cpu().numpy() for x in engine.diff_nodes_device(
                shard_ids, v_from, cluster.version))
        all_ids = np.arange(shards, dtype=np.uint32)
        for h, (gained, lost) in changes.items():
            if h == new_pipe:
                continue
            require(np.array_equal(gained, all_ids[moved & (dst == h)])
                    and np.array_equal(lost, all_ids[moved & (src == h)]),
                    f"{label}: host {h}'s gained / lost shards differ from B3's diff")
        if new_pipe is not None:
            require(np.array_equal(pipes[new_pipe].owned_shards, all_ids[moved & (dst == n)])
                    and bool((dst[moved] == n).all()), f"{label}: the new host's shards")
        res[f"pipeline.{label}.moved"] = all_ids[moved]
        say(f"  {label}: {int(moved.sum())} shards moved, equal to B3's diff on all {shards} "
            f"ids; refresh_membership of {len(pipes)} pipelines {t_ref:.4f} s host wall")
    batches = []
    for h, p in pipes.items():
        for _, b in zip(range(2), p.batches(epoch=1)):
            require(b.shape == (BATCH_PER_HOST, SEQ_LEN) and b.dtype == np.int32
                    and int(b.min()) >= 0 and int(b.max()) < SHARD_VOCAB, f"host {h}'s batch")
            batches.append(b)
        res[f"pipeline.owned.{h}"] = p.owned_shards
    res["pipeline.batches"] = np.stack(batches)
    say(f"  {len(batches)} batches of ({BATCH_PER_HOST}, {SEQ_LEN}) tokens drawn")

    # -- 11b: the elastic coordinator ------------------------------------------
    say(f"phase 11b: ElasticCoordinator, {tracked} tracked ids on {n} nodes, R=1 and R=3, "
        f"and ch / rs / wrh at R=1 ({card})")
    ids = rng.integers(0, 2**32, tracked, dtype=np.uint32)

    def expected(before, after, R):
        """The brute-force MovePlan: owners placed at both versions."""
        if R == 1:
            rows = np.nonzero(before != after)[0]
            return dict(zip(ids[rows].tolist(), zip(before[rows].tolist(), after[rows].tolist())))
        moved, src, _ = align_replica_sets(before, after)
        b, r = np.nonzero(moved)
        return dict(zip(ids[b].tolist(), zip(src[b, r].tolist(), after[b, r].tolist())))

    def placed(c, R, algorithm="asura"):
        with uncounted(LAUNCHES):
            if R > 1:
                return c.engine.place_replica_nodes(ids, R)
            return c.engine.place_nodes(ids, algorithm=algorithm)

    for R in (1, 3):
        c = make_cluster(caps, device=dev)
        coord, t_init = wall(lambda: ElasticCoordinator(c, ids, n_replicas=R))
        _, t_an = wall(coord._addition_numbers)
        say(f"  R={R}: owners of {tracked} ids {t_init:.4f} s; host ADDITION-NUMBER trace "
            f"{t_an:.4f} s ({int((coord._an < 0).sum())} ids past the u32 range: candidates)")
        events = (("add", lambda: coord.add_node(n, 1.0)),
                  ("remove", lambda: coord.remove_node(victim)))
        for label, event in events:
            before = coord.owners()
            plan, t_ev = wall(event)
            after = placed(c, R)
            require(plan.moves == expected(before, after, R),
                    f"R={R} {label}: the MovePlan differs from the brute-force diff")
            require(np.array_equal(coord.owners(), after), f"R={R} {label}: owner table")
            res[f"coord.R{R}.{label}"] = plan.moves
            say(f"    {label}: {plan.n_moves} moves = brute force, {t_ev:.4f} s host wall")
        for label, start in (("live add", lambda: coord.add_node_live(n + 1, 1.0,
                                                                      ingress=WINDOW_INGRESS)),
                             ("live add + rollback",
                              lambda: coord.add_node_live(n + 2, 1.0, ingress=WINDOW_INGRESS)),
                             ("live remove", lambda: coord.remove_node_live(
                                 victim + 1, ingress=WINDOW_INGRESS))):
            live, t_ev = wall(start)
            moves = live.state.plan.n_moves
            if label == "live add + rollback":
                if live.state.n_pending > WINDOW_INGRESS:
                    live.round()  # half-landed: the rollback drains back what landed
                live = coord.rollback_live(live)
                require(n + 2 not in c.nodes, "the rollback left the node in")
            elif label == "live remove":
                try:
                    coord.rollback_live(live)
                    raise RuntimeError("a removal rolled back")
                except ValueError:
                    pass
            rounds, t_drain = wall(live.run)
            require(np.array_equal(coord.owners(), placed(c, R)),
                    f"R={R} {label}: the owner table after the drain")
            res[f"coord.R{R}.{label}.rounds"] = rounds
            say(f"    {label}: {moves} rows, plan {t_ev:.4f} s, drained in {len(rounds)} rounds "
                f"{t_drain:.4f} s host wall")
    for alg in BASELINES:
        c = make_cluster(caps, device=dev)
        coord = ElasticCoordinator(c, ids, algorithm=alg)
        for label, event in (("add", lambda: coord.add_node(n, 1.0)),
                             ("remove", lambda: coord.remove_node(victim))):
            before = coord.owners()
            plan, t_ev = wall(event)
            after = placed(c, 1, alg)
            require(plan.moves == expected(before, after, 1),
                    f"{alg} {label}: the MovePlan differs from the brute-force diff")
            res[f"coord.{alg}.{label}"] = plan.moves
            say(f"  {alg} {label}: {plan.n_moves} moves = brute force, {t_ev:.4f} s host wall")

    # -- 11c: the replicated checkpoint store ----------------------------------
    store_caps = {i: float(cap) for i, cap in enumerate(caps[:store_nodes])}

    def leaf(i: int, *shape):
        """Seeded values in [-1, 1), exact on every device: an integer hash
        of the position, scaled by a power of two."""
        k = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=dev)
        k = (k * 2654435761 + (seed * 1000 + i) * 40503) & (2**21 - 1)
        return ((k - 2**20).to(torch.float32) * 2.0**-20).reshape(shape)

    state = {f"layer{i:02d}.weight": leaf(i, side, side) for i in range(leaves)}
    state["embed.bf16"] = leaf(leaves, side, side // 4).to(torch.bfloat16)
    state["norm.ragged"] = leaf(leaves + 1, 1007)
    n_bytes = sum(t.numel() * t.element_size() for t in state.values())
    gib = n_bytes / 2**30
    say(f"phase 11c: AsuraCheckpointStore of {store_nodes} nodes, R=3, a state of "
        f"{gib:.4f} GiB in {len(state)} leaves ({card})")
    store = AsuraCheckpointStore(store_caps, n_replicas=3, device=dev)
    mgr = CheckpointManager(store)

    def same_as(out, ref):
        return all(torch.equal(out[k], ref[k]) for k in ref)

    sync()
    _, t_save = wall(lambda: mgr.save(1, state))
    n_chunks = len({k for node in store.nodes.values() for k in node.blobs})
    orig = {k: v.clone() for k, v in state.items()}
    _, t_async = wall(lambda: mgr.save_async(2, state))
    for t in state.values():
        t.add_(1)  # an optimizer step updates in place while the thread writes
    mgr.wait()
    out, t_restore = wall(lambda: mgr.restore(2, state))
    sync()
    require(same_as(out, orig), "save_async: the restored state differs from the call-time one")
    require(same_as(mgr.restore(1, state), orig), "save: the restored state differs")
    say(f"  save {t_save:.4f} s = {gib / t_save:.4f} GiB/s, save_async returned in "
        f"{t_async:.4f} s, restore {t_restore:.4f} s = {gib / t_restore:.4f} GiB/s (host wall, "
        f"{n_chunks} chunks of at most 1 MiB per step, byte-exact)")
    down = sorted(store.nodes)[1:3]
    for nid in down:
        store.fail_node(nid)
    require(same_as(mgr.restore(2, state), orig), "restore with 2 nodes down")
    for nid in down:
        held = set(store.nodes[nid].blobs)
        keys_before = {k: set(node.blobs) for k, node in store.nodes.items()}
        moved, t_rep = wall(lambda: store.remove_node_and_repair(nid))
        added = {(key, k) for k, node in store.nodes.items()
                 for key in set(node.blobs) - keys_before[k]}
        require(moved == len(added) and {key for key, _ in added} <= held,
                f"repair of node {nid} moved chunks it did not hold")
        keys = np.fromiter(held, dtype=np.uint32)
        for key, row in zip(keys.tolist(), store.replicas_for(keys)):
            require(all(key in store.nodes[int(x)].blobs for x in row
                        if store.nodes[int(x)].alive), f"chunk {key} under-replicated")
        say(f"  node {nid} failed and repaired: {moved} copies, only chunks it held "
            f"({len(held)}), {t_rep:.4f} s")
        res[f"store.repair.{nid}"] = moved
    require(same_as(mgr.restore(2, state), orig), "restore after the repairs")
    live, t_plan = wall(lambda: store.begin_add_node(store_nodes, 1.5, ingress=WINDOW_INGRESS))
    rounds = live.run()
    require(same_as(mgr.restore(2, state), orig), "restore after the live add")
    say(f"  begin_add_node live: {live.live.state.plan.n_moves} copies in {len(rounds)} "
        f"rounds ({t_plan:.4f} s to plan), restore byte-exact")
    keys = np.fromiter({k for node in store.nodes.values() for k in node.blobs}, np.uint32)
    before = store.replicas_for(keys)
    moved = store.add_node(store_nodes + 1, 2.0)
    after = store.replicas_for(keys)
    want = sum(len(set(a.tolist()) - set(b.tolist())) for a, b in zip(after, before))
    require(moved == want, f"add_node moved {moved} copies, the minimum is {want}")
    require(same_as(mgr.restore(2, state), orig), "restore after add_node")
    say(f"  add_node: {moved} copies, the minimal set; restore byte-exact")
    res["store.live.rounds"] = rounds
    res["store.add_node"] = moved
    res["store.blobs"] = {nid: node.blobs for nid, node in store.nodes.items()}
    del state, orig, out

    # -- 11d: the durability simulator -----------------------------------------
    bench = json.loads((HERE / "BENCH_durability.json").read_text())["entries"]
    for name in durability:
        cfg = DURABILITY[name]
        topo = (durability_topology(cfg["n_domains"], cfg["nodes_per_domain"])
                if name != "racks" else
                {d: {nid: float(caps[nid]) for nid in range(d * RACK, (d + 1) * RACK)}
                 for d in range(n // RACK)})
        kw = {k: cfg[k] for k in ("n_objects", "years", "mttf_node_years",
                                  "mttf_domain_years", "seed")}
        reports, t_sim = wall(lambda: compare_policies(topo, n_replicas=3, device=dev, **kw))
        moved, t_mov = wall(lambda: movement_on_node_add(
            topo, n_objects=min(cfg["n_objects"], 50_000), n_replicas=3, device=dev))
        flat, hier = reports["flat"], reports["hier"]
        say(f"phase 11d ({name}): {len(topo)} domains x {len(topo[0])} nodes, "
            f"{cfg['n_objects']} objects, R=3, {cfg['years']} years: {flat.node_failures} node "
            f"and {flat.domain_failures} domain failures; flat {flat.objects_lost} lost in "
            f"{flat.loss_incidents} incidents, hier {hier.objects_lost} in "
            f"{hier.loss_incidents}; rows repaired {flat.rows_repaired} / "
            f"{hier.rows_repaired}; movement {100 * moved['flat']:.3f} % / "
            f"{100 * moved['hier']:.3f} %; {t_sim:.4f} s simulation + {t_mov:.4f} s movement "
            f"host wall ({card})")
        require(hier.objects_lost < flat.objects_lost or flat.objects_lost == 0,
                f"{name}: domain-aware placement lost {hier.objects_lost} >= flat")
        if name == "quick":
            got = {
                "durability_flat_objects_lost": flat.objects_lost,
                "durability_hier_objects_lost": hier.objects_lost,
                "durability_flat_loss_incidents": flat.loss_incidents,
                "durability_hier_loss_incidents": hier.loss_incidents,
                "durability_trace_node_failures": flat.node_failures,
                "durability_trace_domain_failures": flat.domain_failures,
                "durability_flat_repair_rows": flat.rows_repaired,
                "durability_hier_repair_rows": hier.rows_repaired,
                "durability_move_on_add_flat_pct": round(100 * moved["flat"], 3),
                "durability_move_on_add_hier_pct": round(100 * moved["hier"], 3),
            }
            for key, value in got.items():
                require(value == bench[key]["value"],
                        f"{key}: {value} here, {bench[key]['value']} in BENCH_durability.json")
            say(f"  equal to BENCH_durability.json in {len(got)} entries")
        res[f"durability.{name}"] = (reports, moved)
    return res


def phase11(torch, np, dev, caps, seed) -> dict:
    """The consumers of placement at full width (11a-11d, the main path,
    launches counted) and at a cut size on the card and on the CPU (11e)."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    full = dict(shards=BULK_IDS, tracked=TRACKED, store_nodes=STORE_NODES,
                leaves=STATE_LEAVES, side=STATE_SIDE, durability=("quick", "full", "racks"))
    cut = dict(shards=CUT_IDS, tracked=CUT_IDS, store_nodes=CUT_NODES, leaves=4, side=512,
               durability=("quick",))
    t0 = time.perf_counter()
    reset_launches()
    consumers(torch, np, dev, caps, seed, **full)
    launches = dict(LAUNCHES)
    print(f"  phase 11 main path: launches {launches}, {time.perf_counter() - t0:.1f} s")
    for name in ("place_fused", "place_replicas", "diff_nodes", B4A, "ch_place",
                 "rs_place", "wrh_place", "hier_replicas"):
        require(launches[name] > 0, f"the consumers did not launch {name}")
    print(f"phase 11e: the sequence at {CUT_IDS} ids on {CUT_NODES} nodes, QUICK durability, "
          "on the card and on the CPU")
    t0 = time.perf_counter()
    with uncounted(LAUNCHES):
        card, host = (consumers(torch, np, where, caps[:CUT_NODES], seed, quiet=True, **cut)
                      for where in (dev, torch.device("cpu")))
    require(card.keys() == host.keys(), "phase 11e results differ in keys")
    for key, a in card.items():
        b = host[key]
        same = np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
        require(same, f"phase 11e: {key} differs between the card and the CPU")
    print(f"  equal on the card and the CPU in {len(card)} results (owned shards, batches, "
          f"MovePlans, drain rounds, stored blobs per node, DurabilityReports, movement; "
          f"{time.perf_counter() - t0:.1f} s)")
    return launches


def mesh_path(torch, np, dev, caps, seed, bulk) -> None:
    """Phase 12a: ``ShardedSweep`` over the initialized world-size-1 NCCL
    group at full width.  Each mesh call is driven once (its launches
    count), held to the same engine's single-card call (uncounted), then
    both are timed in turns (single, mesh, mesh, single; uncounted): the
    difference is the collectives' cost at world size 1."""
    from repro_torch.core import HierarchicalCluster, PlacementEngine, make_cluster
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.placement_mesh import ShardedSweep, make_data_mesh
    from repro_torch.migrate import MigrationPlanner
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import RequestStreamDriver

    mesh = make_data_mesh(1, dev.type)
    n = len(caps)

    def same(a, b) -> bool:
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return mismatches(torch, a, b)[0] == 0
        if dataclasses.is_dataclass(a):
            return all(same(getattr(a, f), getattr(b, f)) for f in PLAN_FIELDS)
        return np.array_equal(a, b)

    def pair(what: str, on_mesh, single, reps: int = MESH_TIMED):
        got = on_mesh()
        with uncounted(LAUNCHES):
            require(same(got, single()), f"phase 12a: {what} differs from the single-card path")
            t_mesh, t_single = [], []
            for fn, acc in ((single, t_single), (on_mesh, t_mesh), (on_mesh, t_mesh),
                            (single, t_single)):
                ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
                      for _ in range(reps)]
                for s, e in ev:  # the calls above were the warm-up
                    s.record()
                    fn()
                    e.record()
                torch.cuda.synchronize()
                acc += [s.elapsed_time(e) for s, e in ev]
        ms_m, ms_s = statistics.median(t_mesh), statistics.median(t_single)
        print(f"  {what:46s} mesh {ms_m:10.4f} ms, single card {ms_s:10.4f} ms, "
              f"difference {ms_m - ms_s:+.4f} ms; 0 mismatches")
        return got

    # the single-card counterparts: the sweep's scatter-adds without the pad,
    # the shard and the all-reduce
    def bincount(nodes, n_bins):
        nodes = nodes.reshape(-1)
        hist = torch.zeros(n_bins, dtype=torch.int32, device=nodes.device)
        hist.scatter_add_(0, nodes.clamp(min=0).long(), (nodes >= 0).to(torch.int32))
        return hist.cpu().numpy().astype(np.int64)

    def matrix(diff, n_bins):
        moved, src, dst = diff[0], diff[1], diff[2]
        cell = src.clamp(min=0).long() * n_bins + dst.clamp(min=0).long()
        mat = torch.zeros(n_bins * n_bins, dtype=torch.int32, device=cell.device)
        mat.scatter_add_(0, cell.reshape(-1), moved.reshape(-1).to(torch.int32))
        mat = mat.cpu().numpy().astype(np.int64).reshape(n_bins, n_bins)
        return int(mat.sum()), mat

    # owners and histograms, all four algorithms (wrh on 2**20 ids)
    for alg in ("asura", "ch", "rs", "wrh"):
        engine = PlacementEngine(make_cluster(caps), algorithm=alg)
        sweep = engine.sharded()
        ids = bulk[:WRH_IDS] if alg == "wrh" else bulk
        # (``engine.place_nodes`` would take card ids through the host first)
        pair(f"{alg} place_nodes ({ids.shape[0]} ids)", lambda: sweep.place_nodes(ids),
             lambda: engine.place_nodes_device(ids).cpu().numpy().astype(np.int64))
        pair(f"{alg} histogram", lambda: sweep.histogram(ids, n),
             lambda: bincount(engine.place_nodes_device(ids), n))
    cluster = make_cluster(caps)
    engine = PlacementEngine(cluster)
    sweep = ShardedSweep(engine, mesh)
    pair("asura replica histogram R=3", lambda: sweep.histogram(bulk, n, n_replicas=3),
         lambda: bincount(engine.place_replica_nodes_device(bulk, 3), n))

    # phase 8's add over its tracked ids: diffs, matrices, plans, streams
    engine.artifact()
    v0 = cluster.version
    cluster.add_node(n, 1.0)
    v1 = cluster.version
    tracked = np.random.default_rng(seed + 8).integers(0, 2**32, BULK_IDS, dtype=np.uint32)
    on_card = torch.from_numpy(tracked).to(dev)
    pair("diff_nodes_device", lambda: sweep.diff_nodes_device(on_card, v0, v1),
         lambda: engine.diff_nodes_device(on_card, v0, v1))
    pair("diff_replicas_device R=3", lambda: sweep.diff_replicas_device(on_card, v0, v1, 3),
         lambda: engine.diff_replicas_device(on_card, v0, v1, 3))
    n_moved, _ = pair("movement_matrix R=1", lambda: sweep.movement_matrix(on_card, v0, v1, n + 1),
                      lambda: matrix(engine.diff_nodes_device(on_card, v0, v1), n + 1))
    r_moved, _ = pair("movement_matrix R=3",
                      lambda: sweep.movement_matrix(on_card, v0, v1, n + 1, n_replicas=3),
                      lambda: matrix(engine.diff_replicas_device(on_card, v0, v1, 3), n + 1))
    planner = MigrationPlanner(engine)
    plan = pair("plan (host-facing, gathered)", lambda: planner.plan(tracked, v0, v1, mesh=sweep),
                lambda: planner.plan(tracked, v0, v1), reps=1)
    rplan = pair("plan_replicas R=3 (host-facing, gathered)",
                 lambda: planner.plan_replicas(tracked, v0, v1, 3, mesh=sweep),
                 lambda: planner.plan_replicas(tracked, v0, v1, 3), reps=1)
    require(plan.n_moves == n_moved and rplan.n_moves == r_moved,
            "phase 12a: the movement matrices disagree with the plans")
    chunks = list(planner.chunked(on_card, BULK_IDS // PLAN_CHUNKS))
    pair(f"plan_stream ({PLAN_CHUNKS} chunks)",
         lambda: [p[1:] for p in planner.plan_stream(chunks, v0, v1, mesh=sweep)],
         lambda: [p[1:] for p in planner.plan_stream(chunks, v0, v1)], reps=2)
    print(f"  {n_moved} moved ids, {r_moved} moved replicas of {BULK_IDS} tracked; "
          f"the {n + 1}^2 int32 matrix all-reduced")

    # serving: phase 5's configuration, instrumented, then superstep(4);
    # the CH fan-out and the two-level kernel B8 on the 64 x 64 racks
    cfg = dict(batch=SERVE_BATCH, n_keys=SERVE_KEYS, law="zipf", alpha=1.1,
               n_replicas=3, policy="pow2", seed=seed)
    topo = hier_topologies(np, caps, seed)["64x64"]
    hier = HierarchicalCluster(device=dev)
    for d, members in topo.items():
        for node, cap in members.items():
            hier.add_node(d, node, cap)
    for what, eng, steps, instrumented in (
        ("asura", engine, SERVE_STEPS, True),
        ("ch", PlacementEngine(make_cluster(caps), algorithm="ch"), 4, True),
        ("two-level 64x64", hier.engine, SERVE_STEPS, False),
    ):
        regs = [MetricsRegistry() if instrumented else None for _ in range(2)]
        reduces = eng.ledger.counter("mesh.all_reduces")
        shard = RequestStreamDriver(eng, mesh=mesh, metrics=regs[0], **cfg)
        with uncounted(LAUNCHES):
            solo = RequestStreamDriver(eng, metrics=regs[1], **cfg)
        t_mesh, t_single = [], []
        for _ in range(steps):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            got = shard.step()
            e.record()
            with uncounted(LAUNCHES):
                s2, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s2.record()
                want = solo.step()
                e2.record()
                torch.cuda.synchronize()
                require(same(got, want), f"phase 12a: {what} mesh step differs")
            t_mesh.append(s.elapsed_time(e))
            t_single.append(s2.elapsed_time(e2))
        got = shard.superstep(4)
        with uncounted(LAUNCHES):
            want = torch.stack([solo.step() for _ in range(4)])
        require(same(got, want), f"phase 12a: {what} mesh superstep(4) differs")
        for name in ("counts", "queue", "qhist"):
            require(same(getattr(shard, name), getattr(solo, name)),
                    f"phase 12a: {what} mesh {name} differs")
        if instrumented:
            snap, want_snap = (r.snapshot() for r in regs)
            require(snap.keys() == want_snap.keys() and all(
                np.array_equal(np.asarray(v), np.asarray(want_snap[k])) for k, v in snap.items()),
                f"phase 12a: {what} mesh metrics slab differs")
        print(f"  serve {what:15s} {steps} steps + superstep(4), batch {SERVE_BATCH}: mesh step "
              f"median {statistics.median(t_mesh):.4f} ms, single card "
              f"{statistics.median(t_single):.4f} ms (CUDA events); chosen, counts, queue, qhist"
              f"{', slab' if instrumented else ''} equal; "
              f"{eng.ledger.counter('mesh.all_reduces') - reduces} all-reduces (one per batch), "
              f"mesh.host_staged {eng.ledger.counter('mesh.host_staged')}")


def phase12(torch, np, dev, caps, seed, bulk) -> dict:
    """The multi-card sweep on the card: 12a at NCCL world size 1 and full
    width (the main path, launches counted), 12b the selftest on
    MESH_RANKS processes sharing the card over gloo, at a cut size."""
    import os
    import re
    import signal
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES, reset_launches

    print(f"phase 12a ({card_line(dev)}): ShardedSweep on NCCL at world size 1, "
          f"{len(caps)} nodes, {BULK_IDS} ids")
    t0 = time.perf_counter()
    reset_launches()
    torch.cuda.set_device(dev)  # the rank's card, before the mesh binds one
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=0, world_size=1)
        try:
            mesh_path(torch, np, dev, caps, seed, bulk)
        finally:
            dist.destroy_process_group()
    launches = dict(LAUNCHES)
    print(f"  phase 12a main path: launches {launches}, {time.perf_counter() - t0:.1f} s")
    for name in ("place_fused", "place_replicas", "diff_nodes", B4A, "ch_place",
                 "rs_place", "wrh_place", "baseline_replicas", "hier_replicas"):
        require(launches[name] > 0, f"the mesh path did not launch {name}")

    print(f"phase 12b: the selftest on {MESH_RANKS} ranks sharing the card over gloo, "
          f"{CHECK_IDS} ids, serving batch {MESH_BATCH}")
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.placement_mesh", "--selftest",
         "--devices", str(MESH_RANKS), "--device", "cuda", "--ids", str(CHECK_IDS),
         "--batch", str(MESH_BATCH)],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=MESH_TIMEOUT)
    finally:
        if proc.poll() is None:  # stop the ranks too
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    for line in out.splitlines():
        print(f"  {line}")
    require(proc.returncode == 0, f"phase 12b: the {MESH_RANKS}-rank selftest failed:\n"
            f"{err[-3000:]}")
    staged = re.search(r"backend gloo on cuda:0, mesh\.host_staged (\d+)", out)
    require(staged is not None and f"selftest OK on {MESH_RANKS} ranks" in out,
            "phase 12b: the selftest did not report")
    print(f"  {MESH_RANKS} ranks on one card: 0 mismatches, mesh.host_staged "
          f"{staged.group(1)} (rank 0), {time.perf_counter() - t0:.1f} s")
    return launches


def load_tree(tree: Path, name: str):
    """The ``repro_torch`` package of another checkout at ``tree``,
    imported as ``name`` beside this one (its kernels build from its own
    sources into its own ``_build``)."""
    import importlib.util

    src = tree / "src" / "repro_torch"
    require((src / "__init__.py").is_file(), f"{tree} holds no src/repro_torch")
    spec = importlib.util.spec_from_file_location(
        name, src / "__init__.py", submodule_search_locations=[str(src)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def tree_to(tree: dict, dev) -> dict:
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


@contextlib.contextmanager
def fp32_compute(torch):
    """The model computes in fp32 inside the block (the truth of 13e)."""
    from repro_torch.models import layers as lm_layers

    saved = lm_layers.COMPUTE_DTYPE
    lm_layers.set_compute_dtype(torch.float32)
    try:
        yield
    finally:
        lm_layers.set_compute_dtype(saved)


def lm_runs(torch, cfg, params, prompt, n_dec: int, dev) -> list:
    """[(what, card, CPU, fp32)] logits of a prefill of ``prompt`` and
    ``n_dec`` decode steps fed its first tokens, all on the same weights:
    the serving steps (bf16) on the card and on the CPU, and the model
    computed in fp32 on the CPU (``set_compute_dtype``), the truth that
    both bf16 runs are held to."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.train import make_prefill_step, make_serve_step

    cpu = torch.device("cpu")
    b, p = prompt.shape
    cpu_params = tree_to(params, cpu)

    def logits(d, tree, pre, step) -> list:
        tokens = torch.from_numpy(prompt).to(d)
        out = [pre(tree, {"tokens": tokens})]
        cache = init_cache(cfg, b, p, device=d)
        for t in range(n_dec):
            batch = {"tokens": tokens[:, t:t + 1],
                     "positions": torch.full((b, 1), t, dtype=torch.int32, device=d)}
            got, cache = step(tree, cache, batch)
            out.append(got)
        return out

    card = logits(dev, params, make_prefill_step(cfg), make_serve_step(cfg))
    bf16 = logits(cpu, cpu_params, make_prefill_step(cfg), make_serve_step(cfg))
    with fp32_compute(torch):
        fp32 = logits(cpu, cpu_params, lambda tree, batch: prefill(cfg, tree, batch),
                      lambda tree, cache, batch: decode_step(cfg, tree, cache, batch))
    whats = [f"prefill of {p} tokens"] + [f"decode step {t}" for t in range(n_dec)]
    return list(zip(whats, card, bf16, fp32))


def reading(got: list, control: list, truth: list) -> tuple[float, float]:
    """(max |got - truth|, max |control - truth|) over lists of tensors of
    the same shapes, the second at least 2**-8 x max |truth| (bf16's least
    spacing there)."""
    def dist(xs, ys) -> float:
        return max(float((x.float().cpu() - y.float().cpu()).abs().max()) for x, y in zip(xs, ys))

    floor = 2.0**-8 * max(float(t.float().abs().max()) for t in truth)
    return dist(got, truth), max(dist(control, truth), floor)


def hold_logits(torch, what: str, got, control, truth, phase: str = "13e",
                factor: float = LM_NOISE_FACTOR, quiet: bool = False) -> float:
    """bf16 logits ``got`` against the fp32 ``truth`` of the same weights
    and inputs, ``control`` being another bf16 run of them: max |got -
    truth| within ``LM_NOISE_FACTOR`` x the control's max |control - truth|
    (at least 2**-8 x max |truth|, bf16's least spacing there), and the
    greedy tokens the truth's wherever its top-2 margin exceeds twice that
    limit -> max |got - truth| over the control's (the reading).  ``factor``
    stands for ``LM_NOISE_FACTOR`` where given; ``quiet`` prints a reading
    only when it fails."""
    got, control, truth = (t.float().cpu() for t in (got, control, truth))
    err, ctl = reading([got], [control], [truth])
    limit = factor * ctl
    top2 = truth.topk(2, dim=-1).values
    sure = top2[..., 0] - top2[..., 1] > 2 * limit
    same = bool(torch.equal(got.argmax(-1)[sure], truth.argmax(-1)[sure]))
    if not quiet or not (err <= limit and same):
        print(f"  {what:44s} max |got - fp32| {err:.6f}, control {ctl:.6f}: {err / ctl:.4f} "
              f"(limit {factor}); max |got - control| "
              f"{float((got - control).abs().max()):.6f} of max |control| "
              f"{float(control.abs().max()):.6f}; greedy tokens the fp32 run's on "
              f"{int(sure.sum())}/{sure.numel()} rows with margin > 2 x limit: {same}")
    require(err <= limit and same, f"phase {phase}: {what}: further from fp32 than the control allows")
    return err / ctl


def lm_flops(cfg, batch: int, seq: int) -> float:
    """Multiply-add FLOPs that a causal prefill of ``seq`` positions needs:
    every matmul weight once per position (the head once per sequence) and
    the QK and PV products of the (query, key) pairs the mask keeps: seq
    (seq + 1) / 2 per head and sequence, fewer under a window."""
    d, hd = cfg.d_model, cfg.head_dim_
    per_layer = (d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
                 + 3 * d * cfg.d_ff)
    dense = 2 * batch * seq * cfg.n_layers * per_layer + 2 * batch * d * cfg.vocab
    w = min(cfg.window, seq) if cfg.attn_kind != "full" and cfg.window else seq
    pairs = w * (w + 1) // 2 + (seq - w) * w
    attention = 4 * batch * pairs * cfg.n_heads * hd * cfg.n_layers
    return float(dense + attention)


def twin_nodes(engine, ids, n_replicas: int = 0):
    """Node ids of ``ids`` under ``engine``'s current device table from the
    plain-torch twin of the fused placement kernel (B1), or with
    ``n_replicas`` the (n, R) rows of the replica kernel's twin (B2)."""
    from repro_torch.kernels import ref

    art, params = engine._device_artifact(), engine.params
    if n_replicas:
        return ref.place_replicas_ref(ids, art.len32_dev, art.node_of_dev,
                                      top_level=art.top_level, s_log2=params.s_log2,
                                      max_draws=params.max_draws, n_replicas=n_replicas,
                                      emit_nodes=True)
    return ref.place_fused_ref(ids, art.len32_dev, art.cum_hi_dev, art.cum_lo_dev,
                               art.node_of_dev, top_level=art.top_level, s_log2=params.s_log2,
                               max_draws=params.max_draws, emit_nodes=True)


def hold_routing(torch, what: str, engine, ids, got) -> None:
    """Node ids ``got`` of ``ids`` from ``engine`` against the fused
    placement kernel's twin on the engine's current device table, exact."""
    art = engine._device_artifact()
    want = twin_nodes(engine, ids)
    bad, _ = mismatches(torch, got.to(want.device), want)
    print(f"  {'place_fused':15s} {what:44s} {bad} mismatches against the twin "
          f"(top level {art.top_level})")
    require(bad == 0, f"phase 13: place_fused disagrees with its twin: {what}")


def phase13(torch, np, dev, seed, draws: int = LM_DRAWS) -> dict:
    """The dense language-model serving path on the card: 13a ASURA routing
    of session ids and 13b the serving CLI at full width (the main path,
    launches counted; every routing result held to B1's twin), 13c decode
    at the decode_32k shape, 13d prefill, 13e the card's logits against an
    fp32 run on the CPU, with the CPU's bf16 run as the control, on the
    CLI's weights and ``draws`` more."""
    from repro_torch.core import make_uniform_cluster
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.models import layers as lm_layers
    from repro_torch.train import make_prefill_step, make_serve_step

    card = card_line(dev)
    rng = np.random.default_rng(seed)
    t_phase = time.perf_counter()
    reset_launches()
    print(f"phase 13a ({card}): ASURA routing of {LM_SESSIONS} session ids over "
          f"{LM_REPLICAS} replicas; replica 3 dies, standby {LM_REPLICAS} joins")
    routing = make_uniform_cluster(LM_REPLICAS, device=dev)
    sessions = torch.from_numpy(rng.integers(0, 2**32, LM_SESSIONS, dtype=np.uint32)).to(dev)
    before = routing.engine.place_nodes_device(sessions)
    hold_routing(torch, f"{LM_REPLICAS} replicas", routing.engine, sessions, before)
    routing.remove_node(3)
    after = routing.engine.place_nodes_device(sessions)
    hold_routing(torch, "replica 3 removed", routing.engine, sessions, after)
    routing.add_node(LM_REPLICAS, 1.0)
    after2 = routing.engine.place_nodes_device(sessions)
    hold_routing(torch, f"standby {LM_REPLICAS} joined", routing.engine, sessions, after2)
    moved, moved2 = before != after, after != after2
    require(torch.equal(moved, before == 3), "phase 13a: the moved sessions are not replica 3's")
    require(bool((after2[moved2] == LM_REPLICAS).all()),
            "phase 13a: the standby's join moved sessions elsewhere")
    share = torch.bincount(before.long(), minlength=LM_REPLICAS).cpu().tolist()
    print(f"  sessions per replica {share}; {int(moved.sum())} re-routed off replica 3 (all "
          f"of its {share[3]}); {int(moved2.sum())} moved to the standby, all to it")

    print(f"phase 13b ({card}): python -m repro_torch.launch.serve {' '.join(LM_CLI)} "
          f"--seed {seed}")
    rep = serve.run(LM_CLI + ["--seed", str(seed)])
    launches = dict(LAUNCHES)
    cfg, params, out = rep["cfg"], rep["params"], rep["decoded"]
    require(out.tokens.shape == (rep["ids"].size, 8) and out.tokens.min() >= 0
            and out.tokens.max() < cfg.vocab, "phase 13b: decoded tokens out of shape or range")
    require(launches.get("place_fused", 0) > 0, "phase 13: routing did not launch place_fused")
    n_req = rep["owners"].size
    hold_routing(torch, f"the CLI's owners of {n_req} requests", rep["engine"],
                 torch.from_numpy(np.arange(n_req, dtype=np.uint32)).to(dev),
                 torch.from_numpy(np.asarray(rep["owners"], dtype=np.int32)))
    print(f"  main path launches {launches}; decode step median {rep['step_ms']:.4f} ms "
          f"({rep['tok_s']:.1f} tok/s at batch 8; CUDA events, {card})")
    step = make_serve_step(cfg)
    cache = init_cache(cfg, 8, 64, device=dev)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1), dtype=np.int32)).to(dev),
             "positions": torch.zeros((8, 1), dtype=torch.int32, device=dev)}
    print_profile(profile_steps(torch, lambda: step(params, cache, batch), LM_PROFILED))
    del cache

    b, s = DECODE_32K
    print(f"phase 13c ({card}): decode at the decode_32k shape, batch {b} (cut from 128), "
          f"{s} cached positions, {DECODE_STEPS} steps from position {s - 1}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cache = init_cache(cfg, b, s, device=dev)
    blocks = cache["dense_blocks"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks["k"].normal_(generator=gen)  # a full cache: every slot holds a key
    blocks["v"].normal_(generator=gen)
    blocks["pos"].copy_(torch.arange(s, dtype=torch.int32, device=dev).expand_as(blocks["pos"]))
    blocks["index"].fill_(s - 1)
    kv_bytes = sum(blocks[k].numel() * blocks[k].element_size() for k in ("k", "v", "pos"))
    w_bytes = 2 * cfg.param_count()  # the bf16 working copy, read once per step
    step = make_serve_step(cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)).to(dev)
    marks = []
    for t in range(DECODE_STEPS + 1):  # the first is a warm-up
        batch = {"tokens": tokens,
                 "positions": torch.full((b, 1), s - 1 + t, dtype=torch.int32, device=dev)}
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        begin.record()
        logits, cache = step(params, cache, batch)
        end.record()
        marks.append((begin, end))
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    step_ms = statistics.median(bg.elapsed_time(en) for bg, en in marks[1:])
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    require(logits.shape == (b, cfg.vocab) and bool(torch.isfinite(logits).all()),
            "phase 13c: non-finite logits")
    last = dict(batch, tokens=tokens)
    prof = profile_steps(torch, lambda: step(params, cache, last), 2)
    bound_ms = 1e3 * (kv_bytes + w_bytes) / HBM_BYTES_PER_S
    print(f"  step {step_ms:.4f} ms median of {DECODE_STEPS} (CUDA events), {b * 1e3 / step_ms:.1f} "
          f"tok/s; bound {bound_ms:.4f} ms ({kv_bytes / 1e9:.2f} GB of K, V and positions + "
          f"{w_bytes / 1e9:.2f} GB of bf16 weights at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"{bound_ms / step_ms:.3f} of it); peak memory {peak:.2f} GiB; {card}")
    print_profile(prof)
    del cache, blocks, logits
    torch.cuda.empty_cache()

    pre = make_prefill_step(cfg)
    for b, s in PREFILLS:
        path = "blockwise" if s > lm_layers.BLOCKWISE_THRESHOLD else "dense"
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)).to(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        box = []
        ms = cuda_ms(torch, lambda: box.append(pre(params, {"tokens": tokens})), 1)[0]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        require(box[-1].shape == (b, cfg.vocab) and bool(torch.isfinite(box[-1]).all()),
                f"phase 13d: prefill {b} x {s}: non-finite logits")
        flops = lm_flops(cfg, b, s)
        print(f"phase 13d ({card}): prefill {b} x {s} ({path} attention): {ms:.2f} ms (CUDA "
              f"events, after one warm-up), {b * s * 1e3 / ms:.1f} tok/s; bound {1e3 * flops / BF16_FLOPS_PER_S:.2f} ms "
              f"({flops / 1e12:.2f} TFLOP at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16); "
              f"peak memory {peak:.2f} GiB")
        del box
        torch.cuda.empty_cache()

    b, p, n_dec = LM_CARD_CPU
    print(f"phase 13e ({card}): the card's logits against an fp32 run on the CPU, the CPU's "
          f"bf16 run the control; full width, batch {b}, the CLI's weights and {draws} more")
    prompt = rng.integers(0, cfg.vocab, (b, p), dtype=np.int32)
    readings = []
    for draw in range(draws + 1):
        tree = params if draw == 0 else tree_to(
            init_params(cfg, torch.Generator().manual_seed(draw), device="cpu"), dev)
        for what, got, control, truth in lm_runs(torch, cfg, tree, prompt, n_dec, dev):
            name = f"seed {seed} (card)" if draw == 0 else f"seed {draw} (CPU)"
            readings.append(hold_logits(torch, f"weights {name}, {what}", got, control, truth))
    b, p, threshold = LM_BLOCKWISE
    long_prompt = rng.integers(0, cfg.vocab, (b, p), dtype=np.int32)
    tokens = torch.from_numpy(long_prompt).to(dev)
    dense = pre(params, {"tokens": tokens})
    saved = lm_layers.BLOCKWISE_THRESHOLD
    lm_layers.set_blockwise_threshold(threshold)
    try:
        chunked = pre(params, {"tokens": tokens})
    finally:
        lm_layers.set_blockwise_threshold(saved)
    with fp32_compute(torch):
        truth = prefill(cfg, tree_to(params, torch.device("cpu")),
                        {"tokens": torch.from_numpy(long_prompt)})
    readings.append(hold_logits(torch, f"card blockwise prefill of {p}, dense the control",
                                chunked, dense, truth))
    print(f"  largest reading {max(readings):.4f} of {len(readings)} (limit {LM_NOISE_FACTOR}); "
          f"phase 13 {time.perf_counter() - t_phase:.1f} s")
    return launches


def train_flops(cfg, batch: int, seq: int) -> float:
    """Multiply-add FLOPs of one training step on ``batch`` x ``seq``
    tokens: 3x the forward (the backward takes twice its products), the
    forward being ``lm_flops`` with the head at every position; remat's
    recompute is not counted."""
    head = 2 * batch * (seq - 1) * cfg.d_model * cfg.vocab  # lm_flops counts one per sequence
    return 3.0 * (lm_flops(cfg, batch, seq) + head)


def train_readings(torch, np, cfg, params, tokens, dev, extra=None) -> tuple[dict, float]:
    """One train step from ``params`` (on the CPU) on the card (bf16), on
    the CPU (bf16) and on the CPU in fp32 -> ({quantity: (card, CPU, fp32)}
    for the loss, ``grad_norm`` and the moments ``m`` and ``v`` (the clipped
    gradient x 0.1, its square x 0.05), each a list of CPU tensors; the
    card's update reading).  Adam's first step is about lr x sign(g), so
    the bf16 control's step already takes the other sign wherever a
    gradient is near zero: the new parameters against fp32 would read at
    most 2 lr and hold nothing.  The card's new parameters are instead
    held to the update recomputed in float64 (on the card) from its own
    parameters, ``m`` and ``v`` and the schedule's lr
    (``optimizer.update_reading`` at ``UPDATE_ULPS``), at most 1 when the
    card's fp32 arithmetic is AdamW's.  Twice the lr or a reversed decay
    reads far above it.  ``extra``: the batch's other inputs (CPU tensors,
    e.g. encdec's frames)."""
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train.optimizer import tree_flatten, update_reading

    opt = AdamWConfig(warmup_steps=1)  # the full lr on step 1: the decay term is many ulp of p
    step = make_train_step(cfg, opt)
    cpu = torch.device("cpu")
    out, worst = {}, 0.0
    for name, d in (("card", dev), ("cpu", cpu), ("fp32", cpu)):
        p = params if d == cpu else tree_to(params, d)
        with fp32_compute(torch) if name == "fp32" else contextlib.nullcontext():
            batch = {"tokens": tokens.to(d), **{k: v.to(d) for k, v in (extra or {}).items()}}
            new, state, m = step(p, init_train_state(cfg, p), batch)
        out[name] = {"loss": [m["loss"].cpu()], "grad_norm": [m["grad_norm"].cpu()],
                     **{k: [x.cpu() for x in tree_flatten(state[k])[0]] for k in ("m", "v")}}
        if name == "card":  # in float64 on the card: on the CPU it took ~8 s per draw
            worst = update_reading(opt, p, new, state, UPDATE_ULPS)
        del new, state
    return {k: (out["card"][k], out["cpu"][k], out["fp32"][k]) for k in out["card"]}, worst


def phase14(torch, np, dev, seed, draws: int = TRAIN_DRAWS) -> dict:
    """The dense language-model training path on the card: 14a the training
    CLI at its defaults at full width (the main path, launches counted:
    B1's ownership sweep, B2's chunk placement on save and restore), the
    restore after two store nodes fail held bit for bit to the state saved,
    the owners and replica rows held to B1's and B2's twins; 14b one step
    on the card against an fp32 run on the CPU, the CPU's bf16 run the
    control, on the CLI's trained weights and ``draws`` more; 14c a
    train_4k step (cut to batch 32) timed against its FLOP bound."""
    from repro_torch.checkpoint.sharded import CHUNK_BYTES, _flatten, _leaf_nbytes, chunk_id
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.models import SHAPES, init_params, make_inputs
    from repro_torch.models.lm import set_remat_policy
    from repro_torch.train import init_train_state, make_train_step

    card = card_line(dev)
    rng = np.random.default_rng(seed)
    t_phase = time.perf_counter()
    print(f"phase 14a ({card}): python -m repro_torch.launch.train {' '.join(TRAIN_CLI)} "
          f"--seed {seed}; then store nodes {list(TRAIN_FAILED)} fail and the last save is "
          f"restored")
    reset_launches()
    rep = train.run(TRAIN_CLI + ["--seed", str(seed)])
    mgr, (step, saved) = rep["manager"], rep["last_save"]
    store = mgr.store
    for nid in TRAIN_FAILED:
        store.fail_node(nid)
    restored, t_restore = wall(lambda: mgr.restore(step, saved))
    launches = dict(LAUNCHES)
    cfg, pipe = rep["cfg"], rep["pipeline"]
    require(rep["rc"] == 0, "phase 14a: the training CLI's loss did not improve")
    for name in ("place_fused", "place_replicas"):
        require(launches.get(name, 0) > 0, f"phase 14a: the training path did not launch {name}")
    leaves, got = _flatten(saved)[0], _flatten(restored)[0]
    require(all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
                for a, b in zip(got, leaves)), "phase 14a: the restore differs from the save")
    n_bytes = sum(_leaf_nbytes(x) for x in leaves)
    print(f"  main path launches {launches}; restore of step {step} ({n_bytes / 2**30:.4f} GiB, "
          f"{len(leaves)} leaves) with {len(TRAIN_FAILED)} of {len(store.nodes)} nodes down "
          f"bit-exact in {t_restore:.4f} s (host wall); save_async held the loop "
          f"{', '.join(f'{t:.4f}' for t in rep['save_s'])} s (host wall, the copy to the host)")
    shard_ids = torch.arange(pipe.dataset.n_shards, dtype=torch.int64, device=dev).to(torch.int32)
    want = twin_nodes(pipe.engine, shard_ids)
    mine = (want == pipe.host_id).cpu().numpy()
    require(np.array_equal(pipe.owned_shards, np.arange(pipe.dataset.n_shards)[mine]),
            "phase 14a: the pipeline's shards are not B1's twin's")
    keys = np.array([chunk_id(step, li, ci) for li, leaf in enumerate(leaves)
                     for ci in range(max(1, -(-_leaf_nbytes(leaf) // CHUNK_BYTES)))],
                    dtype=np.uint32)
    rows = twin_nodes(store.engine, torch.from_numpy(keys.view(np.int32)).to(dev), 3).cpu()
    held = {nid: set(node.blobs) for nid, node in store.nodes.items()}
    bad = sum({nid for nid, ks in held.items() if k in ks} != {int(x) for x in row if x >= 0}
              for k, row in zip(keys.tolist(), rows.tolist()))
    print(f"  place_fused     the pipeline's {pipe.owned_shards.size} of {pipe.dataset.n_shards} "
          f"shards are the twin's; place_replicas {bad} of {keys.size} chunks off the twin's "
          f"replica rows")
    require(bad == 0, "phase 14a: stored chunks are not where B2's twin places them")
    del restored, got
    tokens = torch.from_numpy(next(pipe.batches())).to(dev)
    step_fn = make_train_step(cfg)
    print_profile(profile_steps(
        torch, lambda: step_fn(rep["params"], rep["opt_state"], {"tokens": tokens}), 2))

    b, s = TRAIN_CARD_CPU
    print(f"phase 14b ({card}): one train step on the card against an fp32 run on the CPU, the "
          f"CPU's bf16 run the control (loss, grad_norm, m, v), and the card's new parameters "
          f"against AdamW in float64; full width, batch {b} x {s}, the CLI's trained weights "
          f"and {draws} more")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s), dtype=np.int32))
    readings = []
    for draw in range(draws + 1):
        t0 = time.perf_counter()
        tree = tree_to(rep["params"], torch.device("cpu")) if draw == 0 else init_params(
            cfg, torch.Generator().manual_seed(draw), device="cpu")
        runs, upd = train_readings(torch, np, cfg, tree, tokens, dev)
        name = "the CLI's (card)" if draw == 0 else f"seed {draw} (CPU)"
        print(f"  weights {name:17s} update     max |card - float64 AdamW of the card's p, m, v| "
              f"over {UPDATE_ULPS} ulp: {upd:.4f} (limit 1)")
        require(upd <= 1.0, "phase 14b: the card's parameter update is not AdamW's arithmetic")
        for what, (got_, control, truth) in runs.items():
            err, ctl = reading(got_, control, truth)
            readings.append(err / ctl)
            print(f"  weights {name:17s} {what:10s} max |card - fp32| {err:.6e}, control "
                  f"{ctl:.6e}: {err / ctl:.4f} (limit {LM_NOISE_FACTOR}); |fp32| max "
                  f"{max(float(t.abs().max()) for t in truth):.6e}")
            require(err <= LM_NOISE_FACTOR * ctl,
                    f"phase 14b: {what}: further from fp32 than the control allows")
        print(f"  ({time.perf_counter() - t0:.1f} s for the three runs)")
        del runs, tree
    print(f"  largest reading {max(readings):.4f} of {len(readings)} (limit {LM_NOISE_FACTOR})")
    del rep, saved, leaves, mgr, store
    torch.cuda.empty_cache()

    b, s, n_micro = TRAIN_4K
    print(f"phase 14c ({card}): a train_4k step at full width, batch {b} x {s} (cut from 256) in "
          f"{n_micro} microbatches, remat \"nothing\"; a warm-up, then {TRAIN_TIMED} timed")
    set_remat_policy("nothing")
    spec = dataclasses.replace(SHAPES["train_4k"], global_batch=b, seq_len=s)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = make_inputs(cfg, spec, gen, device=dev)["batch"]
    params = init_params(cfg, gen, device=dev)
    opt = init_train_state(cfg, params)
    step_fn = make_train_step(cfg, n_microbatches=n_micro)
    torch.cuda.reset_peak_memory_stats(dev)
    with warnings.catch_warnings(record=True) as caught:  # host syncs of one step
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            (params, opt, m0), t_warm = wall(lambda: step_fn(params, opt, batch))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    loss0 = float(m0["loss"])
    require(math.isfinite(loss0) and abs(loss0 - math.log(cfg.vocab)) < 1.0,
            f"phase 14c: step-0 loss {loss0} is not near ln(vocab) {math.log(cfg.vocab):.4f}")
    marks = []
    for _ in range(TRAIN_TIMED):
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        begin.record()
        params, opt, m = step_fn(params, opt, batch)
        end.record()
        marks.append((begin, end))
    torch.cuda.synchronize()
    step_ms = statistics.median(bg.elapsed_time(en) for bg, en in marks)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    require(math.isfinite(float(m["loss"])), "phase 14c: non-finite loss")
    flops = train_flops(cfg, b, s)
    bound_ms = 1e3 * flops / BF16_FLOPS_PER_S
    print(f"  step-0 loss {loss0:.4f} (ln {cfg.vocab} = {math.log(cfg.vocab):.4f}); warm-up "
          f"{t_warm:.2f} s host wall with {len(syncs)} host syncs under sync debug \"warn\"")
    print(f"  step {step_ms:.2f} ms median of {TRAIN_TIMED} (CUDA events), "
          f"{b * s * 1e3 / step_ms:.1f} tokens/s; bound {bound_ms:.2f} ms ({flops / 1e12:.2f} "
          f"TFLOP at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16, remat not counted; "
          f"{bound_ms / step_ms:.4f} of it); peak memory {peak:.2f} GiB; {card}")
    print_profile(profile_steps(torch, lambda: step_fn(params, opt, batch), 1, warm=False))
    print(f"  phase 14 {time.perf_counter() - t_phase:.1f} s")
    del params, opt, batch
    torch.cuda.empty_cache()
    return launches


def moe_layers(cfg) -> tuple[int, int]:
    """(dense layers, MoE layers) of a config."""
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe is not None else 0
    return cfg.n_layers - n_moe, n_moe


def dropped_per_layer(log, n_moe: int) -> list:
    """The share of assignments dropped at capacity in each MoE layer over
    the calls of a ``RouteLog`` (one call per layer per forward)."""
    kept, made = [0] * n_moe, [0] * n_moe
    for i, (_, _, keep) in enumerate(log.calls):
        kept[i % n_moe] += int(keep.sum())
        made[i % n_moe] += keep.numel()
    return [1.0 - k / m for k, m in zip(kept, made)]


def moe_flops(cfg, batch: int, seq: int) -> float:
    """Multiply-add FLOPs that a causal prefill of ``seq`` positions needs
    when every routed assignment is kept: each active weight (attention or
    MLA projections, the dense MLP, the router, top_k experts and the
    shared ones) once per position, the head once per sequence, and the
    score and value products of the (query, key) pairs the mask keeps."""
    d, v = cfg.d_model, cfg.vocab
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    dense = 2 * batch * seq * (cfg.active_param_count() - embed) + 2 * batch * d * v
    w = min(cfg.window, seq) if cfg.attn_kind != "full" and cfg.window else seq
    pairs = w * (w + 1) // 2 + (seq - w) * w
    if cfg.mla is not None:
        dims = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim + cfg.mla.v_head_dim
    else:
        dims = 2 * cfg.head_dim_
    return float(dense + 2 * batch * pairs * cfg.n_heads * dims * cfg.n_layers)


def expert_bytes(cfg) -> int:
    """bf16 bytes of one expert's matrices."""
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    return 2 * mult * cfg.d_model * cfg.moe.d_ff_expert


def moe_serving(torch, np, dev, arch: str, cfg, params, seed: int, card: str, tag: str) -> None:
    """15a / 15b beyond the CLI: decode at batch 8 against a full ring
    whose index starts ``MOE_WRAP[2]`` slots before its end (a warm-up,
    then ``DECODE_STEPS`` timed, crossing the wrap), profiled, its bytes
    bound from the experts the steps routed to; then the prefills of
    ``MOE_PREFILLS``."""
    from repro_torch.models import init_cache
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.routes import RouteLog
    from repro_torch.train import make_prefill_step, make_serve_step

    rng = np.random.default_rng(seed)
    _, n_moe = moe_layers(cfg)
    b, max_len, before = MOE_WRAP
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cache = init_cache(cfg, b, max_len, device=dev)
    size = next(iter(cache.values()))["pos"].shape[-1]  # the window clamps a ring
    start = size - before
    gen = torch.Generator(device=dev).manual_seed(seed)
    for stack in cache.values():
        for leaf in stack.values():
            if leaf.is_floating_point():
                leaf.normal_(generator=gen)  # every filled slot holds a key
        stack["pos"][..., :start] = torch.arange(start, dtype=torch.int32, device=dev)
        stack["index"].fill_(start)
    cache_bytes = sum(x.numel() * x.element_size() for st in cache.values() for x in st.values())
    kind = "compressed latent" if cfg.mla is not None else "window ring"
    print(f"{tag} ({card}): decode at batch {b} against a full {kind} cache of {size} slots "
          f"({cache_bytes / 1e9:.4f} GB), index {start}: a warm-up and {DECODE_STEPS} timed "
          f"steps from position {start}, the ring wrapping at step {before}")
    step = make_serve_step(cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)).to(dev)
    marks = []
    with RouteLog() as log:
        for t in range(DECODE_STEPS + 1):
            batch = {"tokens": tokens,
                     "positions": torch.full((b, 1), start + t, dtype=torch.int32, device=dev)}
            begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            begin.record()
            logits, cache = step(params, cache, batch)
            end.record()
            marks.append((begin, end))
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    step_ms = statistics.median(bg.elapsed_time(en) for bg, en in marks[1:])
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    require(logits.shape == (b, cfg.vocab) and bool(torch.isfinite(logits).all()),
            f"{tag}: non-finite decode logits")
    first = next(iter(cache.values()))
    require(int(first["index"][0]) == start + DECODE_STEPS + 1
            and int(first["pos"][0, 0, 0]) == size, f"{tag}: the ring did not wrap into slot 0")
    used = [int((torch.bincount(experts[keep.view(experts.shape)].view(-1).cpu(),
                                minlength=cfg.moe.n_experts) > 0).sum())
            for _, experts, keep in log.calls[n_moe:]]  # the timed steps' calls
    per_step = sum(used) / DECODE_STEPS
    dense_w = 2 * cfg.param_count() - n_moe * cfg.moe.n_experts * expert_bytes(cfg)
    w_bytes = dense_w + per_step * expert_bytes(cfg)
    bound_ms = 1e3 * (cache_bytes + w_bytes) / HBM_BYTES_PER_S
    drops = ", ".join(f"{x:.4f}" for x in dropped_per_layer(log, n_moe))
    print(f"  step {step_ms:.4f} ms median of {DECODE_STEPS} (CUDA events), "
          f"{b * 1e3 / step_ms:.1f} tok/s; bound {bound_ms:.4f} ms ({cache_bytes / 1e9:.4f} GB "
          f"of cache + {w_bytes / 1e9:.2f} GB of bf16 weights, {per_step / n_moe:.2f} experts "
          f"per MoE layer routed to per step, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"{bound_ms / step_ms:.3f} of it); peak memory {peak:.2f} GiB; dropped at capacity "
          f"per MoE layer {drops}; {card}")
    last = dict(batch, tokens=tokens)
    print_profile(profile_steps(torch, lambda: step(params, cache, last), 2))
    del cache, step, logits, log, last
    torch.cuda.empty_cache()

    pre = make_prefill_step(cfg)
    for b, s in MOE_PREFILLS[arch]:
        path = "blockwise" if s > lm_layers.BLOCKWISE_THRESHOLD else "dense"
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)).to(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        box = []
        with RouteLog() as log:
            ms = cuda_ms(torch, lambda: box.append(pre(params, {"tokens": tokens})), 1)[0]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        require(box[-1].shape == (b, cfg.vocab) and bool(torch.isfinite(box[-1]).all()),
                f"{tag}: prefill {b} x {s}: non-finite logits")
        flops = moe_flops(cfg, b, s)
        drops = ", ".join(f"{x:.4f}" for x in dropped_per_layer(log, n_moe))
        print(f"{tag} ({card}): prefill {b} x {s} ({path} attention): {ms:.2f} ms (CUDA "
              f"events, after one warm-up), {b * s * 1e3 / ms:.1f} tok/s; bound "
              f"{1e3 * flops / BF16_FLOPS_PER_S:.2f} ms ({flops / 1e12:.2f} TFLOP at "
              f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16, every assignment kept); peak memory "
              f"{peak:.2f} GiB; dropped at capacity per MoE layer {drops}")
        del box, log
        torch.cuda.empty_cache()


def moe_runs(torch, cfg, params, prompt, n_dec: int, dev) -> dict:
    """{run: [(logits, route calls)] of a prefill of ``prompt`` and of
    ``n_dec`` decode steps fed its first tokens against a fresh cache}, on
    the same weights (``params`` on the CPU): "card" and "cpu" the serving
    steps in bf16, "card32" and "fp32" the model computed in fp32
    (``set_compute_dtype``)."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.routes import RouteLog
    from repro_torch.train import make_prefill_step, make_serve_step

    cpu = torch.device("cpu")
    b, p = prompt.shape

    def stages(d, tree, pre, step) -> list:
        tokens = torch.from_numpy(prompt).to(d)
        with RouteLog() as log:
            out = [(pre(tree, {"tokens": tokens}), log.calls)]
        cache = init_cache(cfg, b, p, device=d)
        for t in range(n_dec):
            batch = {"tokens": tokens[:, t:t + 1],
                     "positions": torch.full((b, 1), t, dtype=torch.int32, device=d)}
            with RouteLog() as log:
                logits, cache = step(tree, cache, batch)
            out.append((logits, log.calls))
        return out

    card_params = tree_to(params, dev)
    runs = {"card": stages(dev, card_params, make_prefill_step(cfg), make_serve_step(cfg)),
            "cpu": stages(cpu, params, make_prefill_step(cfg), make_serve_step(cfg))}
    with fp32_compute(torch):
        fns = (lambda tree, batch: prefill(cfg, tree, batch),
               lambda tree, cache, batch: decode_step(cfg, tree, cache, batch))
        runs["fp32"] = stages(cpu, params, *fns)
        runs["card32"] = stages(dev, card_params, *fns)
    return runs


def hold_moe_runs(torch, name: str, runs: dict, prompt_len: int, flips: dict) -> list:
    """15c on one weight draw: per stage (the prefill, then the decode steps,
    whose rows carry the hits of the steps before) the fp32 runs' routes
    and logits, the bf16 routes of the card against the CPU's and the
    card's bf16 logits against fp32 on the rows no flip reached -> the
    readings; ``flips`` counts (flipped, tokens) per comparison."""
    from repro_torch.models.routes import route_changes

    readings, hit = [], {}
    for i, stage in enumerate(zip(*(runs[k] for k in ("card", "cpu", "fp32", "card32")))):
        (card, card_r), (cpu, cpu_r), (f32, f32_r), (c32, c32_r) = stage
        what = f"{name}, prefill of {prompt_len}" if i == 0 else f"{name}, decode step {i - 1}"
        tpr = prompt_len if i == 0 else 1
        if i == 1:
            hit = {}  # decode runs against its own cache
        for key, truth, other, eps in (("fp32 card vs CPU", f32_r, c32_r, ROUTE_EPS_FP32),
                                       ("bf16 card vs CPU", cpu_r, card_r, ROUTE_EPS_BF16),
                                       ("bf16 card vs fp32", f32_r, card_r, 1.0),
                                       ("bf16 CPU vs fp32", f32_r, cpu_r, 1.0)):
            out = route_changes(truth, other, tokens_per_row=tpr, eps=eps, hit=hit.get(key))
            hit[key] = ~out["held"]
            n = flips.setdefault(key, [0, 0])
            n[0], n[1] = n[0] + out["flips"], n[1] + out["tokens"]
            require(out["wide"] == 0, f"phase 15c: {what}: {key}: {out['wide']} routes flipped "
                                      f"beyond the gap limit {eps}")
        held32, held16 = ~hit["fp32 card vs CPU"], ~hit["bf16 card vs CPU"]
        got32, want32 = c32.float().cpu()[held32], f32.float().cpu()[held32]
        err = float((got32 - want32).abs().max()) if held32.any() else 0.0
        close = bool(torch.allclose(got32, want32, rtol=1e-4, atol=1e-5))
        print(f"  {what:44s} fp32 card vs CPU on {int(held32.sum())}/{held32.numel()} rows: "
              f"max |diff| {err:.3e} (rtol 1e-4, atol 1e-5: {close})")
        require(close, f"phase 15c: {what}: the fp32 runs disagree")
        if held16.any():
            readings.append(hold_logits(
                torch, f"{what} ({int(held16.sum())}/{held16.numel()} rows)", card[held16.to(
                    card.device)], cpu[held16], f32[held16], phase="15c"))
        else:
            print(f"  {what:44s} bf16: every row reached by a route flip, no reading")
    return readings


def phase15(torch, np, dev, seed, draws: int = MOE_DRAWS) -> dict:
    """The MoE language models on the card: 15a / 15b the serving CLI at
    full width with the depth cut (the main path, launches counted; its
    routing held to B1's twin), decode across the ring's wrap and the
    prefills; 15c the reduced configs' routes and logits on the card
    against the CPU; 15d one training step per family against the CPU and
    the training CLI at ``--reduced`` (launches counted)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve, train
    from repro_torch.models import init_params, reduced_config
    from repro_torch.models.routes import RouteLog

    card = card_line(dev)
    rng = np.random.default_rng(seed)
    t_phase = time.perf_counter()
    launches: dict = {}

    def count(got: dict) -> None:
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    for tag, arch in zip(("15a", "15b"), MOE_ARCHS):
        t0 = time.perf_counter()
        print(f"phase {tag} ({card}): python -m repro_torch.launch.serve --arch {arch} "
              f"{' '.join(MOE_CLI)} --seed {seed}")
        reset_launches()
        with RouteLog() as log:
            rep = serve.run(["--arch", arch] + MOE_CLI + ["--seed", str(seed)])
        got = dict(LAUNCHES)
        count(got)
        cfg, params, out = rep["cfg"], rep["params"], rep["decoded"]
        n_dense, n_moe = moe_layers(cfg)
        require(out.tokens.shape == (rep["ids"].size, 8) and out.tokens.min() >= 0
                and out.tokens.max() < cfg.vocab, f"phase {tag}: decoded tokens out of range")
        require(got.get("place_fused", 0) > 0, f"phase {tag}: routing did not launch place_fused")
        n_req = rep["owners"].size
        hold_routing(torch, f"the CLI's owners of {n_req} requests", rep["engine"],
                     torch.from_numpy(np.arange(n_req, dtype=np.uint32)).to(dev),
                     torch.from_numpy(np.asarray(rep["owners"], dtype=np.int32)))
        drops = ", ".join(f"{x:.4f}" for x in dropped_per_layer(log, n_moe))
        print(f"  {cfg.name} at full width, {cfg.n_layers} layers ({n_dense} dense + {n_moe} "
              f"MoE; cut from {get_config(arch).n_layers}), {cfg.param_count() / 1e9:.2f} B "
              f"parameters; main path launches {got}; decode step median {rep['step_ms']:.4f} "
              f"ms ({rep['tok_s']:.1f} tok/s at batch 8; CUDA events, {card}); dropped at "
              f"capacity per MoE layer {drops}")
        del rep, out, log
        moe_serving(torch, np, dev, arch, cfg, params, seed, card, f"phase {tag}")
        del params
        torch.cuda.empty_cache()
        print(f"  phase {tag} {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    b, p, n_dec = MOE_CARD_CPU
    print(f"phase 15c ({card}): the reduced configs on the card against the CPU, weight "
          f"seeds 0 .. {draws}, prefill {b} x {p} and {n_dec} decode steps; route gaps "
          f"{ROUTE_EPS_FP32} (fp32) and {ROUTE_EPS_BF16} (bf16) of the largest |logit|")
    readings = []
    for arch in MOE_ARCHS:
        cfg = reduced_config(get_config(arch))
        flips: dict = {}
        for draw in range(draws + 1):
            params = init_params(cfg, torch.Generator().manual_seed(draw), device="cpu")
            prompt = rng.integers(0, cfg.vocab, (b, p), dtype=np.int32)
            runs = moe_runs(torch, cfg, params, prompt, n_dec, dev)
            readings += hold_moe_runs(torch, f"{cfg.name} seed {draw}", runs, p, flips)
        print(f"  {cfg.name}: route flips over the tokens compared: " + "; ".join(
            f"{k} {f}/{n} ({f / max(n, 1):.4f})" for k, (f, n) in flips.items()))
    compared = len(MOE_ARCHS) * (draws + 1) * (n_dec + 1)
    require(2 * len(readings) >= compared,
            f"phase 15c: route flips left {len(readings)} of {compared} comparisons a row")
    print(f"  largest reading {max(readings):.4f} of {len(readings)} (limit {LM_NOISE_FACTOR}); "
          f"15c {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    b, s = MOE_TRAIN
    print(f"phase 15d ({card}): one train step per family at the reduced size, batch {b} x "
          f"{s}, against an fp32 run on the CPU, the CPU's bf16 run the control (limit "
          f"{MOE_TRAIN_FACTOR}), and the card's new parameters against AdamW in float64")
    worst = 0.0
    for arch in MOE_ARCHS:
        cfg = reduced_config(get_config(arch))
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s), dtype=np.int32))
        for draw in range(draws + 1):
            tree = init_params(cfg, torch.Generator().manual_seed(draw), device="cpu")
            runs, upd = train_readings(torch, np, cfg, tree, tokens, dev)
            require(upd <= 1.0, f"phase 15d: {cfg.name}: the parameter update is not AdamW's")
            parts = []
            for what, (got_, control, truth) in runs.items():
                err, ctl = reading(got_, control, truth)
                worst = max(worst, err / ctl)
                parts.append(f"{what} {err / ctl:.4f}")
                require(err <= MOE_TRAIN_FACTOR * ctl,
                        f"phase 15d: {cfg.name} {what}: further from fp32 than the control allows")
            print(f"  {cfg.name} seed {draw}: " + ", ".join(parts) + f"; update {upd:.4f} of "
                  f"its limit")
    print(f"  largest reading {worst:.4f} (limit {MOE_TRAIN_FACTOR})")
    print(f"phase 15d ({card}): python -m repro_torch.launch.train {' '.join(MOE_TRAIN_CLI)} "
          f"--seed {seed}")
    reset_launches()
    rep = train.run(MOE_TRAIN_CLI + ["--seed", str(seed)])
    got = dict(LAUNCHES)
    count(got)
    require(rep["rc"] == 0, "phase 15d: the training CLI's loss did not improve")
    for name in ("place_fused", "place_replicas"):
        require(got.get(name, 0) > 0, f"phase 15d: the training path did not launch {name}")
    print(f"  main path launches {got}; loss {rep['losses'][0]:.4f} -> {rep['losses'][-1]:.4f}; "
          f"step {rep['step_ms']:.4f} ms median ({rep['tok_s']:.1f} tokens/s); peak memory "
          f"{(rep['peak_bytes'] or 0) / 2**30:.4f} GiB; 15d {time.perf_counter() - t0:.1f} s")
    del rep
    torch.cuda.empty_cache()
    print(f"  phase 15 {time.perf_counter() - t_phase:.1f} s")
    return launches


def decode_bound(cfg, params, cache, batch: int) -> tuple[float, float, float]:
    """(bytes, FLOPs, ms) a decode step of ``cfg`` must at least cost: the
    bf16 working copy of every matrix it reads and the fp32 vectors beside
    them (the encoder is not read in decode; an untied embedding only
    gathers rows), every cache byte, and for encdec the FLOPs of the
    reference's cross K / V recompute from ``enc_out`` in every layer; ms
    the larger of bytes over the HBM rate and FLOPs over the bf16 rate."""
    from repro_torch.train.optimizer import tree_flatten
    from repro_torch.train.step import _is_matmul_weight

    def weight_bytes(tree: dict) -> int:
        return sum(weight_bytes(v) if isinstance(v, dict)
                   else v.numel() * (2 if _is_matmul_weight(k) else 4) for k, v in tree.items())

    skip = {"enc_blocks", "enc_final_norm"} | (set() if cfg.tie_embeddings else {"embed"})
    w_bytes = weight_bytes({k: v for k, v in params.items() if k not in skip})
    c_bytes = sum(x.numel() * x.element_size() for x in tree_flatten(cache)[0])
    flops = 0.0
    if cfg.family == "encdec":
        flops = 2.0 * batch * cfg.enc_seq * cfg.d_model * 2 * cfg.n_kv_heads * cfg.head_dim_ \
            * cfg.n_layers
    ms = 1e3 * max((w_bytes + c_bytes) / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)
    return float(w_bytes + c_bytes), flops, ms


def rec_flops(cfg, batch: int, seq: int, head_every: bool = False) -> float:
    """Multiply-add FLOPs of a prefill of ``seq`` positions of a recurrent,
    RWKV or encoder-decoder model: every matrix once per position (the
    head once per sequence, or at every position with ``head_every``);
    local / causal attention over the (query, key) pairs its mask keeps;
    RG-LRU's conv and gates; RWKV6's chunked WKV as the reference computes
    it (per token and head the state read and write, 2 hd^2, and the lower
    triangle of its chunk, C hd); whisper's encoder over ``enc_seq``
    frames (all pairs), the decoder's cross K / V once per sequence and
    its cross-attention over every (token, frame) pair."""
    d, v, hd, h = cfg.d_model, cfg.vocab, cfg.head_dim_, cfg.n_heads
    tok = batch * seq
    mlp = (3 if cfg.act in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    qo, kv = 2 * d * h * hd, 2 * d * cfg.n_kv_heads * hd  # attention projections per position

    def pairs(window: int) -> int:
        w = min(window, seq) if window else seq
        return w * (w + 1) // 2 + (seq - w) * w

    head = (tok if head_every else batch) * d * v
    if cfg.family == "rglru":
        w = cfg.lru_width or d
        n_super, n_tail = divmod(cfg.n_layers, len(cfg.block_pattern))
        kinds = list(cfg.block_pattern) * n_super + [cfg.block_pattern[0]] * n_tail
        n_rec, n_att = kinds.count("rec"), kinds.count("attn")
        per_rec = 3 * d * w + 2 * w * w + CONV_MACS * w + mlp
        macs = tok * (n_rec * per_rec + n_att * (qo + kv + mlp))
        macs += 2 * batch * pairs(cfg.window) * h * hd * n_att
    elif cfg.family == "rwkv6":
        hd_r = cfg.rwkv_head_dim
        per = 6 * d * d + 2 * d * cfg.d_ff + 5 * 32 * d * 2 + 64 * d * 2
        wkv = (d // hd_r) * (2 * hd_r * hd_r + RWKV_CHUNK_LEN * hd_r)
        macs = tok * cfg.n_layers * (per + wkv)
    else:
        macs = encoder_macs(cfg, batch)
        macs += tok * cfg.n_layers * (qo + kv + qo + mlp)  # self-attention, cross q / o, MLP
        macs += batch * cfg.enc_seq * cfg.n_layers * kv  # cross K / V, once per sequence
        macs += 2 * batch * (pairs(0) + seq * cfg.enc_seq) * h * hd * cfg.n_layers
    return 2.0 * (macs + head)


def encoder_macs(cfg, batch: int) -> int:
    """Multiply-adds of whisper's encoder over ``enc_seq`` frames: every
    matrix once per frame and every (frame, frame) pair (not causal)."""
    d, h, hd, se = cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.enc_seq
    mlp = (3 if cfg.act in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    per_frame = 2 * d * h * hd + 2 * d * cfg.n_kv_heads * hd + mlp
    return cfg.n_enc_layers * (batch * se * per_frame + 2 * batch * se * se * h * hd)


def fill_long_cache(torch, cfg, cache, last: int, gen) -> None:
    """A decode cache as if every position up to ``last`` had been
    written: each ring holds the positions its slots last took (slot = pos
    % size), random bf16 keys and values, its index at ``last + 1`` (the
    next write goes to slot (last + 1) % size and the ring wraps after
    it); recurrent states random."""
    for leaf_parent in _cache_dicts(cache):
        if "pos" in leaf_parent:
            size = leaf_parent["pos"].shape[-1]
            slots = torch.arange(size, device=leaf_parent["pos"].device)
            leaf_parent["pos"].copy_((last - (last - slots) % size).to(torch.int32)
                                     .expand_as(leaf_parent["pos"]))
            leaf_parent["index"].fill_(last + 1)
        for name, leaf in leaf_parent.items():
            if not isinstance(leaf, dict) and leaf.is_floating_point():
                leaf.normal_(generator=gen)


def _cache_dicts(tree: dict) -> list:
    """The dicts of a cache tree that hold tensors."""
    out = [tree] if any(not isinstance(v, dict) for v in tree.values()) else []
    for v in tree.values():
        if isinstance(v, dict):
            out += _cache_dicts(v)
    return out


def rec_runs(torch, cfg, params, prompt, frames, n_dec: int, dev) -> list:
    """[(what, card bf16, CPU bf16, CPU fp32, card fp32)] logits of a prefill
    of ``prompt`` (with ``frames`` for encdec) and ``n_dec`` decode steps
    fed its first tokens against a fresh cache of the prompt's length
    (encdec: its ``enc_out`` the run's own encoding of the frames), on the
    same weights (``params`` on the CPU)."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import lm
    from repro_torch.train import make_prefill_step, make_serve_step

    cpu = torch.device("cpu")
    b, p = prompt.shape

    def stages(d, tree, pre, step) -> list:
        batch = {"tokens": torch.from_numpy(prompt).to(d)}
        if frames is not None:
            batch["frames"] = frames.to(d)
        out = [pre(tree, batch)]
        cache = init_cache(cfg, b, p, device=d)
        if frames is not None:
            cache["enc_out"] = lm._encode(cfg, tree, batch["frames"]).to(lm_layers.COMPUTE_DTYPE)
        for t in range(n_dec):
            got, cache = step(tree, cache, {"tokens": batch["tokens"][:, t:t + 1],
                                            "positions": torch.full((b, 1), t, dtype=torch.int32,
                                                                    device=d)})
            out.append(got)
        return out

    card_params = tree_to(params, dev)
    card = stages(dev, card_params, make_prefill_step(cfg), make_serve_step(cfg))
    bf16 = stages(cpu, params, make_prefill_step(cfg), make_serve_step(cfg))
    with fp32_compute(torch):
        fns = (lambda tree, batch: prefill(cfg, tree, batch),
               lambda tree, cache, batch: decode_step(cfg, tree, cache, batch))
        fp32 = stages(cpu, params, *fns)
        card32 = stages(dev, card_params, *fns)
    whats = [f"prefill of {p} tokens"] + [f"decode step {t}" for t in range(n_dec)]
    return list(zip(whats, card, bf16, fp32, card32))


def phase16(torch, np, dev, seed, draws: int = REC_DRAWS) -> dict:
    """The recurrent, RWKV and encoder-decoder families on the card: 16a
    the serving CLI at full width and depth (the main path, launches
    counted; routing held to B1's twin), 16b long_500k decode against the
    constant-size state beside a 64-position cache, 16c prefill 8 x 4,096
    (and whisper's encoder alone), 16d the reduced configs on the card
    against the CPU, 16e training: a reduced step per family against the
    CPU, a full-width step with the depth cut, and the training CLI for
    whisper (launches counted)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve, train
    from repro_torch.models import init_cache, init_params, make_inputs, reduced_config
    from repro_torch.models import lm
    from repro_torch.models.config import SHAPES
    from repro_torch.train import (bf16_working_copy, init_train_state, make_prefill_step,
                                   make_serve_step, make_train_step)
    from repro_torch.train.optimizer import tree_flatten

    card = card_line(dev)
    rng = np.random.default_rng(seed)
    t_phase = time.perf_counter()
    launches: dict = {}

    def count(got: dict) -> None:
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    def timed_steps(step, params, cache, b, first: int) -> tuple[float, object]:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)).to(dev)
        marks = []
        for t in range(DECODE_STEPS):
            batch = {"tokens": tokens,
                     "positions": torch.full((b, 1), first + t, dtype=torch.int32, device=dev)}
            begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            begin.record()
            logits, cache = step(params, cache, batch)
            end.record()
            marks.append((begin, end))
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        require(logits.shape == (b, cfg.vocab) and bool(torch.isfinite(logits).all()),
                f"phase 16: {cfg.name}: non-finite decode logits")
        return statistics.median(bg.elapsed_time(en) for bg, en in marks), logits

    for arch in REC_ARCHS:
        t0 = time.perf_counter()
        print(f"phase 16a ({card}): python -m repro_torch.launch.serve --arch {arch} "
              f"{' '.join(REC_CLI)} --seed {seed}")
        reset_launches()
        rep = serve.run(["--arch", arch] + REC_CLI + ["--seed", str(seed)])
        got = dict(LAUNCHES)
        count(got)
        cfg, out = rep["cfg"], rep["decoded"]
        require(out.tokens.shape == (rep["ids"].size, 8) and out.tokens.min() >= 0
                and out.tokens.max() < cfg.vocab, f"phase 16a: {arch}: decoded tokens out of range")
        require(got.get("place_fused", 0) > 0, f"phase 16a: {arch}: routing did not launch "
                                               f"place_fused")
        n_req = rep["owners"].size
        hold_routing(torch, f"the CLI's owners of {n_req} requests", rep["engine"],
                     torch.from_numpy(np.arange(n_req, dtype=np.uint32)).to(dev),
                     torch.from_numpy(np.asarray(rep["owners"], dtype=np.int32)))
        work = bf16_working_copy(rep["params"])  # the serving steps' weights; the master goes
        n_params = sum(x.numel() for x in tree_flatten(work)[0])
        del rep["params"]
        torch.cuda.empty_cache()
        step = make_serve_step(cfg)
        cache = init_cache(cfg, 8, 64, device=dev)
        b_bytes, b_flops, bound_ms = decode_bound(cfg, work, cache, 8)
        print(f"  {cfg.name} at full width and depth ({cfg.n_layers} layers"
              + (f" + {cfg.n_enc_layers} encoder" if cfg.family == "encdec" else "")
              + f", {n_params / 1e9:.3f} B parameters); main path launches {got}; decode step "
              f"median {rep['step_ms']:.4f} ms ({rep['tok_s']:.1f} tok/s at batch 8; CUDA "
              f"events); bound {bound_ms:.4f} ms ({b_bytes / 1e9:.3f} GB of bf16 weights and "
              f"cache at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, {b_flops / 1e12:.3f} TFLOP of cross "
              f"K / V at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s; {bound_ms / rep['step_ms']:.4f} of "
              f"it); {card}")
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1),
                                                         dtype=np.int32)).to(dev),
                 "positions": torch.zeros((8, 1), dtype=torch.int32, device=dev)}
        print_profile(profile_steps(torch, lambda: step(work, cache, batch), 2))
        del rep, out, cache

        if cfg.subquadratic:
            b, s = LONG_500K
            print(f"phase 16b ({card}): {arch} long_500k: batch {b}, a cache made for {s} "
                  f"positions filled through position {s - 2}, {2 * DECODE_STEPS} timed steps "
                  f"from {s - 1}; the same steps against a 64-position cache, in turns")
            gen = torch.Generator(device=dev).manual_seed(seed)
            timed_steps(step, work, init_cache(cfg, b, 64, device=dev), b, 0)  # warm-up
            caches, times = {}, {64: [], s: []}
            for max_len in (64, s):
                caches[max_len] = init_cache(cfg, b, max_len, device=dev)
                fill_long_cache(torch, cfg, caches[max_len], s - 2, gen)
            for turn, max_len in enumerate((64, s, s, 64)):  # in turns: host jitter is shared
                first = s - 1 + DECODE_STEPS * (turn // 2 if max_len == 64 else turn - 1)
                times[max_len].append(timed_steps(step, work, caches[max_len], b, first)[0])
            for max_len, cache in caches.items():
                c_bytes = sum(x.numel() * x.element_size() for x in tree_flatten(cache)[0])
                rings = [d for d in _cache_dicts(cache) if "pos" in d]
                for ring in rings:
                    size = ring["pos"].shape[-1]
                    require(int(ring["index"].reshape(-1)[0]) == s - 1 + 2 * DECODE_STEPS
                            and int(ring["pos"].reshape(-1, size)[0, (s - 1) % size]) == s - 1
                            and int(ring["pos"].reshape(-1, size)[0, s % size]) == s,
                            f"phase 16b: {arch}: the ring did not take positions {s - 1}, {s}")
                ms = statistics.mean(times[max_len])
                times[max_len] = (ms, c_bytes)
                print(f"  cache for {max_len} positions: {c_bytes / 1e6:.4f} MB "
                      f"({len(rings)} rings of {rings[0]['pos'].shape[-1] if rings else 0} "
                      f"slots); step {ms:.4f} ms (the mean of two turns' medians of "
                      f"{DECODE_STEPS}, CUDA events), {b * 1e3 / ms:.1f} tok/s")
            del caches
            print(f"  long_500k step / 64-position step: {times[s][0] / times[64][0]:.4f} "
                  f"(cache bytes {times[s][1] / times[64][1]:.4f}x); {card}")

        b, s = REC_PREFILL
        pre = make_prefill_step(cfg)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s),
                                                         dtype=np.int32)).to(dev)}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((b, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16,
                                          device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        w_gib = torch.cuda.memory_allocated(dev) / 2**30
        box = []
        ms = cuda_ms(torch, lambda: box.append(pre(work, batch)), 1)[0]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        require(box[-1].shape == (b, cfg.vocab) and bool(torch.isfinite(box[-1]).all()),
                f"phase 16c: {arch}: non-finite prefill logits")
        flops = rec_flops(cfg, b, s)
        scores = ""
        if cfg.family == "rglru":
            scores = (f"; the local layers' dense (b, {cfg.n_heads}, {s}, {s}) fp32 scores are "
                      f"{4 * b * cfg.n_heads * s * s / 2**30:.2f} GiB each")
        print(f"phase 16c ({card}): {arch} prefill {b} x {s}"
              + (f" (encoder over {b} x {cfg.enc_seq} zero frames)" if cfg.family == "encdec"
                 else "") + f": {ms:.2f} ms (CUDA events, after one warm-up), "
              f"{b * s * 1e3 / ms:.1f} tok/s; bound {1e3 * flops / BF16_FLOPS_PER_S:.2f} ms "
              f"({flops / 1e12:.2f} TFLOP at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16); peak "
              f"memory {peak:.2f} GiB ({peak - w_gib:.2f} above the {w_gib:.2f} GiB resident)"
              + scores)
        if cfg.family == "encdec":
            frames = batch["frames"]
            ms_enc = cuda_ms(torch, lambda: box.append(lm._encode(cfg, work, frames)), 1)[0]
            enc_flops = 2.0 * encoder_macs(cfg, b)
            print(f"  the encoder alone over {b} x {cfg.enc_seq} frames: {ms_enc:.2f} ms; bound "
                  f"{1e3 * enc_flops / BF16_FLOPS_PER_S:.2f} ms ({enc_flops / 1e12:.2f} TFLOP)")
        del box, pre, work, step, batch
        torch.cuda.empty_cache()
        print(f"  phase 16 ({arch}) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    b, p, n_dec = REC_CARD_CPU
    print(f"phase 16d ({card}): the reduced configs on the card against the CPU, weight seeds "
          f"0 .. {draws}, prefill {b} x {p} and {n_dec} decode steps; fp32 at rtol 1e-4 / atol "
          f"1e-5, bf16 held to the CPU's fp32 at {REC_NOISE_FACTOR} x the CPU bf16 control")
    readings = []
    for arch in REC_ARCHS:
        cfg = reduced_config(get_config(arch))
        worst32 = 0.0
        for draw in range(draws + 1):
            params = init_params(cfg, torch.Generator().manual_seed(draw), device="cpu")
            prompt = rng.integers(0, cfg.vocab, (b, p), dtype=np.int32)
            frames = None
            if cfg.family == "encdec":
                frames = torch.from_numpy(rng.standard_normal(
                    (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))
            for what, got, control, truth, got32 in rec_runs(torch, cfg, params, prompt, frames,
                                                             n_dec, dev):
                name = f"{cfg.name} seed {draw}, {what}"
                close = bool(torch.allclose(got32.cpu(), truth, rtol=1e-4, atol=1e-5))
                worst32 = max(worst32, float((got32.cpu() - truth).abs().max()))
                require(close, f"phase 16d: {name}: the fp32 runs disagree")
                readings.append(hold_logits(torch, name, got, control, truth, phase="16d",
                                            factor=REC_NOISE_FACTOR, quiet=True))
        print(f"  {cfg.name}: fp32 card vs CPU max |diff| {worst32:.3e} over {draws + 1} draws x "
              f"{n_dec + 1} stages (rtol 1e-4, atol 1e-5: held); bf16 readings "
              f"{min(readings[-(draws + 1) * (n_dec + 1):]):.4f} .. "
              f"{max(readings[-(draws + 1) * (n_dec + 1):]):.4f}")
    print(f"  largest reading {max(readings):.4f} of {len(readings)} (limit {REC_NOISE_FACTOR}); "
          f"16d {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    b, s = REC_TRAIN
    print(f"phase 16e ({card}): one train step per family at the reduced size, batch {b} x {s}, "
          f"against an fp32 run on the CPU, the CPU's bf16 run the control (limit "
          f"{REC_TRAIN_FACTOR}), and the card's new parameters against AdamW in float64")
    worst = 0.0
    for arch in REC_ARCHS:
        cfg = reduced_config(get_config(arch))
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s), dtype=np.int32))
        extra = {}
        if cfg.family == "encdec":
            extra["frames"] = torch.from_numpy(rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        for draw in range(draws + 1):
            tree = init_params(cfg, torch.Generator().manual_seed(draw), device="cpu")
            runs, upd = train_readings(torch, np, cfg, tree, tokens, dev, extra)
            require(upd <= 1.0, f"phase 16e: {cfg.name}: the parameter update is not AdamW's")
            parts = []
            for what, (got_, control, truth) in runs.items():
                err, ctl = reading(got_, control, truth)
                worst = max(worst, err / ctl)
                parts.append(f"{what} {err / ctl:.4f}")
                require(err <= REC_TRAIN_FACTOR * ctl,
                        f"phase 16e: {cfg.name} {what}: further from fp32 than the control allows")
            print(f"  {cfg.name} seed {draw}: " + ", ".join(parts) + f"; update {upd:.4f} of "
                  f"its limit")
    print(f"  largest reading {worst:.4f} (limit {REC_TRAIN_FACTOR}); "
          f"{time.perf_counter() - t0:.1f} s")

    b, s = REC_TRAIN_FULL
    for arch in REC_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        layers_kept = REC_TRAIN_LAYERS.get(arch)
        if layers_kept is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers_kept)
        gen = torch.Generator(device=dev).manual_seed(seed)
        spec = dataclasses.replace(SHAPES["train_4k"], global_batch=b, seq_len=s)
        batch = make_inputs(cfg, spec, gen, device=dev)["batch"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = init_params(cfg, gen, device=dev)
        opt = init_train_state(cfg, params)
        n_params = sum(x.numel() for x in tree_flatten(params)[0])
        step_fn = make_train_step(cfg)
        params, opt, m0 = step_fn(params, opt, batch)  # warm-up
        loss0 = float(m0["loss"])
        marks = []
        for _ in range(TRAIN_TIMED):
            begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            begin.record()
            params, opt, m = step_fn(params, opt, batch)
            end.record()
            marks.append((begin, end))
        torch.cuda.synchronize()
        step_ms = statistics.median(bg.elapsed_time(en) for bg, en in marks)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        require(math.isfinite(loss0) and abs(loss0 - math.log(cfg.vocab)) < 1.0
                and math.isfinite(float(m["loss"])),
                f"phase 16e: {arch}: step-0 loss {loss0} is not near ln(vocab)")
        flops = 3.0 * rec_flops(cfg, b, s, head_every=True)
        bound_ms = 1e3 * flops / BF16_FLOPS_PER_S
        cut = ("full depth" if layers_kept is None
               else f"{layers_kept} of {get_config(arch).n_layers} layers")
        print(f"phase 16e ({card}): {arch} train step at full width, {cut} "
              f"({n_params / 1e9:.3f} B parameters), batch {b} x {s}: step-0 loss {loss0:.4f} "
              f"(ln {cfg.vocab} = {math.log(cfg.vocab):.4f}); {step_ms:.2f} ms median of "
              f"{TRAIN_TIMED} (CUDA events), {b * s * 1e3 / step_ms:.1f} tokens/s; bound "
              f"{bound_ms:.2f} ms ({flops / 1e12:.2f} TFLOP at {BF16_FLOPS_PER_S / 1e12:.0f} "
              f"TFLOP/s bf16, 3x the forward with the head at every position, remat not "
              f"counted; {bound_ms / step_ms:.4f} of it); peak memory {peak:.2f} GiB; "
              f"{time.perf_counter() - t0:.1f} s")
        del params, opt, batch, step_fn, m, m0
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    print(f"phase 16e ({card}): python -m repro_torch.launch.train {' '.join(REC_TRAIN_CLI)} "
          f"--seed {seed}")
    reset_launches()
    rep = train.run(REC_TRAIN_CLI + ["--seed", str(seed)])
    got = dict(LAUNCHES)
    count(got)
    require(rep["rc"] == 0, "phase 16e: the training CLI's loss did not improve")
    for name in ("place_fused", "place_replicas"):
        require(got.get(name, 0) > 0, f"phase 16e: the training path did not launch {name}")
    print(f"  main path launches {got}; loss {rep['losses'][0]:.4f} -> {rep['losses'][-1]:.4f}; "
          f"step {rep['step_ms']:.4f} ms median ({rep['tok_s']:.1f} tokens/s); peak memory "
          f"{(rep['peak_bytes'] or 0) / 2**30:.4f} GiB; {time.perf_counter() - t0:.1f} s")
    del rep
    torch.cuda.empty_cache()
    print(f"  phase 16 {time.perf_counter() - t_phase:.1f} s")
    return launches


def sharded_steps(torch, np, dev, seed) -> tuple[dict, dict]:
    """17a: smollm-135m at full width on an NCCL world-size-1 ``(data,
    model)`` mesh against the unsharded steps on the same card -> (B1's
    launches, step ms).  AdamW at a warm-up of one step, so the update is
    ~1e5 ulp of a weight: the sharded step's new parameters are held to
    AdamW recomputed in float64 from its own parameters, ``m`` and ``v``
    (``update_reading``, as 14b), and two controls on the same moments
    (the parameters left as they were, the update doubled) must read far
    above that limit; ``m`` and ``v`` are held leaf by leaf to the
    unsharded step's, each against its own largest value."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import make_uniform_cluster
    from repro_torch.data import DataPipeline, ShardedDataset
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import hooks, init_cache, init_params
    from repro_torch.train import AdamWConfig, init_train_state, make_prefill_step
    from repro_torch.train import make_serve_step, make_train_step
    from repro_torch.train.optimizer import tree_flatten, update_reading

    b, s = SHARD_BATCH
    cfg = get_config(SHARD_ARCH)
    adamw = AdamWConfig(warmup_steps=1)
    reset_launches()
    pipe = DataPipeline(ShardedDataset(n_shards=16, tokens_per_shard=b * s * 8, vocab=cfg.vocab),
                        make_uniform_cluster(2, device=dev), 0, batch_per_host=b, seq_len=s)
    batch = {"tokens": torch.from_numpy(next(pipe.batches())).to(dev)}
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt = init_train_state(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    steps = [{"tokens": torch.randint(0, cfg.vocab, (b, 1), generator=gen, device=dev,
                                      dtype=torch.int32),
              "positions": torch.full((b, 1), t, dtype=torch.int32, device=dev)}
             for t in range(SHARD_DECODE + 1)]
    ms: dict = {}

    def run(params, opt, batch, steps, cache_of, tag: str) -> dict:
        train = make_train_step(cfg, adamw)
        prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
        new_p, new_o, metrics = train(params, opt, batch)
        logits = prefill(params, batch)
        ms[f"train_{tag}"] = statistics.median(
            cuda_ms(torch, lambda: train(params, opt, batch), SHARD_TIMED))
        ms[f"prefill_{tag}"] = statistics.median(
            cuda_ms(torch, lambda: prefill(params, batch), SHARD_TIMED))
        serve(params, cache_of(), steps[0])  # warm-up on a cache of its own
        cache, out = cache_of(), []
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            begin.record()
            for step in steps[1:]:
                step_logits, cache = serve(params, cache, step)
                out.append(step_logits)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms[f"decode_{tag}"] = begin.elapsed_time(end) / SHARD_DECODE
        return dict(params=new_p, state=new_o, metrics=metrics, prefill=logits, decode=out,
                    cache=cache)

    plain = run(params, opt, batch, steps, lambda: init_cache(cfg, b, s, device=dev), "unsharded")
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=0, world_size=1)
        try:
            mesh = make_debug_mesh(1, 1)
            with hooks.activation_sharding(sh.activation_constraint_fn(mesh)):
                placed = (sh.distribute_tree(params, sh.param_shardings(mesh, params)),
                          sh.distribute_tree(opt, sh.opt_shardings(mesh, params)),
                          sh.distribute_tree(batch, sh.batch_shardings(mesh, batch)))
                dsteps = [sh.distribute_tree(x, sh.batch_shardings(mesh, x)) for x in steps]

                def cache_of():
                    c = init_cache(cfg, b, s, device=dev)
                    return sh.distribute_tree(c, sh.cache_shardings(mesh, cfg, c))

                got = run(*placed, dsteps, cache_of, "sharded")
                got = {k: sh.full_tree(v) if not isinstance(v, list)
                       else [sh.full_tree(x) for x in v] for k, v in got.items()}
        finally:
            dist.destroy_process_group()
    launches = dict(LAUNCHES)
    loss_u, loss_s = (float(r["metrics"]["loss"]) for r in (plain, got))
    norm_u, norm_s = (float(r["metrics"]["grad_norm"]) for r in (plain, got))
    flat, rebuild = tree_flatten(params)
    upd = {"sharded": update_reading(adamw, params, got["params"], got["state"], UPDATE_ULPS),
           "unsharded": update_reading(adamw, params, plain["params"], plain["state"],
                                       UPDATE_ULPS),
           "control: unchanged": update_reading(adamw, params, params, got["state"], UPDATE_ULPS),
           "control: doubled": update_reading(adamw, params, rebuild(
               [p0 + 2 * (p1 - p0) for p0, p1 in zip(flat, tree_flatten(got["params"])[0])]),
               got["state"], UPDATE_ULPS)}
    names = tree_flatten(sh.tree_map_with_path(lambda path, _: ".".join(path), params))[0]
    moments = {}
    for key in ("m", "v"):
        moments[key] = max((float((x - y).abs().max()) / float(y.abs().max()), name)
                           for x, y, name in zip(tree_flatten(got["state"][key])[0],
                                                 tree_flatten(plain["state"][key])[0], names))
    same_prefill = torch.equal(got["prefill"], plain["prefill"])
    same_decode = all(torch.equal(x, y) for x, y in zip(got["decode"], plain["decode"]))
    same_cache = all(torch.equal(x, y) for x, y in zip(tree_flatten(got["cache"])[0],
                                                       tree_flatten(plain["cache"])[0]))
    print(f"  batch {b} x {s} from DataPipeline ownership (B1), AdamW lr {adamw.lr} from step 1; "
          f"loss sharded {loss_s:.8f}, unsharded {loss_u:.8f}, rel "
          f"{abs(loss_s - loss_u) / abs(loss_u):.3e} (limit {SHARD_LOSS_RTOL}); grad_norm "
          f"{norm_s:.6f} / {norm_u:.6f}, rel {abs(norm_s - norm_u) / norm_u:.3e} (limit "
          f"{SHARD_GNORM_RTOL})")
    print(f"  new parameters: max |step - float64 AdamW of its p, m, v| over {UPDATE_ULPS} ulp: "
          + ", ".join(f"{k} {v:.4f}" if v < 1e3 else f"{k} {v:.4e}" for k, v in upd.items())
          + " (limit 1; the controls must exceed it)")
    print("  AdamW moments, worst leaf's max |sharded - unsharded| / its max |unsharded|: "
          + ", ".join(f"{k} {r:.4f} ({name})" for k, (r, name) in moments.items())
          + f" (limits {SHARD_M_RTOL} / {SHARD_V_RTOL})")
    print(f"  prefill logits equal: {same_prefill}; {SHARD_DECODE} decode steps' logits equal: "
          f"{same_decode}, caches equal: {same_cache} (sync-debug \"error\")")
    print(f"  ms (CUDA events, median of {SHARD_TIMED}; decode per step of {SHARD_DECODE}; no "
          f"other process on the host): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    require(math.isfinite(loss_s) and abs(loss_s - loss_u) <= SHARD_LOSS_RTOL * abs(loss_u),
            "phase 17a: the sharded loss differs from the unsharded one")
    require(abs(norm_s - norm_u) <= SHARD_GNORM_RTOL * norm_u,
            "phase 17a: the sharded grad_norm differs from the unsharded one")
    require(upd["sharded"] <= 1.0 and upd["unsharded"] <= 1.0,
            "phase 17a: a step's parameter update is not AdamW's arithmetic")
    require(min(upd["control: unchanged"], upd["control: doubled"]) > 1.0,
            "phase 17a: the update check does not tell a wrong step from AdamW's")
    require(moments["m"][0] <= SHARD_M_RTOL and moments["v"][0] <= SHARD_V_RTOL,
            "phase 17a: the sharded step's AdamW moments differ")
    require(same_prefill and same_decode and same_cache,
            "phase 17a: sharded prefill / decode differ from the unsharded steps")
    require(launches.get("place_fused", 0) > 0, "phase 17a: the pipeline did not launch B1")
    return launches, ms


def phase17(torch, np, dev, seed) -> dict:
    """The sharded model path: 17a smollm-135m's train, prefill and decode
    steps at full width on an NCCL world-size-1 mesh against the unsharded
    steps (the main path, launches counted); 17b the dry run of one
    full-width cell on the fake 16x16 mesh, on this host; 17c the 2x2
    sharded-step selftest on 4 CPU gloo ranks, started after 17a's timed
    steps and run beside 17b."""
    import os
    import signal

    from repro_torch.launch import dryrun

    card = card_line(dev)
    t_phase = time.perf_counter()
    print(f"phase 17a ({card}): {SHARD_ARCH} at full width on an NCCL world-size-1 "
          f"(data, model) mesh: one train step, a prefill and {SHARD_DECODE} decode steps, "
          f"against the unsharded steps on the card")
    t0 = time.perf_counter()
    launches, _ = sharded_steps(torch, np, dev, seed)
    print(f"  main path launches {launches}; {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.shardings", "--selftest"],
                            cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        arch, shape = DRY_CELL
        total = torch.cuda.get_device_properties(dev).total_memory
        print(f"phase 17b (host reckoning for {card}): python -m repro_torch.launch.dryrun "
              f"--arch {arch} --shape {shape} on a fake 16x16 group")
        t0 = time.perf_counter()
        r = dryrun.run_cell(arch, shape, verbose=False, serve_tp_only=True)  # the CLI's default
        require(r["status"] == "ok", f"phase 17b: the dry run of {arch} x {shape} failed")
        gb = {k: r[f"{k}_bytes_per_device"] / 1e9 for k in ("argument", "output", "temp", "peak")}
        print(f"  per device: argument {gb['argument']:.3f} GB, output {gb['output']:.3f} GB, "
              f"temp {gb['temp']:.3f} GB, peak {gb['peak']:.3f} GB of the card's "
              f"{total / 1e9:.3f} GB ({'fits' if r['peak_bytes_per_device'] <= total else 'does not fit'})")
        print(f"  {r['flops'] / 1e12:.3f} TFLOP, {r['hlo_bytes'] / 1e9:.3f} GB of op traffic, "
              f"collectives {r['collective_bytes_per_device'] / 1e9:.3f} GB: "
              + ", ".join(f"{k} {v / 1e9:.3f} GB x {r['collectives']['counts'][k]}"
                          for k, v in sorted(r["collective_by_kind"].items()))
              + f"; traced in {r['trace_s']} s, {time.perf_counter() - t0:.1f} s")
        arch, shape = DRY_MULTI_POD
        print(f"phase 17b: python -m repro_torch.launch.dryrun --arch {arch} --shape {shape} "
              f"--reduced --multi-pod (fake 2x16x16 group)")
        t0 = time.perf_counter()
        r = dryrun.run_cell(arch, shape, multi_pod=True, reduced=True, verbose=False)
        require(r["status"] == "ok" and r["n_devices"] == 512 and r["mesh"] == "2x16x16",
                f"phase 17b: the multi-pod dry run of {arch} x {shape} failed")
        print(f"  per device: peak {r['peak_bytes_per_device'] / 1e9:.3f} GB, "
              f"{r['flops'] / 1e12:.3f} TFLOP, collectives "
              f"{r['collective_bytes_per_device'] / 1e9:.3f} GB; traced in {r['trace_s']} s, "
              f"{time.perf_counter() - t0:.1f} s")

        print("phase 17c: python -m repro_torch.launch.shardings --selftest (4 CPU gloo ranks, "
              "2x2 mesh, this host's torch)")
        out, err = proc.communicate(timeout=SELFTEST_TIMEOUT)
    finally:
        if proc.poll() is None:  # stop the ranks too
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    for line in out.splitlines():
        print(f"  {line}")
    require(proc.returncode == 0, f"phase 17c: the 2x2 selftest failed:\n{err[-3000:]}")
    require("sharded model selftest OK on 4 ranks" in out, "phase 17c: the selftest did not report")
    print(f"  phase 17 {time.perf_counter() - t_phase:.1f} s")
    return launches


def compare(seed: int, dev, trees: list[Path], only: list[str] | None = None) -> dict:
    """Every kernel of this checkout against the same kernel of each
    checkout in ``trees`` (built from its own sources), on the same inputs
    at the bulk sizes: outputs equal, then CUDA-event times taken in turns
    (theirs, ours, ours, theirs; TIMED_CALLS calls each), and the builds'
    ptxas numbers.  ``only``: just the cases whose label starts with one
    of these strings (and just the libraries they need)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from repro_torch.core import PlacementEngine, make_cluster
    from repro_torch.core import HierarchicalCluster
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import addition_numbers_top
    import repro_torch

    theirs = [load_tree(t, f"against{k}_repro_torch") for k, t in enumerate(trees)]
    rng = np.random.default_rng(seed)
    caps, huge = rng.uniform(0.5, 2.0, LADDER_NODES), rng.uniform(0.5, 2.0, HUGE_NODES)
    bulk = torch.from_numpy(rng.integers(0, 2**32, BULK_IDS, dtype=np.uint32)).to(dev)

    def event(change):
        """(A, B) device artifacts of the 4096-node cluster before and
        after ``change(cluster)``."""
        cluster = make_cluster(caps)
        engine = PlacementEngine(cluster, device=dev)
        engine.artifact()
        v0 = cluster.version
        change(cluster)
        return engine._device_artifact_for(v0), engine._device_artifact_for(cluster.version)

    events = {
        "add": event(lambda c: c.add_node(LADDER_NODES, 1.0)),
        "remove": event(lambda c: c.remove_node(LADDER_NODES // 2)),
        "top change": event(lambda c: scale_out(np, c)),
    }
    a, _ = events["add"]
    flat = (a.len32_dev, a.cum_hi_dev, a.cum_lo_dev, a.node_of_dev)
    base = {alg: PlacementEngine(make_cluster(caps), device=dev, algorithm=alg)
            ._device_artifact() for alg in BASELINES}
    topo = hier_topologies(np, caps, seed, huge)
    hier = {}
    for name in ("64x64", f"{HUGE_NODES} nodes", "ragged", "12x8"):
        h = HierarchicalCluster(device=dev)
        for d, members in topo[name].items():
            for node, cap in members.items():
                h.add_node(d, node, cap)
        art = h.engine.hier_artifact()
        hier[name] = (art.tables_dev, dict(top_level=art.top_level, max_top=art.max_top,
                                           s_pad=art.s_pad))
    wrh_ids = bulk[:WRH_IDS]
    reps = (bulk, a.len32_dev, a.node_of_dev)
    an_top = addition_numbers_top(a.top_level)
    an_small = (bulk[:AN_CHUNK], a.len32_dev, a.node_of_dev)
    cases = [
        ("place_fused", "asura_place", "place_fused_cuda", (bulk, *flat),
         dict(top_level=a.top_level, emit_nodes=True)),
        ("place_replicas R=3", "asura_place", "place_replicas_cuda", reps,
         dict(top_level=a.top_level, n_replicas=3, emit_nodes=True)),
        # the serving step's form (serve/stream.py, instrumented)
        ("place_replicas R=3 stats", "asura_place", "place_replicas_cuda", reps,
         dict(top_level=a.top_level, n_replicas=3, emit_nodes=True, emit_stats=True)),
        ("place_replicas R=1", "asura_place", "place_replicas_cuda", reps,
         dict(top_level=a.top_level, n_replicas=1, emit_nodes=True)),
        ("place", "asura_place", "place_cuda", (bulk, a.len32_dev),
         dict(top_level=a.top_level)),
        # the trace on its extended ladder, as phase 8c runs it: the bulk
        # size and the main path's chunk of 2**20 ids
        (f"{AN} R=3", "asura_place", "addition_numbers_cuda", reps,
         dict(top_level=an_top, n_replicas=3)),
        (f"{AN} R=3 (2**20 ids)", "asura_place", "addition_numbers_cuda", an_small,
         dict(top_level=an_top, n_replicas=3)),
        (f"{AN} R=1 (2**20 ids)", "asura_place", "addition_numbers_cuda", an_small,
         dict(top_level=an_top, n_replicas=1)),
        ("ch_place", "baselines", "ch_place_cuda", (bulk, base["ch"].keys_dev,
                                                    base["ch"].vals_dev), {}),
        ("rs_place", "baselines", "rs_place_cuda", (bulk, base["rs"].keys_dev,
                                                    base["rs"].vals_dev), {}),
        ("wrh_place (2**20 ids)", "baselines", "wrh_place_cuda",
         (wrh_ids, base["wrh"].keys_dev, base["wrh"].vals_dev), {}),
    ]
    for ev, (ea, eb) in events.items():
        dkw = dict(top_a=ea.top_level, top_b=eb.top_level)
        cases.append((f"diff_nodes ({ev})", "asura_place", "diff_nodes_cuda",
                      (bulk, ea.len32_dev, ea.cum_hi_dev, ea.cum_lo_dev, ea.node_of_dev,
                       eb.len32_dev, eb.cum_hi_dev, eb.cum_lo_dev, eb.node_of_dev), dkw))
        cases.append((f"diff_replicas R=3 ({ev})", "asura_place", "diff_replicas_cuda",
                      (bulk, ea.len32_dev, ea.node_of_dev, eb.len32_dev, eb.node_of_dev),
                      dict(dkw, n_replicas=3)))
    for alg in BASELINES:
        cases.append((f"{FANOUT} {alg} R=3" + (" (2**20 ids)" if alg == "wrh" else ""),
                      "baselines", "baseline_replicas_cuda",
                      (alg, wrh_ids if alg == "wrh" else bulk, base[alg].keys_dev,
                       base[alg].vals_dev), dict(n_replicas=3)))
    for name, (tabs, kw) in hier.items():
        for R in ((3, 1) if name == "64x64" else (3,)):
            cases.append((f"hier_replicas {name} R={R}", "hierarchy",
                          "hier_place_replicas_cuda", (bulk, *tabs), dict(kw, n_replicas=R)))
    if only:
        cases = [c for c in cases if c[0].startswith(tuple(only))]
        require(cases, f"no case matches {only}")
    libs = tuple(sorted({c[1] for c in cases}))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(trees) + 1) as pool:
        built = list(pool.map(lambda b: b.build_all(libs),
                              [build] + [t.kernels.build for t in theirs]))
    print(f"compare: built {libs} of this checkout and of {len(trees)} others in "
          f"{time.perf_counter() - t0:.2f} s")
    print_ptxas(build.ptxas_report)
    for tree, their_built in zip(trees, built[1:]):
        print_ptxas(lambda lib: build.parse_ptxas(their_built[lib]["log"])
                    if lib in their_built else {}, f"ptxas ({tree.name})")

    rows = []
    for label, mod, fn, args, kw in cases:
        f_ours = getattr(getattr(repro_torch.kernels, mod), fn)
        got = f_ours(*args, **kw)
        for tree, their in zip(trees, theirs):
            f_theirs = getattr(getattr(their.kernels, mod), fn)
            want = f_theirs(*args, **kw)
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            bad = sum(mismatches(torch, g, w)[0] for g, w in pairs)
            require(bad == 0, f"{label}: {bad} outputs differ from {tree}'s")
            t_theirs, t_ours = [], []
            for f, acc in ((f_theirs, t_theirs), (f_ours, t_ours), (f_ours, t_ours),
                           (f_theirs, t_theirs)):
                acc += cuda_ms(torch, lambda: f(*args, **kw), TIMED_CALLS)
            row = {"kernel": label, "against": tree.name,
                   "against_ms": statistics.median(t_theirs), "ms": statistics.median(t_ours)}
            row["ratio"] = row["ms"] / row["against_ms"]
            rows.append(row)
            print(f"  {label:36s} against {tree.name:12s} {row['against_ms']:9.4f} ms, this "
                  f"{row['ms']:9.4f} ms, ratio {row['ratio']:.4f}, outputs equal")
    return {"against": [str(t) for t in trees], "kernels": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace serving steps with torch.profiler")
    ap.add_argument("--against", type=Path, nargs="+", default=None,
                    help="instead of the phases, time every kernel against the same "
                         "kernel of the checkout in each of these directories")
    ap.add_argument("--only", action="append", default=None,
                    help="with --against: only the kernels whose label starts with this "
                         "(repeatable)")
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)  # progress survives a kill
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (HERE / "src" / "repro_torch").is_dir():
        print("chip_smoke: the repro_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = card_line(dev)
    print(f"card: {smi}")
    if args.against is not None:
        result = compare(args.seed, dev, [t.resolve() for t in args.against], args.only)
    else:
        result = run(args.seed, dev, args.profile)
    print(json.dumps(result))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
