#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the four CUDA kernels from src/repro_torch/kernels/csrc, in
     parallel; ptxas' registers and spills of every kernel, the bf16
     segment sum's (csrc/segment_sum_bf16.cuh) in each of its three
     libraries without a spill or a stack frame;
  3. every kernel against its plain PyTorch version at small ragged,
     weighted, batched and wide shapes (the fused-bounds kernel on bounds
     of real drift-updated carries, with group sizes that do and do not
     divide 64, the default 512 at K = 1000 among them, and on
     cluster-ordered cases where most cells skip); the update at
     K = 20,000 (cluster ranges); the assignment on exact integer ties
     (the lowest index wins) and on a NaN row; two cases at the paper's
     Table 3 shapes (K = 10 on d = 2, K = 100 on d = 3);
  4. repeated launches of every case are bitwise equal;
  5. the main path at full size: AAKMeans(n_clusters=1000,
     backend="fused").fit(x).predict(x) on the USCensus1990 shape
     (2,458,285 x 69 f32); launch counts prove it ran on the kernels;
     both kernels against their plain versions on the final centroids,
     the assignment on a full and on the padded tail predict chunk;
     predict's labels equal to the fused step's, and the assignment
     kernel's labels and distances at all rows equal to the fused step's
     bit for bit;
  5a. the "pallas" path at full size: fit + predict from the same seed,
     one assignment and one update launch per step, ending at the fused
     fit's energy; both kernels against their plain versions at the
     fit's shapes;
  5b. the "fused_bounds" path at full size: the default groups (G = 2),
     then the cluster-ordered layout with 64-centroid groups, its skipped
     shares per trip; the kernel against its plain version on each run's
     last bounds;
  5c. the locality engine at full size on the unordered rows:
     AAKMeans(backend=get_backend("fused_bounds_reorder", group_size=64))
     from phase 5's seeds, then predict; one bounded and one update
     launch per step, predict's assignment chunks, no other kernel and no
     plain version; the sorts happened; skipped shares per trip; beside
     it the raw fused_bounds fit with the same groups from the same seeds;
     the last step's labels and min_sqdist, gathered back to original
     order, equal bit for bit to the raw kernel's step on the original
     rows with the carry permuted back; the bounded kernel on the sorted
     rows and the update on the fit's labels against their plain
     versions;
  6. the dense oracle's fit from the same seeds at full size ends at the
     fused fit's energy;
  7. fused against dense trajectories at a mid size, every fused step
     redone by the dense oracle, every fused-bounds step by the fused
     kernel; fused_bounds_reorder sorting on any change against never
     sorting, bit for bit on every result leaf, each wrapped step's
     labels and min_sqdist equal bit for bit to the raw kernel's on the
     original rows and the final energies within 1e-4 of the raw
     fused_bounds solve's, at R = 1 (aa_kmeans) and R = 2; at the R = 2
     run's last carry the bounded kernel on the sorted (2, N, d) rows and
     the update on each restart's labels against their plain versions;
  8. kernel times (CUDA events) at the main path's shapes: the fused step,
     the pallas pair (the assignment at all rows and the update) and the
     bounded step at the default groups and at 64-centroid groups with
     nothing skipped and on the cluster-ordered run's last step, in turns
     (each time the mean of two turns in opposite orders), the fused
     step's time over the pair's; the bf16 update on the rows sorted by
     the pallas fit's labels (bit for bit its f32 launch on the upcast
     X) beside the unsorted rows and index_add_ of the upcast X, in the
     same turns; the assignment at predict's chunk;
     beside their bound, plain and library times; the dense oracle's
     one-hot stats against index_add_, and its step.  A distance kernel's bound is the lower of its FP32-core bound
     and its split-TF32 bound (three TF32 products per f32 product on the
     tensor cores); both are printed.  The locality engine's costs
     per step at phase 5c's last carry, in turns: the sort and carry
     re-gather, the X gather, the update, the bounded step on the sorted
     rows and the whole wrapped step, beside the raw bounded step on the
     original rows at the same carry;
  9. the single-problem path at full size: aa_kmeans(backend="fused")
     from phase 5's seeds equals phase 5's fit bit for bit (it is the
     batched driver at R = 1); aa_kmeans_traced on an instrumented engine
     takes its iterations, with one pass for the init, one per accepted
     iteration, two per rejected one and one that detects convergence;
  10. the paper's Tables 2 and 3 at full size on the same data: Table 3's
     five cases (kmeans++, afk-mc2, bf, clarans at K = 10, clarans at
     K = 100, seeded on the card and timed apart), each as lloyd_kmeans
     against aa_kmeans on "dense" and as the same-engine pair on "fused";
     lloyd_iteration on pallas_lloyd_ops (the assignment and update
     kernels) against the dense ops; the traced fused_bounds engine at
     K = 100; Table 2's fixed and dynamic m at m0 = 2 and 5.  Energies
     finite, seeds (K, d) on the card, a converged Lloyd run's labels its
     centroids' assignment, each algorithm's fused and dense runs within
     1e-3; who wins is printed, not checked.  Then the fused step, the
     assignment and the update against their plain versions at each
     case's last AA centroids, and the bounded step with 16-centroid
     groups at K = 100, as phases 3 and 5 hold them.  Last, the CPU
     bound engines (hamerly, elkan, yinyang: masked dense PyTorch) at
     K = 100, max_iter 100, from the clarans seeds: each wrapped in the
     locality engine equal to its raw solve on every leaf, energies
     within 1e-3 of dense's, and hamerly_kmeans's labels equal to
     lloyd_kmeans's;
  11. streaming mini-batch Algorithm 1 at full size on the same data:
     MiniBatchAAKMeans(n_clusters=1000, chunk_size=65536, epochs=5,
     val_size=16384, backend="fused").fit(x): 38 chunks (the last
     padded at weight 0), fused launches 2 x n_steps_ + 1, predict's
     assignment chunks, no plain version; the fit repeated bit-equal;
     labels_ equal to the assignment kernel's at all rows; the driver
     aa_kmeans_minibatch on the fit's own inputs under
     torch.cuda.set_sync_debug_mode("error") (no sync in its loop),
     bit-equal to the fit; the fused kernel on the padded tail chunk
     against its plain version and against the truncated chunk; then
     aa_kmeans_minibatch_streamed from the host training rows, 2 epochs,
     at prefetch 2, 1, 1 and 2 in turns: equal bit for bit, every chunk metered, peak
     device memory under a quarter of X, per-chunk gather, staging, copy
     and step times; the fused kernel at R = 2 on the validation rows at
     the final (c, c_au) against its plain version;
  12. persistence at full size: phase 5's fitted model saved to an
     artifact in a temporary directory and loaded with device=None,
     through AAKMeans.load and through checkpoint.load_estimator, each
     predicting all rows with labels equal to phase 5's predict and
     centroids_, labels_, energy_, n_iter_ and n_accepted_ equal; then
     phase 11's MiniBatchAAKMeans configuration fed 24 host chunks of
     65,536 rows by partial_fit, saved after chunk 10 and loaded into a
     fresh estimator, both fed the remaining chunks and finalized:
     centroids_, energy_, n_steps_ and n_accepted_ equal bit for bit;
     assignment and fused launches, no plain version; save and load wall
     times, artifact bytes and the peak device memory of each load.
  13. segmented and resumed solves at full size: (a) aa_kmeans(backend=
     "fused") from phase 5's seeds with checkpoint_every=100, a
     checkpoint_dir (keep_last_n=2) and a TeeMetrics(CollectMetrics(),
     JsonlMetrics) sink, preempted by its checkpoint_cb at t = 300; the
     run directory's resume point is it_00000300.npz with two snapshots
     listed, and the run resumed from it equals phase 9 bit for bit; the
     whole segmented run too, timed beside phase 9; each boundary's
     snapshot copy, the writer's write latency and the artifacts' bytes;
     (b) aa_kmeans_batched at R = 2 (phase 5's seeds and a kmeans++ draw
     at seed 1), max_iter 60, cut every 25 trips: segmented and resumed
     from the first snapshot equal to the plain run; (c)
     fused_bounds_reorder (64-centroid groups) on the unordered rows,
     max_iter 120, snapshots every 40 iterations through checkpoint_cb:
     resumed from the first one holding a sort and a permutation that is
     not the identity, from the tree and from its artifact, equal to the
     plain run, and that artifact refused by raw fused_bounds; (d) phase
     11's streaming configuration through aa_kmeans_minibatch, cut at
     every epoch and resumed from epoch 2, equal to the plain run.  Each
     case runs on its kernels alone, with no plain version.
  14. serving at full size on phase 5's fitted model: (a)
     build_serving_index() with the defaults (G = 124, C = 512), timed;
     predict(approx=True) on all rows beside the exact predict (rows/s of
     both, the approximate one's peak device memory, recall); every row
     whose label differs has its exact label outside its router's
     closure, or ties it; (b) shrink(C) for C = 16 ... 512 on a seeded
     65,536-row sample: recall monotone in C, ServingModel.labels'
     median latency per 256-row batch (host clock ending in the
     result's copy) beside the exact path's; (c) bucketed closure_assign
     and closure_sqdist equal to plain ones bit for bit at 256 and 16,384
     rows, and a 256-row batch's distances equal to the same rows' in
     the chunk; (d) KMeansServer(batch_size=256) with a CollectMetrics
     sink under 4 producers of 2,000 seeded requests of 1-512 rows, one
     in ten a transform: every answer checked against
     predict(approx=True) (near ties allowed), serve_latency_s p50/p99,
     mean batch_rows, requests/s and rows/s; then approx=False: labels
     equal to argmin(pairwise_sqdist) at the server's block shape, and
     to phase 5's labels but for near ties; (e) a server polling an
     artifact of phase 5's model (with its index) every 0.05 s, the
     file overwritten under traffic with phase 11's MiniBatchAAKMeans
     and its index: no request fails, each is one model's answer, the
     new model answers after the swap, reload_s.  The exact predict's
     assignment launches are the only kernel launches; no plain version.
  15. the two-level solve at full size: (a) AAKMeans(n_clusters=65536,
     backend="fused", hierarchical=True, max_iter=500, seed=0).fit(x)
     (G = 256 groups of 256, the defaults), with its seeding, super-solve,
     partition (N_max, padding share, bytes) and sub-problem seeding
     replayed apart and timed; per round: fused launches, energy,
     moved_frac, round_s; fused, assignment and update launches, no
     plain version, the energy finite, no higher than round 0's and the
     best round's, every label in its super-group's block; the fused
     step at the sub-solve's (256, N_max, 69) weighted shape, the
     assignment of all rows to the routers and the routers' segment sum
     against their plain versions; (b) exact predict at K = 65,536 (its
     energy no higher than the fit's), the assignment kernel against its
     plain version on one 16,384-row chunk at that K,
     build_serving_index() taking the hierarchy's own routing with no
     kernel launch, predict(approx=True) with its recall and peak memory;
     (c) K = 1000 two-level beside phase 5's flat fit; (d) G = 1 from
     phase 5's seeds equal to select_best(aa_kmeans_batched) on every
     leaf (max_iter 60, cut); (e) (a)'s configuration at max_iter 60
     (cut) with a checkpoint_dir, resumed from round 0's snapshot equal
     bit for bit, the sub-energies summing to the energy within 1e-6,
     snapshot bytes and write times; (f) the smallest super-group solved
     padded beside the largest (G = 2) and alone from the same seeds:
     one fused step's labels equal and its stats within 1e-6; a plain
     Lloyd solve and an AA solve (max_iter 100, cut) each with equal
     labels and iterations and energies within 1e-6, the Lloyd
     centroids within 1e-6 of their scale (the AA ones printed, with a
     1e-3 sanity bound: Anderson extrapolation spreads the sums' last
     bits); (g)
     compress_kv_cache, kv_codebooks_batched (fused) and
     kv_codebook_hierarchical (fused, k = 4096) on a (1, 4096, 8, 128)
     K/V cache and embedding_codebook on a (128256, 4096) table
     (Meta-Llama-3-8B's widths, random values).
  16. distribution over torch.distributed at full size on the same data,
     each rank group in spawned children that load X from one .npy: (a)
     AAKMeans(n_clusters=1000, backend="fused", mesh=<one rank over
     NCCL>).fit(x) and predict equal to phase 5's bit for bit, its wall
     beside phase 5's; (b) the same fit at two ranks sharing the card over
     Gloo (card tensors staged through pinned host memory; N padded by a
     row of weight 0): the first step's sums, counts and energy within
     1e-6 of one rank's, the energy within 1e-4 of phase 5's, both ranks'
     results and a repeat (its collectives timed, a sync on each side)
     equal bit for bit, predict under the mesh equal to the single-device
     predict of its centroids, trips, launches per rank, the reduction's
     time per trip; (c) make_distributed_kmeans_batched at R = 2 (phase
     5's seeds and a kmeans++ draw at seed 1), max_iter 60 (cut): one step
     collective per trip, each restart within 1e-4 of one rank's, bit for
     bit on repeat; (d) phase 11's MiniBatchAAKMeans configuration at two
     ranks (each holding half of every chunk): one collective per chunk
     step and one per guard, energy within 1e-4 of phase 11's, bit for bit
     on repeat; aa_kmeans_minibatch_streamed(mesh=) for 2 epochs from host
     memory at two ranks and one, the ingest per rank; (e)
     make_distributed_kmeans with checkpoint_every=100 at two ranks on the
     first N - 1 rows (only rank 0 writes; each snapshot's gather and
     write times, its bytes), resumed from t = 100 at two ranks bit for
     bit and at one rank over NCCL within 1e-4; (f) two steps of pallas
     and of fused_bounds (64-centroid groups, G = 16; phase 5's
     centroids, then one Lloyd step on, the carry running on) at two
     ranks against one: labels equal, sums and energy
     within 1e-6, counts equal, the skipped share equal on both ranks and
     within 1e-6 of one rank's.  The card's compute mode is printed first;
     an exclusive mode fails the phase.
  17. the bf16 compute path at full size on the same data: (a) the
     fused step and the assignment on bf16 X and C (phase 5's
     centroids) launch the tensor-core sweep (csrc/sweep_tc.cuh; its
     counters move, its kernels' SASS holds HGMMA): against the plain
     version labels equal but at near ties, min distances within 1e-5
     of |x|^2 + max |c|^2, the stats of the kernel's labels within the
     f32 gates and the energy within 1e-6 relative; the assignment at
     all rows equal to the fused step bit for bit, a relaunch equal; its
     cross terms against an f64 product at d = 69; the update and the
     bounded step (at the init carry with G = 2 and on one bf16-policy
     step's bounds with 64-centroid groups) on bf16 operands against
     their plain versions with the f32 gates and bit for bit against
     their own f32 launch on the upcast operands, as the assignment of
     bf16 X against f32 centroids is; one bf16 fused step's peak device
     memory above its inputs under a quarter of X's f32 bytes (no f32
     copy of X); (b) AAKMeans(backend=get_backend("fused",
     precision=Precision(compute=torch.bfloat16))) from phase 5's seeds,
     max_iter 500: every fused launch on the tensor cores, the f32
     energy of its centroids within 2 % of phase 5's, the per-step
     cast's time; pallas at the policy one step from its centroids,
     labels equal to the bf16 fused step's (one sweep), fused_bounds
     equal but at near ties; predict equal to an f32 assignment of its
     centroids; save and load keep the policy and the labels; (c) the
     bf16-X fit (bf16 centroids) on the tensor cores, finite, its repeat
     bit-equal, and its predict of the bf16 rows (one tensor-core launch
     a chunk) equal to the bf16 fused step's labels; (d) phase 11's
     MiniBatchAAKMeans configuration on the bf16-policy engine, its
     repeat bit-equal; every bf16 variant and the tensor-core sweep were
     launched on these paths.
  18. wide rows at Meta-Llama-3-8B's embedding table's shape (128,256 x
     4096 f32, 2.10 GB), a 256-component Gaussian mixture drawn on the
     card from seed 0 (data/synthetic.py's _gaussian_mixture recipe):
     (a) the assignment, fused and bounded kernels at d = 822, 1023, 1024
     and 4096 against their plain versions (K = 256 and 1000, shared X
     at R = 3, per-problem X with (R, N) weights; the bounded step from
     drifted bounds at gs 8 and 64), f32 and bf16, relaunches bit-equal:
     every f32 launch and bf16 bounded one streams X through the FP32
     sweep in feature slabs (each bf16 bounded launch bit-equal to the
     f32 launch on the upcast operands), every bf16 assignment and fused
     launch takes the tensor cores; the tensor-core sweep's cross terms
     against an f64 product at d = 821 and 4096; each FP32 kernel forced
     to stream at d = 69 and at the resident path's widest d, bit-equal
     to its resident launch, and a forced stream of bf16 X and C refused;
     the update at (128,256, 4096, 256); (b) AAKMeans(n_clusters=256,
     backend="fused").fit(table), max_iter 500, and predict on every row
     (fit wall, seeding apart, ms a step, peak device memory): every
     launch streamed, predict's labels the fused step's, the first step
     against the dense engine's, the final energy within 1e-4 of the
     dense fit's from the same seeds; (c) the four 1024-wide subspaces as
     one batched fused solve against dense; two steps each of pallas,
     fused_bounds (gs 16) and fused_bounds_reorder against dense; one
     MiniBatchAAKMeans epoch of 65,536-row chunks; a bf16-policy fused
     fit on the tensor cores, its centroids' f32 energy within 2 % of
     (b)'s; (d) each kernel and bf16 variant at (128,256, 4096, 256) and
     on the subspaces in turns, the assignment on a predict chunk, addmm
     + argmin (f32 on the upcast operands for bf16), torch.mm with f32
     output on the bf16 operands with the epilogue and argmin, and
     index_add_ in the same turns, the assignment and the fused step at
     K = 1000 (f32 and bf16), the update on the label-sorted rows (bf16
     bit for bit its f32 launch on the upcast X) and the bf16 update on
     the labels the bf16 fused and bounded steps give there, whose share
     of those steps it prints, the streamed sweep forced at d = 69 and 821
     beside the resident one, beside plain versions and the bounds, and
     the streamed sweep's ptxas registers and spills.  Min distances are
     held within 1e-5 of max(|x|^2, 1) on f32 rows and of |x|^2 + max
     |c|^2 on bf16 ones; a bf16 energy within 1e-5 of sum(w max(|x|^2,
     1)).
Phases 9 to 18 run between phases 7 and 8, so that phase 8's kernel
line counts their launches (phase 16's are the ranks'); phase 8 also
times each kernel's bf16 variant in turns beside it, and the kernel line
lists the four bf16 variants as entries of their own ("<kernel>_bf16":
the launches on a bf16 X, bounds at 2-byte X and bf16 tensor-core
rates beside the epilogue's instructions on the CUDA cores, the library
call on the bf16 operands where torch has one and f32 on the upcast
operands beside it; the fused and assignment ones carry their
tensor-core launches, cross-term errors and HGMMA counts).  Each entry
also carries phase 18's "wide_launches" (its launches on phase 18's main paths, every
one streamed), "wide_ms" (at 128,256 x 4096, K = 256) and "wide" (the
rest of that row).
Every path is driven with the launch counts set to 0 just before it and
read just after; the {"kernels": ...} line sums them over the paths.
Prints one {"kernels": [...]} line, the card's name and power limit, and
last {"ok": true, "device": {...}}.  Exits non-zero without that line
when there is no CUDA device or the port is not beside this script.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12        # H100 SXM FP32, CUDA cores
PEAK_TF32_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
PEAK_BF16_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
MAIN_N_NAME = "USCensus1990"   # 2,458,285 x 69 (the paper's Table 1)
MAIN_K = 1000

# (label, n, k, d, r, x per problem, weights: None | "n" | "rn")
CASES = [
    ("ragged", 1000, 37, 69, None, False, None),
    ("(N,) weights", 4097, 1000, 9, None, False, "n"),
    ("R=3 shared X", 3001, 130, 20, 3, False, None),
    ("R=3 per-problem X, (R,N) weights", 2001, 45, 33, 3, True, "rn"),
    ("wide d=385", 2000, 50, 385, None, False, None),
    ("wide d=561", 1500, 40, 561, 2, False, "rn"),
    ("K=1000, default groups", 3000, 1000, 69, None, False, "n"),
    ("R=2, K=700", 2500, 700, 40, 2, False, "rn"),
    ("Table 3: K=10, d=2", 5000, 10, 2, None, False, None),
    ("Table 3: K=100, d=3", 5000, 100, 3, None, False, "n"),
]
# group size of the fused-bounds kernel per case, none clipped by K (None:
# the engine's default, 512 at K = 1000, so G = 2); 24, 40 and 200 divide
# neither 64 (the row tile) nor K, groups of 200 straddle the 256-centroid
# chunk at K = 700, and 512 spans two chunks; at Table 3's shapes 8 gives
# G = 2 at K = 10 and 24 G = 5 at K = 100
CASE_GROUPS = (8, 24, 64, 40, 16, 24, None, 200, 8, 24)
# cluster-ordered cases: (K, rows per cluster, group size, the least
# skipped share); the owner's group never skips, so G = 2 skips < 1/2
ORDERED_CASES = ((64, 256, 8, 0.5), (1000, 80, 200, 0.5),
                 (1000, 80, None, 0.25))
ORDERED_GS = 64   # groups of the cluster-ordered runs (G = 16 at K = 1000)
# the paper's Table 3 cases (seeding, K) and phase 10's iteration cap
TABLE3_CASES = (("kmeans++", 10), ("afk-mc2", 10), ("bf", 10),
                ("clarans", 10), ("clarans", 100))
PHASE10_MAX_ITER = 1000
# phase 11: MiniBatchAAKMeans(chunk_size, epochs, val_size) at full size
STREAM_CHUNK, STREAM_EPOCHS, STREAM_VAL = 65536, 5, 16384
# phase 12: host chunks fed to partial_fit, and the chunk after which the
# stream is saved
RESUME_CHUNKS, RESUME_AT = 24, 10
# phase 13: (a) aa_kmeans cut every SEG_EVERY iterations and preempted at
# SEG_KILL_AT; (b) the batched driver (R = 2) at a smaller depth, cut
# every SEG_B_EVERY trips; (c) fused_bounds_reorder at a smaller depth,
# cut every SEG_C_EVERY iterations
SEG_EVERY, SEG_KILL_AT = 100, 300
SEG_B_MAX_ITER, SEG_B_EVERY = 60, 25
SEG_C_MAX_ITER, SEG_C_EVERY = 120, 40
# phase 14: the server's batch, the candidate-count sweep's sample and
# counts, the latency batches per count, and the server's requests
SERVE_BATCH, SERVE_SAMPLE = 256, 65536
SERVE_SWEEP = (16, 32, 64, 128, 256, 512)
SERVE_LAT_ITERS = 50
SERVE_REQUESTS, SERVE_EXACT_REQUESTS = 2000, 200
# phase 15: the two-level fit's K (G = 256 groups of 256), the cut depth
# of its G = 1 and resume checks, and of its padding check; the
# applications at Meta-Llama-3-8B's published widths (num_key_value_heads
# 8, head dim 128, hidden 4096, vocab 128,256): one layer's K/V cache
# (batch, T, KV heads, head dim), the codebook sizes
HIER_K = 65536
HIER_CUT_ITER, HIER_PAD_ITER = 60, 100
LLAMA_KV = (1, 4096, 8, 128)
LLAMA_VOCAB, LLAMA_HIDDEN = 128256, 4096
LLAMA_CODES, LLAMA_HIER_K = 256, 4096
# phase 16: the batched restarts' iteration cap (cut), the snapshot
# interval of the resume, the streamed epochs, and each rank group's wall
# limit (s)
DIST_BATCH_MAX_ITER, DIST_EVERY, DIST_STREAM_EPOCHS = 60, 100, 2
DIST_TIMEOUT = 600
# phase 18: wide rows at the Llama table's shape (LLAMA_VOCAB x
# LLAMA_HIDDEN): the mixture's components, the fit's K, the kernel checks'
# widths (822 is one past the resident X tile's widest on an H100, 1023
# leaves f32 rows unaligned), the subspaces of the batched solve
WIDE_COMPONENTS, WIDE_K = 256, 256
WIDE_DS = (822, 1023, 1024, 4096)
WIDE_SUBSPACES = 4


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(torch, got, want, x, c, w):
    """Kernel outputs against the plain version's on the same inputs.
    Labels may differ only where the two distances tie to within the
    reported gap; stats are compared for the assignment the kernel made."""
    from repro_torch.kernels import ref
    lab, mind = got[0], got[1]
    lab_p, mind_p = want[0], want[1]
    xs = x if x.dim() == 3 else x.expand(c.shape[0], *x.shape)
    agree, gap = ref.tie_gap(lab, lab_p, x, c)
    scale = mind_p.abs().clamp_min(1.0)
    mind_err = float(((mind - mind_p).abs() / scale).max())
    out = {"agree": agree, "gap": gap,
           "mind_rel": mind_err,
           "mind_abs": float((mind - mind_p).abs().max())}
    if len(got) == 5:
        sums_e, cnt_e = [], []
        for i in range(c.shape[0]):
            wi = None if w is None else (w[i] if w.dim() == 2 else w)
            s, n = ref.update_ref(xs[i], lab[i], c.shape[1], wi)
            sums_e.append(float((got[2][i] - s).abs().max()
                                / s.abs().max().clamp_min(1.0)))
            cnt_e.append(float((got[3][i] - n).abs().max()
                               / n.abs().max().clamp_min(1.0)))
        out["sums_rel"] = max(sums_e)
        out["counts_rel"] = max(cnt_e)
        out["energy_rel"] = float(((got[4] - want[4]).abs()
                                   / want[4].abs().clamp_min(1e-30)).max())
    return out


def accept(res, what):
    check(res["agree"] == 1.0 or res["gap"] <= 1e-5,
          f"{what}: labels differ beyond a near tie (gap {res['gap']:.2e})")
    check(res["mind_rel"] <= 1e-5,
          f"{what}: min_sqdist off by {res['mind_rel']:.2e} relative")
    if "sums_rel" in res:
        # 1e-4: the reduction-order tolerance of tests/test_kernels_v2.py
        check(res["sums_rel"] <= 1e-4, f"{what}: sums off by "
              f"{res['sums_rel']:.2e} of their scale")
        check(res["counts_rel"] <= 1e-6, f"{what}: counts off by "
              f"{res['counts_rel']:.2e}")
        check(res["energy_rel"] <= 1e-6, f"{what}: energy off by "
              f"{res['energy_rel']:.2e} relative")


def rescale_to_norms(torch, res, got, want, x, c):
    """``compare``'s result with the distances held relative to
    max(distance, |x|^2 + |c|^2 of the assigned centroid, 1), the scale
    of the f32 expansion |x|^2 - 2 x.c + |c|^2's rounding, as
    ``compare_bounds`` holds them: where the centroids are many and
    close to the rows, a distance is far smaller than the norms it
    cancels from, and its error is a few ulps of those norms.  The error
    relative to max(distance, 1) stays in ``mind_rel_raw``."""
    xs = x if x.dim() == 3 else x.expand(c.shape[0], *x.shape)
    xsq = torch.sum(xs * xs, dim=-1)                          # (R, N)
    csq = torch.gather(torch.sum(c * c, dim=-1), 1, want[0].long())
    scale = torch.maximum(want[1].abs(), xsq + csq).clamp_min(1.0)
    res = dict(res, mind_rel_raw=res["mind_rel"])
    res["mind_rel"] = float(((got[1] - want[1]).abs() / scale).max())
    return res


def fmt(res):
    s = (f"labels agree {res['agree']:.7f} (near-tie gap {res['gap']:.2e}),"
         f" min_sqdist rel {res['mind_rel']:.2e} (abs {res['mind_abs']:.2e})")
    if "mind_rel_raw" in res:
        s += (f" relative to |x|^2 + |c|^2 ({res['mind_rel_raw']:.2e} "
              f"relative to the distance)")
    if "mind_rel_x" in res:
        s += f" ({res['mind_rel_x']:.2e} of |x|^2)"
    if "sums_rel" in res:
        s += (f", sums {res['sums_rel']:.2e}, counts "
              f"{res['counts_rel']:.2e}, energy rel {res['energy_rel']:.2e}")
    return s


def compare_stats(got, want):
    """Update-kernel (sums, counts) against the plain version's."""
    (s, n), (ws, wn) = got, want
    return {"sums_rel": float((s - ws).abs().max()
                              / ws.abs().max().clamp_min(1.0)),
            "counts_rel": float((n - wn).abs().max()
                                / wn.abs().max().clamp_min(1.0)),
            "sums_abs": float((s - ws).abs().max())}


def accept_stats(res, what):
    # the tolerances the fused kernel's stats are held to
    check(res["sums_rel"] <= 1e-4, f"{what}: sums off by "
          f"{res['sums_rel']:.2e} of their scale")
    check(res["counts_rel"] <= 1e-6, f"{what}: counts off by "
          f"{res['counts_rel']:.2e}")


def compare_bounds(torch, got, want, x, c, w, lb_sq, ub_sq, tile_rows):
    """Fused-bounds outputs (batched, 7 of them) against the plain
    version's: the fused step's five as ``compare`` holds them, plus the
    skipped share, the skipped group minima (the input bound, bit for
    bit) and the computed ones.  The bounds come from real Lloyd steps,
    after which a centroid can sit on a row: there |x|^2 - 2 x.c + |c|^2
    cancels to a few ulps of |x|^2 on one side and 0 on the other, so
    distances and group minima are relative to max(value, |x|^2, 1) and
    energies to max(energy, sum of w |x|^2)."""
    from repro_torch.kernels import ref
    out = compare(torch, got[:5], want[:5], x, c, w)
    xs = x if x.dim() == 3 else x.expand(c.shape[0], *x.shape)
    xsq = torch.sum(xs * xs, dim=-1)                          # (R, N)
    out["mind_rel"] = float(((got[1] - want[1]).abs() / torch.maximum(
        want[1].abs(), xsq).clamp_min(1.0)).max())
    wsq = torch.sum(xsq if w is None else xsq * w, dim=-1)   # (R,)
    out["energy_rel"] = float(((got[4] - want[4]).abs() / torch.maximum(
        want[4].abs(), wsq).clamp_min(1e-30)).max())
    computed = torch.stack([ref.computed_cells(lb, ub, tile_rows)
                            for lb, ub in zip(lb_sq, ub_sq)])
    g, wg = got[5], want[5]
    out["skipped"] = [float(v) for v in got[6]]
    out["skip_equal"] = torch.equal(got[6], want[6])
    out["gmin_skipped_equal"] = torch.equal(g[~computed], lb_sq[~computed]) \
        and torch.equal(wg[~computed], lb_sq[~computed])
    gscale = torch.maximum(wg.abs(), xsq[..., None]).clamp_min(1.0)
    out["gmin_rel"] = float(((g - wg).abs() / gscale)[computed].max()) \
        if bool(computed.any()) else 0.0
    return out


def accept_bounds(res, what, exact_labels=True):
    """``exact_labels=False``: as ``accept``, labels may differ on near
    ties (the rule phase 5 holds the fused kernel to at full size)."""
    if exact_labels:
        check(res["agree"] == 1.0, f"{what}: labels differ on "
              f"{1 - res['agree']:.2e} of rows")
    check(res["skip_equal"], f"{what}: skipped shares differ")
    check(res["gmin_skipped_equal"],
          f"{what}: a skipped group's minimum is not its bound")
    check(res["gmin_rel"] <= 1e-5, f"{what}: computed group minima off by "
          f"{res['gmin_rel']:.2e} relative")
    accept(res, what)


def fmt_bounds(res):
    return (f"{fmt(res)}, skipped {res['skipped']} (equal "
            f"{res['skip_equal']}), skipped group minima equal "
            f"{res['gmin_skipped_equal']}, computed ones rel "
            f"{res['gmin_rel']:.2e}")


def drifted_bounds(group_size, x, c, w, steps):
    """Bounds of a real carry: the fused_bounds engine with
    ``group_size`` steps from its init carry ``steps`` times, each time to
    the Lloyd update of the last step; -> (centroids of the next step
    (R, K, d), the engine's group size, the kernel's (lab0, lb_sq, ub_sq)
    for them)."""
    from repro_torch.core import get_backend
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    bk = get_backend("fused_bounds", group_size=group_size)
    k = c.shape[-2]
    gs = engine_group_size(k, group_size)
    carry = bk.init_carry(x, c, k)
    for _ in range(steps):
        res, carry = bk.batched_step(x, c, k, carry, w=w)
        c = bk.centroids_from_step(x, res, k, c)
    return c, gs, squared_bounds(carry, c, k, gs)


class StepRecorder:
    """A backend whose batched step records each step's skipped share
    (the carry's BoundStats, wherever it sits: a locality carry holds the
    bound carry inside) and keeps the last step's inputs and carry."""

    def __init__(self, bk):
        import dataclasses
        from repro_torch.core.backends.bounds import extract_stats
        self.skips, self.last, self.out = [], None, None

        def step(x_, cs, k, carries, w=None):
            self.last = (cs, carries)
            res, carries = bk.batched_step(x_, cs, k, carries, w=w)
            self.skips.append(extract_stats(carries).skipped_frac)
            self.out = carries
            return res, carries

        self.backend = dataclasses.replace(bk, name=f"{bk.name}+record",
                                           batched_step_fn=step)


def trips_of(model):
    """Loop trips of a fit: an accepted iteration is one trip, a rejected
    one two (the paper's 2t - a), plus the trip that detects
    convergence."""
    converged = model.n_iter_ <= model.max_iter
    return 2 * model.n_iter_ - 2 + int(converged) - model.n_accepted_


def event_ms(torch, fn, iters, warmup=2):
    """Mean device time of fn(i) over ``iters`` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def distance_bound_ms(n_bytes, n_cross, n_other):
    """Bounds of a distance kernel whose cross terms x.c are ``n_cross``
    f32 operations (2NKd) beside ``n_other`` others (norms, compares):
    -> (bound ms, what bounds it, FP32-core bound ms, split-TF32 bound
    ms).  f32-accurate cross terms take the FP32 cores at 67 TFLOP/s, or
    three TF32 products on the tensor cores at 495 TFLOP/s while the rest
    runs on the FP32 cores; the bound is the lower of the two."""
    fp32, fp32_by = bound_ms(n_bytes, n_cross + n_other)
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_tc = 3 * n_cross / PEAK_TF32_PER_S
    t_other = n_other / PEAK_FP32_PER_S
    tc = max(t_bytes, t_tc, t_other) * 1e3
    tc_by = ("bytes" if t_bytes >= max(t_tc, t_other) else
             "split-tf32 operations" if t_tc >= t_other else "operations")
    return (tc, tc_by, fp32, tc) if tc < fp32 else (fp32, fp32_by, fp32, tc)


# Instructions the tensor-core sweep's epilogue issues on the CUDA cores
# per (row, centroid), csrc/sweep_tc.cuh's take(): FFMA, FADD, FMNMX, IADD3,
# ISETP and two SEL (the SASS opcode mix of scripts/tc_sweep_probe.py).
TC_EPILOGUE_INSTR = 7
# The bounded step's epilogue adds one IMNMX a (row, centroid): the running
# minimum key of the open group (sweep_tc.cuh's fold_bounded).
TC_BOUNDED_INSTR = TC_EPILOGUE_INSTR + 1


def bf16_bound_ms(n_bytes, n_cross, n_other):
    """Bounds of a distance kernel on bf16 operands: -> (bound ms, what
    bounds it, FP32-core bound ms).  The least time for the work is its
    bf16 products on the tensor cores (989 TFLOP/s, f32 accumulation)
    beside the other operations on the CUDA cores (``n_other`` at the FP32
    rate, 67 T a second, an instruction slot counting 2, as an FMA does),
    or the bytes; the FP32-core bound runs the products there too.  The
    tensor-core sweep's epilogue issues TC_EPILOGUE_INSTR instructions a
    (row, centroid): ``tc_other``."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_tc = n_cross / PEAK_BF16_PER_S
    t_other = n_other / PEAK_FP32_PER_S
    by = ("bytes" if t_bytes >= max(t_tc, t_other) else
          "bf16 tensor-core operations" if t_tc >= t_other else "operations")
    return max(t_bytes, t_tc, t_other) * 1e3, by, \
        bound_ms(n_bytes, n_cross + n_other)[0]


def tc_other(n, k, d, chains=False, instr=TC_EPILOGUE_INSTR):
    """The CUDA-core operations of the tensor-core sweep over n rows and k
    centroids of width d, at the FP32 rate (an instruction slot counting
    2): the epilogue's ``instr`` a (row, centroid) (TC_BOUNDED_INSTR in
    the bounded step), and with ``chains`` the |x|^2 FMA chains (the
    fused step's bound has always counted them)."""
    return 2 * instr * n * k + (2 * n * d if chains else 0)


def mm_argmin(torch, x, c, csq):
    """The library's one call on bf16 X and C: ``torch.mm`` with f32 output
    (the aten::mm.dtype overload), the reference's epilogue and argmin;
    None where this torch lacks the overload."""
    try:
        prod = torch.mm(x, c.T, out_dtype=torch.float32)
    except (RuntimeError, TypeError):
        return None
    xf = x.float()
    return torch.argmin(torch.clamp_min(torch.sum(xf * xf, -1, keepdim=True)
                                        - 2.0 * prod + csq, 0.0), dim=1)


def cross_error(torch, assignment, x, c):
    """The tensor-core sweep's cross terms (``assignment.cross_terms``) for
    bf16 rows x (N, d) and centroids c (K, d) against an f64 product of the
    same values: {largest error relative to |x| |c|, to |x|^2 + |c|^2, mean
    signed error relative to |x| |c|}, and the same of the plain version's
    f32 product (``plain_*``)."""
    xd, cd = x.double(), c.double()
    want = xd @ cd.T
    nx, nc = torch.sum(xd * xd, -1), torch.sum(cd * cd, -1)
    norms = nx.sqrt()[:, None] * nc.sqrt()[None]
    out = {}
    for tag, got in (("", assignment.cross_terms(x, c[None])[0]),
                     ("plain_", x.float() @ c.float().T)):
        err = got.double() - want
        out.update({f"{tag}of_norms": float((err.abs() / norms).max()),
                    f"{tag}of_squares": float(
                        (err.abs() / (nx[:, None] + nc[None])).max()),
                    f"{tag}mean_signed": float((err / norms).mean())})
    return out


def tc_sass(build):
    """The HGMMA instructions of the tensor-core sweep's kernels in the
    built assignment, fused and bounded libraries (``cuobjdump -sass``):
    {library: {kernel: count}}."""
    cuobjdump = str(Path(build._nvcc()).parent / "cuobjdump")
    out = {}
    for lib, kernel in (("assignment", "assign_tc"),
                        ("fused_lloyd", "assign_tc"),
                        ("fused_bounds", "bounds_tc")):
        funs = sass_functions(cuobjdump, build.library_path(lib))
        out[lib] = {f: sum(n for op, n in opcode_counts(ins).items()
                           if op.startswith("HGMMA"))
                    for f, ins in funs.items() if kernel in f}
    return out


def ptxas_report(lib_path, pattern):
    """{kernel: ptxas' registers, stack and spill bytes} of the kernels of
    a built library whose names match the regular expression ``pattern``,
    from the compiler log that kernels/build.py keeps beside it (empty
    when there is none)."""
    log = Path(lib_path).with_suffix(".log")
    out, name = {}, None
    for line in (log.read_text().splitlines() if log.exists() else ()):
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            name = entry.group(1) if re.search(pattern, entry.group(1)) \
                else None
            continue
        if name is None:
            continue
        found = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if found:
            out.setdefault(name, {}).update(
                stack=int(found.group(1)), spill_stores=int(found.group(2)),
                spill_loads=int(found.group(3)))
        found = re.search(r"Used (\d+) registers", line)
        if found:
            out.setdefault(name, {})["registers"] = int(found.group(1))
    return out


def sass_functions(cuobjdump: str, lib_path: Path):
    """{function name: its SASS instructions (no addresses, no
    encodings)} of every kernel in the library."""
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    funs, cur = {}, None
    for line in out.splitlines():
        line = line.strip()
        found = re.match(r"Function : (\S+)", line)
        if found:
            cur = funs.setdefault(found.group(1), [])
        elif cur is not None and line.startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1].strip()
            if body and not body.startswith("/*"):
                cur.append(body.split(";")[0].strip())
    return funs


def opcode_counts(ins):
    """Opcodes (with their width suffix) of a function's instructions."""
    counts = collections.Counter()
    for i in ins:
        words = i.split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            counts[words[0]] += 1
    return counts


def phase5c(torch, x, c0, model, zero_counts, read_counts, path_launches,
            tile_rows):
    """The locality engine at full size on phase 5's unordered rows from
    phase 5's seeds, beside the raw bounded fit with the same groups;
    -> (what phase 8 times: the wrapper, the last step's centroids and
    carry, and the raw kernel's bounds at that carry on the original rows;
    the bounded kernel's and the update's largest absolute error against
    their plain versions)."""
    import numpy as np
    from repro_torch.core import AAKMeans, get_backend
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    from repro_torch.core.locality import (ReorderConfig, inner_carry,
                                           permutation, permute_bound_carry,
                                           resort, sort_count, sorted_rows)
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U
    n, k = x.shape[0], MAIN_K
    gs = engine_group_size(k, ORDERED_GS)
    chunks = -(-n // PREDICT_CHUNK)
    print(f"phase 5c: fused_bounds_reorder at full size on the unordered "
          f"rows (gs {gs}, G {-(-k // gs)}; phase 5's seeds)")
    bk_r = get_backend("fused_bounds_reorder", group_size=ORDERED_GS)
    runs = {}
    for label, bk in (("fused_bounds_reorder", bk_r),
                      ("raw fused_bounds", get_backend(
                          "fused_bounds", group_size=ORDERED_GS))):
        rec = StepRecorder(bk)
        zero_counts()
        t0 = time.perf_counter()
        fitted = AAKMeans(n_clusters=k, backend=rec.backend,
                          n_init=1).fit(x, c0s=c0[None])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts_fit, plain_fit = read_counts()
        trips = trips_of(fitted)
        skips = torch.cat(rec.skips).tolist()
        rel = abs(fitted.inertia_ - model.inertia_) / model.inertia_
        runs[label] = (fitted, rec)
        print(f"  {label}: fit {fit_s!r} s (seeds given), "
              f"{fit_s / (1 + trips) * 1e3!r} ms wall a step; n_iter_ "
              f"{fitted.n_iter_}, n_accepted_ {fitted.n_accepted_}, "
              f"inertia_ {fitted.inertia_!r}, {rel:.2e} relative from the "
              f"fused fit's; skipped share: first trip {skips[1]!r}, "
              f"median {float(np.median(skips))!r}, last trip "
              f"{skips[-1]!r}; launches {counts_fit} vs 1 + trips = "
              f"{1 + trips}; plain-version calls {plain_fit}", flush=True)
        check(counts_fit["fused_bounds"] == 1 + trips and plain_fit == 0,
              f"{label}: bounded launches != 1 + trips")
        check(rel <= 1e-3, f"{label} and fused fits end far apart")
        if bk is bk_r:
            check(counts_fit["update"] == 1 + trips
                  and counts_fit["fused_lloyd"] == 0
                  and counts_fit["assignment"] == 0,
                  "the reorder fit did not take one bounded and one "
                  "update launch a step and nothing else")
            t0 = time.perf_counter()
            labels = fitted.predict(x)
            predict_s = time.perf_counter() - t0
            counts, plain = read_counts()
            path_launches["fused_bounds_reorder fit + predict"] = counts
            n_sorts = int(sort_count(rec.out)[0])
            perm = permutation(rec.out)[0]
            moved = int((perm != torch.arange(n, device=perm.device)).sum())
            print(f"    predict {predict_s!r} s, assignment launches "
                  f"{counts['assignment']} vs {chunks} chunks, plain-version "
                  f"calls {plain}; sorts {n_sorts}, rows away from their "
                  f"original slot {moved}", flush=True)
            check(counts["assignment"] == chunks and plain == 0,
                  "reorder predict launches != chunks")
            check(n_sorts > 0 and moved > 0, "the reorder fit never sorted")
            check(labels.shape == (n,), "reorder predict labels")
        else:
            path_launches["fused_bounds fit, gs 64, unordered"] = counts_fit
            check(sum(counts_fit.values()) == counts_fit["fused_bounds"],
                  "the raw bounded fit launched another kernel")
    # the last step again, through the wrapper (original-order outputs),
    # and the raw kernel on the original rows with the carry the wrapper's
    # kernel saw, permuted back: each row's outcome is its own
    fitted, rec = runs["fused_bounds_reorder"]
    cs_last, carry_last = rec.last
    res_w, _ = bk_r.batched_step(x, cs_last, k, carry_last)
    # the wrapper's own sort decision (the registry's default policy)
    carry_s = resort(carry_last, k, ReorderConfig())
    bnds_raw = squared_bounds(permute_bound_carry(inner_carry(carry_s),
                                                  carry_s[1]), cs_last, k,
                              gs)
    raw = F.fused_lloyd(x, cs_last, bounds=bnds_raw, gs=gs)
    same = {"labels": torch.equal(res_w.labels, raw[0]),
            "min_sqdist": torch.equal(res_w.min_sqdist, raw[1])}
    print(f"  the last step through the wrapper vs the raw kernel on the "
          f"original rows (carry permuted back): equal bit for bit {same} "
          f"({int((res_w.labels != raw[0]).sum())} labels, "
          f"{int((res_w.min_sqdist != raw[1]).sum())} distances differ); "
          f"raw kernel's skipped share there {float(raw[6][0])!r}")
    check(all(same.values()), "the wrapper's last step differs from the raw "
          "kernel's on the original rows")
    # the path's kernels against their plain versions at its own shapes:
    # the bounded kernel on the sorted rows (per-problem X), the update on
    # the fit's original-order labels
    xp = sorted_rows(x, carry_s[0])
    bnds_s = squared_bounds(inner_carry(carry_s), cs_last, k, gs)
    res_b = compare_bounds(torch, F.fused_lloyd(xp, cs_last, bounds=bnds_s,
                                                gs=gs),
                           F.fused_bounds_plain(xp, cs_last, None, *bnds_s,
                                                gs, tile_rows),
                           xp, cs_last, None, bnds_s[1], bnds_s[2],
                           tile_rows)
    print(f"  fused_bounds vs plain on the sorted rows at the last step: "
          f"{fmt_bounds(res_b)}")
    accept_bounds(res_b, "fused_bounds on the sorted rows",
                  exact_labels=False)
    del xp
    lab = fitted.labels_
    res_u = compare_stats(U.update(x, lab, k), U.update_plain(x, lab, k))
    print(f"  update vs plain on the reorder fit's labels: sums "
          f"{res_u['sums_rel']:.2e} (abs {res_u['sums_abs']:.2e}), counts "
          f"{res_u['counts_rel']:.2e}", flush=True)
    accept_stats(res_u, "update on the reorder fit's labels")
    return ((bk_r, cs_last, carry_last, bnds_raw, gs),
            res_b["mind_abs"], res_u["sums_abs"])


def phase9(torch, x, c0, model, zero_counts, read_counts, path_launches):
    """The single-problem path at full size: aa_kmeans on phase 5's data
    from phase 5's seeds is phase 5's fit (the batched driver at R = 1)
    bit for bit; the traced driver on an instrumented engine counts one
    pass for the init, one per accepted iteration, two per rejected one
    and one that detects convergence, and takes aa_kmeans's iterations;
    -> (aa_kmeans's result, its wall seconds)."""
    import numpy as np
    from repro_torch.core.backends import get_backend, instrument
    from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                         aa_kmeans_traced)
    print("phase 9: the single-problem path at full size (aa_kmeans, "
          "fused, phase 5's seeds)")
    cfg = KMeansConfig(k=MAIN_K, max_iter=model.max_iter)
    zero_counts()
    t0 = time.perf_counter()
    res = aa_kmeans(x, c0, cfg, backend="fused")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = read_counts()
    path_launches["aa_kmeans (fused)"] = counts
    n_iter, n_acc = int(res.n_iter), int(res.n_accepted)
    converged = bool(res.converged)
    trips = 2 * n_iter - 2 + int(converged) - n_acc
    same = {"labels": torch.equal(res.labels, model.labels_),
            "centroids": torch.equal(res.centroids, model.centroids_),
            "energy": float(res.energy) == model.inertia_,
            "n_iter": n_iter == model.n_iter_,
            "n_accepted": n_acc == model.n_accepted_}
    print(f"  aa_kmeans: {wall!r} s wall, n_iter {n_iter}, n_accepted "
          f"{n_acc}, converged {converged}, energy {float(res.energy)!r}; "
          f"trips {trips}, fused launches {counts['fused_lloyd']}, "
          f"plain-version calls {plain}")
    print(f"  equal bit for bit to phase 5's fit: {same}", flush=True)
    check(all(same.values()), f"aa_kmeans differs from phase 5's fit: "
          f"{same}")
    check(counts["fused_lloyd"] == 1 + trips and plain == 0
          and sum(counts.values()) == counts["fused_lloyd"],
          "aa_kmeans did not run on the fused kernel, one launch a trip")
    passes = []
    bk = instrument(get_backend("fused"), lambda: passes.append(1))
    zero_counts()
    tr = aa_kmeans_traced(x, c0, cfg, backend=bk)
    counts_t, plain_t = read_counts()
    path_launches["aa_kmeans_traced (fused)"] = counts_t
    expected = 1 + sum(1 if a else 2 for a in tr.accepted) \
        + int(bool(tr.result.converged))
    m = np.array(tr.m_values)
    print(f"  aa_kmeans_traced on the instrumented engine: "
          f"{tr.wall_time_s!r} s wall, n_iter {int(tr.result.n_iter)}, "
          f"n_accepted {int(tr.result.n_accepted)}; steps {len(passes)} vs "
          f"1 + sum(1 if accepted else 2) + converged = {expected}; fused "
          f"launches {counts_t['fused_lloyd']}; m over the iterations: mean "
          f"{float(m.mean())!r}, max {int(m.max())}", flush=True)
    check(len(passes) == expected == counts_t["fused_lloyd"]
          and plain_t == 0, "the traced pass count breaks the acceptance "
          "formula")
    check(int(tr.result.n_iter) == n_iter
          and int(tr.result.n_accepted) == n_acc,
          "aa_kmeans_traced takes other iterations than aa_kmeans")
    sys.stdout.flush()
    return res, wall


class StepEvents:
    """A backend whose streaming chunk steps record CUDA events: one as
    the guard (the batched step) starts, one as the chunk step ends; the
    last guard's operands (the final pick's (c, c_au)) are kept."""

    def __init__(self, torch, bk):
        self.marks, self.last_guard = [], None

        def guard(x_, cs, k, carries, w=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append([ev, None])
            self.last_guard = (x_, cs)
            return bk.batched_step(x_, cs, k, carries, w=w)

        def chunk(x_, c, k, w, carry):
            out = bk.minibatch_step(x_, c, k, w, carry)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[-1][1] = ev
            return out

        self.backend = dataclasses.replace(
            bk, name=f"{bk.name}+events", batched_step_fn=guard,
            minibatch_step_fn=chunk)

    def step_ms(self):
        """Per chunk step: (guard start to chunk-step end, guard start to
        the next guard's start) in device milliseconds."""
        done = [m for m in self.marks if m[1] is not None]
        work = [a.elapsed_time(b) for a, b in done]
        span = [a[0].elapsed_time(b[0])
                for a, b in zip(self.marks, self.marks[1:])]
        return work, span


def phase11(torch, x, inertia, zero_counts, read_counts, path_launches):
    """Streaming mini-batch Algorithm 1 at full size: the device-resident
    fit (launch counts, a bit-equal repeat, labels_ against the
    assignment kernel, the driver again with no sync allowed, bit-equal),
    the streamed driver from the host at prefetch 2 and 1 (bit-equal,
    device memory far below X, every chunk metered), and the fused kernel
    against its plain version at this path's shapes; -> the fused
    kernel's largest absolute distance error."""
    import numpy as np
    from repro_torch.core import MiniBatchAAKMeans, get_backend
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.core.kmeans import (aa_kmeans_minibatch,
                                         aa_kmeans_minibatch_streamed)
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.runtime import IngestMeter
    n, d = x.shape
    print(f"phase 11: streaming mini-batch Algorithm 1 at full size "
          f"(MiniBatchAAKMeans, fused, K={MAIN_K}, chunk {STREAM_CHUNK}, "
          f"{STREAM_EPOCHS} epochs, {STREAM_VAL} validation rows)")

    def make():
        return MiniBatchAAKMeans(n_clusters=MAIN_K, chunk_size=STREAM_CHUNK,
                                 epochs=STREAM_EPOCHS, val_size=STREAM_VAL,
                                 backend="fused", seed=0)

    model = make()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(x)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts, plain = read_counts()
    path_launches["MiniBatchAAKMeans fit + labels_"] = counts
    n_train = n - STREAM_VAL
    n_chunks = -(-n_train // STREAM_CHUNK)
    tail = n_train - (n_chunks - 1) * STREAM_CHUNK
    predict_chunks = -(-n // PREDICT_CHUNK)
    print(f"  fit {fit_s!r} s (split, seeding, chunking, the driver and "
          f"labels_ included): {n_chunks} chunks (the last {tail} real "
          f"rows and {STREAM_CHUNK - tail} at weight 0), n_steps_ "
          f"{model.n_steps_}, n_accepted_ {model.n_accepted_}, validation "
          f"energy {model.energy_!r}")
    print(f"  fused launches {counts['fused_lloyd']} vs 2 x n_steps_ + 1 = "
          f"{2 * model.n_steps_ + 1}; assignment launches "
          f"{counts['assignment']} vs predict chunks {predict_chunks}; "
          f"plain-version calls {plain}", flush=True)
    check(model.n_steps_ == STREAM_EPOCHS * n_chunks, "n_steps_")
    check(counts["fused_lloyd"] == 2 * model.n_steps_ + 1,
          "fused launches != 2 x n_steps_ + 1")
    check(counts["assignment"] == predict_chunks,
          "assignment launches != predict chunks")
    check(counts["update"] == counts["fused_bounds"] == 0 and plain == 0,
          "the streaming fit launched another kernel or a plain version")
    check(np.isfinite(model.energy_) and model.energy_ > 0, "energy_")
    lab_all = A.assignment(x, model.centroids_)[0]
    same_lab = bool(np.array_equal(model.labels_, lab_all.cpu().numpy()))
    e_full = float(F.fused_lloyd(x, model.centroids_)[4])
    print(f"  labels_ equal to the assignment kernel's at all rows on the "
          f"final centroids: {same_lab}; full-X energy of the final "
          f"centroids {e_full!r} beside phase 5's inertia_ {inertia!r} "
          f"({e_full / inertia - 1:+.4%})")
    check(same_lab, "labels_ differ from the assignment kernel's")
    check(np.isfinite(e_full), "full-X energy")

    again = make().fit(x)
    same = {"centroids": torch.equal(again.centroids_, model.centroids_),
            "energy_": again.energy_ == model.energy_,
            "n_accepted_": again.n_accepted_ == model.n_accepted_}
    print(f"  the fit again from seed 0, equal bit for bit: {same}")
    check(all(same.values()), f"the repeated fit differs: {same}")
    del again

    # the driver alone on the fit's own inputs, with any sync an error
    inp = model.fit_inputs(x)
    cfg = model._config()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        res = aa_kmeans_minibatch(inp.chunks.chunks, inp.chunks.weights,
                                  inp.x_val, inp.c0, cfg, backend="fused",
                                  generator=inp.generator)
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    driver_s = time.perf_counter() - t0
    same = {"centroids": torch.equal(res.centroids, model.centroids_),
            "energy": float(res.energy) == model.energy_,
            "n_accepted": int(res.n_accepted) == model.n_accepted_,
            "n_steps": res.n_steps == model.n_steps_}
    print(f"  aa_kmeans_minibatch under set_sync_debug_mode('error'): "
          f"{res.n_steps} steps enqueued in {enqueue_s!r} s, done in "
          f"{driver_s!r} s ({res.n_steps / driver_s!r} steps/s, "
          f"{driver_s / res.n_steps * 1e3!r} ms a step); equal to the fit "
          f"bit for bit: {same}", flush=True)
    check(all(same.values()), f"the driver differs from the fit: {same}")

    # the kernels at this path's shapes: R = 2 over the validation rows
    # at the final (c, c_au) (caught by the streamed run's recorder
    # below), and the weighted step on the padded tail chunk
    c_fin = model.centroids_
    xt, wt = inp.chunks.chunks[-1], inp.chunks.weights[-1]
    got = F.fused_lloyd(xt, c_fin, wt)
    want = F.fused_lloyd_plain(xt, c_fin, wt)
    res_tail = compare(torch, tuple(g[None] for g in got),
                       tuple(v[None] for v in want), xt, c_fin[None], wt)
    print(f"  fused on the padded tail chunk ({tail} rows at weight 1) vs "
          f"plain: {fmt(res_tail)}")
    accept(res_tail, "fused on the padded tail chunk")
    trunc = F.fused_lloyd(xt[:tail].contiguous(), c_fin,
                          torch.ones(tail, device=x.device))
    pad_vs = {"labels": torch.equal(got[0][:tail], trunc[0]),
              "min_sqdist": torch.equal(got[1][:tail], trunc[1])}
    stats_v = compare_stats(got[2:4], trunc[2:4])
    e_rel = float((got[4] - trunc[4]).abs() / trunc[4])
    print(f"  padded against truncated tail: real rows equal bit for bit "
          f"{pad_vs}; sums {stats_v['sums_rel']:.2e}, counts "
          f"{stats_v['counts_rel']:.2e}, energy {e_rel:.2e} relative")
    check(all(pad_vs.values()), f"padding moved the real rows: {pad_vs}")
    accept_stats(stats_v, "padded against truncated tail")
    check(e_rel <= 1e-6, f"padded tail energy off by {e_rel:.2e}")
    abs_err = res_tail["mind_abs"]

    # the streamed driver from the host: the fit's training rows, its
    # seeds and validation chunk, prefetch 2 then 1
    x_host = inp.chunks.chunks.reshape(-1, d)[:n_train].cpu().numpy()
    x_val, c0 = inp.x_val, inp.c0
    del inp, res, got, want, trunc
    torch.cuda.synchronize()
    scfg = dataclasses.replace(cfg, epochs=2)
    x_mb = n * d * 4 / 1e6
    runs = []
    # in turns, so neither depth gets the warmer machine
    for prefetch in (2, 1, 1, 2):
        meter = IngestMeter()
        rec = StepEvents(torch, get_backend("fused"))
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        meter.start()
        out = aa_kmeans_minibatch_streamed(
            x_host, x_val, c0, scfg, backend=rec.backend,
            chunk_size=STREAM_CHUNK, seed=0, prefetch=prefetch,
            drop_remainder=True, meter=meter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_s, plain_s = read_counts()
        peak_mb = (torch.cuda.max_memory_allocated() - before) / 1e6
        work, span = rec.step_ms()
        copy = meter.copy_ms()
        steps = out.n_steps
        runs.append((prefetch, wall, out, rec))
        path_launches.setdefault(
            f"aa_kmeans_minibatch_streamed (prefetch {prefetch})", counts_s)

        def med_mean(v, scale=1.0):
            return (f"{float(np.median(v)) * scale!r}, "
                    f"{float(np.mean(v)) * scale!r}")

        print(f"  streamed, prefetch {prefetch}: {wall!r} s wall, {steps} "
              f"steps, {meter.chunks} chunks metered ({meter.bytes} B, "
              f"IngestMeter {meter.gbps!r} GB/s); per chunk (median, mean): "
              f"host gather {med_mean(meter.fetch_s, 1e3)} ms; pinned "
              f"staging {med_mean(meter.stage_s, 1e3)} ms; copy "
              f"{med_mean(copy)} ms; step (guard to chunk step, events) "
              f"{med_mean(work)} ms; step span (guard to guard) "
              f"{med_mean(span)} ms; peak device memory above the start "
              f"{peak_mb!r} MB (X is {x_mb!r} MB)", flush=True)
        check(meter.chunks == steps == 2 * (n_train // STREAM_CHUNK),
              "the meter missed chunks")
        check(len(copy) == steps, "a copy was not timed")
        check(counts_s["fused_lloyd"] == 2 * steps + 1 and plain_s == 0,
              "the streamed run did not run on the fused kernel")
        check(peak_mb < x_mb / 4, f"the streamed run held {peak_mb} MB on "
              f"the card, over a quarter of X")
    _, _, a, rec2 = runs[0]
    same = {"centroids": all(torch.equal(a.centroids, r[2].centroids)
                             for r in runs),
            "energy": all(torch.equal(a.energy, r[2].energy) for r in runs),
            "n_accepted": all(torch.equal(a.n_accepted, r[2].n_accepted)
                              for r in runs),
            "n_steps": all(a.n_steps == r[2].n_steps for r in runs)}
    walls = {p: [r[1] for r in runs if r[0] == p] for p in (2, 1)}
    print(f"  the four streamed runs (prefetch 2, 1, 1, 2) equal bit for "
          f"bit: {same}; mean wall prefetch 2 "
          f"{sum(walls[2]) / 2!r} s, prefetch 1 {sum(walls[1]) / 2!r} s; "
          f"validation energy {float(a.energy)!r}, n_accepted "
          f"{int(a.n_accepted)}")
    check(all(same.values()), f"prefetch depths differ: {same}")

    xv, cs = rec2.last_guard
    got = F.fused_lloyd(xv, cs)
    want = F.fused_lloyd_plain(xv, cs)
    res_g = compare(torch, got, want, xv, cs, None)
    print(f"  fused at R = 2 on the validation rows ({xv.shape[0]} x {d}) "
          f"at the final (c, c_au) vs plain: {fmt(res_g)}")
    accept(res_g, "fused at the guard's shape")
    sys.stdout.flush()
    return max(abs_err, res_g["mind_abs"]), model


def timed_load(torch, load):
    """-> (loaded model, wall s, peak device bytes above the start)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = load()
    torch.cuda.synchronize()
    return (model, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - before)


def timed_save(torch, model, path):
    """-> (artifact path, wall s, artifact bytes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.save(path)
    return out, time.perf_counter() - t0, out.stat().st_size


def phase12(torch, x, x_np, model, labels, zero_counts, read_counts,
            path_launches):
    """Persistence at full size: phase 5's fitted AAKMeans through an
    artifact and back (predict's labels and the fitted state equal), and
    a partial_fit stream saved mid-way, loaded and continued, equal bit
    for bit to the stream that was not interrupted."""
    import tempfile

    import numpy as np
    from repro_torch.checkpoint import load_estimator
    from repro_torch.core import AAKMeans, MiniBatchAAKMeans
    from repro_torch.core.api import PREDICT_CHUNK
    n = x.shape[0]
    print(f"phase 12: persistence at full size (phase 5's fused AAKMeans; "
          f"MiniBatchAAKMeans, fused, K={MAIN_K}, {RESUME_CHUNKS} host "
          f"chunks of {STREAM_CHUNK}, saved after {RESUME_AT})")
    with tempfile.TemporaryDirectory() as tmp:
        p, save_s, nbytes = timed_save(torch, model, Path(tmp) / "aakmeans")
        print(f"  AAKMeans.save {save_s!r} s, {nbytes} bytes")
        zero_counts()
        for how, load in (
                ("AAKMeans.load", lambda: AAKMeans.load(p)),
                ("load_estimator", lambda: load_estimator(p))):
            loaded, load_s, peak = timed_load(torch, load)
            lab = loaded.predict(x)
            same = {
                "class": type(loaded) is AAKMeans,
                "on the card": loaded.centroids_.device.type == "cuda",
                "predict": bool(np.array_equal(lab, labels)),
                "centroids_": torch.equal(loaded.centroids_,
                                          model.centroids_),
                "labels_": torch.equal(loaded.labels_, model.labels_),
                "scalars": (loaded.energy_, loaded.n_iter_,
                            loaded.n_accepted_) == (
                                model.energy_, model.n_iter_,
                                model.n_accepted_)}
            print(f"  {how}: {load_s!r} s, peak device memory "
                  f"{peak / 1e6!r} MB; predict on all {n} rows and the "
                  f"fitted state equal: {same}", flush=True)
            check(all(same.values()), f"{how} differs: {same}")
        counts, plain = read_counts()
        path_launches["loaded AAKMeans predict"] = counts
        chunks = -(-n // PREDICT_CHUNK)
        print(f"  assignment launches {counts['assignment']} vs 2 x predict "
              f"chunks {2 * chunks}; plain-version calls {plain}")
        check(counts["assignment"] == 2 * chunks and plain == 0,
              "the loaded models did not predict on the assignment kernel")

        def make():
            return MiniBatchAAKMeans(
                n_clusters=MAIN_K, chunk_size=STREAM_CHUNK,
                epochs=STREAM_EPOCHS, val_size=STREAM_VAL, backend="fused",
                seed=0)

        host = [x_np[i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK]
                for i in range(RESUME_CHUNKS)]
        zero_counts()
        a = make()
        for chunk in host[:RESUME_AT]:
            a.partial_fit(chunk)
        p, save_s, nbytes = timed_save(torch, a, Path(tmp) / "stream")
        b, load_s, peak = timed_load(
            torch, lambda: MiniBatchAAKMeans.load(p))
        print(f"  mid-stream MiniBatchAAKMeans.save after {RESUME_AT} "
              f"chunks {save_s!r} s, {nbytes} bytes; load {load_s!r} s, "
              f"peak device memory {peak / 1e6!r} MB", flush=True)
        check(b._state.t == RESUME_AT and b._x_val.device.type == "cuda",
              "the loaded stream is not at its step on the card")
        for m in (a, b):
            for chunk in host[RESUME_AT:]:
                m.partial_fit(chunk)
            m.finalize()
        torch.cuda.synchronize()
        counts, plain = read_counts()
        path_launches["MiniBatchAAKMeans partial_fit, save, load"] = counts
    steps = 2 * RESUME_CHUNKS - RESUME_AT
    same = {"centroids_": torch.equal(a.centroids_, b.centroids_),
            "energy_": a.energy_ == b.energy_,
            "n_steps_": a.n_steps_ == b.n_steps_ == RESUME_CHUNKS,
            "n_accepted_": torch.equal(a.n_accepted_, b.n_accepted_)}
    print(f"  resumed against uninterrupted, equal bit for bit: {same}; "
          f"validation energy {a.energy_!r}, n_accepted_ "
          f"{int(a.n_accepted_)}; fused launches {counts['fused_lloyd']} vs "
          f"2 x {steps} steps + 2 picks = {2 * steps + 2}; plain-version "
          f"calls {plain}", flush=True)
    check(all(same.values()), f"the resumed stream differs: {same}")
    check(np.isfinite(a.energy_), "the stream's energy")
    check(counts["fused_lloyd"] == 2 * steps + 2 and plain == 0,
          "the stream did not run on the fused kernel")


class Preempted(RuntimeError):
    """Raised by phase 13's callback to stand in for a preemption."""


def phase13(torch, dev, x, c0, res9, wall9, max_iter, zero_counts,
            read_counts, path_launches):
    """Segmented and resumed solves at full width: (a) aa_kmeans cut
    every SEG_EVERY iterations and preempted at SEG_KILL_AT, resumed from
    its run directory's newest snapshot; (b) the batched driver at R = 2
    resumed from its first snapshot; (c) fused_bounds_reorder resumed
    mid-sort, and refused on the raw engine; (d) the streaming driver cut
    at every epoch and resumed from epoch 2.  Every resumed or segmented
    run equals its uninterrupted run bit for bit, on the kernels."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import resume_point
    from repro_torch.core import MiniBatchAAKMeans, get_backend
    from repro_torch.core import serialize
    from repro_torch.core.init_schemes import batched_init
    from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                         aa_kmeans_batched,
                                         aa_kmeans_minibatch,
                                         loop_state_like)
    from repro_torch.core.locality import permutation, sort_count
    from repro_torch.runtime import (CollectMetrics, JsonlMetrics,
                                     TeeMetrics, read_manifest,
                                     snapshot_name, tree_nbytes,
                                     write_snapshot)
    print(f"phase 13: segmented and resumed solves at full size "
          f"(K={MAIN_K}, fused; checkpoint every {SEG_EVERY}, preempted at "
          f"t = {SEG_KILL_AT})")

    def same_result(a, b):
        return {f: torch.equal(u, v)
                for f, u, v in zip(a._fields, a, b)}

    def only(counts, plain, *names):
        return plain == 0 and all(v > 0 if k in names else v == 0
                                  for k, v in counts.items())

    cfg = KMeansConfig(k=MAIN_K, max_iter=max_iter)
    n_iter, n_acc = int(res9.n_iter), int(res9.n_accepted)
    trips9 = 2 * n_iter - 2 + int(bool(res9.converged)) - n_acc
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) the main path, preempted and resumed
        collect = CollectMetrics()
        sink = TeeMetrics(collect, JsonlMetrics(tmp / "metrics.jsonl"))

        def preempt(state, t):
            if t == SEG_KILL_AT:
                raise Preempted(f"preempted at t = {t}")

        zero_counts()
        t0 = time.perf_counter()
        try:
            aa_kmeans(x, c0, cfg, backend="fused", checkpoint_every=SEG_EVERY,
                      checkpoint_dir=tmp / "a", keep_last_n=2, metrics=sink,
                      checkpoint_cb=preempt)
            raise PhaseError("the preempting callback did not stop the run")
        except Preempted:
            pass
        torch.cuda.synchronize()
        cut_s = time.perf_counter() - t0
        sink.close()
        path, meta = resume_point(tmp / "a")
        manifest = read_manifest(tmp / "a")
        files = sorted(p.name for p in (tmp / "a").glob("it_*.npz"))
        print(f"  (a) cut run to t = {SEG_KILL_AT}: {cut_s!r} s; resume "
              f"point {path.name if path else None}, meta t "
              f"{meta and meta['t']}, backend {meta and meta['backend']}; "
              f"manifest lists {[e['file'] for e in manifest['snapshots']]}"
              f", on disk {files}", flush=True)
        check(path is not None and path.name == snapshot_name(SEG_KILL_AT)
              and meta["t"] == SEG_KILL_AT, "resume_point after the cut")
        check(len(manifest["snapshots"]) == 2 and files == [
            e["file"] for e in manifest["snapshots"]],
            "keep_last_n=2 did not keep two snapshots")
        nbytes = {name: (tmp / "a" / name).stat().st_size for name in files}
        # the restore alone: the snapshot's layout on the meta device,
        # then the artifact read into it on the card
        t0 = time.perf_counter()
        like = loop_state_like(x, c0, cfg, "fused")
        like_s = time.perf_counter() - t0
        tree, _ = serialize.restore(path, like, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0 - like_s
        del like, tree
        t0 = time.perf_counter()
        resumed = aa_kmeans(x, c0, cfg, backend="fused", resume_from=path)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        counts, plain = read_counts()
        path_launches["13a aa_kmeans cut + resumed (fused)"] = counts
        same = same_result(resumed, res9)
        snaps = [r["snapshot_s"] for _, r in collect.records
                 if "snapshot_s" in r]
        segs = [r["segment_s"] for _, r in collect.records
                if "segment_s" in r]
        writes = [r["checkpoint_write_s"] for _, r in collect.records
                  if "checkpoint_write_s" in r]
        lines = (tmp / "metrics.jsonl").read_text().splitlines()
        recs = [json.loads(ln) for ln in lines]
        print(f"  (a) restore alone: layout {like_s!r} s, read and copy to "
              f"the card {restore_s!r} s; resumed run {resume_s!r} s "
              f"(restore included) beside phase 9's {wall9!r} s for the "
              f"whole solve; equal to phase 9 bit for bit: {same}")
        print(f"  (a) boundaries: snapshot copies {snaps} s (host clock, "
              f"ending in the copy's sync), segments {segs} s, writer's "
              f"write latency {writes} s; artifact bytes {nbytes}; "
              f"{len(recs)} JSONL records", flush=True)
        print(f"  (a) fused launches {counts['fused_lloyd']} vs 1 + trips "
              f"{1 + trips9}; plain-version calls {plain}")
        check(all(same.values()), f"the resumed run differs: {same}")
        # the boundary whose callback raised logs no scalars, but its
        # snapshot was written
        check(len(snaps) == SEG_KILL_AT // SEG_EVERY - 1
              and len(writes) == len(snaps) + 1 and len(recs) == len(
                  collect.records)
              and recs[0]["step"] == collect.records[0][0],
              "the sinks missed a boundary")
        check(counts["fused_lloyd"] == 1 + trips9
              and only(counts, plain, "fused_lloyd"),
              "the cut and resumed runs did not run on the fused kernel "
              "once per trip")
        # the whole segmented run against phase 9's plain one
        zero_counts()
        t0 = time.perf_counter()
        seg = aa_kmeans(x, c0, cfg, backend="fused",
                        checkpoint_every=SEG_EVERY,
                        checkpoint_dir=tmp / "a2", keep_last_n=2)
        torch.cuda.synchronize()
        seg_s = time.perf_counter() - t0
        counts, plain = read_counts()
        path_launches["13a aa_kmeans segmented (fused)"] = counts
        same = same_result(seg, res9)
        print(f"  (a) the whole segmented run (checkpoint every "
              f"{SEG_EVERY}, written on the thread): {seg_s!r} s beside "
              f"phase 9's {wall9!r} s ({seg_s / wall9 - 1:+.2%}); equal "
              f"bit for bit: {same}; fused launches {counts['fused_lloyd']}",
              flush=True)
        check(all(same.values()) and counts["fused_lloyd"] == 1 + trips9
              and only(counts, plain, "fused_lloyd"),
              f"the segmented run differs: {same}")
        del seg, resumed
        shutil.rmtree(tmp / "a")
        shutil.rmtree(tmp / "a2")

        # (b) batched, R = 2
        c0b = batched_init("kmeans++",
                           torch.Generator(device=dev).manual_seed(1), x,
                           MAIN_K, 1)[0]
        c0s = torch.stack([c0, c0b])
        cfg_b = KMeansConfig(k=MAIN_K, max_iter=SEG_B_MAX_ITER)
        zero_counts()
        t0 = time.perf_counter()
        plain_b = aa_kmeans_batched(x, c0s, cfg_b, backend="fused")
        torch.cuda.synchronize()
        plain_b_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        seg_b = aa_kmeans_batched(x, c0s, cfg_b, backend="fused",
                                  checkpoint_every=SEG_B_EVERY,
                                  checkpoint_dir=tmp / "b")
        torch.cuda.synchronize()
        seg_b_s = time.perf_counter() - t0
        first = tmp / "b" / snapshot_name(SEG_B_EVERY)
        t0 = time.perf_counter()
        res_b = aa_kmeans_batched(x, c0s, cfg_b, backend="fused",
                                  resume_from=first)
        torch.cuda.synchronize()
        res_b_s = time.perf_counter() - t0
        counts, plain = read_counts()
        path_launches["13b aa_kmeans_batched R=2 (fused)"] = counts
        same_seg, same_res = same_result(seg_b, plain_b), \
            same_result(res_b, plain_b)
        files = sorted(p.name for p in (tmp / "b").glob("it_*.npz"))
        print(f"  (b) R = 2, max_iter {SEG_B_MAX_ITER}, n_iter "
              f"{plain_b.n_iter.tolist()}, n_accepted "
              f"{plain_b.n_accepted.tolist()}: plain {plain_b_s!r} s, "
              f"segmented every {SEG_B_EVERY} trips {seg_b_s!r} s "
              f"({files}, {first.stat().st_size} bytes each), resumed from "
              f"{first.name} {res_b_s!r} s; segmented equal {same_seg}, "
              f"resumed equal {same_res}; fused launches "
              f"{counts['fused_lloyd']}, plain-version calls {plain}",
              flush=True)
        check(all(same_seg.values()) and all(same_res.values()),
              "the batched segmented or resumed run differs")
        check(only(counts, plain, "fused_lloyd"),
              "the batched runs did not run on the fused kernel alone")
        del plain_b, seg_b, res_b
        shutil.rmtree(tmp / "b")

        # (c) mid-sort resume of the locality engine
        bk = get_backend("fused_bounds_reorder", group_size=ORDERED_GS)
        raw = get_backend("fused_bounds", group_size=ORDERED_GS)
        cfg_c = KMeansConfig(k=MAIN_K, max_iter=SEG_C_MAX_ITER)
        trees = {}
        zero_counts()
        full_c = aa_kmeans(x, c0, cfg_c, backend=bk)
        cut_c = aa_kmeans(x, c0, cfg_c, backend=bk,
                          checkpoint_every=SEG_C_EVERY,
                          checkpoint_cb=lambda st, t: trees.setdefault(t, st))
        ar = torch.arange(x.shape[0], dtype=torch.int32, device=dev)
        live = [t for t in sorted(trees)
                if int(sort_count(trees[t].carry)) > 0
                and not torch.equal(permutation(trees[t].carry), ar)]
        print(f"  (c) fused_bounds_reorder (gs {ORDERED_GS}), max_iter "
              f"{SEG_C_MAX_ITER}, n_iter {int(full_c.n_iter)}: boundaries "
              f"{sorted(trees)}, sorts there "
              f"{[int(sort_count(trees[t].carry)) for t in sorted(trees)]};"
              f" with a live permutation: {live}", flush=True)
        check(all(same_result(cut_c, full_c).values()),
              "the segmented reorder run differs from the plain one")
        check(bool(live) and live[0] < int(full_c.n_iter),
              "no snapshot holds a live permutation before the end")
        t_live = live[0]
        state = trees[t_live]
        del trees
        res_c = aa_kmeans(x, c0, cfg_c, backend=bk, resume_from=state)
        art = write_snapshot(tmp / "c", state, kind=serialize.KIND_LOOP,
                             step=t_live, extra={"t": t_live, "k": MAIN_K,
                                                 "backend": bk.name})
        res_c2 = aa_kmeans(x, c0, cfg_c, backend=bk, resume_from=art)
        torch.cuda.synchronize()
        counts, plain = read_counts()
        path_launches["13c fused_bounds_reorder resumed mid-sort"] = counts
        refused = None
        try:
            aa_kmeans(x, c0, cfg_c, backend=raw, resume_from=art)
        except ValueError as e:
            refused = str(e)
        same, same2 = same_result(res_c, full_c), same_result(res_c2, full_c)
        print(f"  (c) resumed at t = {t_live} from the callback's tree: "
              f"equal {same}; from its artifact ({art.stat().st_size} "
              f"bytes, payload {tree_nbytes(state)}): equal {same2}; on raw "
              f"fused_bounds: refused {refused is not None} "
              f"({(refused or '')[-80:]!r}); launches {counts}, "
              f"plain-version calls {plain}", flush=True)
        check(all(same.values()) and all(same2.values()),
              "the mid-sort resume differs")
        check(refused is not None, "the raw engine took a reorder snapshot")
        check(only(counts, plain, "fused_bounds", "update"),
              "the reorder runs did not run on the bounded and update "
              "kernels alone")
        del state, full_c, cut_c, res_c, res_c2
        shutil.rmtree(tmp / "c")

        # (d) the streaming driver, phase 11's configuration
        model = MiniBatchAAKMeans(n_clusters=MAIN_K, chunk_size=STREAM_CHUNK,
                                  epochs=STREAM_EPOCHS, val_size=STREAM_VAL,
                                  backend="fused", seed=0)
        inp = model.fit_inputs(x)
        cfg_d = model._config()
        args = (inp.chunks.chunks, inp.chunks.weights, inp.x_val, inp.c0,
                cfg_d)
        zero_counts()
        runs = {}
        for label, kw in (
                ("plain", {}),
                ("segmented", dict(checkpoint_every=1,
                                   checkpoint_dir=tmp / "d")),
                ("resumed from epoch 2", dict(
                    resume_from=tmp / "d" / snapshot_name(2)))):
            gen = torch.Generator().manual_seed(0)
            t0 = time.perf_counter()
            runs[label] = aa_kmeans_minibatch(*args, backend="fused",
                                              generator=gen, **kw)
            torch.cuda.synchronize()
            runs[label] = (runs[label], time.perf_counter() - t0)
        counts, plain = read_counts()
        path_launches["13d aa_kmeans_minibatch segmented + resumed"] = counts
        ref_d = runs["plain"][0]
        steps = ref_d.n_steps
        for label, (r, s) in runs.items():
            eq = {"centroids": torch.equal(r.centroids, ref_d.centroids),
                  "energy": torch.equal(r.energy, ref_d.energy),
                  "n_steps": r.n_steps == steps,
                  "n_accepted": torch.equal(r.n_accepted, ref_d.n_accepted)}
            print(f"  (d) {label}: {s!r} s, equal to plain {eq}")
            check(all(eq.values()), f"the {label} stream differs: {eq}")
        files = sorted(p.name for p in (tmp / "d").glob("it_*.npz"))
        left = steps * (STREAM_EPOCHS - 2) // STREAM_EPOCHS
        want = 2 * (2 * steps + 1) + 2 * left + 1
        print(f"  (d) {files}, {(tmp / 'd' / files[0]).stat().st_size} "
              f"bytes each; fused launches {counts['fused_lloyd']} vs "
              f"2 x (2 x {steps} + 1) + 2 x {left} + 1 = {want}; "
              f"plain-version calls {plain}", flush=True)
        check(len(files) == STREAM_EPOCHS, "a snapshot per epoch")
        check(counts["fused_lloyd"] == want
              and only(counts, plain, "fused_lloyd"),
              "the streams did not run on the fused kernel")
    sys.stdout.flush()



def phase14(torch, x, x_np, model, labels, model_mb, zero_counts,
            read_counts, path_launches):
    """Serving at full size on phase 5's fitted fused model: (a) the
    default index, approximate predict on all rows beside the exact one;
    (b) the candidate-count sweep on a sample, with the serving model's
    per-batch latency; (c) bucketed scans equal to plain ones bit for
    bit; (d) the micro-batching server under four producers, with the
    closure and the exact path; (e) a hot reload under traffic to phase
    11's model.  -> the assignment kernel's launches in this phase."""
    import statistics
    import tempfile
    import threading

    import numpy as np
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.core.lloyd import pairwise_sqdist
    from repro_torch.kernels.ref import tie_gap
    from repro_torch.kernels.tiles import pad_rows
    from repro_torch.runtime.metrics import CollectMetrics
    from repro_torch.serving import (KMeansServer, ServingModel,
                                     candidate_table, closure_assign,
                                     closure_sqdist, default_n_candidates,
                                     default_n_groups)
    t_phase = time.perf_counter()
    n = x.shape[0]
    dev = x.device
    c = model.centroids_
    print(f"phase 14: serving at full size (phase 5's fused AAKMeans, "
          f"K={MAIN_K}; the default closure index; KMeansServer at batch "
          f"{SERVE_BATCH})")

    def agrees(got, want, rows, cents):
        """Host labels ``got`` against ``want`` for the rows ``rows``
        (device indices): (equal, the largest near-tie gap where they
        differ, rows that differ)."""
        if np.array_equal(got, want):
            return True, 0.0, 0
        g = torch.from_numpy(np.asarray(got, np.int32)).to(dev)[None]
        w = torch.from_numpy(np.asarray(want, np.int32)).to(dev)[None]
        _, gap = tie_gap(g, w, x[rows], cents[None])
        return False, gap, int((g != w).sum())

    zero_counts()
    # (a) the index and approximate predict on all rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.build_serving_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    idx = model.closure_index_
    print(f"  (a) build_serving_index() {build_s!r} s: G={idx.n_groups}, "
          f"C={idx.n_candidates}")
    check((idx.n_groups, idx.n_candidates) == (
        default_n_groups(MAIN_K), default_n_candidates(MAIN_K)) == (124, 512),
          "the default index is not G = 124, C = 512")
    t0 = time.perf_counter()
    lab_exact = model.predict(x)
    exact_s = time.perf_counter() - t0
    check(np.array_equal(lab_exact, labels),
          "exact predict differs from phase 5's")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lab_apx = model.predict(x, approx=True)
    approx_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    recall = float(np.mean(lab_apx == lab_exact))
    # every difference: the exact label is absent from the row's router's
    # closure (routed as predict routes, chunk by chunk), or a near tie
    diff = np.nonzero(lab_apx != lab_exact)[0]
    routers, cands = idx.routers, idx.candidates
    g_all = torch.empty(n, dtype=torch.int64, device=dev)
    for i in range(0, n, PREDICT_CHUNK):
        xc = pad_rows(x[i:i + PREDICT_CHUNK], PREDICT_CHUNK)
        m = min(PREDICT_CHUNK, n - i)
        g_all[i:i + m] = torch.argmin(pairwise_sqdist(xc, routers),
                                      dim=1)[:m]
    rows_d = torch.from_numpy(diff).to(dev)
    exact_d = torch.from_numpy(lab_exact[diff]).to(dev).long()
    in_closure = (cands[g_all[rows_d]].long() == exact_d[:, None]).any(1)
    n_in = int(in_closure.sum())
    gap_in = 0.0
    if n_in:
        sel = rows_d[in_closure]
        _, gap_in = tie_gap(
            torch.from_numpy(lab_apx[diff]).to(dev)[in_closure][None],
            exact_d[in_closure].to(torch.int32)[None], x[sel], c[None])
    print(f"  (a) exact predict {exact_s!r} s ({n / exact_s!r} rows/s); "
          f"approx predict {approx_s!r} s ({n / approx_s!r} rows/s), peak "
          f"device memory {peak / 1e6!r} MB above the start; recall "
          f"{recall!r} ({len(diff)} rows differ: {len(diff) - n_in} with "
          f"the exact label outside their router's closure, {n_in} inside "
          f"it at a near-tie gap of at most {gap_in:.2e})", flush=True)
    check(n_in == 0 or gap_in <= 1e-5,
          "an approximate label differs where the exact one was a "
          "candidate, beyond a near tie")

    # (b) the candidate-count sweep on a seeded sample
    gen = torch.Generator(device=dev).manual_seed(14)
    sel = torch.randperm(n, generator=gen, device=dev)[:SERVE_SAMPLE]
    sel_np = sel.cpu().numpy()
    xs, xs_np, es = x[sel], x_np[sel_np], lab_exact[sel_np]
    batches = [xs_np[i * SERVE_BATCH:(i + 1) * SERVE_BATCH]
               for i in range(SERVE_LAT_ITERS)]

    def latency_ms(sm):
        sm.warmup(SERVE_BATCH)
        ts = []
        for xb in batches:
            t0 = time.perf_counter()
            sm.labels(xb)          # ends in the result's copy to the host
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e3

    exact_ms = latency_ms(ServingModel(c, None))
    recalls = {}
    for cc in SERVE_SWEEP:
        small = idx.shrink(cc)
        tab = candidate_table(c, small.candidates)
        got = torch.cat([closure_assign(xs[i:i + PREDICT_CHUNK], c,
                                        small.routers, small.candidates,
                                        tab)[0]
                         for i in range(0, SERVE_SAMPLE, PREDICT_CHUNK)])
        recalls[cc] = float(np.mean(got.cpu().numpy() == es))
        ms = latency_ms(ServingModel(c, small))
        print(f"  (b) C={cc}: recall {recalls[cc]!r} on {SERVE_SAMPLE} "
              f"sampled rows; ServingModel.labels median {ms!r} ms per "
              f"{SERVE_BATCH}-row batch ({SERVE_LAT_ITERS} batches; the "
              f"exact path {exact_ms!r} ms)", flush=True)
    rs = [recalls[cc] for cc in SERVE_SWEEP]
    check(rs == sorted(rs), f"recall is not monotone in C: {recalls}")

    # (c) bucketed scans equal plain ones, bit for bit
    tab = candidate_table(c, cands)
    full = closure_sqdist(x[:PREDICT_CHUNK], c, routers, cands, tab)
    same = {}
    for rows in (SERVE_BATCH, PREDICT_CHUNK):
        xr = x[:rows]
        l0, d0 = closure_assign(xr, c, routers, cands, tab)
        l1, d1 = closure_assign(xr, c, routers, cands, tab, bucketed=True)
        s0 = closure_sqdist(xr, c, routers, cands, tab)
        s1 = closure_sqdist(xr, c, routers, cands, tab, bucketed=True)
        same[rows] = (torch.equal(l0, l1) and torch.equal(d0, d1)
                      and torch.equal(s0, s1))
    in_chunk = torch.equal(closure_sqdist(x[:SERVE_BATCH], c, routers, cands,
                                          tab, bucketed=True),
                           full[:SERVE_BATCH])
    del full, s0, s1
    print(f"  (c) bucketed equal to plain bit for bit (closure_assign, "
          f"closure_sqdist) at {SERVE_BATCH} and {PREDICT_CHUNK} rows: "
          f"{same}; a {SERVE_BATCH}-row batch's distances equal to the same "
          f"rows' in the {PREDICT_CHUNK}-row chunk: {in_chunk}")
    check(all(same.values()) and in_chunk, "bucketed and plain scans differ")

    # (d) the server under four producers
    rng = np.random.default_rng(14)
    reqs = [(int(s), int(m), bool(t)) for s, m, t in zip(
        rng.integers(0, n - 512, SERVE_REQUESTS),
        rng.integers(1, 513, SERVE_REQUESTS),
        rng.random(SERVE_REQUESTS) < 0.1)]

    def drive(srv, jobs, producers):
        """-> ({request: answer}, errors, wall s)."""
        answers, errors = {}, []

        def produce(part):
            for j in part:
                s, m, t = jobs[j]
                try:
                    f = srv.submit(x_np[s:s + m],
                                   op="transform" if t else "labels")
                    answers[j] = f.result(timeout=60)
                except Exception as e:   # noqa: BLE001 — counted
                    errors.append(e)
        threads = [threading.Thread(target=produce,
                                    args=(range(p, len(jobs), producers),))
                   for p in range(producers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a producer hung")
        return answers, errors, wall

    sink = CollectMetrics()
    with KMeansServer(model, batch_size=SERVE_BATCH, metrics=sink) as srv:
        check(srv._model.approx and srv._model.device.type == "cuda",
              "the server does not serve the index on the card")
        answers, errors, wall = drive(srv, reqs, 4)
    check(not errors and len(answers) == SERVE_REQUESTS,
          f"{len(errors)} requests failed, {len(answers)} answered")
    worst, n_diff = 0.0, 0
    for j, (s, m, t) in enumerate(reqs):
        got = answers[j]
        if t:
            check(got.shape == (m, MAIN_K), "a transform's shape")
            got = np.argmin(got, axis=1).astype(np.int32)
        else:
            check(got.shape == (m,) and got.dtype == np.int32,
                  "a label request's shape")
        eq, gap, nd = agrees(got, lab_apx[s:s + m],
                             torch.arange(s, s + m, device=dev), c)
        worst, n_diff = max(worst, gap), n_diff + nd
    recs = [r for _, r in sink.records if "serve_latency_s" in r]
    lat = sorted(r["serve_latency_s"] for r in recs)
    rows_total = sum(m for _, m, _ in reqs)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    mean_rows = sum(r["batch_rows"] for r in recs) / len(recs)
    print(f"  (d) {SERVE_REQUESTS} requests ({sum(t for *_, t in reqs)} "
          f"transforms, {rows_total} rows) from 4 producers in {wall!r} s: "
          f"{SERVE_REQUESTS / wall!r} requests/s, {rows_total / wall!r} "
          f"rows/s; {len(recs)} micro-batches, mean batch_rows "
          f"{mean_rows!r}; serve_latency_s p50 {p50!r}, p99 {p99!r}; answers "
          f"against predict(approx=True): {n_diff} labels differ, near-tie "
          f"gap at most {worst:.2e}", flush=True)
    check(worst <= 1e-5, "served labels differ beyond a near tie")
    short = reqs[:SERVE_EXACT_REQUESTS]
    with KMeansServer(model, batch_size=SERVE_BATCH, approx=False) as srv:
        check(not srv._model.approx, "approx=False serves the index")
        answers, errors, wall = drive(srv, short, 4)
    check(not errors and len(answers) == len(short), "exact requests failed")
    worst, n_diff = 0.0, 0
    for j, (s, m, t) in enumerate(short):
        # the server's blocks are SERVE_BATCH rows: price the request the
        # same way, so each row meets the same product
        xb = pad_rows(x[s:s + m], -(-m // SERVE_BATCH) * SERVE_BATCH)
        want = torch.cat([torch.argmin(pairwise_sqdist(
            xb[i:i + SERVE_BATCH], c), dim=1)
            for i in range(0, xb.shape[0], SERVE_BATCH)])[:m]
        got = answers[j]
        if t:
            got = np.argmin(got, axis=1).astype(np.int32)
        check(np.array_equal(got, want.cpu().numpy()),
              "the exact server's labels are not argmin(pairwise_sqdist)")
        _, gap, nd = agrees(got, labels[s:s + m],
                            torch.arange(s, s + m, device=dev), c)
        worst, n_diff = max(worst, gap), n_diff + nd
    print(f"  (d) approx=False: {len(short)} requests in {wall!r} s, labels "
          f"equal to argmin(pairwise_sqdist) exactly; against phase 5's "
          f"assignment-kernel labels {n_diff} differ, near-tie gap at most "
          f"{worst:.2e}", flush=True)
    check(worst <= 1e-5, "the exact server differs from phase 5's labels")

    # (e) hot reload under traffic to phase 11's model
    model_mb.build_serving_index()
    lab_mb = model_mb.predict(x, approx=True)
    wants = ((lab_apx, c), (lab_mb, model_mb.centroids_))
    sink = CollectMetrics()
    with tempfile.TemporaryDirectory() as tmp:
        p = model.save(Path(tmp) / "serve")
        stop = threading.Event()
        got_reqs, errors = [], []
        with KMeansServer(p, batch_size=SERVE_BATCH, poll_s=0.05,
                          metrics=sink) as srv:
            def traffic(seed):
                r = np.random.default_rng(seed)
                while not stop.is_set():
                    s, m = int(r.integers(0, n - 512)), int(r.integers(1, 513))
                    try:
                        got_reqs.append((s, m, srv.predict(x_np[s:s + m],
                                                           timeout=60)))
                    except Exception as e:   # noqa: BLE001 — counted
                        errors.append(e)
            threads = [threading.Thread(target=traffic, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            try:
                time.sleep(0.5)
                model_mb.save(p)
                deadline = time.time() + 30
                while srv.reload_count == 0 and time.time() < deadline:
                    time.sleep(0.02)
                time.sleep(0.5)
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=120)
            check(not any(t.is_alive() for t in threads), "traffic hung")
            check(srv.reload_count == 1 and srv.last_reload_error is None,
                  f"reload_count {srv.reload_count}, error "
                  f"{srv.last_reload_error!r}")
            after = srv.predict(x_np[:SERVE_BATCH * 4], timeout=60)
    check(not errors, f"{len(errors)} requests failed across the reload")
    which = []
    for s, m, got in got_reqs:
        rows = torch.arange(s, s + m, device=dev)
        hit = [i for i, (w, cw) in enumerate(wants)
               if agrees(got, w[s:s + m], rows, cw)[1] <= 1e-5]
        check(len(hit) >= 1, "a request was answered by neither model")
        which.append(hit[0])
    first_new = which.index(1) if 1 in which else len(which)
    n_old_after = sum(1 for w in which[first_new:] if w == 0)
    eq, gap, _ = agrees(after, lab_mb[:SERVE_BATCH * 4],
                        torch.arange(SERVE_BATCH * 4, device=dev),
                        model_mb.centroids_)
    reload_s = [r["reload_s"] for _, r in sink.records if "reload_s" in r]
    print(f"  (e) hot reload under traffic: {len(got_reqs)} requests, none "
          f"failed, {which.count(0)} answered by phase 5's model and "
          f"{which.count(1)} by phase 11's ({n_old_after} old answers after "
          f"the first new one, from batches already running); reload_s "
          f"{reload_s!r}; after the swap equal to phase 11's model: {eq} "
          f"(near-tie gap {gap:.2e})", flush=True)
    check(1 in which and gap <= 1e-5, "the new model does not answer")
    counts, plain = read_counts()
    path_launches["serving: exact predict beside approx"] = counts
    chunks = -(-n // PREDICT_CHUNK)
    print(f"  assignment launches {counts['assignment']} vs exact predict "
          f"chunks {chunks}; other kernels "
          f"{ {k: v for k, v in counts.items() if k != 'assignment'} }; "
          f"plain-version calls {plain}", flush=True)
    check(counts["assignment"] == chunks and plain == 0
          and sum(counts.values()) == chunks,
          "phase 14 ran another kernel or a plain version")
    print(f"  phase 14 took {time.perf_counter() - t_phase!r} s")
    return counts["assignment"]


class RoundProbe:
    """A metrics sink for the hierarchy's round loop: each round's
    scalars beside the kernels' launch counts when it was logged."""

    def __init__(self, read_counts):
        self.read_counts = read_counts
        self.rounds = []

    def log_scalars(self, step, scalars):
        counts, plain = self.read_counts()
        self.rounds.append((int(step),
                            {k: float(v) for k, v in scalars.items()},
                            counts, plain))


def phase15(torch, dev, x, c0_main, model5, fit5_s, zero_counts,
            read_counts, path_launches):
    """The two-level solve at full size: (a) AAKMeans(K=65536,
    backend="fused", hierarchical=True) with its seeding, super-solve and
    partition replayed apart and timed; (b) exact predict at K = 65,536,
    the free serving index, approximate predict; (c) K = 1000 against
    phase 5's flat fit; (d) G = 1 against the flat batched solve, bit for
    bit; (e) round-granular resume, bit for bit; (f) a padded group
    against the same rows alone; (g) the KV-cache and embedding
    codebooks at Llama 3 8B's widths.  Each path's kernels against their
    plain versions at its shapes.  -> (the phase's launches per kernel,
    {kernel: largest max-abs error of its checks})."""
    import os
    import tempfile

    import numpy as np
    from repro_torch.core import (AAKMeans, KMeansConfig, aa_kmeans,
                                  aa_kmeans_batched, aa_kmeans_hierarchical,
                                  select_best)
    from repro_torch.core import applications as app
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.core.hierarchy import _partition, default_n_groups
    from repro_torch.core.init_schemes import batched_init, kmeanspp_init
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U
    from repro_torch.serving import hierarchy_closure_index
    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize
    n, d = x.shape
    k = HIER_K
    g = default_n_groups(k)
    k_sub = k // g
    errs = {"fused_lloyd": 0.0, "assignment": 0.0, "update": 0.0}
    launches = {}

    def record(path, counts):
        path_launches[path] = counts
        for kn, v in counts.items():
            launches[kn] = launches.get(kn, 0) + v

    print(f"phase 15: {nvidia_smi_line()}")
    print(f"  the two-level solve at full size (AAKMeans("
          f"n_clusters={k}, backend='fused', hierarchical=True, max_iter "
          f"500, seed 0): G={g}, K/G={k_sub}, n_reassign 2, super_max_iter "
          f"50, n_init 1) on {MAIN_N_NAME} {tuple(x.shape)}")
    check(g == 256 and k_sub == 256, "default_n_groups(65536) is not 256")

    # the fit's first steps replayed apart, drawing from a generator as
    # the fit does: the super seeds, the super-solve, the partition and
    # the sub-problems' seeds
    cfg = KMeansConfig(k=k)
    gen = torch.Generator(device=dev).manual_seed(0)
    sync()
    t0 = time.perf_counter()
    c0_super = kmeanspp_init(gen, x, g)
    sync()
    super_seed_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    sup = aa_kmeans(x, c0_super, dataclasses.replace(cfg, k=g, max_iter=50),
                    backend="fused")
    sync()
    super_s = time.perf_counter() - t0
    super_counts, _ = read_counts()
    super_fused = super_counts["fused_lloyd"]
    t0 = time.perf_counter()
    ls0 = sup.labels.to(torch.int32)
    xg, wg, _, n_max = _partition(x, ls0, g, k_sub, 256)
    sync()
    part_s = time.perf_counter() - t0
    sizes = torch.bincount(ls0.long(), minlength=g)
    part_bytes = xg.numel() * xg.element_size() \
        + wg.numel() * wg.element_size()
    t0 = time.perf_counter()
    c0s = batched_init("kmeans++", gen, xg, k_sub, g, weights=wg)
    sync()
    sub_seed_s = time.perf_counter() - t0
    del c0s
    print(f"  super-solve: kmeans++ of {g} routers {super_seed_s!r} s; "
          f"aa_kmeans at K={g} {super_s!r} s, n_iter {int(sup.n_iter)}, "
          f"n_accepted {int(sup.n_accepted)}, {super_fused} fused launches "
          f"({super_fused - 1} trips, {super_s / super_fused * 1e3!r} ms a "
          f"launch)")
    print(f"  partition {part_s!r} s: groups of {int(sizes.min())} to "
          f"{int(sizes.max())} rows (median {int(sizes.median())}); N_max "
          f"{n_max}, G*N_max = {g * n_max} rows, padding share "
          f"{g * n_max / n!r} of N, (xg, wg) {part_bytes / 1e9!r} GB; "
          f"sub-problem seeding ({g} weighted kmeans++ of {k_sub}) "
          f"{sub_seed_s!r} s", flush=True)

    # (a) the estimator's fit
    probe = RoundProbe(read_counts)
    sync()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    model = AAKMeans(n_clusters=k, backend="fused", hierarchical=True,
                     max_iter=500, seed=0, metrics=probe).fit(x)
    sync()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    counts, plain = read_counts()
    record("hierarchical fit (15a)", counts)
    prev = {"fused_lloyd": super_fused}
    print(f"  (a) fit {fit_s!r} s (seeding included), peak device memory "
          f"{peak / 1e9!r} GB above the start; n_iter_ (rounds) "
          f"{model.n_iter_}, n_accepted_ {model.n_accepted_}, inertia_ "
          f"{model.inertia_!r}")
    for r, sc, cnt, _ in probe.rounds:
        fused_r = cnt["fused_lloyd"] - prev["fused_lloyd"]
        print(f"    round {r}: {fused_r} fused launches ({fused_r - 1} "
              f"trips of the batched sub-solve), assignment "
              f"{cnt['assignment']}, update {cnt['update']} so far; energy "
              f"{sc['energy']!r}, energy_best {sc['energy_best']!r}, "
              f"moved_frac {sc['moved_frac']!r}, n_max {int(sc['n_max'])}, "
              f"round_s {sc['round_s']!r}")
        prev = cnt
    print(f"  (a) launches {counts}; plain-version calls {plain}",
          flush=True)
    check(counts["fused_lloyd"] > super_fused and counts["assignment"] > 0
          and counts["update"] > 0 and counts["fused_bounds"] == 0,
          "the hierarchical fit did not launch the fused, assignment and "
          "update kernels")
    check(plain == 0, "the hierarchical fit called a plain version")
    check(np.isfinite(model.inertia_), "the hierarchical energy")
    check(int(probe.rounds[0][1]["n_max"]) == n_max,
          "the replayed partition is not the fit's")
    check(model.inertia_ <= probe.rounds[0][1]["energy"],
          "the returned energy is above round 0's")
    check(model.inertia_ == probe.rounds[-1][1]["energy_best"],
          "the returned energy is not the best round's")
    # every row's label in its super-group's block: the best round's
    # super-labels are the super-solve's (round 0) or the nearest
    # router's (a reassignment round)
    grp = (model.labels_ // k_sub).to(torch.int32)
    near = A.assignment(x, model.hier_routers_)[0]
    in_block = torch.equal(grp, near) or torch.equal(grp, ls0)
    print(f"  (a) labels_ // K/G equal to the routers' assignment "
          f"{torch.equal(grp, near)}, to the super-solve's labels "
          f"{torch.equal(grp, ls0)}")
    check(in_block, "a row's label is outside its super-group's block")
    # the path's kernels against their plain versions at its shapes (after
    # the counts were read): the fused step on the round-0 partition at
    # the fitted sub-codebooks, the assignment of all rows to the routers,
    # the routers' segment sum
    cg = model.centroids_.reshape(g, k_sub, d)
    got, want = F.fused_lloyd(xg, cg, wg), F.fused_lloyd_plain(xg, cg, wg)
    res = rescale_to_norms(torch, compare(torch, got, want, xg, cg, wg),
                           got, want, xg, cg)
    del got, want
    print(f"  fused vs plain at the sub-solve's shape ({g} x {n_max} x {d}, "
          f"K/G={k_sub}, weighted): {fmt(res)}")
    accept(res, "fused at the sub-solve's shape")
    errs["fused_lloyd"] = res["mind_abs"]
    # the kernel's share of a reassignment round's trip (after the counts
    # were read): its time at this shape beside the round's wall per
    # launch, and its bound on all G*N_max rows, padding included
    sub_ms = event_ms(torch, lambda i: F.fused_lloyd(xg, cg, wg), 3,
                      warmup=1)
    rows_p = g * n_max
    sub_bound = distance_bound_ms(
        4 * (rows_p * (d + 1) + g * k_sub * d)
        + 4 * (2 * rows_p + g * k_sub * (d + 1) + g),
        2 * rows_p * k_sub * d, 3 * rows_p * k_sub + 2 * rows_p * d)
    r1 = [(sc["round_s"], cnt["fused_lloyd"] - prv["fused_lloyd"])
          for (_, sc, cnt, _), (_, _, prv, _) in zip(probe.rounds[1:],
                                                     probe.rounds)]
    trip_ms = [1e3 * t / nl for t, nl in r1]
    print(f"  the fused kernel at the sub-solve's shape: {sub_ms!r} ms "
          f"(CUDA events), bound {sub_bound[0]!r} ms ({sub_bound[1]}; "
          f"FP32-core bound {sub_bound[2]!r} ms) on the {rows_p} padded "
          f"rows, {sub_bound[0] * n / rows_p!r} ms on the live ones; "
          f"reassignment rounds' wall per fused launch {trip_ms!r} ms, "
          f"so the kernel is {[sub_ms / t for t in trip_ms]!r} of a trip",
          flush=True)
    del xg, wg
    r_p = model.hier_routers_[None]
    got, want = A.assignment(x, r_p), A.assignment_plain(x, r_p)
    res = rescale_to_norms(torch, compare(torch, got, want, x, r_p, None),
                           got, want, x, r_p)
    print(f"  assignment vs plain at the reassignment's shape (all rows, "
          f"K={g}): {fmt(res)}")
    accept(res, "assignment at the reassignment's shape")
    errs["assignment"] = res["mind_abs"]
    res_u = compare_stats(U.update(x, near, g), U.update_plain(x, near, g))
    print(f"  update vs plain at the routers' shape (all rows into {g}): "
          f"sums {res_u['sums_rel']:.2e} (abs {res_u['sums_abs']:.2e}), "
          f"counts {res_u['counts_rel']:.2e}")
    accept_stats(res_u, "update at the routers' shape")
    errs["update"] = res_u["sums_abs"]
    sys.stdout.flush()

    # (b) exact predict at K = 65,536, the free index, approximate predict
    zero_counts()
    sync()
    t0 = time.perf_counter()
    labels = model.predict(x)
    exact_s = time.perf_counter() - t0
    counts, plain = read_counts()
    record("hierarchical predict (15b)", counts)
    chunks = -(-n // PREDICT_CHUNK)
    lab_t = torch.from_numpy(labels).to(dev).long()

    def energy_of(lab):
        return float(sum(torch.sum((x[i:i + PREDICT_CHUNK] - model.centroids_[
            lab[i:i + PREDICT_CHUNK]]) ** 2, dtype=torch.float64)
            for i in range(0, n, PREDICT_CHUNK)))

    e_pred, e_fit = energy_of(lab_t), energy_of(model.labels_.long())
    print(f"  (b) exact predict {exact_s!r} s ({n / exact_s!r} rows/s), "
          f"{counts['assignment']} assignment launches vs {chunks} chunks, "
          f"plain-version calls {plain}; energy of its labels {e_pred!r} "
          f"against the fit's labels' {e_fit!r} (f64 sums of f32 rows), "
          f"{int((lab_t != model.labels_).sum())} rows relabelled")
    check(counts["assignment"] == chunks and plain == 0
          and sum(counts.values()) == chunks, "exact predict's launches")
    check(e_pred <= e_fit * (1 + 1e-6), "predict's energy is above the fit's")
    xc, c_p = x[:PREDICT_CHUNK], model.centroids_[None]
    got = tuple(o[None] for o in A.assignment(xc, model.centroids_))
    want = tuple(o[None] for o in A.assignment_plain(xc, model.centroids_))
    res = rescale_to_norms(torch, compare(torch, got, want, xc, c_p, None),
                           got, want, xc, c_p)
    del got, want
    print(f"  (b) assignment vs plain on one {PREDICT_CHUNK}-row chunk at "
          f"K={k}: {fmt(res)}")
    accept(res, f"assignment at K={k}")
    errs["assignment"] = max(errs["assignment"], res["mind_abs"])
    zero_counts()
    sync()
    t0 = time.perf_counter()
    model.build_serving_index()
    sync()
    build_s = time.perf_counter() - t0
    counts, _ = read_counts()
    idx = model.closure_index_
    free = hierarchy_closure_index(model.centroids_, model.hier_routers_,
                                   model.hier_offsets_)
    free_ok = torch.equal(idx.routers, model.hier_routers_) and \
        torch.equal(idx.candidates, free.candidates)
    print(f"  (b) build_serving_index() {build_s!r} s: G={idx.n_groups}, "
          f"C={idx.n_candidates}; the hierarchy's own routing "
          f"(routers are hier_routers_, candidates each group's rows "
          f"nearest-first) {free_ok}; kernel launches {sum(counts.values())}")
    check(free_ok and sum(counts.values()) == 0 and idx.n_groups == g,
          "build_serving_index did not take the hierarchical branch")
    sync()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lab_apx = model.predict(x, approx=True)
    approx_s = time.perf_counter() - t0
    peak_apx = torch.cuda.max_memory_allocated() - mem0
    recall = float(np.mean(lab_apx == labels))
    print(f"  (b) predict(approx=True) {approx_s!r} s ({n / approx_s!r} "
          f"rows/s), recall {recall!r} against exact predict, peak device "
          f"memory {peak_apx / 1e6!r} MB above the start; exact/approx "
          f"time {exact_s / approx_s!r}", flush=True)
    print(f"  (b) approximate labels equal to the fit's labels_ on "
          f"{float(np.mean(lab_apx == model.labels_.cpu().numpy()))!r} of "
          f"rows")
    check(recall > 0.5, "approximate predict's recall")
    del lab_t

    # (c) K = 1000 two-level against phase 5's flat fit
    zero_counts()
    sync()
    t0 = time.perf_counter()
    m1000 = AAKMeans(n_clusters=MAIN_K, backend="fused",
                     hierarchical=True).fit(x)
    sync()
    fit1000_s = time.perf_counter() - t0
    counts, plain = read_counts()
    record("hierarchical fit at K=1000 (15c)", counts)
    print(f"  (c) K={MAIN_K} two-level (G={default_n_groups(MAIN_K)}, "
          f"K/G={MAIN_K // default_n_groups(MAIN_K)}): fit {fit1000_s!r} s, "
          f"rounds {m1000.n_iter_}, inertia_ {m1000.inertia_!r}; phase 5's "
          f"flat fit {fit5_s!r} s, inertia_ {model5.inertia_!r}: time "
          f"ratio {fit1000_s / fit5_s!r}, energy ratio "
          f"{m1000.inertia_ / model5.inertia_!r}; launches {counts}, plain "
          f"{plain}", flush=True)
    check(plain == 0 and np.isfinite(m1000.inertia_), "(c) K = 1000")
    del m1000

    # (d) G = 1 is the flat batched solve, bit for bit
    cfg_cut = KMeansConfig(k=MAIN_K, max_iter=HIER_CUT_ITER)
    zero_counts()
    t0 = time.perf_counter()
    r1 = aa_kmeans_hierarchical(x, MAIN_K, cfg_cut, "fused", n_groups=1,
                                c0s=c0_main[None])
    flat = select_best(aa_kmeans_batched(x, c0_main[None], cfg_cut,
                                         backend="fused"))
    sync()
    counts, plain = read_counts()
    record("G=1 against the flat solve (15d)", counts)
    same = {"centroids": torch.equal(r1.centroids, flat.centroids),
            "labels": torch.equal(r1.labels, flat.labels),
            "energy": torch.equal(r1.energy, flat.energy),
            "sub_energies": torch.equal(r1.sub_energies, flat.energy[None]),
            "labels_super": not bool(r1.labels_super.any()),
            "group_offsets": r1.group_offsets.tolist() == [0, MAIN_K],
            "n_rounds": r1.n_rounds == 0}
    print(f"  (d) G=1 from phase 5's seeds (max_iter {HIER_CUT_ITER}, cut) "
          f"against select_best(aa_kmeans_batched): {same}; "
          f"{time.perf_counter() - t0!r} s for both; launches {counts}, "
          f"plain {plain}", flush=True)
    check(all(same.values()) and plain == 0, "G = 1 is not the flat solve")
    del r1, flat

    # (e) round-granular resume of (a)'s configuration at a cut depth
    cfg_e = KMeansConfig(k=k, max_iter=HIER_CUT_ITER)
    probe_e = RoundProbe(read_counts)
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        full = aa_kmeans_hierarchical(x, k, cfg_e, "fused", seed=0,
                                      checkpoint_dir=tmp, metrics=probe_e)
        sync()
        full_s = time.perf_counter() - t0
        snaps = sorted(p for p in os.listdir(tmp) if p.endswith(".npz"))
        sizes_b = [os.path.getsize(os.path.join(tmp, p)) for p in snaps]
        t0 = time.perf_counter()
        resumed = aa_kmeans_hierarchical(x, k, cfg_e, "fused", seed=0,
                                         resume_from=os.path.join(
                                             tmp, snaps[0]))
        sync()
        resume_s = time.perf_counter() - t0
    counts, plain = read_counts()
    record("hierarchical checkpointed and resumed (15e)", counts)
    same = {f: (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
            for f, a, b in zip(full._fields, full, resumed)}
    sub_rel = abs(float(full.sub_energies.sum()) - float(full.energy)) \
        / float(full.energy)
    print(f"  (e) max_iter {HIER_CUT_ITER} (cut): {full.n_rounds} rounds, "
          f"energy {float(full.energy)!r} in {full_s!r} s; snapshots "
          f"{snaps}, bytes {sizes_b}, each write "
          f"{[r[1].get('snapshot_s') for r in probe_e.rounds]!r} s; resumed "
          f"from round 0's in {resume_s!r} s, equal bit for bit {same}; "
          f"sub-energies sum to the energy within {sub_rel:.2e}; launches "
          f"{counts}, plain {plain}", flush=True)
    check(all(same.values()), "the resumed run differs")
    check(plain == 0, "(e) called a plain version")
    check(sub_rel <= 1e-6, "the sub-energies do not sum to the energy")
    check(torch.equal(full.labels // k_sub, full.labels_super),
          "a row's label is outside its super-group's block")
    check(float(full.energy) <= probe_e.rounds[0][1]["energy"],
          "(e): the returned energy is above round 0's")
    del full, resumed

    # (f) a padded group against its rows alone, from the same seeds
    order = torch.argsort(sizes)
    small, large = int(order[0]), int(order[-1])
    rows = torch.nonzero(ls0 == small)[:, 0]
    pair = torch.cat([rows, torch.nonzero(ls0 == large)[:, 0]])
    lab2 = torch.cat([torch.zeros(rows.shape[0], dtype=torch.int32,
                                  device=dev),
                      torch.ones(pair.shape[0] - rows.shape[0],
                                 dtype=torch.int32, device=dev)])
    xg2, wg2, _, n_max2 = _partition(x[pair], lab2, 2, k_sub, 256)
    c02 = batched_init("kmeans++", torch.Generator(device=dev).manual_seed(1),
                       xg2, k_sub, 2, weights=wg2)
    cfg_f = KMeansConfig(k=k_sub, max_iter=HIER_PAD_ITER)
    m = rows.shape[0]

    def apart(a, b):
        """(bit for bit, largest difference relative to b's scale)."""
        return torch.equal(a, b), float((a - b).abs().max()
                                        / b.abs().max().clamp_min(1e-30))

    zero_counts()
    # one step from the seeds: the kernel's part, before any Anderson
    # extrapolation; then the solve with plain Lloyd steps through the
    # same driver, and with Anderson's
    step_p = F.fused_lloyd(xg2, c02, wg2)
    step_a = F.fused_lloyd(x[rows], c02[0])
    solves = {}
    for label, acc in (("Lloyd", False), ("AA", True)):
        cfg_s = dataclasses.replace(cfg_f, accelerated=acc)
        solves[label] = (
            aa_kmeans_batched(xg2, c02, cfg_s, backend="fused", weights=wg2),
            aa_kmeans_batched(x[rows], c02[:1], cfg_s, backend="fused"))
    counts, plain = read_counts()
    record("padded against unpadded (15f)", counts)
    step_lab = torch.equal(step_p[0][0, :m], step_a[0])
    step_s, step_c, step_e = (apart(step_p[i][0], step_a[i])
                              for i in (2, 3, 4))
    print(f"  (f) group {small} ({m} rows, padded to {n_max2} beside group "
          f"{large}'s {pair.shape[0] - m}), from the same seeds: one fused "
          f"step: labels equal {step_lab}, sums bit for bit {step_s[0]} "
          f"({step_s[1]:.2e} of their scale), counts {step_c[0]} "
          f"({step_c[1]:.2e}), energy {step_e[0]} ({step_e[1]:.2e}); "
          f"plain {plain}")
    check(step_lab and plain == 0, "a padded step's labels differ")
    check(max(step_s[1], step_c[1], step_e[1]) <= 1e-6,
          "a padded step's stats differ beyond 1e-6")
    for label, (both, alone) in solves.items():
        lab_eq = torch.equal(both.labels[0, :m], alone.labels[0])
        it_eq = torch.equal(both.n_iter[:1], alone.n_iter)
        c_eq, c_rel = apart(both.centroids[0], alone.centroids[0])
        e_eq, e_rel = apart(both.energy[0], alone.energy[0])
        print(f"  (f) the {label} solve (max_iter {HIER_PAD_ITER}, cut): "
              f"labels equal {lab_eq}, n_iter {both.n_iter[0].item()} / "
              f"{alone.n_iter[0].item()}, centroids bit for bit {c_eq} "
              f"({c_rel:.2e} of their scale), energy bit for bit {e_eq} "
              f"({e_rel:.2e})", flush=True)
        check(lab_eq and it_eq, f"padded and unpadded {label} solves' "
              f"labels or iterations differ")
        check(e_rel <= 1e-6, f"padded and unpadded {label} energies "
              f"differ beyond 1e-6")
        # the segment sum's slabs follow N and R, so the padded sums
        # round otherwise; Lloyd steps keep that at the sums' rounding,
        # Anderson's extrapolation spreads it, so its centroids get only
        # a sanity bound
        check(c_rel <= (1e-6 if label == "Lloyd" else 1e-3),
              f"padded and unpadded {label} centroids differ")
    del xg2, wg2, solves, step_p, step_a

    # (g) the applications at Meta-Llama-3-8B's widths (random values)
    b, t, hkv, hd = LLAMA_KV
    gen_g = torch.Generator(device=dev).manual_seed(0)
    cache = {nm: torch.randn(LLAMA_KV, generator=gen_g, device=dev)
             for nm in ("k", "v")}
    zero_counts()
    sync()
    t0 = time.perf_counter()
    new, err = app.compress_kv_cache(cache, LLAMA_CODES, t)
    sync()
    kv_s = time.perf_counter() - t0
    stacked = torch.stack([cache[nm].reshape(-1, hd) for nm in ("k", "v")])
    cbs, codes, res = app.kv_codebooks_batched(stacked, LLAMA_CODES)
    rec = torch.stack([cbs[i][codes[i].long()] for i in range(2)])
    same_cb = torch.equal(rec[0].reshape(LLAMA_KV), new["k"])
    counts, plain = read_counts()
    check(sum(counts.values()) == 0 and plain == 0,
          "the dense applications launched a kernel or a plain version")
    print(f"  (g) compress_kv_cache (K/V {LLAMA_KV}, valid_len {t}, "
          f"k={LLAMA_CODES}; dense, R = 2): {kv_s!r} s, relative error "
          f"{err!r}; its solve repeated by kv_codebooks_batched: n_iter "
          f"{res.n_iter.tolist()}, n_accepted {res.n_accepted.tolist()}, "
          f"the same reconstruction {same_cb}")
    check(same_cb and 0.0 < err < 1.0, "compress_kv_cache")
    zero_counts()
    sync()
    t0 = time.perf_counter()
    cbs, codes, res = app.kv_codebooks_batched(stacked, LLAMA_CODES,
                                               backend="fused")
    sync()
    kvb_s = time.perf_counter() - t0
    rec = torch.stack([cbs[i][codes[i].long()] for i in range(2)])
    kvb_err = float(torch.linalg.norm(rec - stacked)
                    / torch.linalg.norm(stacked))
    counts, plain = read_counts()
    record("kv_codebooks_batched fused (15g)", counts)
    print(f"  (g) kv_codebooks_batched({tuple(stacked.shape)}, "
          f"k={LLAMA_CODES}, backend='fused'): {kvb_s!r} s, n_iter "
          f"{res.n_iter.tolist()}, n_accepted {res.n_accepted.tolist()}, "
          f"relative error {kvb_err!r}; fused launches "
          f"{counts['fused_lloyd']} (1 + trips), plain {plain}")
    check(counts["fused_lloyd"] > 0 and plain == 0, "kv_codebooks_batched")
    zero_counts()
    sync()
    t0 = time.perf_counter()
    cb, codes, hres = app.kv_codebook_hierarchical(stacked[0], LLAMA_HIER_K,
                                                   backend="fused")
    sync()
    kvh_s = time.perf_counter() - t0
    kvh_err = float(torch.linalg.norm(cb[codes.long()] - stacked[0])
                    / torch.linalg.norm(stacked[0]))
    counts, plain = read_counts()
    record("kv_codebook_hierarchical fused (15g)", counts)
    print(f"  (g) kv_codebook_hierarchical({tuple(stacked[0].shape)}, "
          f"k={LLAMA_HIER_K}, backend='fused'; G="
          f"{hres.routers.shape[0]}): {kvh_s!r} s, rounds {hres.n_rounds}, "
          f"relative error {kvh_err!r}; launches {counts}, plain {plain}")
    check(counts["fused_lloyd"] > 0 and plain == 0,
          "kv_codebook_hierarchical")
    del cache, new, stacked, cb, codes
    table = torch.randn((LLAMA_VOCAB, LLAMA_HIDDEN), generator=gen_g,
                        device=dev)
    zero_counts()
    sync()
    t0 = time.perf_counter()
    cbs, codes, emb_err = app.embedding_codebook(table, LLAMA_CODES,
                                                 n_subspaces=4)
    sync()
    emb_s = time.perf_counter() - t0
    blocks = app._subspace_blocks(table, 4)
    cbs2, _, res = app.kv_codebooks_batched(blocks, LLAMA_CODES)
    counts, plain = read_counts()
    check(sum(counts.values()) == 0 and plain == 0,
          "embedding_codebook launched a kernel or a plain version")
    print(f"  (g) embedding_codebook({tuple(table.shape)}, k={LLAMA_CODES}, "
          f"n_subspaces 4; dense, R = 4): {emb_s!r} s, relative error "
          f"{emb_err!r}; its solve repeated by kv_codebooks_batched on the "
          f"subspace blocks: n_iter {res.n_iter.tolist()}, the same "
          f"codebooks {torch.equal(cbs, cbs2)}", flush=True)
    check(torch.equal(cbs, cbs2) and 0.0 < emb_err < 1.0,
          "embedding_codebook")
    del table, blocks, cbs, cbs2
    print(f"  phase 15 launches {launches}; took "
          f"{time.perf_counter() - t_phase!r} s")
    return launches, errs


def _dist_counts():
    """Every kernel's launches and plain-version calls so far, in this
    process."""
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U
    return {"fused_lloyd": F.launches, "assignment": A.launches,
            "update": U.launches, "fused_bounds": F.bounds_launches,
            "plain": F.plain_calls + A.plain_calls + U.plain_calls
            + F.bounds_plain_calls}


def _dist_delta(before):
    now = _dist_counts()
    return {key: now[key] - before[key] for key in now}


def _rank16(rank, world, pg, tmp, cfg):
    """One rank of phase 16, in a spawned child: the process group over
    ``pg`` ("gloo": both ranks on the card, its tensors staged through
    the host; "nccl"), a one-dim mesh on ``cfg["device"]`` ("cuda"), the
    rank's work, its results saved for the parent.  ``cfg`` carries the
    parent's sizes, since a spawned child imports this file anew."""
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    tmp = Path(tmp)
    if cfg["device"] == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        pg, init_method=f"file://{tmp / f'store{world}'}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=cfg["timeout"]),
        device_id=torch.device("cuda", 0) if pg == "nccl" else None)
    try:
        mesh = init_device_mesh(cfg["device"], (world,),
                                mesh_dim_names=("data",))
        out = _ranks16(torch, world, mesh, tmp, cfg)
        torch.save(out, tmp / f"out{world}_{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _ranks16(torch, world, mesh, tmp, cfg):
    """What every rank of phase 16 runs; -> its results (host tensors,
    numbers, launch and collective counts)."""
    import numpy as np
    from repro_torch.core import AAKMeans, MiniBatchAAKMeans, get_backend
    from repro_torch.core import distributed as D
    from repro_torch.core.backends import distribute
    from repro_torch.core.backends.bounds import extract_stats
    from repro_torch.core.kmeans import (KMeansConfig,
                                         aa_kmeans_minibatch_streamed)
    from repro_torch.core.minibatch import MiniBatchConfig
    from repro_torch.device import mesh_device
    from repro_torch.runtime import CollectMetrics, IngestMeter
    dev = mesh_device(mesh)
    x_np = np.load(tmp / "x.npy", mmap_mode="r")
    c0, c0b, c_fin, c_next = (
        torch.from_numpy(np.load(tmp / f"{name}.npy")).to(dev)
        for name in ("c0", "c0b", "c_fin", "c_next"))
    n, k, axes = x_np.shape[0], cfg["k"], ("data",)
    out = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def host(res):
        return [t.cpu() if isinstance(t, torch.Tensor) else t for t in res]

    def padding_weights(r, pad):
        """(r, N + pad) weights, 0 on the rows that pad N to the shard
        count (global; each rank keeps its block)."""
        if not pad:
            return None
        w = torch.ones((r, n + pad))
        w[:, n:] = 0.0
        return w

    # the fit's first step (c0 on every row; the padding at weight 0)
    x_sh, pad = D.shard_dataset(x_np, mesh, axes)
    w = padding_weights(1, pad)
    fused = distribute(get_backend("fused"), axes)
    with D.mesh_scope(mesh):
        res, _ = fused.batched_step(
            x_sh.local, c0[None], k, (),
            w=None if w is None else D.local_block(w, mesh, axes, dim=1))
    out["first_step"] = [t[0].cpu() for t in res[2:]]
    out["pad"] = pad
    del res

    # (a) / (b): the estimator's fit and predict
    def fit_once(timed):
        D.time_collectives(timed)
        D.reset_collective_counts()
        before = _dist_counts()
        sync()
        t0 = time.perf_counter()
        model = AAKMeans(n_clusters=k, backend="fused", mesh=mesh,
                         seed=0, max_iter=cfg["max_iter"]).fit(x_np)
        sync()
        fit_s = time.perf_counter() - t0
        got = {"centroids": model.centroids_.cpu(),
               "labels": model.labels_.cpu(), "energy": model.energy_,
               "n_iter": model.n_iter_, "n_accepted": model.n_accepted_,
               "trips": trips_of(model), "fit_s": fit_s,
               "reduce_s": D.collective_seconds(),
               "collectives": D.collective_counts(),
               "launches": _dist_delta(before)}
        D.time_collectives(False)
        return model, got

    model, out["fit"] = fit_once(False)
    before = _dist_counts()
    t0 = time.perf_counter()
    out["fit"]["predict"] = model.predict(x_np)
    out["fit"]["predict_s"] = time.perf_counter() - t0
    out["fit"]["predict_launches"] = _dist_delta(before)
    del model
    if world > 1:
        # the repeat, with every collective timed (a sync on each side)
        out["repeat"] = fit_once(True)[1]

    # (c) batched restarts, cut at DIST_BATCH_MAX_ITER
    cfg_c = KMeansConfig(k=k, max_iter=cfg["batch_iter"])
    c0s = torch.stack([c0, c0b])
    fit_c = D.make_distributed_kmeans_batched(mesh, cfg_c, axes,
                                              backend="fused")
    out["batched"] = []
    for _ in range(2 if world > 1 else 1):
        D.reset_collective_counts()
        before = _dist_counts()
        t0 = time.perf_counter()
        res = fit_c(x_sh, c0s, padding_weights(2, pad))
        sync()
        out["batched"].append({
            "res": host(res), "wall_s": time.perf_counter() - t0,
            "collectives": D.collective_counts(),
            "launches": _dist_delta(before)})
    del x_sh, res

    # (d) streaming: the estimator (two ranks only), then the streamed
    # driver from host memory
    if world > 1:
        out["minibatch"] = []
        for _ in range(2):
            D.reset_collective_counts()
            before = _dist_counts()
            t0 = time.perf_counter()
            mb = MiniBatchAAKMeans(
                n_clusters=k, chunk_size=cfg["chunk"], epochs=cfg["epochs"],
                val_size=cfg["val"], backend="fused", mesh=mesh,
                seed=0).fit(x_np)
            sync()
            out["minibatch"].append({
                "centroids": mb.centroids_.cpu(), "energy": mb.energy_,
                "n_steps": mb.n_steps_, "n_accepted": mb.n_accepted_,
                "labels": mb.labels_, "wall_s": time.perf_counter() - t0,
                "collectives": D.collective_counts(),
                "launches": _dist_delta(before)})
        del mb
    cfg_s = MiniBatchConfig(k=k, chunk_size=cfg["chunk"],
                            epochs=cfg["stream_epochs"])
    meter = IngestMeter()
    D.reset_collective_counts()
    before = _dist_counts()
    t0 = time.perf_counter()
    res = aa_kmeans_minibatch_streamed(
        x_np[cfg["val"]:], x_np[:cfg["val"]], c0, cfg_s, "fused", seed=0,
        drop_remainder=True, meter=meter, mesh=mesh)
    sync()
    out["streamed"] = {"res": host(res), "wall_s": time.perf_counter() - t0,
                       "ingest": meter.scalars(),
                       "collectives": D.collective_counts(),
                       "launches": _dist_delta(before)}

    # (e) elastic resume, on the first N - N % 2 rows
    # (make_distributed_kmeans takes no weights, so N must divide)
    x_e = x_np[:n - n % 2]
    cfg_e = KMeansConfig(k=k, max_iter=cfg["max_iter"])
    run = tmp / "run16"
    plain_fit = D.make_distributed_kmeans(mesh, cfg_e, axes, backend="fused")
    first = run / f"it_{cfg['every']:08d}.npz"
    if world > 1:
        mx = CollectMetrics()
        D.time_collectives(True)
        D.reset_collective_counts()
        before = _dist_counts()
        t0 = time.perf_counter()
        seg = D.make_distributed_kmeans(
            mesh, cfg_e, axes, backend="fused", checkpoint_every=cfg["every"],
            checkpoint_dir=run, metrics=mx)(x_e, c0)
        sync()
        out["segmented"] = {"res": host(seg),
                            "wall_s": time.perf_counter() - t0,
                            "reduce_s": D.collective_seconds(),
                            "collectives": D.collective_counts(),
                            "records": mx.records,
                            "writes": D._writes(mesh),
                            "launches": _dist_delta(before)}
        D.time_collectives(False)
    before = _dist_counts()
    t0 = time.perf_counter()
    res = plain_fit(x_e, c0, resume_from=first)
    sync()
    out["resumed"] = {"res": host(res), "wall_s": time.perf_counter() - t0,
                      "launches": _dist_delta(before)}

    # (f) the other kernel engines: two steps, from phase 5's last
    # centroids and then from the parent's one Lloyd step past them (the
    # same bits at every world size; the carry runs on), on rows that
    # tile alike at one and two ranks
    x_f = D.local_block(x_np[:n - n % (2 * 64)], mesh, axes)
    out["steps"] = {}
    for name, opts in (("pallas", {}),
                       ("fused_bounds", {"group_size": cfg["gs"]})):
        bk = distribute(get_backend(name, **opts), axes)
        before = _dist_counts()
        with D.mesh_scope(mesh):
            r1, carry = bk.step(x_f, c_fin, k, bk.init_carry(x_f, c_fin, k))
            r2, carry = bk.step(x_f, c_next, k, carry)
        stats = extract_stats(carry)
        out["steps"][name] = {
            "steps": [host((r.labels, r.sums, r.counts, r.energy))
                      for r in (r1, r2)],
            "stats": None if stats is None else host(stats),
            "launches": _dist_delta(before)}
    return out


def _spawn16(torch, world, pg, tmp, cfg):
    """Run phase 16's ranks (spawned children) and wait for them within
    DIST_TIMEOUT; a child that fails or hangs fails the phase.
    -> (each rank's results, wall seconds)."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    ctx = mp.start_processes(_rank16, args=(world, pg, str(tmp), cfg),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise PhaseError(f"phase 16: the {world}-rank group passed its "
                             f"{DIST_TIMEOUT} s limit")
    return ([torch.load(tmp / f"out{world}_{r}.pt", weights_only=False)
             for r in range(world)], time.perf_counter() - t0)


def _rel(a, b):
    """|a - b| / |b| in the Frobenius norm."""
    b = b.double()
    return float(torch_norm(a.double() - b) / torch_norm(b).clamp_min(
        1e-30))


def torch_norm(t):
    return t.reshape(-1).norm()


def compute_mode():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase16(torch, x, x_np, c0_main, model5, labels5, fit5_s, mb11,
            path_launches, device_type="cuda", pgs=("gloo", "nccl")):
    """Distribution over torch.distributed at full size (see the module
    docstring); -> each kernel's launches in the ranks.  ``device_type``
    and ``pgs`` (the two-rank and the one-rank groups' backends) are for
    a rehearsal on the CPU ("cpu", ("gloo", "gloo"))."""
    import tempfile
    import numpy as np
    from repro_torch.core import AAKMeans
    from repro_torch.core.init_schemes import batched_init
    print("phase 16: distribution over torch.distributed (two ranks on "
          "the card over Gloo, one over NCCL)")
    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    mode = compute_mode()
    print(f"  the card: {smi}; compute mode {mode}")
    check("exclusive" not in mode.lower(),
          f"the card's compute mode is {mode}: two ranks cannot share it, "
          f"and phase 16 does not run fewer")
    from repro_torch.core import lloyd
    from repro_torch.kernels import fused_lloyd as F
    n, k = x_np.shape[0], MAIN_K
    c0b = batched_init("kmeans++", torch.Generator(device=x.device)
                       .manual_seed(1), x, k, 1)[0]
    c_fin = model5.centroids_
    step = F.fused_lloyd(x, c_fin)
    c_next = lloyd.update_from_sums(step[2], step[3], c_fin)
    del step
    if device_type == "cuda":
        torch.cuda.empty_cache()
    cfg = {"k": k, "chunk": STREAM_CHUNK, "epochs": STREAM_EPOCHS,
           "val": STREAM_VAL, "batch_iter": DIST_BATCH_MAX_ITER,
           "every": DIST_EVERY, "stream_epochs": DIST_STREAM_EPOCHS,
           "gs": ORDERED_GS, "max_iter": model5.max_iter,
           "timeout": DIST_TIMEOUT, "device": device_type}
    launches = {}
    with tempfile.TemporaryDirectory() as tmpd:
        tmp = Path(tmpd)
        np.save(tmp / "x.npy", x_np)
        for name, t in (("c0", c0_main), ("c0b", c0b), ("c_fin", c_fin),
                        ("c_next", c_next)):
            np.save(tmp / f"{name}.npy", t.cpu().numpy())
        del c0b, c_next
        two, two_s = _spawn16(torch, 2, pgs[0], tmp, cfg)
        print(f"  two ranks (Gloo, card tensors staged through pinned host "
              f"memory) ran in {two_s!r} s")
        one, one_s = _spawn16(torch, 1, pgs[1], tmp, cfg)
        print(f"  one rank (NCCL) ran in {one_s!r} s")
        snap = tmp / "run16" / f"it_{DIST_EVERY:08d}.npz"
        snap_bytes = snap.stat().st_size
        n_snaps = len(list((tmp / "run16").glob("it_*.npz")))
    w1, r0, r1 = one[0], two[0], two[1]

    def launched(what, counts):
        path_launches[f"phase 16 {what}"] = {
            key: v for key, v in counts.items() if key != "plain"}
        for key, v in counts.items():
            launches[key] = launches.get(key, 0) + v

    # (a) one rank over NCCL: phase 5's fit, bit for bit
    fa = w1["fit"]
    same = {"labels": torch.equal(fa["labels"], model5.labels_.cpu()),
            "centroids": torch.equal(fa["centroids"],
                                     model5.centroids_.cpu()),
            "inertia_": fa["energy"] == model5.inertia_,
            "n_iter_": fa["n_iter"] == model5.n_iter_,
            "n_accepted_": fa["n_accepted"] == model5.n_accepted_}
    print(f"  (a) AAKMeans(mesh=1 rank, NCCL).fit: {fa['fit_s']!r} s "
          f"against phase 5's {fit5_s!r} s; n_iter_ {fa['n_iter']}, "
          f"n_accepted_ {fa['n_accepted']}, inertia_ {fa['energy']!r}")
    print(f"  (a) equal to phase 5's fit bit for bit: {same}")
    print(f"  (a) predict {fa['predict_s']!r} s, equal to phase 5's "
          f"{bool(np.array_equal(fa['predict'], labels5))}; launches "
          f"{fa['launches']} fit, {fa['predict_launches']} predict; "
          f"collectives {fa['collectives']}")
    check(all(same.values()), "(a) the one-rank mesh fit is not phase 5's")
    check(np.array_equal(fa["predict"], labels5),
          "(a) the one-rank mesh predict is not phase 5's")
    launched("(a) fit + predict, 1 rank", {
        key: fa["launches"][key] + fa["predict_launches"][key]
        for key in fa["launches"]})

    # (b) two ranks sharing the card over Gloo
    fb, rb = r0["fit"], r0["repeat"]
    step_rel = [_rel(a, b) for a, b in zip(r0["first_step"],
                                            w1["first_step"])]
    e_rel = abs(fb["energy"] - model5.inertia_) / model5.inertia_
    agree = float((fb["labels"] == model5.labels_.cpu()).float().mean())
    ranks_equal = all(
        torch.equal(r0["fit"][key], r1["fit"][key])
        if isinstance(r0["fit"][key], torch.Tensor)
        else r0["fit"][key] == r1["fit"][key]
        for key in ("centroids", "labels", "energy", "n_iter", "n_accepted"))
    repeat_equal = all(
        torch.equal(fb[key], rb[key]) if isinstance(fb[key], torch.Tensor)
        else fb[key] == rb[key]
        for key in ("centroids", "labels", "energy", "n_iter", "n_accepted"))
    single = AAKMeans(n_clusters=k, backend="fused")
    single.centroids_ = fb["centroids"].to(x.device)
    pred_single = single.predict(x)
    trips_b = fb["trips"]
    print(f"  (b) two ranks: fit {fb['fit_s']!r} s (repeat, collectives "
          f"timed: {rb['fit_s']!r} s), {trips_b} trips; n_iter_ "
          f"{fb['n_iter']} / n_accepted_ {fb['n_accepted']} against phase "
          f"5's {model5.n_iter_} / {model5.n_accepted_}; inertia_ "
          f"{fb['energy']!r}, {e_rel!r} relative from phase 5's")
    print(f"  (b) padding rows at weight 0: {r0['pad']}")
    print(f"  (b) labels equal to phase 5's: {agree!r}")
    print(f"  (b) first step against one rank's (relative, Frobenius): "
          f"sums {step_rel[0]!r}, counts {step_rel[1]!r}, energy "
          f"{step_rel[2]!r}")
    for r, rank in enumerate(two):
        print(f"  (b) rank {r}: fused launches {rank['fit']['launches']}, "
              f"collectives {rank['fit']['collectives']}")
    print(f"  (b) the reduction per trip (host clock ending in a sync, "
          f"both ends): {rb['reduce_s'] / max(1, trips_b) * 1e3!r} ms, "
          f"{rb['reduce_s']!r} s of the repeat's {rb['fit_s']!r} s")
    print(f"  (b) ranks equal bit for bit {ranks_equal}; the repeat equal "
          f"bit for bit {repeat_equal}; predict {fb['predict_s']!r} s, "
          f"equal to the single-device predict of the same centroids on "
          f"every row {bool(np.array_equal(fb['predict'], pred_single))}")
    check(max(step_rel) <= 1e-6, "(b) the first step differs from one "
          "rank's by more than 1e-6")
    check(e_rel <= 1e-4, "(b) the final energy is not within 1e-4 of "
          "phase 5's")
    check(ranks_equal, "(b) the ranks' results differ")
    check(repeat_equal, "(b) the repeat fit differs")
    check(np.array_equal(fb["predict"], pred_single)
          and np.array_equal(r1["fit"]["predict"], pred_single),
          "(b) predict under the mesh differs from the single-device one")
    check(fb["launches"]["plain"] == 0, "(b) a plain version ran")
    for r, rank in enumerate(two):
        f = rank["fit"]
        launched(f"(b) fit + predict, rank {r} of 2", {
            key: f["launches"][key] + f["predict_launches"][key]
            + rank["repeat"]["launches"][key] for key in f["launches"]})
    del pred_single, single

    # (c) batched restarts
    bc, bc2, bw1 = r0["batched"][0], r0["batched"][1], w1["batched"][0]
    e2, e1 = bc["res"][2], bw1["res"][2]
    rel_c = (e2.double() - e1.double()).abs() / e1.double()
    trips_c = bc["collectives"]["converged"]
    print(f"  (c) R = 2, max_iter {DIST_BATCH_MAX_ITER} (cut): two ranks "
          f"{bc['wall_s']!r} s, one rank {bw1['wall_s']!r} s; energies "
          f"{e2.tolist()} against one rank's {e1.tolist()}, relative "
          f"{rel_c.tolist()}; n_iter {bc['res'][3].tolist()} / "
          f"{bw1['res'][3].tolist()}; collectives {bc['collectives']} "
          f"({trips_c} trips)")
    repeat_c = all(torch.equal(a, b) for a, b in zip(bc["res"],
                                                      bc2["res"]))
    print(f"  (c) repeat equal bit for bit {repeat_c}")
    check(bc["collectives"]["step"] == trips_c + 1,
          "(c) not one step collective per trip")
    check(float(rel_c.max()) <= 1e-4, "(c) a restart is not within 1e-4 "
          "of its one-rank run")
    check(repeat_c, "(c) the repeat differs")
    for r, rank in enumerate(two):
        launched(f"(c) batched, rank {r} of 2", {
            key: sum(b["launches"][key] for b in rank["batched"])
            for key in bc["launches"]})
    launched("(c) batched, 1 rank", bw1["launches"])

    # (d) streaming
    md, md2 = r0["minibatch"]
    rel_d = abs(md["energy"] - mb11[0]) / mb11[0]
    repeat_d = torch.equal(md["centroids"], md2["centroids"]) and \
        md["energy"] == md2["energy"]
    chunk_steps = md["n_steps"]
    print(f"  (d) MiniBatchAAKMeans(mesh=2 ranks).fit: {md['wall_s']!r} s "
          f"(labels_ included), {chunk_steps} steps, {md['n_accepted']} "
          f"accepted; energy {md['energy']!r} against phase 11's "
          f"{mb11[0]!r} ({rel_d!r} relative; phase 11: {mb11[1]} steps, "
          f"{mb11[2]} accepted); collectives {md['collectives']}; repeat "
          f"equal bit for bit {repeat_d}")
    s2, s1 = r0["streamed"], w1["streamed"]
    rel_s = abs(float(s2["res"][1]) - float(s1["res"][1])) / \
        float(s1["res"][1])
    print(f"  (d) aa_kmeans_minibatch_streamed(mesh=), "
          f"{DIST_STREAM_EPOCHS} epochs from host memory: two ranks "
          f"{s2['wall_s']!r} s, one rank {s1['wall_s']!r} s; energy "
          f"{float(s2['res'][1])!r} against one rank's "
          f"{float(s1['res'][1])!r} ({rel_s!r} relative); collectives "
          f"{s2['collectives']}")
    for r, rank in enumerate(two):
        print(f"  (d) rank {r} of 2 ingest: {rank['streamed']['ingest']}")
    print(f"  (d) one rank's ingest: {s1['ingest']}")
    check(md["collectives"]["step"] == 2 * chunk_steps + 1,
          "(d) not one collective per chunk step and one per guard")
    check(rel_d <= 1e-4, "(d) the minibatch energy is not within 1e-4 of "
          "phase 11's")
    check(repeat_d, "(d) the repeat differs")
    check(rel_s <= 1e-4, "(d) the streamed energy is not within 1e-4 of "
          "one rank's")
    for r, rank in enumerate(two):
        launched(f"(d) streaming, rank {r} of 2", {
            key: sum(m["launches"][key] for m in rank["minibatch"])
            + rank["streamed"]["launches"][key]
            for key in md["launches"]})
    launched("(d) streamed, 1 rank", s1["launches"])

    # (e) elastic resume
    seg, res2, res1 = r0["segmented"], r0["resumed"], w1["resumed"]
    same_e = all(torch.equal(a, b) for a, b in zip(seg["res"], res2["res"]))
    rel_e = abs(float(res1["res"][2]) - float(seg["res"][2])) / \
        float(seg["res"][2])
    gathers = [rec["gather_s"] for _, rec in seg["records"]
               if "gather_s" in rec]
    writes = [rec["checkpoint_write_s"] for _, rec in seg["records"]
              if "checkpoint_write_s" in rec]
    print(f"  (e) segmented every {DIST_EVERY} on {n - n % 2} rows: "
          f"{seg['wall_s']!r} s, {n_snaps} snapshots of {snap_bytes} B "
          f"(the first), written by rank 0 only: "
          f"{[r['segmented']['writes'] for r in two]}")
    print(f"  (e) each snapshot's gather {gathers} s; each write {writes} s")
    print(f"  (e) resumed at two ranks from t = {DIST_EVERY}: "
          f"{res2['wall_s']!r} s, equal bit for bit {same_e}; at one rank "
          f"(NCCL): {res1['wall_s']!r} s, energy {float(res1['res'][2])!r} "
          f"against {float(seg['res'][2])!r} ({rel_e!r} relative), n_iter "
          f"{int(res1['res'][3])} / {int(seg['res'][3])}")
    check(same_e, "(e) the same-world resume differs from the "
          "uninterrupted run")
    check(rel_e <= 1e-4, "(e) the one-rank resume is not within 1e-4")
    check([r["segmented"]["writes"] for r in two] == [True, False],
          "(e) a rank other than the first wrote")
    for r, rank in enumerate(two):
        launched(f"(e) segmented + resumed, rank {r} of 2", {
            key: rank["segmented"]["launches"][key]
            + rank["resumed"]["launches"][key]
            for key in seg["launches"]})
    launched("(e) resumed, 1 rank", res1["launches"])

    # (f) the pallas and fused_bounds engines
    for name in ("pallas", "fused_bounds"):
        g = [rank["steps"][name] for rank in two]
        want = w1["steps"][name]
        rows = []
        for i in range(2):
            lab = torch.cat([gg["steps"][i][0] for gg in g])
            rows.append({
                "labels_equal": torch.equal(lab, want["steps"][i][0]),
                "sums": _rel(g[0]["steps"][i][1], want["steps"][i][1]),
                "counts_equal": torch.equal(g[0]["steps"][i][2],
                                            want["steps"][i][2]),
                "energy": _rel(g[0]["steps"][i][3], want["steps"][i][3]),
                "ranks_equal": all(torch.equal(a, b) for a, b in zip(
                    g[0]["steps"][i][1:], g[1]["steps"][i][1:]))})
        print(f"  (f) {name}, two steps (phase 5's centroids, then one "
              f"Lloyd step on) at two ranks against one: {rows}")
        check(all(r["labels_equal"] and r["counts_equal"]
                  and r["ranks_equal"] and r["sums"] <= 1e-6
                  and r["energy"] <= 1e-6 for r in rows),
              f"(f) {name} at two ranks differs from one rank")
        if want["stats"] is not None:
            sk = [float(gg["stats"][1]) for gg in g]
            print(f"  (f) {name} skipped share: ranks {sk}, one rank "
                  f"{float(want['stats'][1])!r}")
            check(sk[0] == sk[1] and abs(sk[0] - float(want["stats"][1]))
                  <= 1e-6, f"(f) {name}'s skipped share differs")
        for r, gg in enumerate(g):
            launched(f"(f) {name}, rank {r} of 2", gg["launches"])
        launched(f"(f) {name}, 1 rank", want["launches"])
    check(launches["plain"] == 0, "phase 16 ran a plain version")
    check(launches["fused_lloyd"] > 0 and launches["assignment"] > 0
          and launches["update"] > 0 and launches["fused_bounds"] > 0,
          "phase 16 left a kernel unlaunched")
    print(f"  launches in the ranks: {launches}")
    print(f"  phase 16 took {time.perf_counter() - t_phase!r} s")
    sys.stdout.flush()
    return launches


def phase17(torch, x, c0_main, model5, fit5_s, mb11, zero_counts,
            read_counts, path_launches, tile_rows):
    """The bf16 compute path at full size: (a) each kernel's bf16 variant
    against its plain version and bit for bit against its own f32 launch
    on the upcast operands, a bf16 X against f32 centroids, and one bf16
    fused step's peak device memory; (b) the bf16-policy fused fit from
    phase 5's seeds, its cast, the pallas and fused_bounds steps at the
    policy, predict, save and load; (c) the bf16-X fit, its repeat and
    its predict of the bf16 rows;
    (d) MiniBatchAAKMeans with the bf16-policy engine on phase 11's
    configuration and its repeat.  -> (the bf16 operands phase 8 times:
    X and phase 5's centroids; each bf16 variant's largest absolute error
    against its plain version)."""
    import tempfile

    import numpy as np
    from repro_torch.core import AAKMeans, MiniBatchAAKMeans, get_backend
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.core.backends import Precision, bounds
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U
    from repro_torch.kernels.ref import tie_gap
    bf16 = torch.bfloat16
    policy = Precision(compute=bf16)
    n, d = x.shape
    k = MAIN_K
    t_phase = time.perf_counter()
    print(f"phase 17: the bf16 compute path at full size (N={n}, d={d}, "
          f"K={k})")

    def same(a, b):
        return all(torch.equal(p, q) for p, q in zip(a, b))

    # (a) the four kernels on bf16 operands
    xb = x.to(bf16)
    c5 = model5.centroids_
    cb = c5.to(bf16)
    print(f"  (a) X in bf16: {xb.numel() * 2 / 1e6:.0f} MB (f32: "
          f"{x.numel() * 4 / 1e6:.0f} MB)")
    zero_counts()
    got = F.fused_lloyd(xb, cb)
    lab_a, mind_a = A.assignment(xb, cb)
    counts, _ = read_counts()
    res_f = compare_wide(torch, tuple(g[None] for g in got),
                         tuple(v[None] for v in F.fused_lloyd_plain(xb, cb)),
                         xb, cb[None], None)
    rep = same(F.fused_lloyd(xb, cb), got)
    eq_af = torch.equal(lab_a, got[0]) and torch.equal(mind_a, got[1])
    mixed = same(A.assignment(xb, c5), A.assignment(xb.float(), c5))
    print(f"  tensor-core launches: fused {counts['fused_lloyd_tc']}, "
          f"assignment {counts['assignment_tc']} (of 1 each)")
    print(f"  fused_lloyd bf16 vs plain (min_sqdist relative to |x|^2 + max "
          f"|c|^2): {fmt(res_f)}; relaunch bit-equal {rep}; the assignment "
          f"at all rows vs the fused step: bit-equal {eq_af}; bf16 X "
          f"against f32 centroids vs the f32 launch on the upcast X: "
          f"bit-equal {mixed}")
    accept_wide(res_f, "bf16 fused at full size")
    check(res_f["energy_rel_plain"] <= 1e-6, "bf16 fused energy off by "
          f"{res_f['energy_rel_plain']:.2e} relative")
    check(counts["fused_lloyd_tc"] == counts["assignment_tc"] == 1,
          "a bf16 launch did not take the tensor-core sweep")
    check(rep and eq_af, "the bf16 assignment is not the fused step's "
          "sweep, or a relaunch differs")
    check(mixed, "bf16 X against f32 C is not its f32 launch on the upcast X")
    cross = cross_error(torch, A, xb[:PREDICT_CHUNK], cb)
    sass = tc_sass(build)
    print(f"  the tensor-core sweep's cross terms at d={d} ({PREDICT_CHUNK} "
          f"rows x {k}) against an f64 product: {cross}; HGMMA instructions "
          f"of its kernels (cuobjdump -sass): {sass}", flush=True)
    check(all(v > 0 for lib in sass.values() for v in lib.values())
          and all(sass.values()), "a tensor-core sweep kernel has no HGMMA")
    del mind_a
    lab = got[0]
    got_u = U.update(xb, lab, k)
    res_u = compare_stats(got_u, U.update_plain(xb, lab, k))
    eq_u = same(got_u, U.update(xb.float(), lab, k))
    print(f"  update bf16 vs plain on the fused step's labels: sums "
          f"{res_u['sums_rel']:.2e} (abs {res_u['sums_abs']:.2e}), counts "
          f"{res_u['counts_rel']:.2e}; vs its f32 launch: bit-equal {eq_u}")
    accept_stats(res_u, "bf16 update at full size")
    check(eq_u, "the bf16 update is not its f32 launch on the upcast X")
    errs = {"fused_lloyd": res_f["mind_abs"], "assignment": res_f["mind_abs"],
            "update": res_u["sums_abs"]}
    tc = {"cross_error": {d: cross}, "hgmma": sass}
    del got_u, lab_a
    # the bounded step on the tensor cores: at the init carry with the
    # default groups (G = 2, nothing skipped), and on the bounds of one
    # bf16-policy step with 64-centroid groups, held to the tensor-core
    # contract (compare_wide: labels but at near ties, distances and
    # computed group minima within 1e-5 of |x|^2 + max |c|^2, skipped
    # minima and the skipped share exact); then the bit-exact anchor
    # (ub^2 = +inf, lb^2 = 0, random lab0): the bf16 fused step's outputs
    gs_main = engine_group_size(k)
    c_p = cb[None]
    bnd0 = squared_bounds(bounds.init_carry(x, c_p, k, gs_main),
                          c_p.float(), k, gs_main)
    bk_g = get_backend("fused_bounds", group_size=ORDERED_GS,
                       precision=policy)
    carry = bk_g.init_carry(x, c5[None], k)
    res_g, carry = bk_g.batched_step(x, c5[None], k, carry)
    c_g = bk_g.centroids_from_step(x, res_g, k, c5[None]).to(bf16)
    gs_g = engine_group_size(k, ORDERED_GS)
    bnd_g = squared_bounds(carry, c_g.float(), k, gs_g)
    errs["fused_bounds"] = 0.0
    for what, cc, gs, bnds in (("default groups, skip 0", c_p, gs_main, bnd0),
                               (f"gs {gs_g}, one step's bounds", c_g, gs_g,
                                bnd_g)):
        zero_counts()
        got_b = F.fused_lloyd(xb, cc, bounds=bnds, gs=gs)
        counts, _ = read_counts()
        res_b = compare_wide(torch, got_b, F.fused_bounds_plain(
            xb, cc, None, *bnds, gs, tile_rows), xb, cc, None,
            bounds=(bnds[1], bnds[2]), tile_rows=tile_rows)
        rep_b = same(F.fused_lloyd(xb, cc, bounds=bnds, gs=gs), got_b)
        print(f"  fused_bounds bf16 ({what}) vs plain: {fmt_bounds(res_b)}; "
              f"relaunch bit-equal {rep_b}; on the tensor cores "
              f"{counts['fused_bounds_tc']} of {counts['fused_bounds']}")
        accept_wide(res_b, f"bf16 fused_bounds ({what})")
        check(rep_b, f"the bf16 bounded step ({what}): a relaunch differs")
        check(counts["fused_bounds_tc"] == counts["fused_bounds"] == 1,
              f"the bf16 bounded step ({what}) did not take the tensor "
              f"cores")
        errs["fused_bounds"] = max(errs["fused_bounds"], res_b["mind_abs"])
    del got_b, carry, res_g
    lab0 = torch.randint(0, k, (n,), generator=torch.Generator(
        device=x.device).manual_seed(17), device=x.device, dtype=torch.int32)
    anchor = (lab0, torch.zeros((n, -(-k // gs_g)), device=x.device),
              torch.full((n,), float("inf"), device=x.device))
    got_b = F.fused_lloyd(xb, cb, bounds=anchor, gs=gs_g)
    eq_anchor = same(got_b[:5], F.fused_lloyd(xb, cb))
    eq_gmin = torch.equal(got_b[5].amin(dim=-1), got_b[1])
    print(f"  fused_bounds bf16 at ub^2 = +inf, lb^2 = 0 (gs {gs_g}): the "
          f"bf16 fused step's five outputs bit for bit {eq_anchor}; each "
          f"row's least group minimum its distance {eq_gmin}; skipped "
          f"{float(got_b[6])!r}", flush=True)
    check(eq_anchor and eq_gmin and float(got_b[6]) == 0.0,
          "the bf16 bounded step at ub^2 = +inf, lb^2 = 0 is not the bf16 "
          "fused step")
    del got_b, anchor, lab0
    # one bf16 fused step's device memory above its resident inputs: no
    # f32 copy of X (678 MB) may appear
    del got
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = F.fused_lloyd(xb, cb)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - base
    del out
    print(f"  one bf16 fused step's peak device memory above its inputs: "
          f"{step_peak / 1e6:.1f} MB (a quarter of X in f32: "
          f"{x.numel() / 1e6:.1f} MB)", flush=True)
    check(step_peak < x.numel(), "a bf16 fused step allocated a quarter of "
          "X's f32 bytes or more")

    # (b) the bf16-policy fused fit from phase 5's seeds
    fused_bf = get_backend("fused", precision=policy)
    model = AAKMeans(n_clusters=k, backend=fused_bf, n_init=1)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(x, c0s=c0_main[None])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts, plain = read_counts()
    path_launches["bf16-policy fused fit"] = counts
    trips = trips_of(model)
    e32 = float(F.fused_lloyd(x, model.centroids_)[4])
    gap = abs(e32 - model5.inertia_) / model5.inertia_
    print(f"  (b) bf16-policy fused fit (phase 5's seeds): {fit_s!r} s, "
          f"n_iter_ {model.n_iter_}, n_accepted_ {model.n_accepted_}, "
          f"inertia_ {model.inertia_!r}, fused launches "
          f"{counts['fused_lloyd']} (bf16 {counts['fused_lloyd_bf16']}); "
          f"phase 5's f32 fit: {fit5_s!r} s (seeding included), n_iter_ "
          f"{model5.n_iter_}, n_accepted_ {model5.n_accepted_}, inertia_ "
          f"{model5.inertia_!r}")
    print(f"  the f32 energy of its centroids {e32!r}: {gap!r} relative "
          f"from phase 5's; centroids {model.centroids_.dtype}")
    check(counts["fused_lloyd"] == counts["fused_lloyd_bf16"]
          == counts["fused_lloyd_tc"] == 1 + trips, "bf16-policy fused "
          "launches != 1 + trips, or not all on the tensor cores")
    check(plain == 0, "the bf16-policy fit called a plain version")
    check(model.centroids_.dtype == torch.float32, "policy centroids")
    check(gap <= 0.02, "the bf16-policy fit's f32 energy is more than 2 % "
          "from phase 5's")
    # the engine casts X in every step, as the reference writes it
    cast_ms = event_ms(torch, lambda i: x.to(bf16), 10)
    print(f"  the per-step cast of X to bf16: {cast_ms!r} ms "
          f"({trips + 1} steps: {(trips + 1) * cast_ms / 1e3!r} s of the "
          f"fit), {xb.numel() * 2 / 1e6:.0f} MB transient")
    c_b = model.centroids_
    cb_b = c_b.to(bf16)[None]   # the centroids as the policy casts them
    step_f = fused_bf.step(x, c_b, k)[0].labels
    for name in ("pallas", "fused_bounds"):
        bk = get_backend(name, precision=policy)
        zero_counts()
        lab_o = bk.step(x, c_b, k, bk.init_carry(x, c_b, k))[0].labels
        counts, plain = read_counts()
        path_launches[f"bf16-policy {name} step"] = counts
        kname = "assignment" if name == "pallas" else "fused_bounds"
        # pallas's assignment is the fused step's tensor-core sweep, and
        # the bounded step shares its arithmetic: from the init carry
        # (ub^2 = +inf, lb^2 = 0) it computes every cell, no seed wins, and
        # its labels are the fused step's bit for bit
        agree, gap = tie_gap(lab_o[None], step_f[None], xb, cb_b)
        print(f"  {name} at the bf16 policy, one step from the fit's "
              f"centroids: labels agree with the bf16 fused step's on "
              f"{agree!r} of rows (near-tie gap {gap!r}); {kname} bf16 "
              f"launches {counts[kname + '_bf16']}, on the tensor cores "
              f"{counts[kname + '_tc']}")
        check(agree == 1.0 and counts[kname + "_tc"] == 1,
              f"{name} at the bf16 policy is not the fused step's sweep")
        check(counts[kname + "_bf16"] == 1 and plain == 0,
              f"{name} at the bf16 policy did not launch its bf16 kernel")
    del cb_b
    # the slice's path: the bf16-policy fused_bounds fit from phase 5's
    # seeds (default groups), every step on the tensor cores, and its
    # predict
    rec = StepRecorder(get_backend("fused_bounds", precision=policy))
    model_bb = AAKMeans(n_clusters=k, backend=rec.backend, n_init=1)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model_bb.fit(x, c0s=c0_main[None])
    torch.cuda.synchronize()
    fit_bb_s = time.perf_counter() - t0
    counts, plain = read_counts()
    path_launches["bf16-policy fused_bounds fit"] = counts
    trips_bb = trips_of(model_bb)
    skips = torch.cat(rec.skips).tolist()
    e32_bb = float(F.fused_lloyd(x, model_bb.centroids_)[4])
    gap_bb = abs(e32_bb - model5.inertia_) / model5.inertia_
    print(f"  the bf16-policy fused_bounds fit (phase 5's seeds, gs "
          f"{gs_main}): {fit_bb_s!r} s (no seeding), {trips_bb} trips, "
          f"n_iter_ {model_bb.n_iter_}, n_accepted_ {model_bb.n_accepted_}, "
          f"inertia_ {model_bb.inertia_!r}; the f32 energy of its centroids "
          f"{e32_bb!r}, {gap_bb!r} relative from phase 5's (the bf16-policy "
          f"fused fit's {e32!r}: {fit_s!r} s, {trips} trips); fused_bounds "
          f"launches {counts['fused_bounds']} (bf16 "
          f"{counts['fused_bounds_bf16']}, on the tensor cores "
          f"{counts['fused_bounds_tc']}) vs 1 + trips = {1 + trips_bb}; "
          f"plain-version calls {plain}; skipped share per trip: first "
          f"{skips[1]!r}, median {float(np.median(skips))!r}, mean "
          f"{float(np.mean(skips))!r}, last {skips[-1]!r}", flush=True)
    check(counts["fused_bounds"] == counts["fused_bounds_bf16"]
          == counts["fused_bounds_tc"] == 1 + trips_bb, "bf16-policy "
          "fused_bounds launches != 1 + trips, or not all on the tensor "
          "cores")
    check(plain == 0, "the bf16-policy fused_bounds fit called a plain "
          "version")
    check(gap_bb <= 0.02, "the bf16-policy fused_bounds fit's f32 energy is "
          "more than 2 % from phase 5's")
    zero_counts()
    labels_bb = model_bb.predict(x)
    counts, plain = read_counts()
    path_launches["bf16-policy fused_bounds predict"] = counts
    want = A.assignment(x, model_bb.centroids_)[0].cpu().numpy()
    print(f"  its predict on all rows: equal to an f32 assignment of the "
          f"fit's centroids {bool((labels_bb == want).all())} (assignment "
          f"launches {counts['assignment']})", flush=True)
    check(bool((labels_bb == want).all()) and plain == 0,
          "the bf16-policy fused_bounds predict is not an f32 assignment")
    del rec, model_bb, labels_bb, want
    zero_counts()
    labels = model.predict(x)
    counts, _ = read_counts()
    path_launches["bf16-policy predict"] = counts
    want = A.assignment(x, c_b)[0].cpu().numpy()
    print(f"  predict on all rows: equal to an f32 assignment of the fit's "
          f"centroids {bool((labels == want).all())} (assignment launches "
          f"{counts['assignment']}, bf16 {counts['assignment_bf16']})")
    check(bool((labels == want).all()), "bf16-policy predict is not an f32 "
          "assignment")
    with tempfile.TemporaryDirectory() as tmpd:
        loaded = AAKMeans.load(model.save(Path(tmpd) / "bf16_policy"))
        same_pred = bool((loaded.predict(x) == labels).all())
    print(f"  saved and loaded: precision {loaded.backend.precision}, "
          f"predict equal {same_pred}", flush=True)
    check(loaded.backend.precision.compute == bf16 and same_pred,
          "the loaded bf16-policy model")
    del loaded, labels, want, step_f

    # (c) the bf16-X fit, and its repeat
    walls, fits = [], []
    for _ in range(2):
        m = AAKMeans(n_clusters=k, backend="fused", n_init=1)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.fit(xb, c0s=c0_main[None])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        fits.append(m)
    counts, plain = read_counts()
    path_launches["bf16-X fused fit"] = counts
    m = fits[0]
    e32 = float(F.fused_lloyd(x, m.centroids_.float())[4])
    rep = torch.equal(m.centroids_, fits[1].centroids_) \
        and m.inertia_ == fits[1].inertia_ and m.n_iter_ == fits[1].n_iter_
    print(f"  (c) bf16-X fit: {walls!r} s, n_iter_ {m.n_iter_}, n_accepted_ "
          f"{m.n_accepted_}, inertia_ {m.inertia_!r}, the f32 energy of its "
          f"centroids {e32!r} ({(e32 - model5.inertia_) / model5.inertia_!r}"
          f" relative to phase 5's); centroids {m.centroids_.dtype}; the "
          f"repeat bit-equal {rep}; fused launches {counts['fused_lloyd']} "
          f"(bf16 {counts['fused_lloyd_bf16']})", flush=True)
    check(m.centroids_.dtype == bf16, "bf16-X centroids are not bf16")
    check(math.isfinite(m.inertia_) and math.isfinite(e32),
          "bf16-X fit energy")
    check(rep, "the bf16-X fit's repeat differs")
    check(plain == 0 and counts["fused_lloyd"] == counts["fused_lloyd_bf16"]
          == counts["fused_lloyd_tc"] > 0, "the bf16-X fit's launches, or "
          "not on the tensor cores")
    # its predict of the bf16 rows: the assignment kernel's bf16 variant,
    # whose labels are the fused step's on the same operands
    zero_counts()
    t0 = time.perf_counter()
    lab_c = m.predict(xb)
    predict_s = time.perf_counter() - t0
    counts, plain = read_counts()
    path_launches["bf16-X predict"] = counts
    chunks = -(-n // PREDICT_CHUNK)
    same_c = bool((lab_c == F.fused_lloyd(xb, m.centroids_)[0].cpu()
                   .numpy()).all())
    print(f"  bf16-X predict of the bf16 rows: {predict_s!r} s, assignment "
          f"bf16 launches {counts['assignment_bf16']} vs {chunks} chunks; "
          f"labels equal to the bf16 fused step's {same_c}", flush=True)
    check(counts["assignment"] == counts["assignment_bf16"]
          == counts["assignment_tc"] == chunks and plain == 0,
          "bf16-X predict's launches, or not on the tensor cores")
    check(same_c, "bf16-X predict disagrees with the fused step")
    del fits, m, lab_c

    # (d) MiniBatchAAKMeans with the bf16-policy engine, phase 11's config
    mbs, walls = [], []
    for _ in range(2):
        mb = MiniBatchAAKMeans(n_clusters=k, chunk_size=STREAM_CHUNK,
                               epochs=STREAM_EPOCHS, val_size=STREAM_VAL,
                               backend=fused_bf, seed=0)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mb.fit(x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        mbs.append(mb)
    counts, plain = read_counts()
    path_launches["bf16-policy MiniBatchAAKMeans fit + labels_"] = counts
    mb = mbs[0]
    rep = torch.equal(mb.centroids_, mbs[1].centroids_) \
        and mb.energy_ == mbs[1].energy_
    print(f"  (d) MiniBatchAAKMeans, bf16-policy fused: {walls!r} s, "
          f"n_steps_ {mb.n_steps_}, n_accepted_ {mb.n_accepted_}, validation "
          f"energy {mb.energy_!r} (phase 11: {mb11[0]!r}, "
          f"{(mb.energy_ - mb11[0]) / mb11[0]!r} relative; n_steps_ "
          f"{mb11[1]}, n_accepted_ {mb11[2]}); the repeat bit-equal {rep}; "
          f"fused launches {counts['fused_lloyd']} (bf16 "
          f"{counts['fused_lloyd_bf16']})", flush=True)
    check(rep and plain == 0 and counts["fused_lloyd"]
          == counts["fused_lloyd_bf16"] == counts["fused_lloyd_tc"] > 0,
          "the bf16-policy streaming fit")
    check(mb.n_steps_ == mb11[1], "bf16-policy n_steps_")
    del mbs, mb, lab
    launched = {kn: sum(c[f"{kn}_bf16"] for path, c in path_launches.items()
                        if path.startswith("bf16"))
                for kn in ("fused_lloyd", "assignment", "update",
                           "fused_bounds")}
    on_tc = {kn: sum(c[f"{kn}_tc"] for path, c in path_launches.items()
                     if path.startswith("bf16"))
             for kn in ("fused_lloyd", "assignment", "fused_bounds")}
    tc["launches"] = on_tc
    print(f"  bf16 variants launched on phase 17's paths: {launched}; of them "
          f"on the tensor cores: {on_tc}; phase 17 took "
          f"{time.perf_counter() - t_phase!r} s")
    check(all(v > 0 for v in launched.values()),
          "a bf16 variant was not launched on phase 17's paths")
    check(all(v > 0 for v in on_tc.values()), "the tensor-core sweep was not "
          "launched on phase 17's paths")
    return xb, cb, errs, tc


def wide_table(torch, dev, n, d, n_comp, seed=0):
    """(n, d) f32 on the card: data/synthetic.py::_gaussian_mixture's
    recipe drawn by a CUDA generator from ``seed`` (centers 1.5 x N(0, 1);
    each row a uniform component's center plus N(0, 1) noise scaled by the
    component's U(0.6, 1.8)), made in place so that no host copy exists."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn((n_comp, d), generator=gen, device=dev) * 1.5
    comp = torch.randint(0, n_comp, (n,), generator=gen, device=dev)
    scales = torch.rand((n_comp, 1), generator=gen, device=dev) * 1.2 + 0.6
    x = torch.randn((n, d), generator=gen, device=dev)
    for i in range(0, n, 16384):
        part = comp[i:i + 16384]
        x[i:i + 16384].mul_(scales[part]).add_(centers[part])
    return x


def compare_wide(torch, got, want, x, c, w, bounds=None, tile_rows=None,
                 seeded=False):
    """``compare`` (``compare_bounds`` with ``bounds=(lb_sq, ub_sq)``) with
    the wide rules.  min_sqdist and computed group minima: within 1e-5 of
    max(|x|^2, 1) of the row on f32 rows; on bf16 rows of max(|x|^2 +
    max |c|^2, 1), the scale of the expansion's rounding
    (``rescale_to_norms``' rule), since the FMA chains round bf16 products
    with a bias that grows with d (PERF.md §6); the error relative to
    |x|^2 alone is kept in ``mind_rel_x``.  The energy: within 1e-6
    relative, or, where each row's distance errs with a bias, within 1e-5
    of sum(w max(|x|^2, 1)), the per-row rule summed: on bf16 rows, and in
    a step seeded by drifted bounds (``bounds`` or ``seeded``: a settled
    row keeps the smaller of its seed, the kernel's last distance, and a
    rounding of the same distance).  ``res["energy_tol"]`` is the bound
    the energy is held to."""
    from repro_torch.kernels import ref
    res = (compare(torch, got, want, x, c, w) if bounds is None else
           compare_bounds(torch, got, want, x, c, w, *bounds, tile_rows))
    xf = x.float()
    xs = xf if xf.dim() == 3 else xf.expand(c.shape[0], *xf.shape)
    xsq = torch.sum(xs * xs, dim=-1)                             # (R, N)
    rows = xsq.clamp_min(1.0)
    err = (got[1] - want[1]).abs()
    res["mind_rel_x"] = float((err / rows).max())
    if x.dtype == torch.bfloat16:
        cf = c.float()
        rows = (xsq + torch.sum(cf * cf, dim=-1).max(dim=-1).values[:, None]
                ).clamp_min(1.0)
    res["mind_rel"] = float((err / rows).max())
    if len(got) > 4:
        res["energy_rel_plain"] = res["energy_rel"]
        de = (got[4] - want[4]).abs()
        if x.dtype == torch.bfloat16 or bounds is not None or seeded:
            xrows = xsq.clamp_min(1.0)
            scale = torch.sum(xrows if w is None else xrows * w, dim=-1)
            res["energy_rel"] = float((de / scale).max())
            res["energy_tol"] = 1e-5
        else:
            res["energy_rel"] = float((de / want[4].abs().clamp_min(
                1e-30)).max())
            res["energy_tol"] = 1e-6
    if bounds is not None and "gmin_rel" in res:
        computed = torch.stack([ref.computed_cells(lb, ub, tile_rows)
                                for lb, ub in zip(*bounds)])
        res["gmin_rel"] = float(((got[5] - want[5]).abs()
                                 / rows[..., None])[computed].max()) \
            if bool(computed.any()) else 0.0
    return res


def accept_wide(res, what):
    """``accept`` / ``accept_bounds`` (labels on near ties as phase 5
    holds them) with ``compare_wide``'s energy bound."""
    check(res["agree"] == 1.0 or res["gap"] <= 1e-5,
          f"{what}: labels differ beyond a near tie (gap {res['gap']:.2e})")
    check(res["mind_rel"] <= 1e-5, f"{what}: min_sqdist off by "
          f"{res['mind_rel']:.2e} of |x|^2")
    if "sums_rel" in res:
        check(res["sums_rel"] <= 1e-4, f"{what}: sums off by "
              f"{res['sums_rel']:.2e} of their scale")
        check(res["counts_rel"] <= 1e-6, f"{what}: counts off by "
              f"{res['counts_rel']:.2e}")
        check(res["energy_rel"] <= res["energy_tol"], f"{what}: energy off "
              f"by {res['energy_rel']:.2e} (bound {res['energy_tol']:.0e})")
    if "skip_equal" in res:
        check(res["skip_equal"], f"{what}: skipped shares differ")
        check(res["gmin_skipped_equal"],
              f"{what}: a skipped group's minimum is not its bound")
        check(res["gmin_rel"] <= 1e-5, f"{what}: computed group minima off "
              f"by {res['gmin_rel']:.2e} of |x|^2")


def phase18(torch, dev, x_main, zero_counts, read_counts, path_launches,
            tile_rows, tc):
    """Wide rows at Meta-Llama-3-8B's embedding table's shape (LLAMA_VOCAB x
    LLAMA_HIDDEN f32, a WIDE_COMPONENTS-component Gaussian mixture drawn on
    the card from seed 0): (a) the assignment, fused and bounded kernels at
    WIDE_DS against their plain versions (K = 256 and 1000, shared X at
    R = 3, per-problem X with (R, N) weights; the bounded step from drifted
    bounds at gs 8 and 64), f32 and bf16, each bf16 launch equal to the f32
    launch on the upcast operands, relaunches equal, and the launch forced
    to stream equal to the resident one at d = 69 and at the resident
    path's widest d; (b) AAKMeans(n_clusters=WIDE_K, backend="fused") on
    the table with predict on every row, against the dense engine's fit
    from the same seeds; (c) the four 1024-wide subspaces as one batched
    fused solve against dense, two steps each of pallas, fused_bounds
    (gs 16) and fused_bounds_reorder against dense, a MiniBatchAAKMeans
    epoch and a bf16-policy fused fit; (d) each kernel's times at the
    table's shape, on a predict chunk and on the subspaces (CUDA events,
    in turns, with addmm + argmin and index_add_ in the same turns),
    beside its plain version and its bounds; the assignment, the fused
    step and the bounded step (gs 16, skip 0) at K = 1000 on all rows
    beside addmm + argmin; the bounded step on the table's rows sorted by
    the fit's labels from bounds carried one fused_bounds engine step
    from the fit's centroids, with its skipped share; the assignment
    forced to stream beside its resident launch at d = 69 (x_main, the
    USCensus1990 rows, K = 1000) and at the resident path's widest d (the
    table's first columns, K = 1000); ptxas' registers and spills of the
    streamed sweeps.
    -> (per kernel name and its "_bf16" variant: its launches on (b)'s
    and (c)'s paths, all streamed, its launches in (a)'s checks and its
    wide timings; each kernel's largest absolute error against its plain
    version)."""
    from repro_torch.core import AAKMeans, MiniBatchAAKMeans, get_backend
    from repro_torch.core import applications as app
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.core.backends import Precision, bounds
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    from repro_torch.core.init_schemes import batched_init
    from repro_torch.core.kmeans import KMeansConfig, aa_kmeans_batched
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U
    bf16 = torch.bfloat16
    n, d, k = LLAMA_VOCAB, LLAMA_HIDDEN, WIDE_K
    t_phase = time.perf_counter()
    streams = {"fused_lloyd": (F, "stream_launches"),
               "assignment": (A, "stream_launches"),
               "fused_bounds": (F, "bounds_stream_launches")}
    kernel_names = ("fused_lloyd", "assignment", "update", "fused_bounds")
    # launches on the main paths of (b) and (c), every one at d = 4096 or
    # 1024, and in (a)'s checks at WIDE_DS; a kernel's own count less its
    # bf16 variant's
    wide_launches = {f"{kn}{tag}": 0 for kn in kernel_names
                     for tag in ("", "_bf16")}
    check_launches = dict(wide_launches)

    def zero_all():
        zero_counts()
        for mod, attr in streams.values():
            setattr(mod, attr, 0)

    def read_all(path=None, into=None):
        """The launches since zero_all, the plain-version calls and the
        streamed launches.  A main path (``path``) is recorded for the
        script's totals; ``into`` adds each variant's launches."""
        counts, plain = read_counts()
        streamed = {kn: getattr(mod, attr)
                    for kn, (mod, attr) in streams.items()}
        if path:
            path_launches[path] = counts
        if into is not None:
            for kn in kernel_names:
                into[kn] += counts[kn] - counts[f"{kn}_bf16"]
                into[f"{kn}_bf16"] += counts[f"{kn}_bf16"]
        return counts, plain, streamed

    def sync():
        torch.cuda.synchronize()

    def same(a, b):
        return all(torch.equal(p, q) for p, q in zip(a, b))

    t0 = time.perf_counter()
    table = wide_table(torch, dev, n, d, WIDE_COMPONENTS)
    sync()
    print(f"phase 18: wide rows at Meta-Llama-3-8B's embedding table "
          f"({n} x {d} f32, {table.numel() * 4 / 1e9:.2f} GB, a "
          f"{WIDE_COMPONENTS}-component Gaussian mixture drawn on the card "
          f"from seed 0 in {time.perf_counter() - t0!r} s)", flush=True)
    widest = {"assignment": A._bind(build.load("assignment"))
              .assignment_max_features(0),
              "fused_lloyd": F._bind(build.load("fused_lloyd"))
              .fused_lloyd_max_features(0)}
    print(f"  the resident path's widest d: assignment "
          f"{widest['assignment']}, fused {widest['fused_lloyd']}, bounded "
          f"(G = 32 groups) "
          f"{F._bind_bounds(build.load('fused_bounds')).fused_bounds_max_features(0, 32)}")
    gen = torch.Generator(device=dev).manual_seed(1)

    def rows_of(m):
        """The indices of m distinct table rows (centroids), drawn by gen."""
        return torch.randperm(n, generator=gen, device=dev)[:m]

    errs = {}
    # (a) the kernels against their plain versions
    t0 = time.perf_counter()
    zero_all()
    n_cases = 0
    for dd in WIDE_DS:
        xd = table[:, :dd]
        # (label, X, C (R, K, d), weights, batched)
        n1, n2, n3 = min(16384, n), min(8192, n), min(4096, n // 4)
        x4 = torch.stack([xd[i * (n // 4):i * (n // 4) + n3]
                          for i in (1, 2, 3)])
        w4 = torch.rand((3, n3), generator=gen, device=dev) * 2
        w4[:, :n3 // 5] = 0.0
        cases = [
            (f"K=256, N={n1}", xd[:n1].contiguous(),
             xd[rows_of(256)][None].contiguous(), None, False),
            (f"K=1000, N={n2}", xd[:n2].contiguous(),
             xd[rows_of(1000)][None].contiguous(), None, False),
            (f"R=3 shared X, K=300, N={n3}", xd[:n3].contiguous(),
             xd[rows_of(900)].reshape(3, 300, dd).contiguous(), None, True),
            (f"R=3 per-problem X, (R,N) weights, K=256, N={n3}",
             x4.contiguous(), xd[rows_of(768)].reshape(3, 256, dd)
             .contiguous(), w4, True)]
        for label, xc, cc, wc, batched in cases:
            for dt in (torch.float32, bf16):
                xk, ck = xc.to(dt), cc.to(dt)
                args = (xk, ck if batched else ck[0], wc)
                lift = (lambda out: out) if batched else \
                    (lambda out: tuple(o[None] for o in out))
                got = lift(F.fused_lloyd(*args))
                got_a = lift(A.assignment(*args[:2]))
                res = compare_wide(torch, got,
                                   lift(F.fused_lloyd_plain(*args)), xk, ck,
                                   wc)
                eq = same(got_a, got[:2]) and same(
                    lift(F.fused_lloyd(*args)), got)
                tag = "bf16" if dt == bf16 else "f32"
                what = f"d={dd} {label} {tag}"
                print(f"  (a) [{what}] fused: {fmt(res)}; assignment = the "
                      f"step's sweep, relaunch equal: {eq}")
                accept_wide(res, f"wide fused [{what}]")
                check(eq, f"wide [{what}]: a launch is not bit-equal")
                key = "fused_lloyd" + ("_bf16" if dt == bf16 else "")
                errs[key] = max(errs.get(key, 0.0), res["mind_abs"])
                akey = "assignment" + ("_bf16" if dt == bf16 else "")
                errs[akey] = max(errs.get(akey, 0.0), res["mind_abs"])
                n_cases += 1
        # the bounded step from drifted bounds, gs 8 and 64
        xb3 = xd[:n2].contiguous()
        cb3 = xd[rows_of(256)][None].contiguous()
        for gs in (8, 64):
            cbd, gsr, bnds = drifted_bounds(gs, xb3, cb3, None, steps=2)
            for dt in (torch.float32, bf16):
                xk, ck = xb3.to(dt), cbd.to(dt)
                got = F.fused_lloyd(xk, ck, bounds=bnds, gs=gsr)
                res = compare_wide(torch, got, F.fused_bounds_plain(
                    xk, ck, None, *bnds, gsr, tile_rows), xk, ck, None,
                    bounds=(bnds[1], bnds[2]), tile_rows=tile_rows)
                eq = same(F.fused_lloyd(xk, ck, bounds=bnds, gs=gsr), got)
                tag = "bf16" if dt == bf16 else "f32"
                what = f"d={dd} K=256 N={n2} gs={gsr} {tag}"
                print(f"  (a) [{what}] fused_bounds: {fmt_bounds(res)}; "
                      f"relaunch equal: {eq}")
                accept_wide(res, f"wide fused_bounds [{what}]")
                check(eq, f"wide fused_bounds [{what}]: a launch is not "
                      f"bit-equal")
                key = "fused_bounds" + ("_bf16" if dt == bf16 else "")
                errs[key] = max(errs.get(key, 0.0), res["mind_abs"])
                n_cases += 1
        del cases, x4, xb3
    counts, plain, streamed = read_all(into=check_launches)
    print(f"  (a) {n_cases} cases in {time.perf_counter() - t0!r} s; "
          f"launches {counts}; streamed {streamed}; plain-version calls "
          f"{plain} (the comparisons')", flush=True)
    # f32 launches stream X through the FP32 sweeps; bf16 ones take the
    # tensor cores
    check(all(streamed[kn] == counts[kn] - counts[f"{kn}_tc"]
              for kn in streams), "a wide f32 launch did not stream X")
    check(all(counts[f"{kn}_tc"] == counts[f"{kn}_bf16"] > 0
              for kn in streams),
          "a wide bf16 launch did not take the tensor cores")
    for dd in (widest["assignment"], d):
        xd = table[:PREDICT_CHUNK, :dd].contiguous().to(bf16)
        tc["cross_error"][dd] = cross_error(
            torch, A, xd, table[rows_of(256), :dd].contiguous().to(bf16))
        print(f"  (a) the tensor-core sweep's cross terms at d={dd} "
              f"({PREDICT_CHUNK} rows x 256) against an f64 product: "
              f"{tc['cross_error'][dd]}", flush=True)
        del xd
    # forced streaming equals the resident launch where both fit
    widest["fused_bounds"] = F._bind_bounds(build.load(
        "fused_bounds")).fused_bounds_max_features(0, -(-300 // 16))
    for kname in ("assignment", "fused_lloyd", "fused_bounds"):
        for dd in (69, widest[kname]):
            xs = table[:4096, :dd].contiguous()
            cs = table[rows_of(300), :dd][None].contiguous()
            if kname == "fused_bounds":
                cs, gsr, bnds = drifted_bounds(16, xs, cs, None, steps=2)
            for dt in (torch.float32, bf16):
                xk, ck = xs.to(dt), cs.to(dt)
                if kname == "assignment":
                    def run(st):
                        return A.assignment(xk, ck, _stream=st)
                elif kname == "fused_lloyd":
                    def run(st):
                        return F.fused_lloyd(xk, ck, _stream=st)
                else:
                    def run(st):
                        return F.fused_lloyd(xk, ck, bounds=bnds, gs=gsr,
                                             _stream=st)
                if dt == bf16:
                    # the tensor-core sweep has no streamed path to force
                    try:
                        run(True)
                        refused = False
                    except ValueError:
                        refused = True
                    print(f"  (a) {kname} at d={dd} bf16: forcing the "
                          f"stream refused {refused}")
                    check(refused, f"{kname} at d={dd} bf16: a forced "
                          f"stream was not refused")
                    continue
                zero_all()
                resident = run(False)
                _, _, s0 = read_all()
                streamed_out = run(True)
                _, _, s1 = read_all()
                eq = same(streamed_out, resident)
                tag = "bf16" if dt == bf16 else "f32"
                print(f"  (a) {kname} at d={dd} {tag}: forced streaming "
                      f"equals the resident launch bit for bit {eq} "
                      f"(streamed launches {s0[kname]}, then "
                      f"{s1[kname]})")
                check(eq and s0[kname] == 0 and s1[kname] == 1,
                      f"{kname} at d={dd} {tag}: streamed != resident")
    sys.stdout.flush()

    # (b) the fused main path at d = 4096
    t0 = time.perf_counter()
    c0 = batched_init("kmeans++", torch.Generator(device=dev).manual_seed(0),
                      table, k, 1)[0]
    sync()
    seed_s = time.perf_counter() - t0
    model = AAKMeans(n_clusters=k, backend="fused", n_init=1)
    zero_all()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(table)
    sync()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    labels = model.predict(table)
    predict_s = time.perf_counter() - t0
    counts, plain, streamed = read_all("wide fused fit + predict (18b)",
                                       wide_launches)
    trips = trips_of(model)
    chunks = -(-n // PREDICT_CHUNK)
    step_ms = (fit_s - seed_s) / counts["fused_lloyd"] * 1e3
    print(f"  (b) AAKMeans(n_clusters={k}, backend='fused').fit on the "
          f"table: {fit_s!r} s (seeding included; seeding alone "
          f"{seed_s!r} s, so {fit_s - seed_s!r} s apart), n_iter_ "
          f"{model.n_iter_}, n_accepted_ {model.n_accepted_}, inertia_ "
          f"{model.inertia_!r}; {step_ms!r} ms a step (fit wall less "
          f"seeding over the fused launches); peak device memory "
          f"{peak / 1e9!r} GB above the table; predict {predict_s!r} s "
          f"({n / predict_s!r} rows/s)")
    print(f"  fused launches {counts['fused_lloyd']} vs 1 + trips = "
          f"{1 + trips}, streamed {streamed['fused_lloyd']}; assignment "
          f"launches {counts['assignment']} vs {chunks} predict chunks, "
          f"streamed {streamed['assignment']}; plain-version calls {plain}",
          flush=True)
    check(counts["fused_lloyd"] == streamed["fused_lloyd"] == 1 + trips,
          "the wide fit's fused launches != 1 + trips, or not streamed")
    check(counts["assignment"] == streamed["assignment"] == chunks,
          "the wide predict's launches != chunks, or not streamed")
    check(counts["update"] == counts["fused_bounds"] == 0 and plain == 0,
          "the wide fused path launched another kernel or a plain version")
    check(math.isfinite(model.inertia_) and model.inertia_ > 0, "inertia_")
    c_fin = model.centroids_
    fin = F.fused_lloyd(table, c_fin)
    same_pred = bool((torch.from_numpy(labels).to(dev) == fin[0]).all())
    print(f"  predict's labels equal to the fused step's on the final "
          f"centroids at every row: {same_pred}")
    check(same_pred, "the wide predict disagrees with the fused step")
    # the first step against the dense engine's, then the dense fit
    dense = get_backend("dense")
    first = F.fused_lloyd(table, c0)
    want = dense.step(table, c0, k)[0]
    res = compare_wide(torch, tuple(o[None] for o in first),
                       tuple(o[None] for o in want), table, c0[None], None)
    print(f"  the first step, fused vs dense from the seeds: {fmt(res)}")
    accept_wide(res, "the wide first step")
    errs["fused_lloyd"] = max(errs["fused_lloyd"], res["mind_abs"])
    del first, want
    t0 = time.perf_counter()
    model_d = AAKMeans(n_clusters=k, backend="dense", n_init=1).fit(
        table, c0s=c0[None])
    sync()
    dense_s = time.perf_counter() - t0
    e_rel = abs(model.inertia_ - model_d.inertia_) / model_d.inertia_
    print(f"  the dense fit from the same seeds: {dense_s!r} s, n_iter_ "
          f"{model_d.n_iter_}, n_accepted_ {model_d.n_accepted_}, inertia_ "
          f"{model_d.inertia_!r}; the fused fit's energy {e_rel!r} "
          f"relative from it", flush=True)
    check(e_rel <= 1e-4, "the wide fused and dense fits' energies differ "
          "beyond 1e-4")
    del model_d

    # (c) the 1024-wide subspaces as one batched fused solve
    blocks = app._subspace_blocks(table, WIDE_SUBSPACES)
    dsub = blocks.shape[-1]
    c0s = batched_init("kmeans++", torch.Generator(device=dev).manual_seed(0),
                       blocks, k, WIDE_SUBSPACES)
    cfg = KMeansConfig(k=k)
    zero_all()
    sync()
    t0 = time.perf_counter()
    res_s = aa_kmeans_batched(blocks, c0s, cfg, backend="fused")
    sync()
    sub_s = time.perf_counter() - t0
    counts, plain, streamed = read_all("wide subspaces, batched fused (18c)",
                                       wide_launches)
    first = F.fused_lloyd(blocks, c0s)
    want = dense.batched_step(blocks, c0s, k,
                              dense.batched_init_carry(blocks, c0s, k))[0]
    res1 = compare_wide(torch, first, tuple(want), blocks, c0s, None)
    t0 = time.perf_counter()
    res_sd = aa_kmeans_batched(blocks, c0s, cfg, backend="dense")
    sync()
    sub_d_s = time.perf_counter() - t0
    e_rel_s = float(((res_s.energy - res_sd.energy).abs()
                     / res_sd.energy).max())
    print(f"  (c) the {WIDE_SUBSPACES} subspaces {tuple(blocks.shape)}, one "
          f"batched fused solve: {sub_s!r} s, n_iter {res_s.n_iter.tolist()}"
          f", n_accepted {res_s.n_accepted.tolist()}, energies "
          f"{res_s.energy.tolist()}; fused launches {counts['fused_lloyd']}"
          f" (streamed {streamed['fused_lloyd']}), plain {plain}; first "
          f"step vs dense: {fmt(res1)}; dense: {sub_d_s!r} s, n_iter "
          f"{res_sd.n_iter.tolist()}, energies within {e_rel_s!r} relative",
          flush=True)
    accept_wide(res1, "the subspaces' first step")
    check(counts["fused_lloyd"] == streamed["fused_lloyd"] > 0
          and plain == 0, "the subspace solve's launches")
    check(e_rel_s <= 1e-4, "the subspace fused and dense solves' energies "
          "differ beyond 1e-4")
    lab_sub, cs_sub = res_s.labels, res_s.centroids
    del res_sd, first, want

    # two steps of each other kernel engine at d = 4096 against dense
    gs16 = engine_group_size(k, 16)
    for name, opts in (("pallas", {}), ("fused_bounds", {"group_size": 16}),
                       ("fused_bounds_reorder", {"group_size": 16})):
        bk = get_backend(name, **opts)
        cs = c0[None]
        carry = bk.batched_init_carry(table, cs, k)
        zero_all()
        rows = []
        for step in range(2):
            res_e, carry = bk.batched_step(table, cs, k, carry)
            want = dense.batched_step(table, cs, k, dense.batched_init_carry(
                table, cs, k))[0]
            r_e = compare_wide(torch, tuple(res_e[:5]), tuple(want), table,
                               cs, None, seeded=name != "pallas")
            accept_wide(r_e, f"{name} step {step + 1} at d={d}")
            rows.append(r_e)
            cs = bk.centroids_from_step(table, res_e, k, cs)
        counts, plain, streamed = read_all(f"wide {name}, two steps (18c)",
                                           wide_launches)
        print(f"  (c) {name} (gs {gs16 if opts else '-'}), two steps at "
              f"d={d} vs dense: " + "; ".join(fmt(r) for r in rows)
              + f"; launches {counts}, streamed {streamed}, plain {plain}",
              flush=True)
        kn = "assignment" if name == "pallas" else "fused_bounds"
        check(counts[kn] == streamed[kn] == 2 and plain == 0,
              f"{name}'s wide steps did not stream through their kernel")
    del carry, res_e, want
    # MiniBatchAAKMeans, one epoch of 65,536-row chunks
    mb = MiniBatchAAKMeans(n_clusters=k, chunk_size=STREAM_CHUNK, epochs=1,
                           val_size=STREAM_VAL, backend="fused", seed=0)
    zero_all()
    sync()
    t0 = time.perf_counter()
    mb.fit(table)
    sync()
    mb_s = time.perf_counter() - t0
    counts, plain, streamed = read_all("wide MiniBatchAAKMeans (18c)",
                                       wide_launches)
    print(f"  (c) MiniBatchAAKMeans(chunk {STREAM_CHUNK}, 1 epoch, "
          f"{STREAM_VAL} validation rows, fused): {mb_s!r} s, n_steps_ "
          f"{mb.n_steps_}, n_accepted_ {mb.n_accepted_}, validation energy "
          f"{mb.energy_!r}; fused launches {counts['fused_lloyd']} vs 2 x "
          f"n_steps_ + 1 = {2 * mb.n_steps_ + 1} (streamed "
          f"{streamed['fused_lloyd']}), assignment {counts['assignment']}, "
          f"plain {plain}", flush=True)
    check(counts["fused_lloyd"] == streamed["fused_lloyd"]
          == 2 * mb.n_steps_ + 1 and plain == 0, "the wide stream's launches")
    check(math.isfinite(mb.energy_) and mb.energy_ > 0, "wide stream energy")
    del mb
    # a bf16-policy fused fit from (b)'s seeds
    fused_bf = get_backend("fused", precision=Precision(compute=bf16))
    zero_all()
    sync()
    t0 = time.perf_counter()
    model_b = AAKMeans(n_clusters=k, backend=fused_bf, n_init=1).fit(
        table, c0s=c0[None])
    sync()
    bf_s = time.perf_counter() - t0
    counts, plain, streamed = read_all("wide bf16-policy fused fit (18c)",
                                       wide_launches)
    e32 = float(F.fused_lloyd(table, model_b.centroids_)[4])
    gap = (e32 - model.inertia_) / model.inertia_
    print(f"  (c) bf16-policy fused fit from (b)'s seeds: {bf_s!r} s, n_iter_"
          f" {model_b.n_iter_}, n_accepted_ {model_b.n_accepted_}, inertia_ "
          f"{model_b.inertia_!r}; its centroids' f32 energy {e32!r}, "
          f"{gap!r} relative to (b)'s {model.inertia_!r}; bf16 fused "
          f"launches {counts['fused_lloyd_bf16']} of {counts['fused_lloyd']}"
          f", on the tensor cores {counts['fused_lloyd_tc']}, streamed "
          f"{streamed['fused_lloyd']}, plain {plain}", flush=True)
    check(counts["fused_lloyd"] == counts["fused_lloyd_bf16"]
          == counts["fused_lloyd_tc"] == 1 + trips_of(model_b)
          and streamed["fused_lloyd"] == 0 and plain == 0,
          "the wide bf16-policy fit's launches")
    check(abs(gap) <= 0.02, "the wide bf16-policy fit's f32 energy is more "
          "than 2 % from the f32 fit's")
    del model_b
    # the update kernel at d = 4096 on the fit's labels against its plain
    # version (its column groups take any d)
    lab_fin = fin[0]
    lay = U.layout(U._bind(build.load("update")), n, 1, k, d)
    zero_all()
    res_u = compare_stats(U.update(table, lab_fin, k),
                          U.update_plain(table, lab_fin, k))
    read_all(into=check_launches)
    print(f"  the update at ({n}, {d}, {k}): {lay.groups} column groups of "
          f"{lay.width}, {lay.slabs} slabs; vs plain: sums "
          f"{res_u['sums_rel']:.2e}, counts {res_u['counts_rel']:.2e}")
    accept_stats(res_u, "the wide update")
    errs["update"] = res_u["sums_abs"]

    # (d) times (CUDA events, in turns), the library calls in the same
    # turns: addmm + argmin beside the assignment (f32, and on the upcast
    # operands beside bf16), index_add_ beside the update
    table_b, c_fin_b = table.to(bf16), c_fin.to(bf16)
    blocks_b, cs_sub_b = blocks.to(bf16), cs_sub.to(bf16)
    c_p, c_pb = c_fin[None], c_fin_b[None]
    bnd = squared_bounds(bounds.init_carry(table, c_p, k, gs16), c_p, k, gs16)
    bnd_s = squared_bounds(bounds.init_carry(blocks, cs_sub, k, gs16), cs_sub,
                           k, gs16)
    step = PREDICT_CHUNK
    n_chunks = n // step

    def chunk(xx, i):
        return xx[(i % n_chunks) * step:(i % n_chunks + 1) * step]

    def nearest(xx, cc, csq_):
        """addmm + argmin on f32 operands (X upcast inside the call)."""
        return torch.argmin(torch.addmm(csq_, xx.float(), cc.float().T,
                                        alpha=-2.0), dim=1)

    c_sq = torch.sum(c_fin * c_fin, dim=-1)
    cbf = c_fin_b.float()
    c_sq_b = torch.sum(cbf * cbf, dim=-1)

    # K = 1000 on the table: centroids drawn from its rows
    k4 = 1000
    c1000 = table[rows_of(k4)].contiguous()
    c1000_sq = torch.sum(c1000 * c1000, dim=-1)
    c1000_b = c1000.to(bf16)
    c1000_sq_b = torch.sum(c1000_b.float() ** 2, dim=-1)
    bnd1000 = squared_bounds(bounds.init_carry(table, c1000[None], k4, gs16),
                             c1000[None], k4, gs16)
    # the bounded step where it skips: the table's rows sorted by the fit's
    # labels, and the bounds one fused_bounds engine step leaves from the
    # fit's centroids
    table_s = table[torch.argsort(lab_fin, stable=True)].contiguous()
    bk16 = get_backend("fused_bounds", group_size=16)
    res_car, carry_s = bk16.batched_step(
        table_s, c_p, k, bk16.batched_init_carry(table_s, c_p, k))
    c_car = bk16.centroids_from_step(table_s, res_car, k, c_p)
    bnd_car = squared_bounds(carry_s, c_car, k, gs16)
    del res_car, carry_s
    table_sb, c_carb = table_s.to(bf16), c_car.to(bf16)
    skip_car = float(F.fused_lloyd(table_s, c_car, bounds=bnd_car,
                                   gs=gs16)[6][0])
    print(f"  (d) the bounded step on the label-sorted rows from carried "
          f"bounds (gs {gs16}): skipped share {skip_car!r}", flush=True)
    # the segment sum alone on the label-sorted rows: on the fit's labels
    # (sorted), and on the labels the bf16 fused and bounded steps give
    # there, whose share of those steps it is; the bf16 launch on the
    # sorted labels against its f32 launch on the upcast X, bit for bit
    lab_s = lab_fin[torch.argsort(lab_fin, stable=True)].contiguous()
    lab_fs = F.fused_lloyd(table_sb, c_carb)[0]
    lab_bs = F.fused_lloyd(table_sb, c_carb, bounds=bnd_car, gs=gs16)[0]
    up_sb = table_sb.float()
    eq_ws = all(torch.equal(a, b) for a, b in zip(
        U.update(table_sb, lab_s, k), U.update(up_sb, lab_s, k)))
    del up_sb
    print(f"  (d) the bf16 update on the label-sorted rows: bit-equal to its "
          f"f32 launch on the upcast X {eq_ws}", flush=True)
    check(eq_ws, "the wide bf16 update on label-sorted rows is not its f32 "
          "launch on the upcast X")
    has_mm = mm_argmin(torch, table_b[:128], c_fin_b, c_sq_b) is not None
    sums_buf = torch.zeros(k, d, device=dev)
    lab_l = lab_fin.long()
    # the streamed sweep forced where the resident one fits: USCensus1990
    # (d = 69) and the table's first 821 columns, both at K = 1000
    x69 = x_main
    c69 = x69[torch.randperm(x69.shape[0], generator=gen,
                             device=dev)[:k4]].contiguous()
    x821 = table[:, :widest["assignment"]].contiguous()
    c821 = c1000[:, :widest["assignment"]].contiguous()
    turned = {
        "fused_lloyd": lambda i: F.fused_lloyd(table, c_fin),
        "assignment": lambda i: A.assignment(table, c_fin),
        "update": lambda i: U.update(table, lab_fin, k),
        "fused_bounds": lambda i: F.fused_lloyd(table, c_p, bounds=bnd,
                                                gs=gs16),
        "fused_lloyd_bf16": lambda i: F.fused_lloyd(table_b, c_fin_b),
        "assignment_bf16": lambda i: A.assignment(table_b, c_fin_b),
        "update_bf16": lambda i: U.update(table_b, lab_fin, k),
        "fused_bounds_bf16": lambda i: F.fused_lloyd(table_b, c_pb,
                                                     bounds=bnd, gs=gs16),
        "fused_lloyd subspaces": lambda i: F.fused_lloyd(blocks, cs_sub),
        "assignment subspaces": lambda i: A.assignment(blocks, cs_sub),
        "update subspaces": lambda i: U.update(blocks, lab_sub, k),
        "fused_bounds subspaces": lambda i: F.fused_lloyd(
            blocks, cs_sub, bounds=bnd_s, gs=gs16),
        "fused_lloyd_bf16 subspaces": lambda i: F.fused_lloyd(blocks_b,
                                                              cs_sub_b),
        "assignment_bf16 subspaces": lambda i: A.assignment(blocks_b,
                                                            cs_sub_b),
        "update_bf16 subspaces": lambda i: U.update(blocks_b, lab_sub, k),
        "fused_bounds_bf16 subspaces": lambda i: F.fused_lloyd(
            blocks_b, cs_sub_b, bounds=bnd_s, gs=gs16),
        "assignment chunk": lambda i: A.assignment(chunk(table, i), c_fin),
        "assignment_bf16 chunk": lambda i: A.assignment(chunk(table_b, i),
                                                        c_fin_b),
        "addmm + argmin": lambda i: nearest(table, c_fin, c_sq),
        "addmm + argmin bf16": lambda i: nearest(table_b, c_fin_b, c_sq_b),
        "addmm + argmin chunk": lambda i: nearest(chunk(table, i), c_fin,
                                                  c_sq),
        "addmm + argmin bf16 chunk": lambda i: nearest(chunk(table_b, i),
                                                       c_fin_b, c_sq_b),
        "mm bf16": lambda i: mm_argmin(torch, table_b, c_fin_b, c_sq_b),
        "mm bf16 chunk": lambda i: mm_argmin(torch, chunk(table_b, i),
                                             c_fin_b, c_sq_b),
        "assignment_bf16 K=1000": lambda i: A.assignment(table_b, c1000_b),
        "fused_lloyd_bf16 K=1000": lambda i: F.fused_lloyd(table_b, c1000_b),
        "mm bf16 K=1000": lambda i: mm_argmin(torch, table_b, c1000_b,
                                              c1000_sq_b),
        "index_add_": lambda i: sums_buf.index_add_(0, lab_l, table),
        "index_add_ bf16": lambda i: sums_buf.index_add_(0, lab_l,
                                                         table_b.float()),
        "assignment K=1000": lambda i: A.assignment(table, c1000),
        "fused_lloyd K=1000": lambda i: F.fused_lloyd(table, c1000),
        "fused_bounds K=1000": lambda i: F.fused_lloyd(
            table, c1000[None], bounds=bnd1000, gs=gs16),
        "fused_bounds_bf16 K=1000": lambda i: F.fused_lloyd(
            table_b, c1000_b[None], bounds=bnd1000, gs=gs16),
        "fused_bounds sorted": lambda i: F.fused_lloyd(
            table_s, c_car, bounds=bnd_car, gs=gs16),
        "fused_bounds_bf16 sorted": lambda i: F.fused_lloyd(
            table_sb, c_carb, bounds=bnd_car, gs=gs16),
        "fused_lloyd sorted": lambda i: F.fused_lloyd(table_s, c_car),
        "fused_lloyd_bf16 sorted": lambda i: F.fused_lloyd(table_sb, c_carb),
        "update sorted": lambda i: U.update(table_s, lab_s, k),
        "update_bf16 sorted": lambda i: U.update(table_sb, lab_s, k),
        "update_bf16 sorted, the fused step's labels": lambda i: U.update(
            table_sb, lab_fs, k),
        "update_bf16 sorted, the bounded step's labels": lambda i: U.update(
            table_sb, lab_bs, k),
        "addmm + argmin K=1000": lambda i: nearest(table, c1000, c1000_sq),
        "assignment d=69 resident": lambda i: A.assignment(x69, c69),
        "assignment d=69 streamed": lambda i: A.assignment(x69, c69,
                                                           _stream=True),
        "assignment d=821 resident": lambda i: A.assignment(x821, c821),
        "assignment d=821 streamed": lambda i: A.assignment(x821, c821,
                                                            _stream=True)}
    if not has_mm:
        print("  (d) torch.mm(out_dtype=torch.float32) is not in this torch: "
              "no bf16 library call")
        turned = {what: fn for what, fn in turned.items()
                  if not what.startswith("mm ")}
    turns = {what: [] for what in turned}
    for order in (list(turned), list(reversed(turned))):
        for what in order:
            turns[what].append(event_ms(torch, turned[what],
                                        20 if "chunk" in what else 5))
    turn_ms = {what: sum(ts) / len(ts) for what, ts in turns.items()}
    turn_ms.update({what: None for what in ("mm bf16", "mm bf16 chunk",
                                            "mm bf16 K=1000")
                    if what not in turn_ms})
    print("  (d) in turns: " + "; ".join(
        f"{what} {ts!r} ms" for what, ts in turns.items()))
    g = bnd[1].shape[-1]
    wide = {}
    for kn in ("fused_lloyd", "assignment", "update", "fused_bounds"):
        for tag, xx, cc, nb in (("", table, c_fin, 4),
                                ("_bf16", table_b, c_fin_b, 2)):
            name = kn + tag
            row = {"ms": turn_ms[name],
                   "subspace_ms": turn_ms[f"{name} subspaces"],
                   "library_ms": None}
            bound = bf16_bound_ms if tag else \
                (lambda b, c_, o: distance_bound_ms(b, c_, o)[:3])
            on_tc = tag and kn in ("fused_lloyd", "assignment")

            def other(rows, kk, chains):
                """The CUDA-core operations beside the cross terms."""
                if on_tc:
                    return tc_other(rows, kk, d, chains)
                return 3 * rows * kk + (2 * rows * d if chains else 0)

            def bounded_other(rows, kk, live):
                """The bounded step's: the computed share's epilogue (on
                the tensor-core route, TC_BOUNDED_INSTR a (row,
                centroid)) and the |x|^2 chains."""
                if tag:
                    return live * tc_other(rows, kk, d, True,
                                           TC_BOUNDED_INSTR) \
                        + (1 - live) * 2 * rows * d
                return live * 3 * rows * kk + 2 * rows * d

            if kn == "fused_lloyd":
                row["plain_ms"] = event_ms(
                    torch, lambda i: F.fused_lloyd_plain(xx, cc), 3, warmup=1)
                row["bounds"] = bound(nb * (n * d + k * d)
                                      + 4 * (2 * n + k * d + k + 1),
                                      2 * n * k * d, other(n, k, True))
            elif kn == "assignment":
                row["chunk_ms"] = turn_ms[f"{name} chunk"]
                row["plain_ms"] = event_ms(
                    torch, lambda i: A.assignment_plain(chunk(xx, i), cc), 20)
                # bf16: the one call on the bf16 operands, and f32 addmm on
                # the upcast ones beside it
                lib = "mm bf16" if tag else "addmm + argmin"
                row["chunk_library_ms"] = turn_ms[f"{lib} chunk"]
                row["library_ms"] = turn_ms[lib]
                if tag:
                    row["upcast_library_ms"] = turn_ms["addmm + argmin bf16"]
                    row["chunk_upcast_library_ms"] = \
                        turn_ms["addmm + argmin bf16 chunk"]
                row["bounds"] = bound(nb * (n * d + k * d) + 4 * 2 * n,
                                      2 * n * k * d, other(n, k, False))
                row["chunk_bounds"] = bound(nb * (step * d + k * d)
                                            + 4 * 2 * step,
                                            2 * step * k * d,
                                            other(step, k, False))
            elif kn == "update":
                row["plain_ms"] = event_ms(
                    torch, lambda i: U.update_plain(xx, lab_fin, k), 3,
                    warmup=1)
                row["library_ms"] = turn_ms["index_add_" + (" bf16" if tag
                                                            else "")]
                u_ms, u_by = bound_ms(nb * n * d + 4 * n + 4 * (k * d + k),
                                      n * d + n)
                row["bounds"] = (u_ms, u_by, u_ms)
                # the label-sorted rows; in bf16 also the segment sum's
                # share of the fused and bounded steps on those rows
                row["sorted_ms"] = turn_ms[f"{name} sorted"]
                if tag:
                    row["sorted_shares"] = {
                        what: turn_ms[f"{name} sorted, the {what} step's "
                                      f"labels"]
                        / turn_ms[f"{step_name} sorted"]
                        for what, step_name in (
                            ("fused", "fused_lloyd_bf16"),
                            ("bounded", "fused_bounds_bf16"))}
            else:
                row["plain_ms"] = event_ms(
                    torch, lambda i: F.fused_bounds_plain(
                        xx, cc[None], None, *bnd, gs16, tile_rows), 3,
                    warmup=1)
                row["bounds"] = bound(
                    nb * (n * d + k * d) + 4 * (2 * n + n * g)
                    + 4 * (2 * n + n * g + k * d + k + 1) + 8,
                    2 * n * k * d, bounded_other(n, k, 1.0))
                row["fused_subspace_ms"] = \
                    turn_ms[f"fused_lloyd{tag} subspaces"]
                g4 = bnd1000[1].shape[-1]
                row["k1000"] = {
                    "ms": turn_ms[f"{name} K=1000"], "library_ms": None,
                    "fused_ms": turn_ms["fused_lloyd" + tag + " K=1000"],
                    "bounds": bound(
                        nb * (n * d + k4 * d) + 4 * (2 * n + n * g4)
                        + 4 * (2 * n + n * g4 + k4 * d + k4 + 1) + 8,
                        2 * n * k4 * d, bounded_other(n, k4, 1.0))}
                # the sorted rows: the computed share's cross terms
                live = 1.0 - skip_car
                row["sorted_carried"] = {
                    "ms": turn_ms[f"{name} sorted"], "skipped": skip_car,
                    "fused_ms": turn_ms["fused_lloyd" + tag + " sorted"],
                    "bounds": bound(
                        nb * (n * d + k * d) + 4 * (2 * n + n * g)
                        + 4 * (2 * n + n * g + k * d + k + 1) + 8,
                        live * 2 * n * k * d, bounded_other(n, k, live))}
            if kn in ("fused_lloyd", "assignment"):
                # K = 1000 on all rows: four 256-centroid chunks (f32),
                # eight of 128 (bf16)
                extra = 4 * (2 * n + k4 * d + k4 + 1) if kn == "fused_lloyd" \
                    else 4 * 2 * n
                row["k1000"] = {
                    "ms": turn_ms[f"{name} K=1000"],
                    "library_ms": turn_ms["mm bf16 K=1000" if tag
                                          else "addmm + argmin K=1000"],
                    "bounds": bound(nb * (n * d + k4 * d) + extra,
                                    2 * n * k4 * d,
                                    other(n, k4, kn == "fused_lloyd"))}
            row["launches"] = wide_launches[name]
            row["check_launches"] = check_launches[name]
            wide[name] = row
            sorted_fused = row.get("sorted_carried", {}).get("fused_ms")
            lib_name = "mm (f32 out) + argmin" if tag else "addmm + argmin"
            b_ms, b_by, b_fp32 = row["bounds"]
            print(f"  (d) {name} at ({n}, {d}, {k}): {row['ms']!r} ms "
                  f"(subspaces {WIDE_SUBSPACES} x ({n}, {dsub}): "
                  f"{row['subspace_ms']!r} ms), bound {b_ms!r} ms ({b_by}; "
                  f"FP32-core bound {b_fp32!r} ms), plain "
                  f"{row['plain_ms']!r} ms"
                  + ("" if row["library_ms"] is None else
                     f", library {row['library_ms']!r} ms")
                  + (f"; a {step}-row predict chunk {row['chunk_ms']!r} ms, "
                     f"bound {row['chunk_bounds'][0]!r} ms (FP32-core "
                     f"{row['chunk_bounds'][2]!r} ms), {lib_name} "
                     f"{row['chunk_library_ms']!r} ms"
                     if "chunk_ms" in row else "")
                  + (f", f32 addmm + argmin on the upcast operands "
                     f"{row['upcast_library_ms']!r} ms (chunk "
                     f"{row['chunk_upcast_library_ms']!r} ms)"
                     if "upcast_library_ms" in row else "")
                  + (f"; at K = {k4} {row['k1000']['ms']!r} ms, bound "
                     f"{row['k1000']['bounds'][0]!r} ms (FP32-core "
                     f"{row['k1000']['bounds'][2]!r} ms), "
                     + (f"the fused step {row['k1000']['fused_ms']!r} ms "
                        f"in the same turns"
                        if "fused_ms" in row["k1000"] else
                        f"{lib_name} {row['k1000']['library_ms']!r} ms")
                     if "k1000" in row else "")
                  + (f"; on the label-sorted rows from carried bounds "
                     f"(skipped {row['sorted_carried']['skipped']!r}) "
                     f"{row['sorted_carried']['ms']!r} ms, bound "
                     f"{row['sorted_carried']['bounds'][0]!r} ms (FP32-core "
                     f"{row['sorted_carried']['bounds'][2]!r} ms), the fused"
                     f" step on those rows "
                     f"{row['sorted_carried']['fused_ms']!r} ms"
                     if "sorted_carried" in row else "")
                  + (f"; on the label-sorted rows {row['sorted_ms']!r} ms "
                     f"({row['sorted_ms'] / row['ms']!r}x)"
                     if "sorted_ms" in row else "")
                  + (f", its share of the bf16 steps on those rows: "
                     f"{row['sorted_shares']}"
                     if "sorted_shares" in row else "")
                  + (f"; {row['ms'] / turn_ms['fused_lloyd' + tag]!r}x the "
                     f"fused step in the same turns (subspaces "
                     f"{row['subspace_ms'] / row['fused_subspace_ms']!r}x, "
                     f"K = {k4} "
                     f"{row['k1000']['ms'] / row['k1000']['fused_ms']!r}x, "
                     f"sorted rows "
                     f"{row['sorted_carried']['ms'] / sorted_fused!r}x)"
                     if kn == "fused_bounds" else "")
                  + f"; launches on (b) and (c) {row['launches']}, in (a)"
                  f" {row['check_launches']}")
    # the streamed sweep where the resident one fits (dispatch keeps the
    # resident path there)
    forced = {}
    for dd in (69, widest["assignment"]):
        res_ms = turn_ms[f"assignment d={dd} resident"]
        str_ms = turn_ms[f"assignment d={dd} streamed"]
        forced[f"d{dd}"] = {"resident_ms": res_ms, "streamed_ms": str_ms}
        rows_dd = x69.shape[0] if dd == 69 else n
        print(f"  (d) the assignment at ({rows_dd}, {dd}, {k4}): resident "
              f"{res_ms!r} ms, forced to stream {str_ms!r} ms "
              f"({str_ms / res_ms!r}x)")
    wide["assignment"]["forced_stream"] = forced
    ptxas = ptxas_report(build.library_path("assignment"), "assign_stream")
    wide["assignment"]["stream_ptxas"] = ptxas
    tc_ptxas = ptxas_report(build.library_path("assignment"), "assign_tc")
    wide["assignment_bf16"]["tc_ptxas"] = tc_ptxas
    b_ptxas = ptxas_report(build.library_path("fused_bounds"),
                           "bounds_stream")
    wide["fused_bounds"]["stream_ptxas"] = b_ptxas
    tcb_ptxas = ptxas_report(build.library_path("fused_bounds"), "bounds_tc")
    wide["fused_bounds_bf16"]["tc_ptxas"] = tcb_ptxas
    print(f"  (d) ptxas, the streamed sweep: {ptxas}; the tensor-core sweep: "
          f"{tc_ptxas}; the bounded streamed sweep: {b_ptxas}; the bounded "
          f"tensor-core sweep: {tcb_ptxas}")
    check(all(r.get("spill_stores", 0) + r.get("spill_loads", 0) == 0
              for r in b_ptxas.values()) and len(b_ptxas) > 0,
          "the bounded streamed sweep spills, or ptxas reported nothing")
    check(all(r.get("spill_stores", 0) + r.get("spill_loads", 0)
              + r.get("stack", 0) == 0 for r in tcb_ptxas.values())
          and len(tcb_ptxas) == 2, "the bounded tensor-core sweep spills or "
          "keeps a stack frame, or ptxas reported nothing")
    print(f"  X is read once per 256-centroid chunk: {-(-k // 256)} time(s) "
          f"a step at K = {k}, {-(-k4 // 256)} at K = {k4}; phase 18 took "
          f"{time.perf_counter() - t_phase!r} s", flush=True)
    del table, table_b, blocks, blocks_b, fin, x821, c1000
    del table_s, table_sb, lab_s, lab_fs, lab_bs
    return wide, errs


def phase10(torch, dev, x, zero_counts, read_counts, path_launches,
            tile_rows):
    """The paper's protocols on the card at full size on the USCensus1990
    stand-in: Table 3's five cases (seeded on the card, seeding timed
    apart), each as lloyd_kmeans against aa_kmeans on "dense" and as the
    same-engine pair on "fused"; one lloyd_iteration on the assignment
    and update kernels (pallas_lloyd_ops) against the dense ops; the
    traced bounded engine at K = 100; Table 2's four runs.  Who wins is
    printed, not checked.  Then each kernel against its plain version at
    phase 10's shapes; -> the largest absolute distance (update: sums)
    error per kernel."""
    import numpy as np
    from benchmarks_torch.common import timed
    from repro_torch.core.anderson import AAConfig
    from repro_torch.core import init_schemes
    from repro_torch.core.backends import get_backend
    from repro_torch.core.init_schemes import INIT_SCHEMES
    from repro_torch.core.hamerly import hamerly_kmeans
    from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                         aa_kmeans_traced)
    from repro_torch.core.lloyd import lloyd_iteration, lloyd_kmeans
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U
    from repro_torch.kernels.ops import pallas_lloyd_ops
    from repro_torch.kernels.ref import tie_gap
    n, d = x.shape
    cap = PHASE10_MAX_ITER
    print(f"phase 10: Tables 2 and 3 on the card ({MAIN_N_NAME}, {n} x {d}; "
          f"max_iter {cap}, the protocol's 1000)")
    fused = get_backend("fused")

    def once(fn):
        """(output, wall s) of one run, ending in a device sync."""
        return timed(fn, warmup=0, reps=1)

    zero_counts()
    summary = {"dense": [0, 0, 0], "fused": [0, 0, 0]}  # wins, iter wins, n
    seeds, finals = {}, {}
    for init, k in TABLE3_CASES:
        gen = torch.Generator(device=dev).manual_seed(0)
        c0, seed_s = once(lambda: INIT_SCHEMES[init](gen, x, k))
        check(tuple(c0.shape) == (k, d) and c0.device.type == "cuda",
              f"{init} seeds: shape {tuple(c0.shape)} on {c0.device}")
        seeds[(init, k)] = c0
        cfg = KMeansConfig(k=k, max_iter=cap)
        lcfg = KMeansConfig(k=k, max_iter=cap, accelerated=False)
        lloyd_d, t_ld = once(lambda: lloyd_kmeans(x, c0, k, cap))
        aa_d, t_ad = once(lambda: aa_kmeans(x, c0, cfg, backend="dense"))
        lloyd_f, t_lf = once(lambda: aa_kmeans(x, c0, lcfg, backend=fused))
        aa_f, t_af = once(lambda: aa_kmeans(x, c0, cfg, backend=fused))
        rows = (("dense", lloyd_d[3], float(lloyd_d[2]), t_ld, aa_d, t_ad),
                ("fused", int(lloyd_f.n_iter), float(lloyd_f.energy), t_lf,
                 aa_f, t_af))
        finals[(init, k)] = aa_f.centroids
        # clarans's swap trials (one cost read each), so that its seeding
        # time can be read per trial
        line = [f"  {init} K={k}: seeding {seed_s!r} s"
                + (f" ({init_schemes.clarans_trials} trials)"
                   if init == "clarans" else "")]
        for eng, it_l, e_l, t_l, aa, t_a in rows:
            e_a = float(aa.energy)
            check(np.isfinite(e_l) and np.isfinite(e_a),
                  f"{init} K={k} {eng}: a non-finite energy")
            summary[eng][0] += int(t_a < t_l)
            summary[eng][1] += int(int(aa.n_iter) < it_l)
            summary[eng][2] += 1
            line.append(f"{eng}: Lloyd {it_l} it {t_l!r} s mse "
                        f"{e_l / n!r} | AA {int(aa.n_accepted)}/"
                        f"{int(aa.n_iter)} {t_a!r} s mse {e_a / n!r}")
        # each algorithm on the two engines from the same seeds: only
        # rounding sets them apart (phase 6's 1e-3)
        rel_l = abs(float(lloyd_f.energy) - float(lloyd_d[2])) \
            / float(lloyd_d[2])
        rel_a = abs(float(aa_f.energy) - float(aa_d.energy)) \
            / float(aa_d.energy)
        line.append(f"fused vs dense final energies: Lloyd {rel_l:.2e}, "
                    f"AA {rel_a:.2e} relative")
        print("\n    ".join(line), flush=True)
        check(rel_l <= 1e-3 and rel_a <= 1e-3, f"{init} K={k}: the fused "
              f"and dense runs end far apart")
        # Lloyd's fixed point: a converged run's labels are the assignment
        # of its centroids (each engine's own assignment)
        if lloyd_d[3] < cap:
            check(torch.equal(lloyd_d[1], get_backend("dense").assign(
                x, lloyd_d[0]).labels), f"{init} K={k}: dense Lloyd's "
                "labels are not its centroids' assignment")
        if bool(lloyd_f.converged):
            check(torch.equal(lloyd_f.labels, fused.assign(
                x, lloyd_f.centroids).labels), f"{init} K={k}: fused "
                "Lloyd's labels are not its centroids' assignment")
        # one Lloyd step on the assignment and update kernels against the
        # dense ops, and both against the f64 means of the kernels' labels:
        # the dense ops sum a cluster's rows (~250,000 at K = 10) in long
        # f32 matmul accumulations, about 1e-5 from the exact means, so
        # between the two only the stats' reduction-order tolerance holds
        # (1e-4 of their scale, as phases 3-5a); the kernels are held to
        # 1e-5 of the exact means
        c1_p, lab_p, e_p = lloyd_iteration(x, c0, k, ops=pallas_lloyd_ops())
        c1_d, lab_d, e_d = lloyd_iteration(x, c0, k)
        agree, gap = tie_gap(lab_p[None], lab_d[None], x, c0[None])
        sums = torch.zeros((k, d), dtype=torch.float64, device=dev)
        sums.index_add_(0, lab_p.long(), x.double())
        counts = torch.bincount(lab_p.long(), minlength=k).double()
        exact = torch.where(counts[:, None] > 0, sums / counts.clamp_min(
            1.0)[:, None], c0.double())
        scale = exact.abs().max().clamp_min(1.0)
        err_p = float((c1_p.double() - exact).abs().max() / scale)
        err_d = float((c1_d.double() - exact).abs().max() / scale)
        err_pd = float((c1_p - c1_d).abs().max()
                       / c1_d.abs().max().clamp_min(1.0))
        print(f"    lloyd_iteration on pallas_lloyd_ops vs the dense ops: "
              f"labels agree {agree:.7f} (near-tie gap {gap:.2e}), "
              f"centroids {err_pd:.2e} of their scale, energy rel "
              f"{abs(float(e_p) - float(e_d)) / float(e_d):.2e}; against "
              f"the f64 means: kernels {err_p:.2e}, dense ops {err_d:.2e}")
        check(agree == 1.0 or gap <= 1e-5, f"{init} K={k}: pallas ops' "
              f"labels differ beyond a near tie")
        check(err_pd <= 1e-4, f"{init} K={k}: pallas ops' centroids off "
              f"the dense ops' by {err_pd:.2e}")
        check(err_p <= 1e-5, f"{init} K={k}: pallas ops' centroids off "
              f"the f64 means by {err_p:.2e}")
    for eng, (wins, iter_wins, total) in summary.items():
        print(f"  Table 3 summary, {eng}: AA faster in {wins}/{total}, fewer "
              f"iterations in {iter_wins}/{total}")
    # the bounded engine's trace at K = 100 (16-centroid groups, G = 7)
    c0 = seeds[("clarans", 100)]
    tr = aa_kmeans_traced(x, c0, KMeansConfig(k=100, max_iter=cap),
                          backend=get_backend("fused_bounds",
                                              group_size=16))
    post = tr.bound_phases["post_accept"]
    print(f"  aa_kmeans_traced on fused_bounds (clarans K=100, gs 16): "
          f"{int(tr.result.n_accepted)}/{int(tr.result.n_iter)} in "
          f"{tr.wall_time_s!r} s, mse {tr.mse!r}; skipped share after the "
          f"first accepted iteration {post['skipped_frac']!r} over "
          f"{post['n_iters']} iterations")
    check(np.isfinite(tr.mse) and len(tr.bound_stats) == len(tr.energies),
          "the bounded trace")
    # Table 2: fixed and dynamic m from the kmeans++ seeds at K = 10
    c0 = seeds[("kmeans++", 10)]
    times = {}
    for m0 in (2, 5):
        for dynamic in (False, True):
            cfg = KMeansConfig(k=10, max_iter=cap,
                               aa=AAConfig(m0=m0, dynamic_m=dynamic))
            tr = aa_kmeans_traced(x, c0, cfg, backend="dense")
            check(np.isfinite(tr.mse), "Table 2: a non-finite energy")
            times[(m0, dynamic)] = tr.wall_time_s
            print(f"  Table 2, m0={m0} {'dynamic' if dynamic else 'fixed'}: "
                  f"{int(tr.result.n_accepted)}/{int(tr.result.n_iter)} "
                  f"{tr.wall_time_s!r} s mse {tr.mse!r}, m mean "
                  f"{float(np.mean(tr.m_values))!r} max "
                  f"{max(tr.m_values)}")
    print(f"  Table 2 summary: dynamic m faster at m0=2 "
          f"{times[(2, True)] <= times[(2, False)]}, at m0=5 "
          f"{times[(5, True)] <= times[(5, False)]}")
    counts, plain = read_counts()
    path_launches["Tables 2 and 3"] = counts
    print(f"  launches: {counts}; plain-version calls {plain}", flush=True)
    check(plain == 0, "phase 10 called a plain version")
    check(all(counts[kn] > 0 for kn in ("fused_lloyd", "assignment",
                                         "update", "fused_bounds")),
          "phase 10 did not launch every kernel")
    # every kernel of phase 10 against its plain version at the shapes
    # phase 10 gives it (the counts are read, so these launches are not
    # the path's): the fused step, the assignment and the update at each
    # case's last AA centroids and their labels (means: the seeds are rows
    # of x, where |x|^2 - 2 x.c + |c|^2 cancels to a few ulps of |x|^2 on
    # either side), and the bounded step with 16-centroid groups on the
    # bounds of two real steps from the clarans K = 100 seeds
    errs = dict.fromkeys(counts, 0.0)
    for (init, k), c in finals.items():
        got = tuple(o[None] for o in F.fused_lloyd(x, c))
        res = compare(torch, got, tuple(o[None] for o in F.fused_lloyd_plain(
            x, c)), x, c[None], None)
        res_a = compare(torch, tuple(o[None] for o in A.assignment(x, c)),
                        tuple(o[None] for o in A.assignment_plain(x, c)),
                        x, c[None], None)
        lab = got[0][0]
        res_u = compare_stats(U.update(x, lab, k), U.update_plain(x, lab, k))
        print(f"  [{init} K={k}, last AA centroids] fused vs plain: "
              f"{fmt(res)}; assignment vs plain: {fmt(res_a)}; update vs "
              f"plain: sums {res_u['sums_rel']:.2e} (abs "
              f"{res_u['sums_abs']:.2e}), counts {res_u['counts_rel']:.2e}")
        accept(res, f"fused [{init} K={k}]")
        accept(res_a, f"assignment [{init} K={k}]")
        accept_stats(res_u, f"update [{init} K={k}]")
        errs["fused_lloyd"] = max(errs["fused_lloyd"], res["mind_abs"])
        errs["assignment"] = max(errs["assignment"], res_a["mind_abs"])
        errs["update"] = max(errs["update"], res_u["sums_abs"])
    cb, gs, bnds = drifted_bounds(16, x, seeds[("clarans", 100)][None],
                                  None, steps=2)
    res_b = compare_bounds(torch, F.fused_lloyd(x, cb, bounds=bnds, gs=gs),
                           F.fused_bounds_plain(x, cb, None, *bnds, gs,
                                                tile_rows),
                           x, cb, None, bnds[1], bnds[2], tile_rows)
    print(f"  [clarans K=100, two steps' bounds] fused_bounds (gs={gs}, "
          f"G={bnds[1].shape[-1]}) vs plain: {fmt_bounds(res_b)}",
          flush=True)
    accept_bounds(res_b, "fused_bounds [clarans K=100, gs 16]",
                  exact_labels=False)
    errs["fused_bounds"] = res_b["mind_abs"]
    # the CPU bound engines (masked dense PyTorch, no kernel of their own)
    # from the clarans K = 100 seeds: wrapped in the locality engine equal
    # to raw on every leaf, and near dense's energy
    c0 = seeds[("clarans", 100)]
    cfg = KMeansConfig(k=100, max_iter=100)
    dense_res = aa_kmeans(x, c0, cfg, backend="dense")
    e_dense = float(dense_res.energy)
    for name in ("hamerly", "elkan", "yinyang"):
        pair = {}
        for which in (name, f"{name}_reorder"):
            pair[which] = once(lambda: aa_kmeans(x, c0, cfg, backend=which))
        (raw, t_raw), (wrapped, t_wr) = pair.values()
        same = [torch.equal(a, b) for a, b in zip(raw, wrapped)]
        rel = abs(float(raw.energy) - e_dense) / e_dense
        print(f"  {name} (K=100, max_iter 100): raw {t_raw!r} s, wrapped "
              f"{t_wr!r} s; {int(raw.n_accepted)}/{int(raw.n_iter)}, energy "
              f"{float(raw.energy)!r}, {rel:.2e} relative from dense's "
              f"({int(dense_res.n_accepted)}/{int(dense_res.n_iter)}); "
              f"wrapped equal bit for bit on "
              f"{dict(zip(type(raw)._fields, same))}", flush=True)
        check(all(same), f"{name}: the wrapped solve differs from the raw")
        check(rel <= 1e-3, f"{name}: the energy is far from dense's")
    # hamerly_kmeans's step i assigns at the centroids of update i - 1,
    # lloyd_kmeans's iteration j at those of update j: with one more step
    # the baseline ends on the assignment Lloyd ends on
    (c_h, lab_h, e_h, it_h, frac_h), t_h = once(
        lambda: hamerly_kmeans(x, c0, 100, max_iter=101))
    (c_l, lab_l, e_l, it_l), t_l = once(lambda: lloyd_kmeans(x, c0, 100,
                                                             100))
    print(f"  hamerly_kmeans {t_h!r} s ({it_h} iterations, mean scan "
          f"fraction {float(frac_h)!r}) vs lloyd_kmeans {t_l!r} s ({it_l}): "
          f"labels equal {torch.equal(lab_h, lab_l)} "
          f"({int((lab_h != lab_l).sum())} differ), energies "
          f"{float(e_h)!r} and {float(e_l)!r}", flush=True)
    check(torch.equal(lab_h, lab_l) and it_h == it_l + 1,
          "hamerly_kmeans and lloyd_kmeans part")
    return errs


def run():
    """All phases; returns (nvidia-smi line, device name).  Raises
    PhaseError (or whatever a failing call raises) on the first failure."""
    import numpy as np
    import torch
    from repro_torch.core import AAKMeans, get_backend, lloyd
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.core.backends import bounds
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    from repro_torch.core.init_schemes import batched_init
    from repro_torch.core.kmeans import (KMeansConfig, KMeansResult,
                                         _init_state, aa_kmeans,
                                         aa_kmeans_batched, batched_trip)
    from repro_torch.core.locality import (ReorderConfig, inner_carry,
                                           permute_bound_carry, resort,
                                           sort_count, sorted_rows)
    from repro_torch.data.synthetic import (DATASETS, dataset_components,
                                            make_dataset)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U
    from repro_torch.kernels.ref import tie_gap
    from repro_torch.kernels.tiles import pad_rows

    # each kernel's (module, launch count, plain-version count); the
    # "_bf16" entries count the launches of each kernel on a bf16 X (its
    # bf16 variant), which the kernel's own count includes, and the "_tc"
    # ones those of them on the tensor-core sweep (bf16 X and C)
    counters = {"fused_lloyd": (F, "launches", "plain_calls"),
                "assignment": (A, "launches", "plain_calls"),
                "update": (U, "launches", "plain_calls"),
                "fused_bounds": (F, "bounds_launches", "bounds_plain_calls"),
                "fused_lloyd_bf16": (F, "bf16_launches", None),
                "assignment_bf16": (A, "bf16_launches", None),
                "update_bf16": (U, "bf16_launches", None),
                "fused_bounds_bf16": (F, "bounds_bf16_launches", None),
                "fused_lloyd_tc": (F, "tc_launches", None),
                "assignment_tc": (A, "tc_launches", None),
                "fused_bounds_tc": (F, "bounds_tc_launches", None)}
    path_launches = {}

    def zero_counts():
        for mod, launches, plain in counters.values():
            setattr(mod, launches, 0)
            if plain:
                setattr(mod, plain, 0)

    def read_counts():
        """The launches of every kernel since zero_counts, and the
        plain-version calls."""
        got = {name: getattr(mod, launches)
               for name, (mod, launches, _) in counters.items()}
        return got, sum(getattr(mod, p) for mod, _, p in counters.values()
                        if p)

    dev = resolve_device(None)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    print(f"phase 1: {smi}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{name}, SMs {props.multi_processor_count}; bound peaks "
          f"{PEAK_BYTES_PER_S / 1e12} TB/s, {PEAK_FP32_PER_S / 1e12} "
          f"TFLOP/s FP32", flush=True)

    t0 = time.perf_counter()
    logs = build.build(build.KERNELS)
    print(f"phase 2: built {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0!r} s")
    for kname in build.KERNELS:
        print(f"  {kname}: {build.library_path(kname).relative_to(ROOT)}")
        for line in logs[kname].splitlines():
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:
                print(f"    {entry.group(1)}")
            elif "registers" in line or "spill" in line:
                print(f"      {line.strip()}")
    tile_rows = build.tile_rows()
    lib_rows = {kname: getattr(build.load(kname), f"{kname}_tile_rows")()
                for kname in ("fused_lloyd", "fused_bounds")}
    print(f"  rows per tile: {lib_rows}, csrc/sweep_fp32.cuh kRows "
          f"{tile_rows}")
    check(set(lib_rows.values()) == {tile_rows},
          "the libraries and sweep_fp32.cuh disagree on the row tile")
    lib_u = U._bind(build.load("update"))
    spec_main = DATASETS[MAIN_N_NAME]
    main_shape = (spec_main.n, 1, MAIN_K, spec_main.d)
    print(f"  update layout at the main shape: "
          f"{U.layout(lib_u, *main_shape)}; on a bf16 X: "
          f"{U.layout(lib_u, *main_shape, torch.bfloat16)}")
    # the bf16 segment sum (csrc/segment_sum_bf16.cuh) in each library
    # that holds it: no spill, no stack
    for kname in ("update", "fused_lloyd", "fused_bounds"):
        rep = ptxas_report(build.library_path(kname), "sum16")
        print(f"  ptxas, the bf16 segment sum in {kname}: {rep}")
        check(len(rep) == 1 and all(
            v.get("spill_stores", 0) + v.get("spill_loads", 0)
            + v.get("stack", 0) == 0 for v in rep.values()),
              f"the bf16 segment sum in {kname} spills or keeps a stack "
              f"frame, or ptxas reported nothing")
    sys.stdout.flush()

    print("phase 3: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for (label, n, k, d, r, x_per, wkind), group in zip(CASES, CASE_GROUPS):
        rr = r or 1
        x = torch.randn((rr, n, d) if x_per else (n, d), generator=gen,
                        device=dev)
        c = torch.randn((rr, k, d), generator=gen, device=dev)
        w = None
        if wkind == "n":
            w = torch.rand((n,), generator=gen, device=dev) * 2
        elif wkind == "rn":
            w = torch.rand((rr, n), generator=gen, device=dev) * 2
            w[:, : n // 5] = 0.0
        # r None: the unbatched form, c (K, d) and outputs without R
        ck = c if r else c[0]
        lift = (lambda out: out) if r else \
            (lambda out: tuple(o[None] for o in out))
        unlift = (lambda t: t) if r else (lambda t: t[0])
        got_f = lift(F.fused_lloyd(x, ck, w))
        got_a = lift(A.assignment(x, ck))
        want_f = lift(F.fused_lloyd_plain(x, ck, w))
        res_f = compare(torch, got_f, want_f, x, c, w)
        res_a = compare(torch, got_a, want_f[:2], x, c, None)
        print(f"  [{label}: N={n} K={k} d={d} R={rr}] fused: {fmt(res_f)};"
              f" assignment: {fmt(res_a)}")
        accept(res_f, f"fused [{label}]")
        accept(res_a, f"assignment [{label}]")
        # update: labels in [-1, K], so -1 and K land nowhere; (N,) weights
        lab_u = unlift(torch.randint(-1, k + 1, (rr, n), generator=gen,
                                     device=dev, dtype=torch.int32))
        w_u = None if w is None else (w if w.dim() == 1
                                      else w[0].contiguous())
        got_u = U.update(x, lab_u, k, w_u)
        res_u = compare_stats(got_u, U.update_plain(x, lab_u, k, w_u))
        print(f"    update: sums {res_u['sums_rel']:.2e}, counts "
              f"{res_u['counts_rel']:.2e}")
        accept_stats(res_u, f"update [{label}]")
        # fused-bounds on the bounds of two real steps
        cb, gs, bnds = drifted_bounds(group, x, c, w, steps=2)
        args_b = (x, unlift(cb), w, *(unlift(b) for b in bnds))
        got_b = lift(F.fused_lloyd(*args_b[:3], bounds=args_b[3:], gs=gs))
        want_b = lift(F.fused_bounds_plain(*args_b, gs, tile_rows))
        res_b = compare_bounds(torch, got_b, want_b, x, cb, w, bnds[1],
                               bnds[2], tile_rows)
        print(f"    fused_bounds (gs={gs}, G={bnds[1].shape[-1]}): "
              f"{fmt_bounds(res_b)}")
        accept_bounds(res_b, f"fused_bounds [{label}]")
        cases.append((x, ck, w, got_f, got_a, lift, (x, lab_u, k, w_u),
                      got_u, args_b, gs, got_b))
    # rows laid out cluster by cluster with the centroid order matching
    # (the reference's "ordered" layout): most cells skip
    d_o = 16
    for k_o, per, group, least in ORDERED_CASES:
        centers = torch.randn((k_o, d_o), generator=gen, device=dev) * 20.0
        x_o = (centers[:, None, :] + torch.randn(
            (k_o, per, d_o), generator=gen, device=dev)).reshape(-1, d_o)
        c_o = centers + 0.5 * torch.randn((k_o, d_o), generator=gen,
                                          device=dev)
        cb, gs, bnds = drifted_bounds(group, x_o, c_o[None], None, steps=3)
        got_b = F.fused_lloyd(x_o, cb, bounds=bnds, gs=gs)
        res_b = compare_bounds(torch, got_b, F.fused_bounds_plain(
            x_o, cb, None, *bnds, gs, tile_rows), x_o, cb, None, bnds[1],
            bnds[2], tile_rows)
        label = f"cluster-ordered: N={x_o.shape[0]} K={k_o} d={d_o}"
        print(f"  [{label}] fused_bounds (gs={gs}, G={bnds[1].shape[-1]}): "
              f"{fmt_bounds(res_b)}")
        accept_bounds(res_b, f"fused_bounds [{label}]")
        check(res_b["skipped"][0] > least, f"[{label}] skips no more "
              f"than {least} of its cells")
        cases.append((None, None, None, None, None, None, None, None,
                      (x_o, cb, None, *bnds), gs, got_b))
    # cases of one kernel each: (label, launch, its first outputs)
    single = []
    # the update's cluster-range layout: K too large for one block
    x_r = torch.randn((4000, 69), generator=gen, device=dev)
    lab_r = torch.randint(-1, 20001, (4000,), generator=gen, device=dev,
                          dtype=torch.int32)
    lay_r = U.layout(lib_u, 4000, 1, 20000, 69)
    got_u = U.update(x_r, lab_r, 20000)
    res_u = compare_stats(got_u, U.update_plain(x_r, lab_r, 20000))
    print(f"  [update, K=20000 N=4000 d=69: {lay_r.ranges} cluster ranges x "
          f"{lay_r.groups} column groups] sums {res_u['sums_rel']:.2e}, "
          f"counts {res_u['counts_rel']:.2e}")
    check(lay_r.ranges > 1, "K=20000 takes no cluster ranges")
    accept_stats(res_u, "update [K=20000]")
    single.append(("update K=20000", lambda: U.update(x_r, lab_r, 20000),
                   got_u))
    # exact ties: small integers, so every distance is exact; centroid
    # j + 10 duplicates j, and j must win
    x_t = torch.randint(-4, 5, (300, 6), generator=gen, device=dev).float()
    c_t = torch.randint(-4, 5, (10, 6), generator=gen, device=dev).float()
    c_t = torch.cat([c_t, c_t])
    got_t = A.assignment(x_t, c_t)
    want_t = A.assignment_plain(x_t, c_t)
    print(f"  [assignment, exact ties: N=300 K=20 d=6] labels equal "
          f"{torch.equal(got_t[0], want_t[0])}, all below the duplicates "
          f"{bool((got_t[0] < 10).all())}, distances equal "
          f"{torch.equal(got_t[1], want_t[1])}")
    check(torch.equal(got_t[0], want_t[0]) and bool((got_t[0] < 10).all())
          and torch.equal(got_t[1], want_t[1]),
          "assignment: an exact tie did not go to the lowest index")
    single.append(("assignment ties", lambda: A.assignment(x_t, c_t),
                   got_t))
    # a NaN row: NaN distance, label 0 (the first NaN), the rest unharmed
    x_n = torch.randn((1000, 69), generator=gen, device=dev)
    c_n = torch.randn((37, 69), generator=gen, device=dev)
    x_n[7] = float("nan")
    got_n = A.assignment(x_n, c_n)
    want_n = A.assignment_plain(x_n, c_n)
    nan_ok = bool(torch.isnan(got_n[1][7])) and int(got_n[0][7]) == 0 \
        and torch.equal(torch.isnan(got_n[1]), torch.isnan(want_n[1]))
    keep = ~torch.isnan(want_n[1])
    res_n = compare(torch, (got_n[0][keep][None], got_n[1][keep][None]),
                    (want_n[0][keep][None], want_n[1][keep][None]),
                    x_n[keep], c_n[None], None)
    print(f"  [assignment, a NaN row: N=1000 K=37 d=69] NaN row: label "
          f"{int(got_n[0][7])}, distance {float(got_n[1][7])}; the other "
          f"rows: {fmt(res_n)}")
    check(nan_ok, "assignment: the NaN row is not NaN with label 0")
    accept(res_n, "assignment [NaN row, the other rows]")
    single.append(("assignment NaN row", lambda: A.assignment(x_n, c_n),
                   got_n))

    print("phase 4: repeated launches are bitwise equal")
    for (x, c, w, got_f, got_a, lift, args_u, got_u, args_b, gs,
         got_b) in cases:
        label = "cluster-ordered" if x is None else "a phase-3 case"
        if x is not None:
            again = lift(F.fused_lloyd(x, c, w)) + lift(A.assignment(x, c)) \
                + U.update(*args_u)
            for a, b in zip(got_f + got_a + got_u, again):
                check(torch.equal(a, b), f"[{label}] relaunch differs")
        again_b = F.fused_lloyd(*args_b[:3], bounds=args_b[3:], gs=gs)
        if args_b[1].dim() == 2:          # the unbatched form
            again_b = tuple(o[None] for o in again_b)
        for a, b in zip(got_b, again_b):
            check(torch.equal(a, b), f"[{label}] fused_bounds relaunch "
                  f"differs")
    for label, launch, got in single:
        again = launch()
        for a, b in zip(got, again):
            check(torch.equal(a, b) or (torch.isnan(a).any() and torch.equal(
                torch.nan_to_num(a, nan=-1.0), torch.nan_to_num(b, nan=-1.0))),
                  f"[{label}] relaunch differs")
    print(f"  all {len(cases)} cases, all four kernels, and the "
          f"{len(single)} single-kernel cases: equal")
    del cases, single
    sys.stdout.flush()

    print("phase 5: main path at full size")
    spec = DATASETS[MAIN_N_NAME]
    t0 = time.perf_counter()
    x_np = make_dataset(MAIN_N_NAME)
    x = torch.from_numpy(x_np).to(dev)
    torch.cuda.synchronize()
    print(f"  data {tuple(x.shape)} f32 ({x.numel() * 4 / 1e6:.0f} MB) made "
          f"and copied in {time.perf_counter() - t0:.1f} s")
    check(tuple(x.shape) == (spec.n, spec.d), "dataset shape")
    t0 = time.perf_counter()
    # the fit's own seeds (AAKMeans seeds from a generator at seed 0);
    # phase 9 starts from them
    c0_main = batched_init("kmeans++",
                           torch.Generator(device=dev).manual_seed(0), x,
                           MAIN_K, 1)[0]
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    model = AAKMeans(n_clusters=MAIN_K, backend="fused", n_init=1)
    zero_counts()
    t0 = time.perf_counter()
    model.fit(x)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = model.predict(x)
    predict_s = time.perf_counter() - t0
    counts, plain = read_counts()
    path_launches["fused fit + predict"] = counts
    fused_launches, assign_launches = counts["fused_lloyd"], \
        counts["assignment"]
    converged = model.n_iter_ <= model.max_iter
    trips = trips_of(model)
    chunks = -(-spec.n // PREDICT_CHUNK)
    print(f"  seeding {seed_s!r} s (timed alone), fit {fit_s!r} s "
          f"(seeding included), predict {predict_s!r} s "
          f"({spec.n / predict_s!r} rows/s)")
    print(f"  n_iter_ {model.n_iter_}, n_accepted_ {model.n_accepted_}, "
          f"converged {converged}, inertia_ {model.inertia_!r}")
    print(f"  fused launches {fused_launches} vs 1 + trips = {1 + trips}; "
          f"assignment launches {assign_launches} vs predict chunks "
          f"{chunks}; plain-version calls {plain}", flush=True)
    check(fused_launches == 1 + trips, "fused launches != 1 + trips")
    check(assign_launches == chunks, "assignment launches != chunks")
    check(counts["update"] == counts["fused_bounds"] == 0,
          "the fused path launched another engine's kernel")
    check(plain == 0, "the main path called a plain version")
    check(np.isfinite(model.inertia_) and model.inertia_ > 0, "inertia")
    check(labels.shape == (spec.n,) and labels.min() >= 0
          and labels.max() < MAIN_K, "predict labels")
    c_fin = model.centroids_
    got = F.fused_lloyd(x, c_fin)
    want = F.fused_lloyd_plain(x, c_fin)
    res_main = compare(torch, tuple(g[None] for g in got),
                       tuple(v[None] for v in want), x, c_fin[None], None)
    print(f"  fused step vs plain step on the final centroids: "
          f"{fmt(res_main)}")
    accept(res_main, "fused at full size")
    # the fused step launches predict's sweep (sweep_fp32.cuh's
    # launch_assign), so their labels are equal by construction: these
    # checks hold the two wrappers' operands and outputs together
    lab_pred = torch.from_numpy(labels).to(dev)
    agree = float((lab_pred == got[0]).float().mean())
    print(f"  predict labels vs the fused step's on the same centroids: "
          f"{agree:.7f} equal, {int((lab_pred != got[0]).sum())} rows "
          f"differ")
    check(agree == 1.0, "predict and the fused step disagree")
    # ... and so are their distances, bit for bit, at all rows
    lab_all, mind_all = A.assignment(x, c_fin)
    same_d = torch.equal(mind_all, got[1])
    print(f"  the assignment kernel at all rows vs the fused step on the "
          f"same centroids: labels equal {torch.equal(lab_all, got[0])}, "
          f"distances equal bit for bit {same_d} "
          f"({int((mind_all != got[1]).sum())} rows differ)")
    check(same_d and torch.equal(lab_all, got[0]),
          "the fused step's distances are not the assignment kernel's")
    main_abs_err = res_main["mind_abs"]
    del got, want, lab_all, mind_all
    # the assignment kernel at the shape predict gives it: a full chunk
    # and the tail chunk padded with copies of its last row
    tail = spec.n % PREDICT_CHUNK
    assign_abs_err = 0.0
    for what, xc in (("full chunk", x[:PREDICT_CHUNK]),
                     (f"tail chunk ({tail} rows padded)",
                      pad_rows(x[spec.n - tail:], PREDICT_CHUNK))):
        res = compare(torch, tuple(o[None] for o in A.assignment(xc, c_fin)),
                      tuple(o[None] for o in A.assignment_plain(xc, c_fin)),
                      xc, c_fin[None], None)
        print(f"  assignment vs plain on predict's {what}: {fmt(res)}")
        accept(res, f"assignment at predict's {what}")
        assign_abs_err = max(assign_abs_err, res["mind_abs"])
    sys.stdout.flush()

    print("phase 5a: the pallas path at full size (the same seed)")
    model_p = AAKMeans(n_clusters=MAIN_K, backend="pallas", n_init=1)
    zero_counts()
    t0 = time.perf_counter()
    model_p.fit(x)
    torch.cuda.synchronize()
    fit_p_s = time.perf_counter() - t0
    counts_fit, _ = read_counts()
    t0 = time.perf_counter()
    labels_p = model_p.predict(x)
    predict_p_s = time.perf_counter() - t0
    counts_p, plain = read_counts()
    path_launches["pallas fit + predict"] = counts_p
    predict_launches = counts_p["assignment"] - counts_fit["assignment"]
    trips_p = trips_of(model_p)
    rel_p = abs(model_p.inertia_ - model.inertia_) / model.inertia_
    print(f"  fit {fit_p_s!r} s (seeding included), predict "
          f"{predict_p_s!r} s; n_iter_ {model_p.n_iter_}, n_accepted_ "
          f"{model_p.n_accepted_}, inertia_ {model_p.inertia_!r}, "
          f"{rel_p:.2e} relative from the fused fit's")
    print(f"  in the fit: assignment launches {counts_fit['assignment']}, "
          f"update launches {counts_fit['update']} vs 1 + trips = "
          f"{1 + trips_p}; predict: {predict_launches} assignment "
          f"launches vs {chunks} chunks; plain-version calls {plain}",
          flush=True)
    check(counts_fit["assignment"] == counts_fit["update"] == 1 + trips_p,
          "pallas launches != 1 + trips")
    check(predict_launches == chunks, "pallas predict launches != chunks")
    check(counts_p["fused_lloyd"] == counts_p["fused_bounds"] == 0,
          "the pallas path launched another engine's kernel")
    check(plain == 0, "the pallas path called a plain version")
    check(rel_p <= 1e-3, "pallas and fused fits end far apart")
    check(labels_p.shape == (spec.n,), "pallas predict labels")
    lab_p = model_p.labels_
    # both kernels at the shape the fit gives them: all rows, R = 1
    c_p = model_p.centroids_[None]
    res_a = compare(torch, A.assignment(x, c_p), A.assignment_plain(x, c_p),
                    x, c_p, None)
    print(f"  assignment vs plain on all rows at the fit's final centroids: "
          f"{fmt(res_a)}")
    accept(res_a, "assignment at the pallas fit's shape")
    assign_abs_err = max(assign_abs_err, res_a["mind_abs"])
    del c_p
    res_u = compare_stats(U.update(x, lab_p, MAIN_K),
                          U.update_plain(x, lab_p, MAIN_K))
    print(f"  update vs plain on the fit's last labels: sums "
          f"{res_u['sums_rel']:.2e} (abs {res_u['sums_abs']:.2e}), counts "
          f"{res_u['counts_rel']:.2e}")
    accept_stats(res_u, "update at full size")
    update_abs_err = res_u["sums_abs"]
    sys.stdout.flush()

    print("phase 5b: the fused_bounds path at full size")
    rec = StepRecorder(get_backend("fused_bounds"))
    gs_main = engine_group_size(MAIN_K)
    zero_counts()
    t0 = time.perf_counter()
    model_b = AAKMeans(n_clusters=MAIN_K, backend=rec.backend,
                       n_init=1).fit(x)
    torch.cuda.synchronize()
    fit_b_s = time.perf_counter() - t0
    counts_b, plain = read_counts()
    path_launches["fused_bounds fit"] = counts_b
    trips_b = trips_of(model_b)
    skips = torch.cat(rec.skips).tolist()
    rel_b = abs(model_b.inertia_ - model.inertia_) / model.inertia_
    print(f"  default groups: gs {gs_main}, G {-(-MAIN_K // gs_main)}; fit "
          f"{fit_b_s!r} s (seeding included); n_iter_ {model_b.n_iter_}, "
          f"n_accepted_ {model_b.n_accepted_}, inertia_ "
          f"{model_b.inertia_!r}, {rel_b:.2e} relative from the fused "
          f"fit's")
    print(f"  fused_bounds launches {counts_b['fused_bounds']} vs 1 + trips "
          f"= {1 + trips_b}; plain-version calls {plain}; skipped share: "
          f"first trip {skips[1]!r}, median {float(np.median(skips))!r}, "
          f"last trip {skips[-1]!r}", flush=True)
    check(counts_b["fused_bounds"] == 1 + trips_b,
          "fused_bounds launches != 1 + trips")
    check(sum(counts_b.values()) == counts_b["fused_bounds"],
          "the fused_bounds fit launched another kernel")
    check(plain == 0, "the fused_bounds path called a plain version")
    check(rel_b <= 1e-3, "fused_bounds and fused fits end far apart")
    cs_last, carry_last = rec.last
    bnds_d = squared_bounds(carry_last, cs_last, MAIN_K, gs_main)
    del rec, model_b, carry_last
    got = F.fused_lloyd(x, cs_last, bounds=bnds_d, gs=gs_main)
    res_d = compare_bounds(torch, got, F.fused_bounds_plain(
        x, cs_last, None, *bnds_d, gs_main, tile_rows), x, cs_last, None,
        bnds_d[1], bnds_d[2], tile_rows)
    print(f"  fused_bounds vs plain on the default fit's last bounds: "
          f"{fmt_bounds(res_d)}")
    accept_bounds(res_d, "fused_bounds at full size, default groups",
                  exact_labels=False)
    del got, cs_last, bnds_d
    # the cluster-ordered layout: rows sorted by their synthetic
    # component, seeds drawn evenly along the sorted rows
    order = torch.from_numpy(np.argsort(dataset_components(MAIN_N_NAME),
                                        kind="stable")).to(dev)
    x_ord = x[order].contiguous()
    del order
    seeds = x_ord[torch.linspace(0, spec.n - 1, MAIN_K,
                                 device=dev).long()][None]
    rec = StepRecorder(get_backend("fused_bounds", group_size=ORDERED_GS))
    gs_o = engine_group_size(MAIN_K, ORDERED_GS)
    zero_counts()
    t0 = time.perf_counter()
    model_o = AAKMeans(n_clusters=MAIN_K, backend=rec.backend,
                       n_init=1).fit(x_ord, c0s=seeds)
    torch.cuda.synchronize()
    fit_o_s = time.perf_counter() - t0
    counts_o, plain = read_counts()
    path_launches["fused_bounds fit, cluster-ordered"] = counts_o
    trips_o = trips_of(model_o)
    skips_o = torch.cat(rec.skips).tolist()
    print(f"  cluster-ordered, gs {gs_o}, G {-(-MAIN_K // gs_o)}: fit "
          f"{fit_o_s!r} s; n_iter_ {model_o.n_iter_}, n_accepted_ "
          f"{model_o.n_accepted_}, inertia_ {model_o.inertia_!r}; "
          f"fused_bounds launches {counts_o['fused_bounds']} vs 1 + trips "
          f"= {1 + trips_o}; skipped share: first trip {skips_o[1]!r}, "
          f"median {float(np.median(skips_o))!r}, last trip "
          f"{skips_o[-1]!r}", flush=True)
    check(counts_o["fused_bounds"] == 1 + trips_o,
          "ordered fused_bounds launches != 1 + trips")
    check(plain == 0, "the ordered run called a plain version")
    check(np.isfinite(model_o.inertia_), "ordered run inertia")
    check(skips_o[-1] > 0.0, "the cluster-ordered run skips nothing")
    cs_last, carry_last = rec.last
    bnds_o = squared_bounds(carry_last, cs_last, MAIN_K, gs_o)
    del rec, model_o, carry_last
    got = F.fused_lloyd(x_ord, cs_last, bounds=bnds_o, gs=gs_o)
    res_o = compare_bounds(torch, got, F.fused_bounds_plain(
        x_ord, cs_last, None, *bnds_o, gs_o, tile_rows), x_ord, cs_last,
        None, bnds_o[1], bnds_o[2], tile_rows)
    print(f"  fused_bounds vs plain on the ordered run's last bounds: "
          f"{fmt_bounds(res_o)}")
    accept_bounds(res_o, "fused_bounds at full size", exact_labels=False)
    bounds_abs_err = max(res_d["mind_abs"], res_o["mind_abs"])
    skip_conv = res_o["skipped"][0]
    del got
    sys.stdout.flush()

    reorder_last, err_b, err_u = phase5c(torch, x, c0_main, model,
                                         zero_counts, read_counts,
                                         path_launches, tile_rows)
    bounds_abs_err = max(bounds_abs_err, err_b)
    update_abs_err = max(update_abs_err, err_u)
    sys.stdout.flush()

    print("phase 6: the dense oracle from the same seeds at full size")
    t0 = time.perf_counter()
    dense_model = AAKMeans(n_clusters=MAIN_K, backend="dense",
                           n_init=1).fit(x)
    torch.cuda.synchronize()
    rel = abs(dense_model.inertia_ - model.inertia_) / dense_model.inertia_
    print(f"  dense: fit {time.perf_counter() - t0!r} s, n_iter_ "
          f"{dense_model.n_iter_}, n_accepted_ {dense_model.n_accepted_}, "
          f"converged {dense_model.n_iter_ <= dense_model.max_iter}, "
          f"inertia_ {dense_model.inertia_!r}; fused ends {rel:.2e} "
          f"relative from it")
    check(rel <= 1e-3, "fused and dense fits end far apart at full size")
    del dense_model
    sys.stdout.flush()

    print("phase 7: fused vs dense trajectories (N=100000, d=69, K=256, "
          "n_init=3)")
    xm = x[:100000].contiguous()
    c0s = batched_init("kmeans++", torch.Generator(device=dev).manual_seed(1),
                       xm, 256, 3)
    cfg = KMeansConfig(k=256)
    fused, dense = get_backend("fused"), get_backend("dense")
    bounded = get_backend("fused_bounds", group_size=ORDERED_GS)
    worst = {"labels": 0.0, "energy": 0.0, "steps": 0}
    worst_b = {"agree": 1.0, "gap": 0.0, "energy": 0.0, "steps": 0}

    def checked(x_, cs, k, carries, w=None):
        res, carries = fused.batched_step(x_, cs, k, carries, w=w)
        ref_res, _ = dense.batched_step(x_, cs, k, carries, w=w)
        worst["steps"] += 1
        worst["labels"] = max(worst["labels"], float(
            (res.labels != ref_res.labels).float().mean()))
        worst["energy"] = max(worst["energy"], float(
            ((res.energy - ref_res.energy).abs() / ref_res.energy).max()))
        return res, carries

    def checked_bounds(x_, cs, k, carries, w=None):
        res, carries = bounded.batched_step(x_, cs, k, carries, w=w)
        ref_res, _ = fused.batched_step(x_, cs, k, (), w=w)
        agree, gap = tie_gap(res.labels, ref_res.labels, x_, cs)
        worst_b["steps"] += 1
        worst_b["agree"] = min(worst_b["agree"], agree)
        worst_b["gap"] = max(worst_b["gap"], gap)
        worst_b["energy"] = max(worst_b["energy"], float(
            ((res.energy - ref_res.energy).abs() / ref_res.energy).max()))
        return res, carries

    checking = dataclasses.replace(fused, name="fused+dense-check",
                                   batched_step_fn=checked)
    checking_b = dataclasses.replace(bounded, name="fused_bounds+check",
                                     batched_step_fn=checked_bounds)
    runs = {}
    for label, bk in (("fused", fused), ("dense", dense),
                      ("fused, each step redone by dense", checking),
                      (f"fused_bounds (gs {ORDERED_GS}), each step redone "
                       f"by fused", checking_b)):
        t0 = time.perf_counter()
        res = aa_kmeans_batched(xm, c0s, cfg, backend=bk)
        torch.cuda.synchronize()
        runs[label] = res
        print(f"  {label}: n_iter {res.n_iter.tolist()}, n_accepted "
              f"{res.n_accepted.tolist()}, energy "
              f"{[repr(float(e)) for e in res.energy]}, "
              f"{time.perf_counter() - t0:.2f} s")
    print(f"  {worst['steps']} fused steps redone by the dense oracle: labels"
          f" differ on at most {worst['labels']:.2e} of rows, energies by at "
          f"most {worst['energy']:.2e} relative")
    print(f"  {worst_b['steps']} fused_bounds steps redone by the fused "
          f"kernel: labels agree on at least {worst_b['agree']:.7f} of rows "
          f"(largest near-tie gap {worst_b['gap']:.2e}), energies differ by "
          f"at most {worst_b['energy']:.2e} relative")
    check(worst["labels"] <= 1e-4 and worst["energy"] <= 1e-5,
          "a fused step disagrees with the dense oracle")
    check(worst_b["agree"] == 1.0 or worst_b["gap"] <= 1e-5,
          "a fused_bounds step's labels differ from the fused kernel's "
          "beyond a near tie")
    check(worst_b["energy"] <= 1e-5,
          "a fused_bounds step's energy differs from the fused kernel's")
    e_f, e_d = runs["fused"].energy, runs["dense"].energy
    rel = float(((e_f - e_d).abs() / e_d).max())
    print(f"  free-running final energies fused vs dense: {rel:.2e} "
          f"relative at most")
    check(rel <= 1e-3, "fused and dense solves end far apart")
    check(torch.equal(runs["fused"].centroids,
                      runs["fused, each step redone by dense"].centroids),
          "the fused trajectory is not reproducible")
    # the locality engine: sorting on any change ("always") against never
    # sorting ("never") is one program on other data, so bit for bit.
    # Against the raw engine the strict claim is per step: each wrapped
    # step's labels and min_sqdist equal the raw kernel's on the original
    # rows with the carry permuted back (redone below).  Whole fits may
    # part, since the raw step's energy is the kernel's row sum and the
    # wrapper's a torch.sum, and a near tie in the accept test then goes
    # either way: they are held to 1e-4 (the sound runs part by 3.92e-07
    # at R = 1 and 7.19e-05 at R = 2 on the H100), the per-step bit
    # equality carrying the strict claim.
    always_cfg = ReorderConfig(churn_threshold=0.0)
    zero_counts()
    mid = {}
    for r in (1, 2):
        rec = StepRecorder(get_backend("fused_bounds_reorder",
                                       group_size=ORDERED_GS,
                                       churn_threshold=0.0))
        never_bk = get_backend("fused_bounds_reorder", group_size=ORDERED_GS,
                               churn_threshold=1.5)
        if r == 1:
            raw = aa_kmeans(xm, c0s[0], cfg, backend=bounded)
            always = aa_kmeans(xm, c0s[0], cfg, backend=rec.backend)
            never = aa_kmeans(xm, c0s[0], cfg, backend=never_bk)
        else:
            raw = aa_kmeans_batched(xm, c0s[:r], cfg, backend=bounded)
            always = aa_kmeans_batched(xm, c0s[:r], cfg, backend=rec.backend)
            never = aa_kmeans_batched(xm, c0s[:r], cfg, backend=never_bk)
        mid[r] = (raw, always, never, sort_count(rec.out).tolist())
    counts, plain = read_counts()
    path_launches["fused_bounds_reorder at mid size"] = counts
    check(plain == 0, "phase 7's reorder runs called a plain version")
    gs_m = engine_group_size(256, ORDERED_GS)
    # the path's kernels against their plain versions at its own shapes
    # (the counts are read, so these launches are not counted): at the
    # R = 2 run's last carry, the bounded kernel on the sorted rows
    # (per-problem X, (2, N, d)) and the update on each restart's labels
    cs_m, carry_m = rec.last
    carry_ms = resort(carry_m, 256, always_cfg)
    xp = sorted_rows(xm, carry_ms[0])
    bnds_m = squared_bounds(inner_carry(carry_ms), cs_m, 256, gs_m)
    res_b = compare_bounds(torch, F.fused_lloyd(xp, cs_m, bounds=bnds_m,
                                                gs=gs_m),
                           F.fused_bounds_plain(xp, cs_m, None, *bnds_m,
                                                gs_m, tile_rows),
                           xp, cs_m, None, bnds_m[1], bnds_m[2], tile_rows)
    print(f"  fused_bounds vs plain on the sorted rows at the R=2 run's last "
          f"step: {fmt_bounds(res_b)}")
    accept_bounds(res_b, "fused_bounds on phase 7's sorted rows",
                  exact_labels=False)
    del xp
    bounds_abs_err = max(bounds_abs_err, res_b["mind_abs"])
    for i, lab in enumerate(mid[2][1].labels):
        res_u = compare_stats(U.update(xm, lab, 256),
                              U.update_plain(xm, lab, 256))
        print(f"  update vs plain on the R=2 reorder solve's labels "
              f"(restart {i}): sums {res_u['sums_rel']:.2e} (abs "
              f"{res_u['sums_abs']:.2e}), counts {res_u['counts_rel']:.2e}")
        accept_stats(res_u, f"update on phase 7's labels (restart {i})")
        update_abs_err = max(update_abs_err, res_u["sums_abs"])
    for r, (raw, always, never, sorts) in mid.items():
        worst_r = {"steps": 0, "labels": 0, "mind": 0, "sums": 0,
                   "energy": 0.0}
        inner_bk = get_backend("fused_bounds_reorder", group_size=ORDERED_GS,
                               churn_threshold=0.0)

        def redone(x_, cs, k, carries, w=None):
            res, out = inner_bk.batched_step(x_, cs, k, carries, w=w)
            carry_s = resort(carries, k, always_cfg)
            raw_step = F.fused_lloyd(x_, cs, bounds=squared_bounds(
                permute_bound_carry(inner_carry(carry_s), carry_s[1]), cs,
                k, gs_m), gs=gs_m)
            worst_r["steps"] += 1
            worst_r["labels"] += int((res.labels != raw_step[0]).sum())
            worst_r["mind"] += int((res.min_sqdist != raw_step[1]).sum())
            worst_r["sums"] += int((res.sums != raw_step[2]).sum())
            worst_r["energy"] = max(worst_r["energy"], float(
                ((res.energy - raw_step[4]).abs() / raw_step[4]).max()))
            return res, out

        redo = dataclasses.replace(inner_bk, name="reorder+redone",
                                   batched_step_fn=redone)
        again = aa_kmeans(xm, c0s[0], cfg, backend=redo) if r == 1 else \
            aa_kmeans_batched(xm, c0s[:r], cfg, backend=redo)
        same = [torch.equal(a, b) for a, b in zip(always, never)]
        same_again = all(torch.equal(a, b) for a, b in zip(always, again))
        e_rel = float(((always.energy - raw.energy).abs()
                       / raw.energy).max())
        driver = "aa_kmeans" if r == 1 else "aa_kmeans_batched"
        print(f"  fused_bounds_reorder at R={r} ({driver}): always vs never "
              f"equal bit for bit on {dict(zip(KMeansResult._fields, same))};"
              f" sorts {sorts}; n_iter {always.n_iter.tolist()}, n_accepted "
              f"{always.n_accepted.tolist()}, energy "
              f"{always.energy.tolist()}; the raw solve: n_iter "
              f"{raw.n_iter.tolist()}, n_accepted {raw.n_accepted.tolist()},"
              f" energy {raw.energy.tolist()}, labels equal "
              f"{torch.equal(always.labels, raw.labels)}, final energies "
              f"{e_rel:.2e} relative apart", flush=True)
        print(f"    {worst_r['steps']} wrapped steps redone by the raw kernel "
              f"on the original rows: {worst_r['labels']} labels and "
              f"{worst_r['mind']} min_sqdist differ, {worst_r['sums']} sums "
              f"differ bit for bit, energies at most {worst_r['energy']:.2e}"
              f" relative apart; the redone run is the always run bit for "
              f"bit {same_again}", flush=True)
        check(all(same), f"R={r}: always and never sorting differ")
        check(min(sorts) > 0, f"R={r}: the always policy never sorted")
        check(worst_r["labels"] == worst_r["mind"] == 0 and same_again,
              f"R={r}: a wrapped step differs from the raw kernel's")
        check(e_rel <= 1e-4, f"R={r}: the reorder and raw solves end far "
              f"apart")
    del xm, runs
    sys.stdout.flush()

    res9, wall9 = phase9(torch, x, c0_main, model, zero_counts, read_counts,
                         path_launches)
    errs10 = phase10(torch, dev, x, zero_counts, read_counts, path_launches,
                     tile_rows)
    main_abs_err = max(main_abs_err, errs10["fused_lloyd"])
    err11, model_mb = phase11(torch, x, model.inertia_, zero_counts,
                              read_counts, path_launches)
    main_abs_err = max(main_abs_err, err11)
    phase12(torch, x, x_np, model, labels, zero_counts, read_counts,
            path_launches)
    phase13(torch, dev, x, c0_main, res9, wall9, model.max_iter, zero_counts,
            read_counts, path_launches)
    del res9
    serve_launches = phase14(torch, x, x_np, model, labels, model_mb,
                             zero_counts, read_counts, path_launches)
    mb11 = (model_mb.energy_, model_mb.n_steps_, model_mb.n_accepted_)
    del model_mb
    hier_launches, errs15 = phase15(torch, dev, x, c0_main, model, fit_s,
                                    zero_counts, read_counts, path_launches)
    dist_launches = phase16(torch, x, x_np, c0_main, model, labels, fit_s,
                            mb11, path_launches)
    x_bf, c_bf, errs17, tc = phase17(torch, x, c0_main, model, fit_s, mb11,
                                     zero_counts, read_counts, path_launches,
                                     tile_rows)
    wide18, errs18 = phase18(torch, dev, x, zero_counts, read_counts,
                             path_launches, tile_rows, tc)
    main_abs_err = max(main_abs_err, errs15["fused_lloyd"])
    assign_abs_err = max(assign_abs_err, errs15["assignment"])
    update_abs_err = max(update_abs_err, errs15["update"])
    assign_abs_err = max(assign_abs_err, errs10["assignment"])
    update_abs_err = max(update_abs_err, errs10["update"])
    bounds_abs_err = max(bounds_abs_err, errs10["fused_bounds"])

    print("phase 8: times at the main path's shapes (CUDA events, after a "
          "warm-up)")
    n, d, k = spec.n, spec.d, MAIN_K
    c_p = c_fin[None]
    # the bounded kernel's three cases: at the init carry (ub = inf, so
    # every cell computes) with the default groups and with gs_o, and the
    # cluster-ordered run's last step
    bounds_cases = []
    for what, xb, cb, gs in (
            ("default groups, skip 0", x, c_p, gs_main),
            (f"gs {gs_o}, skip 0", x, c_p, gs_o),
            (f"gs {gs_o}, the cluster-ordered run's last step", x_ord,
             cs_last, gs_o)):
        bnds = squared_bounds(bounds.init_carry(x, cb, k, gs), cb, k, gs) \
            if xb is x else bnds_o
        skip = float(F.fused_lloyd(xb, cb, bounds=bnds, gs=gs)[6][0])
        bounds_cases.append((what, xb, cb, gs, bnds, skip))
    # the kernels the main paths launch, timed in turns (this order, then
    # the reverse), 10 launches a turn; each time is the mean of the turns
    turned = {"fused_lloyd": lambda i: F.fused_lloyd(x, c_fin),
              "assignment, all rows": lambda i: A.assignment(x, c_p),
              "update": lambda i: U.update(x, lab_p, k)}
    # each bf16 variant beside its f32 kernel, on phase 17's bf16 X and
    # phase 5's centroids in bf16 (the bounded one at the init carry:
    # G = 2, nothing skipped)
    cb_p = c_bf[None]
    bnds_b = squared_bounds(bounds.init_carry(x, cb_p, k, gs_main),
                            cb_p.float(), k, gs_main)
    skip_b = float(F.fused_lloyd(x_bf, cb_p, bounds=bnds_b, gs=gs_main)[6][0])
    # and on phase 5c's cluster-ordered rows at its last step's bounds
    # (G = 16), where most cells skip
    x_ord_b, cs_last_b = x_ord.to(torch.bfloat16), cs_last.to(torch.bfloat16)
    skip_ob = float(F.fused_lloyd(x_ord_b, cs_last_b, bounds=bnds_o,
                                  gs=gs_o)[6][0])
    n_chunks_b = n // PREDICT_CHUNK

    def chunk_b(i):
        return x_bf[(i % n_chunks_b) * PREDICT_CHUNK:
                    (i % n_chunks_b + 1) * PREDICT_CHUNK]

    cbf = c_bf.float()
    c_sq_b = torch.sum(cbf * cbf, dim=-1)
    # the bf16 update (csrc/segment_sum_bf16.cuh) also on the rows sorted
    # by the pallas fit's labels, where each 32-row group holds one or two
    # labels, beside index_add_ of the upcast X; first the sorted launch
    # against its f32 launch on the upcast X, bit for bit
    order_p = torch.argsort(lab_p, stable=True)
    x_bf_s, lab_ps = x_bf[order_p].contiguous(), lab_p[order_p].contiguous()
    del order_p
    eq_sorted = all(torch.equal(a, b) for a, b in zip(
        U.update(x_bf_s, lab_ps, k), U.update(x_bf_s.float(), lab_ps, k)))
    print(f"  the bf16 update on the label-sorted rows: bit-equal to its f32 "
          f"launch on the upcast X {eq_sorted}")
    check(eq_sorted, "the bf16 update on label-sorted rows is not its f32 "
          "launch on the upcast X")
    sums_b16 = torch.zeros(k, d, device=dev)
    turned.update({
        "fused_lloyd bf16": lambda i: F.fused_lloyd(x_bf, c_bf),
        "assignment bf16, all rows": lambda i: A.assignment(x_bf, cb_p),
        "assignment bf16, chunk": lambda i: A.assignment(chunk_b(i), c_bf),
        "update bf16": lambda i: U.update(x_bf, lab_p, k),
        "update bf16, label-sorted rows": lambda i: U.update(x_bf_s, lab_ps,
                                                             k),
        "index_add_ bf16 (upcast X)": lambda i: sums_b16.index_add_(
            0, lab_p, x_bf.float()),
        "fused_bounds bf16, default groups, skip 0": lambda i: F.fused_lloyd(
            x_bf, cb_p, bounds=bnds_b, gs=gs_main),
        "fused_bounds bf16, the cluster-ordered run's last step":
            lambda i: F.fused_lloyd(x_ord_b, cs_last_b, bounds=bnds_o,
                                    gs=gs_o)})
    # the library on the same bf16 operands (torch.mm with f32 output, the
    # epilogue, argmin), where this torch has the overload, and f32 addmm
    # on the upcast operands, in the same turns
    has_mm = mm_argmin(torch, x_bf[:128], c_bf, c_sq_b) is not None
    if has_mm:
        turned.update({
            "mm bf16, all rows": lambda i: mm_argmin(torch, x_bf, c_bf,
                                                     c_sq_b),
            "mm bf16, chunk": lambda i: mm_argmin(torch, chunk_b(i), c_bf,
                                                  c_sq_b)})
    else:
        print("  torch.mm(out_dtype=torch.float32) is not in this torch: no "
              "bf16 library call")
    turned.update({
        "addmm upcast bf16, all rows": lambda i: torch.argmin(torch.addmm(
            c_sq_b, x_bf.float(), cbf.T, alpha=-2.0), dim=1),
        "addmm upcast bf16, chunk": lambda i: torch.argmin(torch.addmm(
            c_sq_b, chunk_b(i).float(), cbf.T, alpha=-2.0), dim=1)})
    for what, xb, cb, gs, bnds, _ in bounds_cases:
        turned[f"fused_bounds, {what}"] = (
            lambda i, xb=xb, cb=cb, gs=gs, bnds=bnds: F.fused_lloyd(
                xb, cb, bounds=bnds, gs=gs))
    # the locality engine's parts of a step at phase 5c's last carry: the
    # sort decision (a stable sort and the carry's re-gather, computed
    # every step), the X gather, the update on the original-order labels,
    # the bounded step on the sorted rows, and the whole wrapped step;
    # beside them the raw bounded step on the original rows at the same
    # carry
    bk_r, cs_r, carry_r, bnds_rr, gs_r = reorder_last
    cfg_r = ReorderConfig()
    carry_rs = resort(carry_r, k, cfg_r)
    xp_r = sorted_rows(x, carry_rs[0])
    bnds_rs = squared_bounds(inner_carry(carry_rs), cs_r, k, gs_r)
    lab_r = bk_r.batched_step(x, cs_r, k, carry_r)[0].labels[0]
    reorder_parts = {
        "reorder: sort + carry re-gather": lambda i: resort(carry_r, k,
                                                            cfg_r),
        "reorder: X gather": lambda i: sorted_rows(x, carry_rs[0]),
        "reorder: update": lambda i: U.update(x, lab_r, k),
        "reorder: bounded step, sorted rows": lambda i: F.fused_lloyd(
            xp_r, cs_r, bounds=bnds_rs, gs=gs_r),
        "reorder: the whole wrapped step": lambda i: bk_r.batched_step(
            x, cs_r, k, carry_r),
        "raw bounded step, original rows, same carry": lambda i:
            F.fused_lloyd(x, cs_r, bounds=bnds_rr, gs=gs_r)}
    turned.update(reorder_parts)
    turns = {what: [] for what in turned}
    for order in (list(turned), list(reversed(turned))):
        for what in order:
            turns[what].append(event_ms(torch, turned[what], 10))
    turn_ms = {what: sum(ts) / len(ts) for what, ts in turns.items()}
    print("  in turns: " + "; ".join(
        f"{what} {ts!r} ms" for what, ts in turns.items()))
    fused_ms = turn_ms["fused_lloyd"]
    assign_full_ms = turn_ms["assignment, all rows"]
    update_ms = turn_ms["update"]
    pair_ms = assign_full_ms + update_ms
    print(f"  fused step {fused_ms!r} ms against the pallas pair "
          f"(assignment at all rows + update) {pair_ms!r} ms: "
          f"{fused_ms / pair_ms!r} of it")
    fused_plain_ms = event_ms(torch, lambda i: F.fused_lloyd_plain(x, c_fin),
                              3, warmup=1)
    fused_bytes = 4 * (n * d + k * d) + 4 * (2 * n + k * d + k + 1)
    fused_bound, fused_by, fused_fp32, fused_tc = distance_bound_ms(
        fused_bytes, 2 * n * k * d, 3 * n * k + 2 * n * d)
    step = PREDICT_CHUNK
    n_chunks = n // step

    def chunk(i):
        return x[(i % n_chunks) * step:(i % n_chunks + 1) * step]

    assign_ms = event_ms(torch, lambda i: A.assignment(chunk(i), c_fin), 50)
    assign_plain_ms = event_ms(
        torch, lambda i: A.assignment_plain(chunk(i), c_fin), 50)
    c_sq = torch.sum(c_fin * c_fin, dim=-1)

    def library(i):
        xc = chunk(i)
        return torch.argmin(torch.addmm(c_sq, xc, c_fin.T, alpha=-2.0),
                            dim=1)

    library_ms = event_ms(torch, library, 50)

    def assign_bounds(rows):
        return distance_bound_ms(4 * (rows * d + k * d) + 4 * 2 * rows,
                                 2 * rows * k * d, 3 * rows * k)

    assign_bound, assign_by, assign_fp32, assign_tc = assign_bounds(step)
    # the shape the pallas fit gives it: all rows at R = 1
    library_full_ms = event_ms(
        torch, lambda i: torch.argmin(torch.addmm(c_sq, x, c_fin.T,
                                                  alpha=-2.0), dim=1), 5)
    full_bound, full_by, full_fp32, full_tc = assign_bounds(n)
    print(f"  fused_lloyd (N={n}, K={k}, d={d}, R=1): {fused_ms!r} ms, "
          f"bound {fused_bound!r} ms ({fused_by}; FP32-core bound "
          f"{fused_fp32!r} ms, split-TF32 bound {fused_tc!r} ms), plain "
          f"{fused_plain_ms!r} ms")
    print(f"  assignment (predict chunk {step} x {k} x {d}): "
          f"{assign_ms!r} ms, bound {assign_bound!r} ms ({assign_by}; "
          f"FP32-core bound {assign_fp32!r} ms), plain {assign_plain_ms!r} "
          f"ms, matmul+argmin {library_ms!r} ms")
    print(f"  assignment (the pallas fit's shape: all {n} rows x {k} x {d}, "
          f"R=1): {assign_full_ms!r} ms, bound {full_bound!r} ms "
          f"({full_by}; FP32-core bound {full_fp32!r} ms), matmul+argmin "
          f"{library_full_ms!r} ms")
    # the update kernel on the pallas fit's labels; its library yardstick
    # is the one call that computes the sums
    update_plain_ms = event_ms(torch, lambda i: U.update_plain(x, lab_p, k),
                               3, warmup=1)
    sums_buf = torch.zeros(k, d, device=dev)
    update_lib_ms = event_ms(
        torch, lambda i: sums_buf.index_add_(0, lab_p, x), 10)
    update_bytes = 4 * (n * d + n) + 4 * (k * d + k)
    update_bound, update_by = bound_ms(update_bytes, n * d + n)
    print(f"  update (N={n}, K={k}, d={d}, R=1, labels of the pallas fit): "
          f"{update_ms!r} ms, bound {update_bound!r} ms ({update_by}), "
          f"plain {update_plain_ms!r} ms, index_add_ (sums only) "
          f"{update_lib_ms!r} ms")
    # the dense oracle's stats (lloyd.weighted_cluster_sums: one-hot
    # matmuls over row chunks, so they repeat bit for bit) against the
    # index_add_ pair they replace, and the dense step they sit in
    ones = torch.ones(n, device=dev)
    lab_l = lab_p.long()
    onehot_ms = event_ms(torch, lambda i: lloyd.weighted_cluster_sums(
        x, lab_p, ones, k), 3, warmup=1)
    index_add_ms = event_ms(torch, lambda i: (
        torch.zeros(k, d, device=dev).index_add_(0, lab_l, x),
        torch.zeros(k, device=dev).index_add_(0, lab_l, ones)), 3, warmup=1)
    dense = get_backend("dense")
    dense_step_ms = event_ms(torch, lambda i: dense.step(x, c_fin, k), 3,
                             warmup=1)
    print(f"  the dense oracle's stats (N={n}, K={k}, d={d}): one-hot "
          f"chunks {onehot_ms!r} ms, index_add_ (sums and counts) "
          f"{index_add_ms!r} ms; the dense step {dense_step_ms!r} ms")
    del ones, lab_l

    def bounds_cost(g, skip):
        """(bytes, cross-term operations, other operations) of one bounded
        step with G groups of which the share ``skip`` of (tile, group)
        cells is skipped."""
        n_bytes = 4 * (n * d + k * d + 2 * n + n * g) \
            + 4 * (2 * n + n * g + k * d + k + 1) + 8
        return (n_bytes, (1.0 - skip) * 2 * n * k * d,
                (1.0 - skip) * 3 * n * k + 2 * n * d)

    bounds_rows = []
    for what, xb, cb, gs, bnds, skip in bounds_cases:
        ms = turn_ms[f"fused_bounds, {what}"]
        b_ms, b_by, b_fp32, _ = distance_bound_ms(
            *bounds_cost(bnds[1].shape[-1], skip))
        bounds_rows.append((what, skip, ms, b_ms, b_by, b_fp32, bnds))
        print(f"  fused_bounds ({what}: G={bnds[1].shape[-1]}, skipped "
              f"{skip!r}): {ms!r} ms ({ms / fused_ms!r} of the fused step), "
              f"bound {b_ms!r} ms ({b_by}; FP32-core bound {b_fp32!r} ms)")
    del bounds_cases
    (_, skip0, bounds_ms_main, bounds_bound, bounds_by, bounds_fp32,
     bnds0) = bounds_rows[0]
    bounds_plain_ms = event_ms(
        torch, lambda i: F.fused_bounds_plain(x, c_p, None, *bnds0,
                                              gs_main, tile_rows), 3,
        warmup=1)
    skip_sorted = float(F.fused_lloyd(xp_r, cs_r, bounds=bnds_rs,
                                      gs=gs_r)[6][0])
    skip_raw = float(F.fused_lloyd(x, cs_r, bounds=bnds_rr, gs=gs_r)[6][0])
    g_r = bnds_rs[1].shape[-1]
    sorted_bound = distance_bound_ms(*bounds_cost(g_r, skip_sorted))
    raw_bound = distance_bound_ms(*bounds_cost(g_r, skip_raw))
    print(f"  the locality engine at phase 5c's last step (gs {gs_r}; skipped "
          f"share {skip_sorted!r} on the sorted rows, {skip_raw!r} on the "
          f"original rows): " + "; ".join(
              f"{what} {turn_ms[what]!r} ms" for what in reorder_parts)
          + f"; bounded step bounds: sorted rows {sorted_bound[0]!r} ms "
          f"({sorted_bound[1]}; FP32-core bound {sorted_bound[2]!r} ms), "
          f"original rows {raw_bound[0]!r} ms ({raw_bound[1]}; FP32-core "
          f"bound {raw_bound[2]!r} ms)")
    del xp_r, carry_rs, bnds_rs, reorder_last, reorder_parts
    print(f"  fused_bounds plain (default groups, skip 0): "
          f"{bounds_plain_ms!r} ms; the ordered run converged at skip "
          f"{skip_conv!r}")
    # the bf16 variants: times in turns above; plain versions (which
    # upcast), library calls on the upcast operands, bounds at 2-byte X
    bf = {}
    bf["fused_lloyd"] = dict(
        ms=turn_ms["fused_lloyd bf16"],
        plain_ms=event_ms(torch, lambda i: F.fused_lloyd_plain(x_bf, c_bf), 3,
                          warmup=1),
        library_ms=None, bounds=bf16_bound_ms(
            2 * (n * d + k * d) + 4 * (2 * n + k * d + k + 1),
            2 * n * k * d, tc_other(n, k, d, chains=True)))
    bf["assignment"] = dict(
        ms=turn_ms["assignment bf16, chunk"],
        plain_ms=event_ms(torch, lambda i: A.assignment_plain(chunk_b(i),
                                                              c_bf), 50),
        library_ms=turn_ms.get("mm bf16, chunk"),
        upcast_library_ms=turn_ms["addmm upcast bf16, chunk"],
        bounds=bf16_bound_ms(2 * (step * d + k * d) + 4 * 2 * step,
                             2 * step * k * d, tc_other(step, k, d)),
        all_rows=dict(
            ms=turn_ms["assignment bf16, all rows"],
            library_ms=turn_ms.get("mm bf16, all rows"),
            upcast_library_ms=turn_ms["addmm upcast bf16, all rows"],
            bounds=bf16_bound_ms(2 * (n * d + k * d) + 4 * 2 * n,
                                 2 * n * k * d, tc_other(n, k, d))))
    bf["update"] = dict(
        ms=turn_ms["update bf16"],
        plain_ms=event_ms(torch, lambda i: U.update_plain(x_bf, lab_p, k), 3,
                          warmup=1),
        library_ms=turn_ms["index_add_ bf16 (upcast X)"],
        sorted_ms=turn_ms["update bf16, label-sorted rows"])
    u_ms, u_by = bound_ms(2 * n * d + 4 * n + 4 * (k * d + k), n * d + n)
    bf["update"]["bounds"] = (u_ms, u_by, u_ms)
    print(f"  update bf16 on the label-sorted rows {bf['update']['sorted_ms']!r}"
          f" ms, {bf['update']['sorted_ms'] / bf['update']['ms']!r}x the "
          f"unsorted rows' in the same turns")
    del x_bf_s, lab_ps, sums_b16
    def bf16_bounded_bound(g_, skip_):
        """The bf16 bounded step's bounds on the tensor cores: its computed
        share's products and epilogue (TC_BOUNDED_INSTR a (row,
        centroid)) beside the |x|^2 chains, against X, C, the bounds, the
        group minima and the fused step's outputs."""
        live = 1.0 - skip_
        return bf16_bound_ms(
            2 * (n * d + k * d) + 4 * (2 * n + n * g_)
            + 4 * (2 * n + n * g_ + k * d + k + 1) + 8,
            live * 2 * n * k * d,
            live * tc_other(n, k, d, False, TC_BOUNDED_INSTR) + 2 * n * d)

    bf["fused_bounds"] = dict(
        ms=turn_ms["fused_bounds bf16, default groups, skip 0"],
        plain_ms=event_ms(torch, lambda i: F.fused_bounds_plain(
            x_bf, cb_p, None, *bnds_b, gs_main, tile_rows), 3, warmup=1),
        library_ms=None,
        bounds=bf16_bounded_bound(bnds_b[1].shape[-1], skip_b),
        ordered=dict(
            ms=turn_ms["fused_bounds bf16, the cluster-ordered run's last "
                       "step"], skipped=skip_ob,
            bounds=bf16_bounded_bound(bnds_o[1].shape[-1], skip_ob)))
    for kn, row in bf.items():
        f32_ms = {"fused_lloyd": fused_ms, "assignment": assign_ms,
                  "update": update_ms, "fused_bounds": bounds_ms_main}[kn]
        b_ms, b_by, b_fp32 = row["bounds"]
        print(f"  {kn} bf16: {row['ms']!r} ms (f32 {f32_ms!r} ms, "
              f"{row['ms'] / f32_ms!r} of it), bound {b_ms!r} ms ({b_by}; "
              f"FP32-core bound {b_fp32!r} ms), plain {row['plain_ms']!r} ms"
              + ("" if row["library_ms"] is None else
                 f", library {row['library_ms']!r} ms")
              + ("" if "upcast_library_ms" not in row else
                 f" (torch.mm with f32 output on the bf16 operands, the "
                 f"epilogue and argmin), f32 addmm + argmin on the upcast "
                 f"operands {row['upcast_library_ms']!r} ms")
              + (", library on the upcast X" if kn == "update" else ""))
    row, fused_b = bf["fused_bounds"], turn_ms["fused_lloyd bf16"]
    ordered_f32 = (f"fused_bounds, gs {gs_o}, the cluster-ordered run's "
                   f"last step")
    print(f"  fused_bounds bf16 on the tensor cores against the bf16 fused "
          f"step in the same turns: skip 0 {row['ms'] / fused_b!r}x; the "
          f"cluster-ordered run's last step (gs {gs_o}, skipped {skip_ob!r}) "
          f"{row['ordered']['ms']!r} ms, {row['ordered']['ms'] / fused_b!r}x, "
          f"bound {row['ordered']['bounds'][0]!r} ms "
          f"({row['ordered']['bounds'][1]}), the f32 step there "
          f"{turn_ms[ordered_f32]!r} ms")
    row = bf["assignment"]["all_rows"]
    print(f"  assignment bf16 at all rows: {row['ms']!r} ms (f32 "
          f"{assign_full_ms!r} ms), bound {row['bounds'][0]!r} ms "
          f"({row['bounds'][1]}; FP32-core bound {row['bounds'][2]!r} ms), "
          f"torch.mm with f32 output + argmin {row['library_ms']!r} ms, "
          f"f32 addmm + argmin on the upcast operands "
          f"{row['upcast_library_ms']!r} ms")
    kernel_s = fused_launches * fused_ms / 1e3
    print(f"  fit of phase 5 split: seeding {seed_s!r} s, fused launches x "
          f"kernel time {kernel_s!r} s, the rest (host loop, Anderson "
          f"window) {fit_s - seed_s - kernel_s!r} s")
    # one trip of the solver loop at the main path's shapes, with the
    # loop's one sync: the fused kernel's share of it bounds the device's
    # idle share from above
    cfg_main = KMeansConfig(k=k)
    bst = _init_state(x, c_fin[None], cfg_main, fused)
    trips = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(trips):
        bst = batched_trip(x, bst, cfg_main, fused)
        bool(torch.any(bst.pending))
    trip_ms = (time.perf_counter() - t0) / trips * 1e3
    print(f"  one loop trip: {trip_ms!r} ms wall; the fused kernel is "
          f"{fused_ms / trip_ms!r} of it, so the device idles at most "
          f"{max(0.0, 1 - fused_ms / trip_ms)!r} of a trip")
    print("  launches per path: " + "; ".join(
        f"{path}: " + ", ".join(f"{kn} {v}" for kn, v in c.items() if v)
        for path, c in path_launches.items()))
    total = {kn: sum(c.get(kn, 0) for c in path_launches.values())
             for kn in counters}
    # a kernel's own count includes its bf16 variant's launches
    for kn in bf:
        total[kn] -= total[f"{kn}_bf16"]
    kernels = [
        {"name": "fused_lloyd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_lloyd.cu",
         "replaces": "src/repro/kernels/fused_lloyd.py:55",
         "launches": total["fused_lloyd"], "max_abs_err": main_abs_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms,
         "bound_ms": fused_bound, "bound_by": fused_by,
         "fp32_bound_ms": fused_fp32, "library_ms": None,
         "hierarchy_launches": hier_launches.get("fused_lloyd", 0),
         "distributed_launches": dist_launches["fused_lloyd"]},
        {"name": "assignment", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/assignment.cu",
         "replaces": "src/repro/kernels/assignment.py:37",
         "launches": total["assignment"], "max_abs_err": assign_abs_err,
         "ms": assign_ms, "plain_ms": assign_plain_ms,
         "bound_ms": assign_bound, "bound_by": assign_by,
         "fp32_bound_ms": assign_fp32, "library_ms": library_ms,
         "serving_launches": serve_launches,
         "hierarchy_launches": hier_launches.get("assignment", 0),
         "distributed_launches": dist_launches["assignment"],
         "all_rows": {"ms": assign_full_ms, "bound_ms": full_bound,
                      "bound_by": full_by, "fp32_bound_ms": full_fp32,
                      "library_ms": library_full_ms}},
        {"name": "update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/update.cu",
         "replaces": "src/repro/kernels/update.py:30",
         "launches": total["update"], "max_abs_err": update_abs_err,
         "ms": update_ms, "plain_ms": update_plain_ms,
         "bound_ms": update_bound, "bound_by": update_by,
         "fp32_bound_ms": update_bound, "library_ms": update_lib_ms,
         "hierarchy_launches": hier_launches.get("update", 0),
         "distributed_launches": dist_launches["update"]},
        {"name": "fused_bounds", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_bounds.cu",
         "replaces": "src/repro/kernels/fused_lloyd.py:123",
         "launches": total["fused_bounds"], "max_abs_err": bounds_abs_err,
         "ms": bounds_ms_main, "plain_ms": bounds_plain_ms,
         "bound_ms": bounds_bound, "bound_by": bounds_by,
         "fp32_bound_ms": bounds_fp32, "library_ms": None,
         "distributed_launches": dist_launches["fused_bounds"]},
    ]
    replaces = {kn["name"]: kn["replaces"] for kn in kernels}
    for kn, row in bf.items():
        b_ms, b_by, b_fp32 = row["bounds"]
        entry = {"name": f"{kn}_bf16", "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{kn}.cu",
                 "replaces": replaces[kn], "launches": total[f"{kn}_bf16"],
                 "max_abs_err": errs17[kn], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": b_ms,
                 "bound_by": b_by, "fp32_bound_ms": b_fp32,
                 "library_ms": row["library_ms"]}
        if "ordered" in row:
            o_ms, o_by, o_fp32 = row["ordered"]["bounds"]
            entry["ordered"] = {
                "ms": row["ordered"]["ms"],
                "skipped": row["ordered"]["skipped"], "bound_ms": o_ms,
                "bound_by": o_by, "fp32_bound_ms": o_fp32}
        if kn != "update":
            # the sweep of the three distance kernels on bf16 X and C
            entry["tensor_cores"] = {
                "source": "src/repro_torch/kernels/csrc/sweep_tc.cuh",
                "launches": total[f"{kn}_tc"],
                "cross_error": tc["cross_error"], "hgmma": tc["hgmma"]}
        if "upcast_library_ms" in row:
            entry["upcast_library_ms"] = row["upcast_library_ms"]
        if kn == "update":
            # its own kernel on a bf16 X, launched through update.cu
            entry["source"] = \
                "src/repro_torch/kernels/csrc/segment_sum_bf16.cuh"
            entry["sorted_ms"] = row["sorted_ms"]
        if "all_rows" in row:
            a_ms, a_by, a_fp32 = row["all_rows"]["bounds"]
            entry["all_rows"] = {
                "ms": row["all_rows"]["ms"], "bound_ms": a_ms,
                "bound_by": a_by, "fp32_bound_ms": a_fp32,
                "library_ms": row["all_rows"]["library_ms"],
                "upcast_library_ms": row["all_rows"]["upcast_library_ms"]}
        kernels.append(entry)
    # phase 18's wide rows: every entry's launches on the wide main paths
    # and its time at the Llama table's shape, with the rest of the row
    for entry in kernels:
        row = wide18[entry["name"]]
        b_ms, b_by, b_fp32 = row["bounds"]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   errs18.get(entry["name"], 0.0))
        entry["wide_launches"] = row["launches"]
        entry["wide_ms"] = row["ms"]
        entry["wide"] = {
            "shape": [LLAMA_VOCAB, LLAMA_HIDDEN, WIDE_K],
            "check_launches": row["check_launches"],
            "subspace_ms": row["subspace_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "fp32_bound_ms": b_fp32,
            "library_ms": row["library_ms"]}
        for key in ("upcast_library_ms",):
            if key in row:
                entry["wide"][key] = row[key]
        if "chunk_ms" in row:
            entry["wide"]["chunk"] = {
                "ms": row["chunk_ms"], "bound_ms": row["chunk_bounds"][0],
                "fp32_bound_ms": row["chunk_bounds"][2],
                "library_ms": row["chunk_library_ms"]}
            if "chunk_upcast_library_ms" in row:
                entry["wide"]["chunk"]["upcast_library_ms"] = \
                    row["chunk_upcast_library_ms"]
        for key in ("k1000", "sorted_carried"):
            if key not in row:
                continue
            k_ms, k_by, k_fp32 = row[key]["bounds"]
            entry["wide"][key] = {
                "ms": row[key]["ms"], "bound_ms": k_ms, "bound_by": k_by,
                "fp32_bound_ms": k_fp32,
                "library_ms": row[key].get("library_ms")}
            for extra in ("fused_ms", "skipped"):
                if extra in row[key]:
                    entry["wide"][key][extra] = row[key][extra]
        for key in ("forced_stream", "stream_ptxas", "tc_ptxas",
                    "sorted_ms", "sorted_shares"):
            if key in row:
                entry["wide"][key] = row[key]
    print(json.dumps({"kernels": kernels}))
    return smi, name


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: the port (src/repro_torch) is not under {ROOT}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        smi, name = run()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(f"power: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
