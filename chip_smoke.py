#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `src/repro_torch/kernels/csrc/` (first use
builds them), then runs these phases -- 1 to 3d, 4g's padded round trips and
3e in order, then each full-width phase followed by its multiple-loading
case and its kernels' times (4, 5, 4g, 4h, 4i, 5's block shapes, 4j, 4k, 4b,
4g, 5b, 4j, 4c, 4g, 5c, 4c', 4d, 4i, 5d, 4e, 5d, 4f, 5d), then DBLP at
its full size through multiple loading (4g), then 6a to 6f, 7, and last 8 -- and fails
(non-zero exit, no result line) as soon as a phase fails.  The kernels compiled in several
block shapes, which the tile knobs select (`kernels/ops.py` VARIANTS), are
held and timed in each: match_count and tanimoto_count with 128 and 32
query rows a block (phases 2, 2c: each shape through its C entry at every
parity shape, the 32-row one also at Q = 1, 7, 31, 32, 33 with m odd and
4095 to 8193, and the identity; phase 5 at Q = 1, 16, 64, 1024; 4i and 4c
launch the 32-row shape on the main path), packed_cosine_topk and
packed_tanimoto_topk with tiles of 2048 and 1024 data rows (2, 2c: every
case at both tiles; 5b, 5c: both tiles with topk_from_candidates, and the
PACKED search with a tuned 1024-row tile in turns with the default):

  1. environment and build: versions, the card's name and power limit, the
     kernels' build time and what ptxas reports for them;
  2. each kernel against its plain PyTorch version on the card, bit-exact, at
     odd shapes (nothing a multiple of a tile): match_count (also with ids of
     three classes -- in [0, 31744), the float16 path of its equality tile;
     the same with one general-path id in some chunks; full-range int32 --
     at m odd and m = 4095 to 8193 around the tile's 4096-column flush, and
     ids 0..31743 against themselves, m = 1 and 2, which must count m times
     the identity), cpq_hist (1 to 58,112 bins -- 453 / 454 on either side
     of its per-thread counters --, whole rows and chunked rows, Q = 1 with
     N = 1,000,003, odd N, a row of 16.8 M counts past one flush of its
     16-bit counters, skewed counts with -1 and past-max_count entries, every
     entry in one bin), cosine_count (with zero rows), packed_cosine_count
     (V from 1 to 544; W = 1, 7, 8, 9, 16 and 17 at Q and N past one block of
     its carry-save tile and ragged, on random, all-equal and complementary
     rows), and packed_cosine_topk (k from 1 to above the tile, N
     not a multiple of the tile, N < k, all-equal rows; W = 1, 7, 8, 9 on its
     one-byte count tile, 10, 15, 16, 17, 170 on its two-byte one, bins in
     device scratch from 16; rows near the complement of a query, so that
     fewer than kc rows of a tile count above the one-byte tile's collapsed
     end and the kernel recounts), whose buffers reduced by
     topk_from_candidates must also equal a sort of the counts; 2c. the three TANIMOTO kernels the same way:
     tanimoto_count (m from 1 to 8193, the same value classes and identity
     check as match_count), packed_tanimoto_count (bucket ids 0 to
     253, m from 1 to 8200: across its 32-column chunks and the flush of its
     lanes after 127 of them, one query row equal to a data row) and
     packed_tanimoto_topk (k from 1 to above the
     tile; m = 1, 37, 238, 254 and 255 on either side of its one-byte count
     tile, 503 and 504 on either side of its bins' move to device scratch,
     and 6000); 2d. range_count (d = 1 to 37 and 2100, past one flush of its
     float16 lanes; data all in [-2048, 2048] (its float16 path), the same
     with +-2049 / +-2050 or the ends of int32 in some tiles, and full-range
     int32; bounds around +-2049 and at the ends of int32, empty ranges, lo =
     hi, the pad (1, 0); output rows that are and are not 16-byte aligned),
     minsum_count (V = 1 to 9000, across its
     4096-column window; dense rows of values 0 to 127, sparse rows of at most
     38 non-zeros and all-zero rows, values near INT32_MAX whose sums wrap,
     -1 pad rows; the wrapper's pick, the sparse kernel and the dense tile
     each, and the conversion's lists against their plain versions) and
     ip_count (V = 1 to 8195, int8 {0, 1}, and int32 / float32 through the
     wrapper);
     2e. cosine_count and ip_count, the int8 tensor-core tile, at V from 1 to
     8195 across its 32- and 128-byte steps, over the full int8 range, {0, 1}
     and {-1, 0, +1}, through both of its loaders (TMA; registers, for V not a
     multiple of 16 and for base pointers that are not 16-byte aligned);
  3. a small served round trip through `RetrievalService`: uneven adds, one
     compaction, CPQ / SPQ / SORT; the kernel path must equal the plain path
     bit for bit and unperturbed corpus points must retrieve themselves;
     3b. the same with `scheme="simhash"`, WIDE and PACKED (PACKED must equal
     WIDE), and a MONOLITHIC plan over the padded PACKED corpus
     (`concat_data`), which runs packed_cosine_count and the pad mask;
     3c. the same with `scheme="minhash"` (m = 96, 128 buckets), WIDE and
     PACKED, a padded PACKED plan that runs packed_tanimoto_count, and
     `scheme="rbh"` (-> EQ), kernel path against plain path; 3d. RANGE,
     MINSUM and IP through `SegmentedIndex` at their configurations' widths:
     17 uneven adds, one compaction, CPQ / SPQ / SORT, kernel path = plain
     path = a monolithic `GenieIndex.build`; 3e. coarse routing on all six
     engines, WIDE and PACKED, five uneven segments: ROUTED_VERIFIED = NONE
     for CPQ / SPQ / SORT on SEGMENTED and the host loop, ROUTED = a sort of
     the selected segments alone; a cold segment (upper bound under the
     threshold) is never scanned -- one match_count launch fewer, and from
     pinned parts its bytes are never copied (`plan.copied_bytes`) --, and a
     tied bound and an unfilled slot each force the fallback;
  4. the main path at full width -- the SIFT configuration's shape with the
     service's defaults: 4.5 M points of 128 dimensions in 16 sealed
     segments, m = required_m(0.06, 0.06) E2LSH functions into 8192 buckets,
     searches of 1024 queries for the top 100 by c-PQ -- with the kernels'
     launch counts read around it and a sample of rows held against a
     sort-method search through the plain path;
     4b. the same corpus and queries through `scheme="simhash"` (m = 238 sign
     bits), once WIDE (cosine_count + cpq_hist) and once PACKED (the fused
     packed_cosine_topk); PACKED must equal WIDE on every row;
     4c. the same corpus and queries through `scheme="minhash"` with 254
     buckets (the largest domain PACKED admits), WIDE (tanimoto_count +
     cpq_hist) and PACKED (the fused packed_tanimoto_topk), PACKED equal to
     WIDE on every row; 4c'. `scheme="rbh"` at the OCR configuration's width
     (d = 1156, 8192 buckets, sigma by the median heuristic on the corpus),
     cut to 2 of its 16 adds of 218,750 rows (the RBH hash is a 1156-step
     plain PyTorch fold per add);
     4d. Adult -> `SegmentedIndex(Engine.RANGE)` at full size (980,000
     tuples x 14 attributes in 1024 bins, 16 adds, ranges +-50); 4e. DBLP ->
     MINSUM (3-grams in 4096 buckets, K = 32 candidates verified by edit
     distance, N cut to 1 M); 4f. Tweets -> IP (8192 buckets, N cut to 1 M):
     each with its launch counts (16 of its count kernel and 16 of cpq_hist
     per search; MINSUM also 16 of each of its two conversion kernels), 8
     sampled rows against the plain path, search and add times, memory and
     the device's idle share;
     4g. multiple loading (paper section III-D): first small padded round
     trips -- GenieIndex.search_multiload with 7 parts of 5000 rows, the
     last carrying each engine's pad rows, for all six engines and both
     layouts, kernel path = plain path for CPQ / SPQ / SORT --; then, each
     case with its search
     times, queries/s, peak device memory, launch counts and idle share:
     the e2lsh corpus of phase 4 through GenieIndex.search_multiload(n_parts
     = 16), the scanned form, and through multiload_search_host over its 16
     segments in pinned host memory, both equal to the SEGMENTED service
     search bit for bit (ids, counts, threshold); the PACKED simhash and
     minhash indexes of 4b / 4c through SegmentedIndex.search_multiload
     (packed_cosine_count / packed_tanimoto_count and cpq_hist 16 times a
     search), equal to the fused SEGMENTED search; and DBLP -> MINSUM at its
     full 5.0 M titles in 80 parts of 62,500 rows, each drawn on the card and
     copied into a pinned host tensor of its own (N cut only where the host
     cannot pin them and keep 10 GB free), streamed by multiload_search_host:
     the source title among the 32 candidates of all 1024 queries (drawn from
     every part), 64 verified by edit distance, 8 rows equal to a sort-method
     search of the same parts through the plain path.  The host-loop cases
     also print the pinned bytes, the H2D rate of the copy alone and the
     share of the copy hidden under the match (against the same search with
     its parts on the card; for DBLP, 8 parts on the card scaled up);
     4h. routing at the SIFT shape, on the e2lsh service of phase 4: the
     summary's cost alone and in `add`, the route's host stages, ROUTED and
     ROUTED_VERIFIED at nprobe 4 (the default) and 8 -- segments selected,
     fallback, search times, VERIFIED = NONE on every row, ROUTED's
     recall@100 against NONE --, and the routed host loop over the 16
     segments in pinned memory with the bytes it copies; 4i. the serving
     front-end over the same service: single requests of Q = 1, 4, 16, 64
     through `ServingFrontend` and `RetrievalService.search` (median ms),
     then 32 submitter threads sending 256 requests of 1 to 64 queries, k
     10 or 100, each equal to its serial search (queries/s, p50 / p99,
     dispatches, rows a dispatch), and the single requests again with the
     equality tile's default pick (32 query rows a block up to Q = 32) and
     with its 128-row shape only, in turns; 4j. the autotuner:
     RetrievalService.tune() (budget 8, 2 repeats) on the e2lsh service and
     on the simhash PACKED one, its entry, default and tuned times and the
     time tune() takes, the tuned search equal to the untuned one bit for
     bit, the cache saved to a file and reloaded, a cache with another
     card's fingerprint keeping the defaults, and the single requests of 4i
     through the tuned e2lsh service; after 4d, the Adult RANGE index as an
     `IndexService` tenant (stacked (lo, hi) queries), so that range_count
     runs through the front-end;
     4k. the distributed layout on one NCCL rank (`launch.mesh` starts its
     own process group of world size 1 and it is destroyed after the
     phase): (i) small round trips on a (1,) "data" mesh and a (1, 1, 1)
     "pod" mesh, whose hierarchical plans run the two-level merge -- the six
     engines WIDE and COSINE / TANIMOTO PACKED, CPQ / SPQ / SORT, kernel path
     and plain path, data padded to a multiple of 8 with n_objects set --,
     each DISTRIBUTED search equal to the SEGMENTED search of the same
     segments bit for bit, and ROUTED_VERIFIED at nprobe 1 equal to NONE;
     (ii) `RetrievalService(mesh=make_local_mesh())` at the SIFT shape of
     phase 4 (e2lsh WIDE, then simhash PACKED on the same corpus), 256
     queries a search (a shard is one part: its [Q, 4.5 M] count matrix and
     the compaction's transient bound Q; PERF.md section 4), with its search
     times, peak memory, launch counts (one launch of the count kernel and
     of cpq_hist a search), idle share, the gather + merge timed apart,
     each search equal to the SEGMENTED search of the service's own index
     and ROUTED_VERIFIED at nprobe 4 equal to NONE, and the count kernel and
     cpq_hist timed in one launch over the 4.5 M rows, equal to their 16
     per-segment launches;
  5. each kernel's time at the full-width per-segment shape beside the plain
     version's, one PyTorch library call where one computes the same
     function, and the least time the card could take (bytes moved over the
     memory rate, or operations over the peak rate for their type, whichever
     is larger); for match_count also its SASS (instructions per compared
     pair, by opcode and pipe, on each path of the equality tile), the SM
     clock while it runs, the pairs per SM-clock and the issue floor, and its
     time on full-range int32 ids (the general path); 5b. the same for the
     three COSINE kernels, with packed_cosine_topk's popcount floor at the
     SM clock read while it runs, and packed_cosine_count in turns with its
     previous design (tools/packed_count_ab.py, built from
     tools/packed_count_baseline.cu), with the SM clock, pairs per SM-clock,
     both designs' SASS floors and the [Q, N] write alone; 5c. the same for the three TANIMOTO kernels (with
     the word-pair rates, and tanimoto_count's SASS and clock as for
     match_count), and tanimoto_count at m = 4096; packed_tanimoto_count
     also in turns with its previous design (tools/range_ptan_ab.py, built
     from tools/range_ptan_baseline.cu) and tanimoto_count, at the segment
     and at m = 4096, with the SM clock, pairs per SM-clock and both designs'
     SASS floors; 5d. the same for range_count, minsum_count and ip_count
     (range_count in turns with its previous design, as packed_tanimoto_count):
     minsum_count as the whole call against the bytes the function must
     move, its conversion kernels (minsum_nnz, minsum_csr) and its count
     kernel timed alone, a dense segment of DBLP's shape through the sparse
     kernel and the dense tile, and the share of non-zero entries where the
     wrapper switches between them; and cpq_hist on the real counts of the
     Adult, DBLP and Tweets segments.  5b and 5d log the loader that
     cosine_count and ip_count take at their per-segment shapes.

  6. the slice's modules and entry points: 6a. the CSR postings engine
     (core/postings.py) over the e2lsh signatures of one SIFT segment (N =
     281,250, m = 238, D = 67; keywords i * 67 + sig[:, i]): the host build,
     scan_counts_tiled on the card at split limits max_list_len, 4096 and
     1024, each equal to match_count on the same signatures bit for bit, and
     CPU-Idx (numpy) equal to both on 4 queries; 6b. the paper's
     load-balance study (Fig 12) with benchmarks/fig12_load_balance.py's
     keyword law at Adult's N = 980,000, Q = 16, the tiled scans equal to
     CPU-Idx on the queries' distinct keywords; 6c. the dry-run's cells
     (launch/dryrun.py) for the six datasets on 1 and 4 cards, and its memory
     model against phase 4k's measured peak (fails beyond 25 %); 6d. LM
     serving: ServeEngine.generate on smollm-360m at full size and on
     qwen2-moe-a2.7b at full width cut to 4 of 24 layers, 8 prompts of 128
     tokens, greedy twice (the same tokens), one decode step against a
     teacher-forced forward (5e-2; the MoE at capacity factor 64 and float32
     compute), one decode step profiled, the MoE's slots dropped at its
     shipped capacity factor; 6e. `launch/serve` over 200,000 documents
     embedded through smollm-360m's table (4 batches of 1024 queries) and
     the four examples at the reference's sizes, each search launching its
     count kernel and cpq_hist (quickstart's self-retrieval 1.000); 6f. the
     ssm, hybrid and encoder-decoder families at full size: ServeEngine.generate
     on mamba2-1.3b, zamba2-2.7b and seamless-m4t-large-v2 (256 frames a
     prompt), 8 prompts of 256 tokens (the FULL configs' SSD chunk),
     cache_cap 512, greedy twice (the same tokens), one decode step against
     a teacher-forced forward padded to a whole SSD chunk (5e-2), one decode
     step profiled; then `launch/serve` over 200,000 documents embedded
     through mamba2-1.3b's table, each search launching match_count and
     cpq_hist, self-retrieval >= 0.99.

  7. training (train/, optim/, checkpoint/; no kernel of its own): the
     Trainer on smollm-360m at full size (float32 parameters and moments,
     bfloat16 compute, 8 x 1024 tokens a step, remat "nothing"), 20 steps:
     step times, tokens/s, peak memory, model FLOPs a step and their share
     of the dense bfloat16 peak; the loss must fall by 0.5 or more.  Then 3
     steps with remat "none" and 3 with "dots" (peak memory, step time); the
     embedding gradient's deterministic scatter against the default one
     (time, and whether the default repeats its bits); 4 straight steps
     against 2 steps, an asynchronous checkpoint to a temporary directory, a
     fresh Trainer and 2 more, every parameter, moment and the step equal
     bit for bit; last, 6d's and 6f's peak memories beside the last
     release's (serving builds no autograd graph).

  8. sharding on a one-rank NCCL mesh (launch/sharding.py, launch/shapes.py,
     models/partition.py; no kernel of its own): every Shard sits on an axis
     of size 1, but every parameter, gradient and batch is a DTensor and
     every hint and redistribution is dispatched.  8a: `launch/train.main`
     for 3 steps as the entry point, then phase 7's 20-step run again through
     the state shardings -- every state leaf a DTensor on its spec's
     placements, the losses within 1e-4 of phase 7's (how many bit for bit),
     the median step time against phase 7's, tokens/s and peak memory.  8b:
     2 sharded steps + a checkpoint + a fresh sharded Trainer to step 4 equal
     4 straight sharded steps bit for bit, leaf for leaf, and that checkpoint
     restored with shardings onto a new one-rank mesh equals the saved
     leaves.  8c: smollm-360m's prefill and 32 greedy decode steps through
     `ServeEngine` with `params_shardings(..., use_tp_serve)` and the caches
     placed by `cache_shardings`: the tokens equal 6d's.  8d: the LM dry-run,
     all 160 cells (one line each: fits and GB a rank by term), and its
     memory model of 8a's run against 8a's measured peak (within 25 %).  The
     process group is destroyed after the phase.

It needs one CUDA device and no network, and imports neither jax nor the JAX
package.  The last line of its output is one JSON object
`{"ok": true, "device": {...}}`; the line before it lists the kernels.
"""
from __future__ import annotations

import collections
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate, and
# the float32 rate outside the tensor cores.  The data sheet lists no int32
# rate; the int32 pipe is no wider than the float32 one, so the float32 figure
# bounds integer compare/add work from below as well.
PEAK_BYTES_PER_S = 3.35e12
PEAK_ALU_OPS_PER_S = 67e12
# the int8 tensor-core rate (dense), the peak for an int8 product
PEAK_INT8_TC_OPS_PER_S = 1979e12

# The SIFT configuration's shape (4.5 M x 128-dim points, 1024 queries per
# batch, top 100) with the retrieval service's defaults.
FULL_N = 4_500_000
FULL_DIM = 128
FULL_SEGMENTS = 16
FULL_Q = 1024
FULL_K = 100
N_SEARCHES = 4
SEED = 0

MATCH_SHAPES = [(1, 5, 3), (3, 130, 17), (8, 300, 64), (5, 257, 33), (70, 100003, 238)]
# (Q, N, V) for the COSINE kernels; the packed count also runs the extra
# widths, so that V covers 1, 31, 33, 95, 238 and 513 (W = 1 .. 17)
COSINE_SHAPES = [(1, 5, 3), (3, 130, 17), (8, 300, 64), (5, 257, 33), (2, 90, 33),
                 (4, 300, 256), (1, 40, 513), (70, 100003, 238)]
PACKED_EXTRA_SHAPES = [(3, 70, 1), (6, 4099, 31), (9, 2500, 95)]
# (Q, N, V) for the packed count's carry-save tile (1024 data rows and 32
# query rows a block, eight words a tree): W = 1, 7, 8, 9, 16 and 17 at Q and
# N past one block and ragged, each on random rows, all-equal rows and rows
# that are the complements of the queries
COUNT_EXTRA_SHAPES = [(67, 1025, 32), (65, 2049, 224), (130, 3001, 256), (129, 1023, 288),
                      (3, 1500, 512), (66, 1100, 544), (1, 1, 5)]
COUNT_KINDS = ("random", "equal", "complement")
# (Q, N, V, k) for the fused top-k: k in {1, 3, 10, 100} and one k above the
# tile, N not a multiple of the tile, N < k (once with k above the tile: the
# executor fills the missing slots), Q past one and two 64-row items; W = 1,
# 7 (the widest one-byte tile that keeps every count), 8 and 9 (one-byte
# tiles whose counts <= 32W - 254 are stored as 0), 10 (the first two-byte
# tile), 15 / 16 (the last with its bins in shared memory, the first with
# them in device scratch), 17 and 170
TOPK_CASES = [(5, 5000, 238, 1), (7, 5000, 238, 3), (33, 9000, 238, 10),
              (70, 100003, 238, 100), (4, 7000, 238, 2500), (3, 50, 238, 100),
              (2, 50, 238, 3000), (6, 3000, 1, 10), (130, 4500, 224, 100),
              (65, 4500, 288, 7), (3, 2100, 289, 100), (5, 2100, 480, 10),
              (5, 2100, 481, 10), (9, 4500, 513, 100), (3, 2100, 5440, 10)]
# (Q, N, V, k) run on rows near the complement of the queries (near_complement:
# counts at and just below the one-byte tile's collapsed end 32W - 254), so
# that fewer than kc rows of a tile clear it and the kernel recounts
# collapsed entries; W = 8 and 9 on the one-byte tile, 10 on the two-byte one
COMPLEMENT_CASES = [(3, 5000, 238, 1), (3, 5000, 238, 100), (3, 5000, 238, 2500),
                    (2, 4500, 288, 100), (2, 4500, 289, 100)]
# (Q, N, max_count) for cpq_hist: 1 bin, 4, 65, Adult's 15, 239 (e2lsh / minhash at
# m = 238), 255, 453 / 454 on either side of the per-thread counters' limit,
# and MAX_BINS; odd N (rows that start off a 16-byte boundary); whole rows a
# block where Q fills the card, chunks of a row otherwise (Q = 1, N =
# 1,000,003); a row of 16.8 M counts (past one flush of the 16-bit counters)
HIST_CASES = [(1, 5, 0), (1, 5, 3), (8, 300, 64), (70, 100003, 238), (600, 20001, 14),
              (1, 1_000_003, 14), (1, 1_000_003, 238), (3, 257, 254), (5, 30001, 452),
              (5, 30001, 453), (2, 10007, 58111), (70, 16_800_001, 238)]
# (Q, N, m) for the TANIMOTO count kernels, nothing a multiple of a tile
TANIMOTO_SHAPES = [(1, 5, 1), (3, 130, 3), (8, 300, 17), (70, 100003, 238), (5, 2100, 600),
                   (3, 1500, 4099)]
# packed_tanimoto_count counts chunks of 32 columns (31 to 33, 63 to 65) and
# adds its lanes into the output after 127 chunks (4064 / 4065 columns) and
# at the end; one query row equals a data row, so a lane reaches its largest
# count
PACKED_TANIMOTO_SHAPES = [(3, 70, 1), (2, 90, 5), (5, 257, 17), (3, 301, 31), (130, 301, 32),
                          (5, 129, 33), (4, 300, 40), (3, 301, 47), (3, 200, 63),
                          (3, 200, 65), (70, 100003, 238), (2, 200, 300), (3, 1030, 4064),
                          (3, 1030, 4065), (3, 1500, 4099), (2, 700, 4096), (2, 500, 8200)]
# (Q, N, m, k) for the fused TANIMOTO top-k: k in {1, 3, 10, 100} and k
# above the tile, N not a multiple of the tile, N < k, Q past one and two
# 64-row items; m = 1, 238, 254 (the last with one-byte counts), 255 (the
# first with two-byte counts), 503 / 504 (the last with the bins in shared
# memory, the first with them in device scratch) and 6000
TANIMOTO_TOPK_CASES = [(5, 5000, 238, 1), (7, 5000, 238, 3), (33, 9000, 238, 10),
                       (70, 100003, 238, 100), (4, 7000, 238, 2500), (3, 50, 238, 100),
                       (2, 50, 238, 3000), (6, 3000, 1, 10), (130, 4500, 37, 7),
                       (65, 5000, 254, 1), (65, 5000, 254, 2100), (33, 5000, 255, 100),
                       (33, 2100, 255, 3000), (3, 2100, 503, 10), (3, 2100, 504, 10),
                       (2, 4200, 504, 2048), (3, 2100, 6000, 10), (2, 2100, 6000, 2500)]
# The equality tile of match_count and tanimoto_count (count_eq_tile in
# csrc/eq_tile.cuh) compares a 32-column chunk as float16 lanes when every id
# staged for it lies in [0, 31744), and as int32 on its general path when
# any does not.  Its parity runs every shape with three value classes
# (eq_ids), and these extra shapes: m odd, and m on either side of the
# 4096 columns after which the float16 lanes are added into int32.
EQ_EXTRA_SHAPES = [(7, 129, 1), (5, 133, 2), (9, 1001, 63), (3, 301, 4095), (5, 257, 4096),
                   (2, 130, 4097), (3, 131, 8193)]
EQ_KINDS = ("lanes", "mixed", "int32")
# (Q, N, m) for the equality tile's Narrow shape (32 query rows a block,
# tile_q = 32): Q = 1, 7, 31, 32, 33 (one and two query tiles), m odd and
# 4095 to 8193 around the 4096-column flush
NARROW_EQ_SHAPES = [(1, 1001, 63), (7, 301, 4095), (31, 257, 4096), (32, 130, 4097),
                    (33, 131, 8193), (1, 100003, 238), (7, 5, 1), (33, 1029, 33)]
# the fused top-k kernels' tiles (tile_n): the default and the narrow one
FUSED_TILES = (2048, 1024)
LANE_END = 0x7C00
# ids at the float16 path's borders: 0, the subnormals' last and the normals'
# first (1023, 1024), float16's last exact integer and the next (2048, 2049),
# the range's last ids (31742, 31743)
LANE_POOL = [0, 1, 1023, 1024, 2048, 2049, 8191, 31742, 31743]
# ids that send their chunk to the general path
GENERAL_POOL = [-2**31, -2**31 + 1, -1, 31744, 31745, 65535, 65536, 2**31 - 1]
# The OCR configuration's width (src/repro/configs/genie_datasets.py): d = 1156,
# 16 adds of 218,750 rows, of which phase 4c' runs 2
OCR_DIM = 1156
OCR_ROWS = 218_750
OCR_SEGMENTS = 2


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, device: torch.device, reps: int = 1, warmup: int = 0, hold: bool = False):
    """(mean milliseconds of one call, last result).  On the card the time is
    between two CUDA events around `reps` calls, read after a synchronise.
    `hold`: the stream first sleeps ~50 ms on the card, so that the host has
    enqueued all `reps` calls before the first event is reached and the time
    is the device's alone -- for a kernel shorter than its launch on the
    host, which the events would otherwise measure."""
    out = None
    for _ in range(warmup):
        out = fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(reps):
            out = fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def eq_ids(gen: torch.Generator, rows: int, m: int, kind: str) -> torch.Tensor:
    """int32 [rows, m] ids on the CPU, from a pool of 16 so that equal ids
    are common: "lanes" ids in [0, 31744) with the border ids of LANE_POOL;
    "mixed" the same with one id of GENERAL_POOL in one row of every third
    32-column chunk from the second on (the same column and value in every
    call), so that one call counts fast and general chunks; "int32" ids from
    the whole int32 range, its ends included."""
    if kind == "int32":
        extra = torch.randint(-2**31, 2**31 - 1, (8,), generator=gen).tolist()
        pool = torch.tensor(GENERAL_POOL + extra, dtype=torch.int64)
    else:
        extra = torch.randint(0, LANE_END, (16 - len(LANE_POOL),), generator=gen).tolist()
        pool = torch.tensor(LANE_POOL + extra, dtype=torch.int64)
    ids = pool[torch.randint(0, len(pool), (rows, m), generator=gen)].to(torch.int32)
    if kind == "mixed":
        for chunk in range(1, -(-m // 32), 3):
            col = 32 * chunk + chunk % min(32, m - 32 * chunk)
            row = int(torch.randint(0, rows, (1,), generator=gen))
            ids[row, col] = GENERAL_POOL[chunk % len(GENERAL_POOL)]
    return ids


def eq_parity(name: str, kernel, plain, shapes, device: torch.device,
              gen: torch.Generator) -> int:
    """The equality kernel `name` against its plain version at every shape
    and value class of eq_ids, bit-exact; returns the worst error."""
    worst = 0
    for q, n, m in shapes:
        for kind in EQ_KINDS:
            d, s = eq_ids(gen, n, m, kind).to(device), eq_ids(gen, q, m, kind).to(device)
            s[0] = d[min(1, n - 1)]                # one row equal in every column
            got = kernel(d, s)
            want = plain(d, s)
            sync(device)
            err = max_abs_err(got, want)
            worst = max(worst, err)
            check(got.shape == (q, n) and got.dtype == torch.int32 and torch.equal(got, want),
                  f"{name} differs from its plain version at (Q,N,m)=({q},{n},{m}) {kind} ids: "
                  f"max abs err {err}")
        log(f"  {name} (Q,N,m)=({q},{n},{m}) ids {'/'.join(EQ_KINDS)}: equal")
    return worst


def eq_identity(name: str, kernel, device: torch.device) -> int:
    """The float16 path's premise on the card: ids 0..31743 as data and as
    queries, m = 1 (row i = [i]) and m = 2 (row i = [i, 31743 - i]), must
    count m on the diagonal and 0 elsewhere -- no two of the 31,744 bit
    patterns compare equal as float16 (subnormals kept) and each equals
    itself.  Returns the worst difference from m times the identity."""
    ids = torch.arange(LANE_END, dtype=torch.int32, device=device)
    worst = 0
    for m, rows in ((1, ids[:, None]), (2, torch.stack([ids, LANE_END - 1 - ids], 1))):
        rows = rows.contiguous()
        got = kernel(rows, rows)
        diag = got.diagonal()
        off = got.sum(dtype=torch.int64) - diag.sum(dtype=torch.int64)
        err = max(int((diag - m).abs().max().item()), int(off.item()),
                  -int(got.min().item()))
        worst = max(worst, err)
        check(err == 0, f"{name}: ids 0..{LANE_END - 1} against themselves (m={m}) are not "
                        f"{m} x the identity: worst difference {err}")
        del got, diag
    log(f"  {name}: ids 0..{LANE_END - 1} against themselves, m = 1 and 2: m x the identity")
    return worst


def eq_variant(name: str, tile_q: int):
    """The equality kernel `name` (match_count or tanimoto_count) in the
    block shape of `tile_q` query rows (128: Wide, 32: Narrow) whatever Q is,
    through its C entry (the wrapper's pick_variant would clamp a small Q to
    the Narrow shape)."""
    from repro_torch.kernels import common

    entry = name if tile_q == 128 else f"{name}_q{tile_q}"

    def run(d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        n, q, m = common.check_pair(name, d, s)
        return common.launch_count(name, d, s, n, q, m, entry=entry, variant=f"tile_q={tile_q}")
    return run


def fused_variant(name: str, tile_n: int):
    """The fused top-k kernel `name` (packed_cosine_topk or
    packed_tanimoto_topk) in its tile of `tile_n` data rows whatever N is,
    through its C entries; operands as the wrapper takes them."""
    from repro_torch.kernels import common

    entry = name if tile_n == 2048 else f"{name}_n{tile_n}"

    def run(d: torch.Tensor, s: torch.Tensor, k: int):
        return common.launch_fused_topk(name, d, s, d.device, d.shape[0], s.shape[0],
                                        d.shape[1], k, tile_n, entry=entry)
    return run


# ---------------------------------------------------------------------------
# Phase 1: environment and build
# ---------------------------------------------------------------------------

def phase_environment_and_build() -> None:
    from repro_torch.kernels import build

    log("== phase 1: environment and build")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch CUDA {torch.version.cuda}")
    log("card:", gpu_name_and_power_limit())
    nvcc = build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()
    log("nvcc:", nvcc, "|", version[-2] if len(version) > 1 else version[-1])
    try:
        import triton
        log("triton imports: yes, version", triton.__version__, "(the port does not use it)")
    except ImportError as e:
        log("triton imports: no --", e)
    t0 = time.perf_counter()
    build.load()
    log(f"kernel library built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc build alone: {build.build_seconds()} s)")
    for line in build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  ptxas:", line.strip())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernel_parity(device: torch.device) -> dict:
    """Bit-exact comparison at odd shapes; returns the worst absolute
    difference seen per kernel (0 when the phase passes)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.match_count import match_count_plain

    log("== phase 2: kernels against their plain PyTorch versions")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    worst = {"match_count": 0, "cpq_hist": 0}
    worst.update(cosine_parity(device, gen))
    worst.update(tanimoto_parity(device))
    worst.update(sa_parity(device))
    for name, err in dot_tile_parity(device).items():
        worst[name] = max(worst[name], err)
    worst["match_count"] = max(
        eq_parity("match_count", ops.match_count, match_count_plain,
                  MATCH_SHAPES + EQ_EXTRA_SHAPES, device, gen),
        eq_parity("match_count[tile_q=128]", eq_variant("match_count", 128), match_count_plain,
                  MATCH_SHAPES + EQ_EXTRA_SHAPES, device, gen),
        eq_identity("match_count", ops.match_count, device))
    # the Narrow shape: through the wrapper (tile_q = 32) and its C entry
    worst["match_count[tile_q=32]"] = max(
        eq_parity("match_count[tile_q=32]", lambda d, s: ops.match_count(d, s, tile_q=32),
                  match_count_plain, NARROW_EQ_SHAPES, device, gen),
        eq_parity("match_count[tile_q=32]", eq_variant("match_count", 32), match_count_plain,
                  MATCH_SHAPES + EQ_EXTRA_SHAPES, device, gen),
        eq_identity("match_count[tile_q=32]", eq_variant("match_count", 32), device))
    for q, n, m in MATCH_SHAPES:
        for dtype in (torch.int32, torch.int16):
            d = torch.randint(0, 9, (n, m), generator=gen, dtype=dtype).to(device)
            s = torch.randint(0, 9, (q, m), generator=gen, dtype=dtype).to(device)
            got = ops.match_count(d, s)
            want = match_count_plain(d.to(torch.int32), s.to(torch.int32))
            sync(device)
            err = max_abs_err(got, want)
            worst["match_count"] = max(worst["match_count"], err)
            check(got.shape == (q, n) and got.dtype == torch.int32 and torch.equal(got, want),
                  f"match_count differs from its plain version at (Q,N,m)=({q},{n},{m}) "
                  f"{dtype}: max abs err {err}")
        log(f"  match_count (Q,N,m)=({q},{n},{m}) int32+int16: equal")
    worst["cpq_hist"] = hist_parity(device)
    return worst


def hist_parity(device: torch.device) -> int:
    """cpq_hist against its plain version at HIST_CASES, bit-exact: counts
    from -1 (the pad mask's fill) to past max_count, neither of which may land
    in a bin, skewed so that a third of a row falls in one bin; then every
    entry in one bin, the last and the first.  Returns the worst error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cpq_hist import cpq_hist_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    worst = 0
    for q, n, max_count in HIST_CASES:
        c = torch.randint(-1, max_count + 3, (q, n), generator=gen, device=device,
                          dtype=torch.int32)
        c[:, ::3] = max_count // 2
        c[:, ::7] = -1
        fills = [("skewed, with -1 and past-max_count entries", c)]
        if n < 1_000_000:
            fills += [(f"every entry {v}", torch.full_like(c, v)) for v in {0, max_count}]
        for what, counts in fills:
            got = ops.cpq_hist(counts, max_count)
            want = cpq_hist_plain(counts, max_count)
            sync(device)
            err = max_abs_err(got, want)
            worst = max(worst, err)
            check(got.shape == (q, max_count + 1) and torch.equal(got, want),
                  f"cpq_hist differs from its plain version at (Q,N)=({q},{n}) "
                  f"max_count={max_count}, {what}: max abs err {err}")
        log(f"  cpq_hist (Q,N)=({q},{n}) bins={max_count + 1}: equal "
            f"({'; '.join(what for what, _ in fills)})")
        del c, fills
    return worst


# (Q, N, V, data offset, query offset) for the int8 tensor-core tile of
# cosine_count and ip_count: V straddles its 32-byte MMA depth and 128-byte
# stage (1 .. 8195), Q and N are multiples of neither 64 nor 256, two shapes
# have more tiles than the card has SMs, and an offset of 1 byte makes a
# contiguous view whose base pointer is not 16-byte aligned.  V a multiple
# of 16 with aligned pointers takes TMA, everything else the register loader.
DOT_TILE_CASES = [(3, 70, 1, 0, 0), (5, 130, 31, 0, 0), (67, 301, 32, 0, 0),
                  (67, 301, 33, 0, 0), (130, 517, 127, 0, 0), (130, 517, 128, 0, 0),
                  (130, 517, 129, 0, 0), (67, 1001, 238, 0, 0), (67, 1001, 240, 0, 0),
                  (33, 777, 8195, 0, 0), (129, 2311, 8192, 0, 0), (300, 70001, 238, 0, 0),
                  (300, 70001, 256, 0, 0), (67, 1001, 240, 1, 0), (67, 1001, 256, 0, 1),
                  (129, 2311, 8192, 1, 1)]
# the value sets: the full int8 range, IP's {0, 1}, COSINE's {-1, 0, +1}
DOT_TILE_VALUES = {"int8 -128..127": (-128, 128), "{0,1}": (0, 2), "{-1,0,1}": (-1, 2)}


def _int8_view(gen: torch.Generator, rows: int, v: int, lo: int, hi: int, offset: int,
               device: torch.device) -> torch.Tensor:
    """A contiguous int8 [rows, v] on the card whose base pointer lies
    `offset` bytes past an allocation's (aligned) start."""
    buf = torch.randint(lo, hi, (rows * v + offset,), generator=gen, dtype=torch.int8)
    buf[offset] = lo                                  # both ends of the range appear
    buf[-1] = hi - 1
    return buf.to(device)[offset:].view(rows, v)


def dot_tile_parity(device: torch.device) -> dict:
    """Phase 2e: cosine_count and ip_count, the two kernels on the int8
    tensor-core tile, against their plain versions bit-exact over
    DOT_TILE_CASES x DOT_TILE_VALUES, each call's loader logged and checked
    against the rule; both loaders must have run for both kernels.  Returns
    the worst absolute difference per kernel."""
    from repro_torch.kernels import common, ops
    from repro_torch.kernels.cosine_count import cosine_count_plain
    from repro_torch.kernels.ip_count import ip_count_plain

    log("== phase 2e: cosine_count and ip_count (int8 tensor-core tile) against their "
        "plain versions")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    worst = {"cosine_count": 0, "ip_count": 0}
    seen = {name: set() for name in worst}
    for q, n, v, d_off, q_off in DOT_TILE_CASES:
        for label, (lo, hi) in DOT_TILE_VALUES.items():
            d = _int8_view(gen, n, v, lo, hi, d_off, device)
            s = _int8_view(gen, q, v, lo, hi, q_off, device)
            want_tma = v % 16 == 0 and d.data_ptr() % 16 == 0 and s.data_ptr() % 16 == 0
            for name, kernel, plain in (("cosine_count", ops.cosine_count, cosine_count_plain),
                                        ("ip_count", ops.ip_count, ip_count_plain)):
                loader = common.dot_tile_loader(name, d, s)
                check(loader == ("tma" if want_tma else "registers"),
                      f"{name} took the {loader} loader at V={v}, offsets ({d_off}, {q_off})")
                seen[name].add(loader)
                got = kernel(d, s)
                want = plain(d, s)
                sync(device)
                err = max_abs_err(got, want)
                worst[name] = max(worst[name], err)
                check(got.shape == (q, n) and got.dtype == torch.int32 and torch.equal(got, want),
                      f"{name} differs from its plain version at (Q,N,V)=({q},{n},{v}) "
                      f"{label}, offsets ({d_off}, {q_off}), {loader} loader: max abs err {err}")
        log(f"  cosine_count, ip_count (Q,N,V)=({q},{n},{v}) offsets ({d_off},{q_off}), "
            f"{loader} loader, values {', '.join(DOT_TILE_VALUES)}: equal")
    for name, loaders in seen.items():
        check(loaders == {"tma", "registers"}, f"{name} ran through {sorted(loaders)} only")
    return worst


def _signs(gen: torch.Generator, rows: int, v: int, device: torch.device) -> torch.Tensor:
    return (torch.randint(0, 2, (rows, v), generator=gen, dtype=torch.int8) * 2 - 1).to(device)


def fused_result(ids: torch.Tensor, cnts: torch.Tensor, k: int):
    """The fused kernel's buffers reduced as the executor reduces them."""
    from repro_torch.core.plan import _fused_candidates_topk

    return _fused_candidates_topk(lambda d, q, kk: (ids, cnts), None, None, k)


def sort_oracle(counts: torch.Tensor, k: int):
    """(ids, counts) [Q, k] by a stable sort of the full counts, -1 past N."""
    from repro_torch.core import cpq
    from repro_torch.core.types import SearchParams

    kk = min(k, counts.shape[1])
    res = cpq.sort_select(counts, SearchParams(k=kk, max_count=int(counts.max().item())))
    pad = counts.new_full((counts.shape[0], k - kk), -1)
    return torch.cat([res.ids, pad], dim=1), torch.cat([res.counts, pad], dim=1)


def cosine_parity(device: torch.device, gen: torch.Generator) -> dict:
    """The three COSINE kernels against their plain versions, bit-exact;
    returns the worst absolute difference per kernel."""
    from repro_torch.core import packing
    from repro_torch.kernels import ops
    from repro_torch.kernels.cosine_count import cosine_count_plain
    from repro_torch.kernels.packed_cosine import (packed_cosine_count_plain,
                                                   packed_cosine_topk_plain)

    worst = {"cosine_count": 0, "packed_cosine_count": 0, "packed_cosine_topk": 0,
             "packed_cosine_topk[tile_n=1024]": 0}
    for i, (q, n, v) in enumerate(COSINE_SHAPES):
        d, s = _signs(gen, n, v, device), _signs(gen, q, v, device)
        if i == 3:
            d[::4] = 0                     # zero rows: the engine's pad fill, V // 2
        got = ops.cosine_count(d, s)
        want = cosine_count_plain(d, s)
        sync(device)
        err = max_abs_err(got, want)
        worst["cosine_count"] = max(worst["cosine_count"], err)
        check(got.shape == (q, n) and got.dtype == torch.int32 and torch.equal(got, want),
              f"cosine_count differs from its plain version at (Q,N,V)=({q},{n},{v}): "
              f"max abs err {err}")
        log(f"  cosine_count (Q,N,V)=({q},{n},{v}){' with zero rows' if i == 3 else ''}: equal")
    count_cases = ([(q, n, v, "random") for q, n, v in COSINE_SHAPES + PACKED_EXTRA_SHAPES]
                   + [(q, n, v, kind) for q, n, v in COUNT_EXTRA_SHAPES for kind in COUNT_KINDS])
    for q, n, v, kind in count_cases:
        d, s = _signs(gen, n, v, device), _signs(gen, q, v, device)
        if kind == "equal":                # every sign agrees: V everywhere
            d.fill_(1)
            s.fill_(1)
        elif kind == "complement":         # query i the complement of data row i: 0 there
            s[:min(q, n)] = -d[:min(q, n)]
        dw, sw = packing.pack_signs_data(d), packing.pack_signs_queries(s)
        got = ops.packed_cosine_count(dw, sw)
        want = packed_cosine_count_plain(dw, sw)
        sync(device)
        err = max_abs_err(got, want)
        worst["packed_cosine_count"] = max(worst["packed_cosine_count"], err)
        check(got.shape == (q, n) and torch.equal(got, want),
              f"packed_cosine_count differs from its plain version at (Q,N,V)="
              f"({q},{n},{v}) {kind} rows: max abs err {err}")
        if kind == "equal":
            check(bool((got == v).all()), f"packed_cosine_count: all-equal rows do not count "
                                          f"V={v}")
        if kind == "complement":
            check(bool((got.diagonal()[:min(q, n)] == 0).all()),
                  f"packed_cosine_count: complementary rows do not count 0 at V={v}")
        log(f"  packed_cosine_count (Q,N,V)=({q},{n},{v}) W={dw.shape[1]} {kind} rows: equal")
    cases = ([(q, n, v, k, "random") for q, n, v, k in TOPK_CASES] + [(2, 3000, 64, 5, "equal")]
             + [(q, n, v, k, "complement") for q, n, v, k in COMPLEMENT_CASES])
    for q, n, v, k, kind in cases:
        all_equal = kind == "equal"
        if all_equal:                      # identical rows: the lowest ids must come out
            dw = packing.pack_signs_data(torch.ones((n, v), dtype=torch.int8, device=device))
            sw = packing.pack_signs_queries(torch.ones((q, v), dtype=torch.int8, device=device))
        elif kind == "complement":
            d, s = near_complement(gen, q, n, v, device)
            dw, sw = packing.pack_signs_data(d), packing.pack_signs_queries(s)
        else:
            dw = packing.pack_signs_data(_signs(gen, n, v, device))
            sw = packing.pack_signs_queries(_signs(gen, q, v, device))
        want_ids, want_cnts = sort_oracle(packed_cosine_count_plain(dw, sw), k)
        for tile in FUSED_TILES:               # each tile through its C entries
            key = "packed_cosine_topk" + ("" if tile == 2048 else f"[tile_n={tile}]")
            ids, cnts = fused_variant("packed_cosine_topk", tile)(dw, sw, k)
            pids, pcnts = packed_cosine_topk_plain(dw, sw, k, tile)
            sync(device)
            err = max(max_abs_err(ids, pids), max_abs_err(cnts, pcnts))
            worst[key] = max(worst[key], err)
            kc = min(k, tile)
            check(ids.shape == (q, -(-n // tile) * kc) and torch.equal(ids, pids)
                  and torch.equal(cnts, pcnts),
                  f"packed_cosine_topk buffers differ from the plain version at "
                  f"(Q,N,V,k)=({q},{n},{v},{k}) tile {tile}: max abs err {err}")
            got_ids, got_cnts = fused_result(ids, cnts, k)
            check(torch.equal(got_ids, want_ids) and torch.equal(got_cnts, want_cnts),
                  f"packed_cosine_topk after topk_from_candidates differs from a sort "
                  f"at (Q,N,V,k)=({q},{n},{v},{k}) tile {tile}")
            if all_equal:
                check(got_ids.tolist() == [list(range(k))] * q,
                      "all-equal rows: not the lowest ids")
        ids, cnts = ops.packed_cosine_topk(dw, sw, k=k)     # the wrapper's own pick
        check(torch.equal(fused_result(ids, cnts, k)[0], want_ids),
              f"packed_cosine_topk's wrapper at (Q,N,V,k)=({q},{n},{v},{k})")
        log(f"  packed_cosine_topk (Q,N,V,k)=({q},{n},{v},{k}) W={dw.shape[1]} tiles "
            f"{FUSED_TILES} {kind} rows: buffers equal, merged == sort")
    return worst


def near_complement(gen: torch.Generator, q: int, n: int, v: int, device: torch.device):
    """(data [n, v], queries [q, v]) signs for COMPLEMENT_CASES: data row r is
    the complement of query 0 with L - 4 + r % 5 signs flipped back, where L
    = max(0, 32W - 254) is the one-byte tile's collapsed end (so its count
    with query 0 is L - 4 .. L), L + 1 of them in every 97th row; every 37th
    row is random, so fewer than 100 rows of a tile count above L; query 1
    is the complement of data row 3, any further query random."""
    w = -(-v // 32)
    low = max(0, 32 * w - 254)
    s = _signs(gen, q, v, torch.device("cpu"))
    d = (-s[0]).repeat(n, 1)
    rows = torch.arange(n)
    flips = torch.where(rows % 97 == 1, low + 1, low - 4 + rows % 5)
    cols = torch.argsort(torch.rand((n, v), generator=gen), dim=1)
    flip = torch.arange(v)[None, :] < flips.clamp(min=0)[:, None]
    d.scatter_(1, cols, torch.where(flip, -d.gather(1, cols), d.gather(1, cols)))
    d[::37] = _signs(gen, len(range(0, n, 37)), v, torch.device("cpu"))
    if q > 1:
        s[1] = -d[3]
    return d.to(device), s.to(device)


# ---------------------------------------------------------------------------
# Phase 3: small served round trip, kernel path == plain path
# ---------------------------------------------------------------------------

def phase_small_service(device: torch.device) -> None:
    log("== phase 3: small served round trip (kernel path vs plain path)")
    small_wide_round_trip(device, "e2lsh", _small_corpus(SEED + 1, device))


def small_wide_round_trip(device: torch.device, label: str, corpus: tuple, k: int = 10,
                          max_segments: int = 16, **service_kw) -> None:
    """A service (the defaults, or `service_kw`) on the kernel path and the
    plain path through one compaction: ids, counts and thresholds equal for
    CPQ / SPQ / SORT, and corpus points retrieve themselves."""
    from repro_torch.core import TopKMethod
    from repro_torch.serve import RetrievalService

    batches, emb, pick, queries = corpus
    services = {
        use_kernel: RetrievalService(device=device, seed=SEED, use_kernel=use_kernel,
                                     max_segments=max_segments, **service_kw)
        for use_kernel in (True, False)
    }
    _fill_small(services, emb, batches, max_segments)
    for method in (TopKMethod.CPQ, TopKMethod.SPQ, TopKMethod.SORT):
        res_k, _ = services[True].search(None, k=k, embeddings=queries, method=method)
        res_p, _ = services[False].search(None, k=k, embeddings=queries, method=method)
        sync(device)
        for field in ("ids", "counts", "threshold"):
            check(torch.equal(getattr(res_k, field), getattr(res_p, field)),
                  f"{label} {method.value}: kernel path and plain path differ in {field}")
        top1 = float((res_k.ids[:, 0] == pick.to(torch.int32)).float().mean().item())
        check(top1 == 1.0, f"{label} {method.value}: top-1 self-retrieval {top1} != 1.0")
        log(f"  {label} {method.value}: ids/counts/threshold equal on both paths, "
            f"top-1 self-retrieval {top1:.3f}")


def phase_small_simhash(device: torch.device) -> int:
    """The simhash service, WIDE and PACKED, each on the kernel path and the
    plain path; then a MONOLITHIC plan over the PACKED corpus padded by
    `concat_data`, which runs `packed_cosine_count` and the pad mask.  Returns
    that plan's `packed_cosine_count` launches (the only path that runs the
    kernel: the service's searches take the fused kernel)."""
    log("== phase 3b: small simhash round trip, WIDE and PACKED (kernel path vs plain path)")
    return small_layout_round_trip(device, "simhash", "packed_cosine_count", SEED + 2)[0]


def _small_corpus(seed: int, device: torch.device, max_segments: int = 16, dim: int = 32,
                  n_queries: int = 64):
    """(batches, corpus, picked ids, queries) of the small round trips: uneven
    adds, one past max_segments, and corpus points as queries."""
    big = [3000, 5000, 2500, 6000, 3500]
    batches = big + [50] * (max_segments + 1 - len(big))   # one past max_segments
    gen = torch.Generator(device="cpu").manual_seed(seed)
    emb = torch.randn((sum(batches), dim), generator=gen).to(device)
    pick = torch.linspace(0, sum(batches) - 1, n_queries).to(torch.int64).to(device)
    return batches, emb, pick, emb[pick]


def _fill_small(services: dict, emb: torch.Tensor, batches: list, max_segments: int) -> None:
    for svc in services.values():
        start = 0
        for rows in batches:
            svc.add(range(start, start + rows), embeddings=emb[start:start + rows])
            start += rows
        stats = svc.index_stats
        check(stats.compaction_count == 1 and stats.n_segments == max(1, max_segments // 2)
              and stats.n_objects == sum(batches),
              f"expected one compaction down to {max_segments // 2} segments, got "
              f"{stats.compaction_count} compactions, {stats.n_segments} segments")


def small_layout_round_trip(device: torch.device, scheme: str, count_kernel: str, seed: int,
                            k: int = 10, max_segments: int = 16, **service_kw):
    """A scheme with a PACKED layout served WIDE and PACKED, each on the kernel
    path and the plain path, through one compaction (kernel path = plain
    path, PACKED = WIDE, corpus points retrieve themselves); then a MONOLITHIC
    plan over the PACKED corpus padded by `concat_data`, which runs the packed
    count kernel `count_kernel` and the pad mask.  Returns that plan's
    launches of `count_kernel` and the corpus (batches, emb, pick, queries)."""
    from repro_torch.core import TopKMethod, execute, plan_search
    from repro_torch.kernels import common
    from repro_torch.serve import RetrievalService

    batches, emb, pick, queries = _small_corpus(seed, device, max_segments)
    services = {
        (layout, use_kernel): RetrievalService(device=device, seed=SEED, scheme=scheme,
                                               signature_layout=layout, use_kernel=use_kernel,
                                               max_segments=max_segments, **service_kw)
        for layout in ("wide", "packed") for use_kernel in (True, False)
    }
    _fill_small(services, emb, batches, max_segments)
    wide_res = {}
    for method in (TopKMethod.CPQ, TopKMethod.SPQ, TopKMethod.SORT):
        res = {key: svc.search(None, k=k, embeddings=queries, method=method)[0]
               for key, svc in services.items()}
        sync(device)
        for layout in ("wide", "packed"):
            for field in ("ids", "counts", "threshold"):
                check(torch.equal(getattr(res[(layout, True)], field),
                                  getattr(res[(layout, False)], field)),
                      f"{scheme} {layout} {method.value}: kernel path and plain path "
                      f"differ in {field}")
        check(torch.equal(res[("packed", True)].ids, res[("wide", True)].ids)
              and torch.equal(res[("packed", True)].counts, res[("wide", True)].counts),
              f"{scheme} {method.value}: PACKED differs from WIDE")
        top1 = float((res[("wide", True)].ids[:, 0] == pick.to(torch.int32)).float().mean().item())
        check(top1 == 1.0, f"{scheme} {method.value}: top-1 self-retrieval {top1} != 1.0")
        wide_res[method] = res[("wide", True)]
        log(f"  {scheme} {method.value}: WIDE and PACKED each equal on both paths, "
            f"PACKED == WIDE, top-1 self-retrieval {top1:.3f}")

    # the PACKED corpus as one padded matrix: the plan has n_objects, so the
    # fused kernel is off and the packed count kernel + pad mask run instead
    index = services[("packed", True)]._index
    data, n = index.concat_data(pad_multiple=4096)
    q_exec = index.model.prepare_queries_for(services[("packed", True)]._hash(queries),
                                             device, "packed")
    launches = 0
    for method in (TopKMethod.CPQ, TopKMethod.SPQ, TopKMethod.SORT):
        got = {}
        for use_kernel in (True, False):
            plan = plan_search(index.engine, k, index.max_count, part_rows=(data.shape[0],),
                               n_objects=n, method=method, use_kernel=use_kernel,
                               signature_layout="packed")
            check(plan.fused_match is None, "a padded plan must not take the fused kernel")
            common.reset_launch_counts()   # the padded-plan path starts here
            got[use_kernel] = execute(plan, data, q_exec)
            sync(device)
            counts = common.launch_counts()
            if use_kernel and method is TopKMethod.CPQ:
                launches = counts.get(count_kernel, 0)
        check(counts == {}, f"the plain path launched a kernel: {counts}")
        for field in ("ids", "counts", "threshold"):
            check(torch.equal(getattr(got[True], field), getattr(got[False], field)),
                  f"padded PACKED {scheme} plan {method.value}: kernel path and plain path "
                  f"differ in {field}")
        check(torch.equal(got[True].ids, wide_res[method].ids)
              and torch.equal(got[True].counts, wide_res[method].counts),
              f"padded PACKED {scheme} plan {method.value}: differs from the segmented service")
    check(launches == 1, f"{count_kernel} launched {launches} times in the padded plan")
    log(f"  MONOLITHIC plan over concat_data(pad_multiple=4096) of the PACKED index "
        f"({data.shape[0]} rows, {n} real): {count_kernel} launched {launches}x per "
        f"search; CPQ/SPQ/SORT equal the plain path and the segmented service")
    return launches, (batches, emb, pick, queries)


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------

def drive_full_width(device: torch.device, expect_launches: dict, sim_range: tuple,
                     n_total: int = FULL_N, dim: int = FULL_DIM,
                     n_segments: int = FULL_SEGMENTS, n_queries: int = FULL_Q,
                     k: int = FULL_K, n_searches: int = N_SEARCHES, **service_kw) -> dict:
    """Fill a RetrievalService with the SIFT-shaped corpus in `n_segments`
    adds and search it `n_searches` times; `expect_launches` is each kernel's
    launches per search on this path (and no other kernel may launch).
    Returns the launch counts of the run, the service, the query batch, its
    signatures and the last result."""
    from repro_torch.core import TopKMethod
    from repro_torch.kernels import common
    from repro_torch.serve import RetrievalService

    check(n_total % n_segments == 0 and n_queries % n_segments == 0,
          "segments must divide the corpus and the query batch")
    rows = n_total // n_segments
    per_seg_queries = n_queries // n_segments
    common.reset_launch_counts()           # the path starts here

    svc = RetrievalService(device=device, seed=SEED, **service_kw)
    log(f"  scheme {svc.scheme}, {svc.signature_layout.value}: m = required_m({svc.eps}, "
        f"{svc.delta}) = {svc.m}; n_buckets = {svc.n_buckets}; w = {svc.w}; N = {n_total} "
        f"in {n_segments} adds of {rows}; d = {dim}; Q = {n_queries}; k = {k}")
    gen = torch.Generator(device=device).manual_seed(SEED)
    add_seconds, query_rows, expect = [], [], []
    for s in range(n_segments):
        emb = torch.randn((rows, dim), generator=gen, device=device)
        sync(device)
        t0 = time.perf_counter()
        svc.add(range(s * rows, (s + 1) * rows), embeddings=emb)
        sync(device)
        add_seconds.append(time.perf_counter() - t0)
        # queries: corpus points of every segment, shifted by 0.01
        query_rows.append(emb[:per_seg_queries] + 0.01)
        expect.append(s * rows + torch.arange(per_seg_queries, device=device))
        del emb
    queries = torch.cat(query_rows)
    expect = torch.cat(expect).to(torch.int32)
    stats = svc.index_stats
    check(stats.n_segments == n_segments and stats.compaction_count == 0,
          f"expected {n_segments} sealed segments and no compaction, got "
          f"{stats.n_segments} / {stats.compaction_count}")
    log(f"  add: {statistics.median(add_seconds):.4f} s/batch median "
        f"(first {add_seconds[0]:.4f} s, total {sum(add_seconds):.3f} s); "
        f"signatures on the device: {stats.bytes_device / 1e9:.4f} GB "
        f"(WIDE {stats.bytes_signatures_wide / 1e9:.4f} GB, PACKED "
        f"{stats.bytes_signatures_packed / 1e9:.4f} GB)")

    timing = {}
    res, sims = timed_searches(
        lambda: svc.search(None, k=k, embeddings=queries, method=TopKMethod.CPQ),
        n_queries, n_searches, expect_launches, device, record=timing)
    launches = common.launch_counts()

    check_result(res, n_queries, k, n_total)
    check(sims.shape == (n_queries, k) and bool((sims >= sim_range[0]).all())
          and bool((sims <= sim_range[1]).all()),
          f"similarity estimates outside {list(sim_range)}")
    top1 = float((res.ids[:, 0] == expect).float().mean().item())
    log(f"  top-1 self-retrieval: {top1:.4f}")
    check(top1 >= 0.99, f"top-1 self-retrieval {top1} < 0.99")

    qsigs = svc._hash(queries)
    check_sample_on_plain_path(svc._index, qsigs, res, k, device)
    return dict(launches=launches, service=svc, qsigs=qsigs, queries=queries, result=res,
                timing=timing,
                add_seconds=add_seconds)


def check_result(res, n_queries: int, k: int, n_total: int) -> None:
    """A top-k result of full width: shapes, dtypes, order, ids in range."""
    check(res.ids.shape == (n_queries, k) and res.counts.shape == (n_queries, k)
          and res.threshold.shape == (n_queries,), "result shapes")
    check(res.ids.dtype == torch.int32 and res.counts.dtype == torch.int32, "result dtypes")
    check(bool((res.counts[:, :-1] >= res.counts[:, 1:]).all()), "counts not non-increasing")
    check(bool(((res.ids >= 0) & (res.ids < n_total)).all()), "ids out of range")


def check_sample_on_plain_path(index, queries, res, k: int, device: torch.device) -> None:
    """8 rows of `res` against a sort-method search through the plain path:
    the same sealed segments of the SegmentedIndex `index`, viewed by an
    index that never uses a kernel."""
    from repro_torch.core import SegmentedIndex, TopKMethod
    from repro_torch.kernels import common

    n_queries = res.ids.shape[0]
    sample = torch.arange(0, n_queries, max(1, n_queries // 8), device=device)[:8]
    plain = SegmentedIndex(engine=index.engine, max_count=index.max_count, use_kernel=False,
                           segments=index.segments, device=device,
                           signature_layout=index.signature_layout)
    before = common.launch_counts()
    # RANGE queries are an (lo, hi) pair
    rows = tuple(q[sample] for q in queries) if isinstance(queries, tuple) else queries[sample]
    oracle = plain.search(rows, k=k, method=TopKMethod.SORT)
    sync(device)
    check(common.launch_counts() == before, "the plain path launched a kernel")
    check(torch.equal(oracle.ids, res.ids[sample]) and torch.equal(oracle.counts, res.counts[sample])
          and torch.equal(oracle.threshold, res.threshold[sample]),
          "the kernel path differs from the sort oracle on the sampled rows")
    log(f"  rows {sample.tolist()} equal a sort-method search through the plain path")


def timed_searches(search, n_queries: int, n_searches: int, expect_launches: dict,
                   device: torch.device, record: dict | None = None):
    """Run `search()` n_searches times: log the first time and the median of
    the rest, queries/s and the peak device memory; check that the launch
    counts since the path's reset are `expect_launches` per search (and that
    no other kernel launched).  Returns the last result; `record` receives
    the times (`search_ms`) and the peak (`peak_bytes`)."""
    from repro_torch.kernels import common

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    search_ms, res = [], None
    for _ in range(n_searches):
        ms, res = timed_ms(search, device)
        search_ms.append(ms)
    launches = common.launch_counts()      # the path ends here
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rest = search_ms[1:] or search_ms
    median_ms = statistics.median(rest)
    log(f"  search: first {search_ms[0]:.2f} ms, median of the rest {median_ms:.2f} ms "
        f"({[round(t, 2) for t in search_ms]}); "
        f"{n_queries / (median_ms / 1e3):.1f} queries/s; "
        f"peak device memory {peak / 1e9:.3f} GB")
    log(f"  kernel launches on this path: {launches}")
    if record is not None:
        record.update(search_ms=search_ms, peak_bytes=peak)
    want = {name: per * n_searches for name, per in expect_launches.items()}
    check(launches == want, f"launches {launches}, expected {want} "
          f"({expect_launches} per search x {n_searches} searches)")
    return res


def service_search(run: dict, k: int):
    """One search of a full-width service run, as drive_full_width runs it."""
    return lambda: run["service"].search(None, k=k, embeddings=run["queries"])


def phase_full_width(device: torch.device, **sizes) -> dict:
    """The default service (E2LSH -> EQ, WIDE) at full width."""
    log("== phase 4: RetrievalService defaults at full width")
    return drive_full_width(device, {"match_count": FULL_SEGMENTS, "cpq_hist": FULL_SEGMENTS},
                            (0.0, 1.0), **sizes)


def phase_full_width_simhash(device: torch.device, **sizes) -> dict:
    """RetrievalService(scheme="simhash") at full width, WIDE then PACKED, on
    the same corpus; PACKED must equal WIDE on every row."""
    log("== phase 4b: RetrievalService(scheme='simhash') at full width, WIDE and PACKED")
    segs = sizes.get("n_segments", FULL_SEGMENTS)
    out = {}
    for layout, per_search in (("wide", {"cosine_count": segs, "cpq_hist": segs}),
                               ("packed", {"packed_cosine_topk": segs})):
        out[layout] = drive_full_width(device, per_search, (-1.0, 1.0), scheme="simhash",
                                       signature_layout=layout, **sizes)
        profile_one_search(service_search(out[layout], sizes.get("k", FULL_K)), device)
    wide, packed = out["wide"]["result"], out["packed"]["result"]
    check(torch.equal(wide.ids, packed.ids) and torch.equal(wide.counts, packed.counts),
          "simhash PACKED differs from WIDE")
    log(f"  PACKED ids and counts equal WIDE on all {wide.ids.shape[0]} rows")
    return out


def search_split(svc, queries: torch.Tensor, k: int, device: torch.device) -> None:
    """One search taken apart stage by stage (same functions, same order as
    core/plan.py runs them), each stage timed on its own and summed over the
    segments."""
    from repro_torch.core import cpq, merge
    from repro_torch.core.plan import _mask_pad_counts
    from repro_torch.kernels import ops

    index = svc._index
    params_k = [min(k, r) for r in index.segment_rows]
    cap = max(2 * k, k + 16)
    split = dict.fromkeys(
        ["hash", "match kernel", "mask", "histogram kernel", "gate", "compaction",
         "final order", "merge"], 0.0)

    def stage(name, fn):
        ms, out = timed_ms(fn, device)
        split[name] += ms
        return out

    qsigs = stage("hash", lambda: svc._hash(queries))
    bufs_i, bufs_c, offset = [], [], 0
    for seg, kk in zip(index.segments, params_k):
        counts = stage("match kernel", lambda: ops.match_count(seg.data, qsigs))
        counts = stage("mask", lambda: _mask_pad_counts(counts, offset, None))
        hist = stage("histogram kernel", lambda: ops.cpq_hist(counts, index.max_count))
        thr = stage("gate", lambda: cpq.audit_threshold(hist, kk)[1])
        cand = stage("compaction", lambda: cpq._compact_candidates(counts, thr, cap))
        ids, vals = stage("final order", lambda: cpq.topk_from_candidates(*cand, kk))
        bufs_i.append(torch.where(ids >= 0, ids + offset, -1))
        bufs_c.append(vals)
        offset += seg.stats.n_objects
        del counts, cand
    stage("merge", lambda: merge.merge_ragged(bufs_i, bufs_c, k))
    total = sum(split.values())
    log("  one search, stage by stage (ms, summed over the segments; each stage "
        "synchronised, so the sum exceeds an unsplit search):")
    for name, ms in split.items():
        log(f"    {name:17s} {ms:9.2f}  {100 * ms / total:5.1f}%")
    log(f"    {'sum':17s} {total:9.2f}")


def profile_one_search(search, device: torch.device, what: str = "search") -> None:
    """One search (`search()`) under torch.profiler: the share of the
    search's wall time in which the device was busy (kernels on one stream do
    not overlap, so their times add up), and the kernels that took most of
    it."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats the time of the kernels it
    # launched; copies (a multiload host loop's run on a side stream, beside
    # the kernels) are summed apart
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(r[0] for r in rows if r[2].startswith("Memcpy"))
    rows = sorted((r for r in rows if r[0] > 0 and not r[2].startswith("Memcpy")), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if copies:
        log(f"  profiler: device copies (Memcpy) {copies:.1f} ms, not counted as busy below")
    if busy_ms == 0:
        log("  profiler: no device time recorded; device busy share not measured")
        return
    log(f"  profiler: one {what} {wall_ms:.1f} ms wall under the profiler, device busy "
        f"{busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% (idle {100 - 100 * busy_ms / wall_ms:.1f}%); "
        f"device time by kernel:")
    for ms, count, key in rows[:10]:
        log(f"    {ms:9.2f} ms  {100 * ms / busy_ms:5.1f}%  x{count:<4d} {key[:90]}")


# ---------------------------------------------------------------------------
# Phase 5: the kernels' times at the per-segment shape
# ---------------------------------------------------------------------------

# The pipe each SASS opcode of the count bodies issues to on sm_90: 32-bit
# integer add, compare, select and logic on the 64-lane integer pipe ("int");
# float16x2 compare, add and FMA on the float16 pipe ("fp16x2"), where an
# HSET2 takes two issue slots and an HADD2 / HFMA2 one (measured on an H100:
# 62 against 112 thread-instructions per SM-clock, tools/fp16_pipe_rates.py);
# float32 ("fp32"); IMAD on the FMA pipe ("imad"); shared-memory loads and
# stores through the MIO queue ("mio").  An SM issues 128 thread-instructions
# a clock (4 schedulers x 32 threads).
SASS_PIPES = {"ISETP": "int", "IADD3": "int", "SEL": "int", "LOP3": "int", "IMNMX": "int",
              "SHF": "int", "LEA": "int", "PLOP3": "int", "VIADD": "int", "PRMT": "int",
              "HSET2": "fp16x2", "HADD2": "fp16x2", "HFMA2": "fp16x2", "HMUL2": "fp16x2",
              "FADD": "fp32", "FFMA": "fp32", "FSEL": "fp32", "IMAD": "imad", "POPC": "popc",
              "LDS": "mio", "STS": "mio"}
SLOTS_PER_SM_CLOCK = 128
POPC_PER_SM_CLOCK = 16
INT_LANES_PER_SM = 64
# the fewest pairs a basic block must compare to count as a count body
MIN_BODY_PAIRS = 256
SASS_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")


def eq_pairs(ops: collections.Counter, full: collections.Counter) -> int:
    """(query, data, column) pairs an equality count body compares: two an
    HSET2 (float16 lanes), one an ISETP (int32 ids), four a POPC (byte lanes
    counted by eq_lanes)."""
    return 2 * ops["HSET2"] + ops["ISETP"] + 4 * ops["POPC"]


def range_pairs(ops: collections.Counter, full: collections.Counter) -> int:
    """(query, data row, attribute) interval tests a RANGE count body makes:
    one per saturated float16 add (two a word of two tests: [x >= lo'] and [x
    <= hi']), one per two ISETPs on the int32 path (lo <= x, x <= hi)."""
    sat = sum(c for op, c in full.items()
              if op.split(".")[0] in ("HADD2", "HFMA2") and "SAT" in op.split(".")[1:])
    return sat + ops["ISETP"] // 2


def sass_count_bodies(sass: dict, kernel: str, pairs_of=eq_pairs) -> list:
    """The count bodies of `kernel` in the library's SASS (build.sass()): the
    basic blocks (straight-line runs of instructions) that compare at least
    `pairs_of.min_pairs` pairs, or MIN_BODY_PAIRS where the rule sets none
    (`pairs_of(base opcodes, full opcodes)`: eq_pairs, or range_pairs for
    interval tests), largest first.  Each with its path (float16 lanes,
    with int SWAR where it also pops counts / int32 compare into float16 lanes
    / int32), pairs, instructions per pair in all, by opcode and by pipe, and
    the pairs per SM-clock that the issue rate, the float16 pipe, the int pipe
    and the popc pipe allow."""
    # mangled (length-prefixed) or demangled: not packed_tanimoto_count_kernel
    # for tanimoto_count_kernel
    name = next(n for n in sass
                if f"{len(kernel)}{kernel}" in n or re.search(rf"(?<!\w){kernel}\(", n))
    # a block ends at a branch and starts at a label or at any branch's
    # target address (cuobjdump prints addresses, nvdisasm labels)
    lines = sass[name].splitlines()
    targets = {int(t, 16) for line in lines if " BRA " in line
               for t in re.findall(r"0x([0-9a-f]+)", line.split(";")[0])}
    blocks, current = [], []
    for line in lines:
        hit = SASS_INSTRUCTION.search(line)
        if re.match(r"\s*\.L_x_\d+:", line) or (hit and int(hit.group(1), 16) in targets):
            blocks.append(current)
            current = []
        if hit:
            current.append(hit.group(2))
            if current[-1].split(".")[0] in ("BRA", "EXIT", "BAR"):
                blocks.append(current)
                current = []
    blocks.append(current)
    bodies = []
    for block in blocks:
        full = collections.Counter(block)
        ops = collections.Counter(op.split(".")[0] for op in block)
        pairs = pairs_of(ops, full)
        if pairs < getattr(pairs_of, "min_pairs", MIN_BODY_PAIRS):
            continue
        pipes = collections.Counter()
        for op, c in ops.items():
            pipes[SASS_PIPES.get(op, "other")] += c
        total = sum(ops.values())
        fp16_slots = 2 * ops["HSET2"] + ops["HADD2"] + ops["HFMA2"] + ops["HMUL2"]
        lanes = ops["HSET2"] or any("SAT" in op.split(".")[1:] for op in full)
        bodies.append(dict(
            path=("float16 lanes" + (" + int SWAR" if ops["POPC"] else "") if lanes else
                  "int SWAR" if ops["POPC"] else
                  "int32 compare, float16 lanes" if ops["HADD2"] else "int32"),
            pairs=pairs, per_pair=round(total / pairs, 4),
            by_opcode={op: round(c / pairs, 4) for op, c in ops.most_common()},
            by_pipe={p: round(c / pairs, 4) for p, c in pipes.most_common()},
            issue_pairs_per_sm_clock=round(SLOTS_PER_SM_CLOCK * pairs / total, 2),
            fp16_pipe_pairs_per_sm_clock=(round(SLOTS_PER_SM_CLOCK * pairs / fp16_slots, 2)
                                          if fp16_slots else None),
            int_pipe_pairs_per_sm_clock=(round(INT_LANES_PER_SM * pairs / pipes["int"], 2)
                                         if pipes["int"] else None),
            popc_pipe_pairs_per_sm_clock=(round(POPC_PER_SM_CLOCK * pairs / ops["POPC"], 2)
                                          if ops["POPC"] else None)))
    return sorted(bodies, key=lambda b: -b["pairs"])


def log_sass_bodies(kernel: str, bodies: list) -> None:
    for b in bodies:
        log(f"  SASS {kernel} [{b['path']}]: {b['pairs']} pairs in the body, {b['per_pair']} "
            f"instructions a pair; by pipe {b['by_pipe']}; by opcode {b['by_opcode']}; "
            f"allows {b['issue_pairs_per_sm_clock']} pairs/SM-clock by issue, "
            f"{b['fp16_pipe_pairs_per_sm_clock']} by the float16 pipe (an HSET2 two slots), "
            f"{b['int_pipe_pairs_per_sm_clock']} by the int pipe, "
            f"{b['popc_pipe_pairs_per_sm_clock']} by the popc pipe")


def sm_clock_mhz(fn, device: torch.device, seconds: float = 3.0):
    """The median SM clock (MHz, `nvidia-smi --query-gpu=clocks.sm` every 100
    ms) while `fn` runs back to back on the card for about `seconds`: the
    sampler starts first, and only its samples from 0.2 s after the first
    call to the moment the card has run the last one count; None when there
    is none."""
    import threading

    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                             "-lms", "100"], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    samples = []
    started = threading.Event()

    def read():
        for line in proc.stdout:
            if line.strip().isdigit():
                samples.append((time.perf_counter(), float(line)))
                started.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        started.wait(timeout=15)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
        done = torch.cuda.Event()
        done.record()
        while not done.query():
            time.sleep(0.01)
        t1 = time.perf_counter()
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
        reader.join(timeout=30)
    sync(device)
    busy = [mhz for at, mhz in samples if t0 + 0.2 <= at <= t1]
    return statistics.median(busy) if busy else None


def pairs_per_sm_clock(pairs: float, ms: float, clock_mhz) -> float | None:
    """Compared (query, data, column) pairs per SM per clock at `clock_mhz`."""
    if not clock_mhz:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pairs / (ms * 1e-3) / sms / (clock_mhz * 1e6)


def library_eq_count(data: torch.Tensor, query: torch.Tensor, counts: torch.Tensor,
                     device: torch.device):
    """library_ms of an equality count [Q, N]: torch.cdist(query, data, p=0)
    counts the unequal coordinates of every pair, so m minus it is the count
    (bucket ids and m are far below 2**24, exact in float32).  The operands are
    cast to float32 beforehand and the subtraction is not timed, as with
    _int_mm for cosine_count; timed here, used nowhere in the port."""
    m = data.shape[1]
    qf, df = query.float(), data.float()
    try:
        ms, dist = timed_ms(lambda: torch.cdist(qf, df, p=0), device, reps=1, warmup=1)
    except RuntimeError as e:          # the yardstick only: the port never calls it
        log(f"  torch.cdist refused these operands ({e}); library_ms not measured")
        return None
    del qf, df
    check(torch.equal(dist.neg_().add_(m).to(torch.int32), counts),
          "the cdist yardstick disagrees with the equality count")
    return ms


def eq_tile_trace(name: str, fn, ms: float, pairs: int, device: torch.device) -> None:
    """Phase 5 / 5c: the SASS of the equality kernel `name` (instructions per
    compared pair, by opcode and pipe, for each path), the SM clock while it
    runs at this shape, the pairs per SM per clock that `ms` makes, and the
    issue floor (pairs / 128 per SM-clock at that clock) beside the bound."""
    from repro_torch.kernels import build

    bodies = sass_count_bodies(build.sass(), f"{name}_kernel")
    log_sass_bodies(f"{name}_kernel", bodies)
    clock = sm_clock_mhz(fn, device)
    rate = pairs_per_sm_clock(pairs, ms, clock)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor = pairs / (SLOTS_PER_SM_CLOCK * sms * clock * 1e6) * 1e3 if clock else None
    trace = dict(kernel=name, ms=ms, pairs=pairs, sm_clock_mhz=clock, pairs_per_sm_clock=rate,
                 issue_floor_ms=floor, bodies=bodies)
    log(f"  {name}: {ms:.4f} ms for {pairs:.4g} pairs; SM clock {clock} MHz while it runs; "
        f"{rate} pairs per SM-clock; issue floor {floor} ms (pairs / {SLOTS_PER_SM_CLOCK} "
        f"per SM-clock on {sms} SMs)")
    log("  eq_tile trace: " + json.dumps(trace))


def eq_general_path(shape: tuple, q: int, device: torch.device) -> None:
    """Phase 5: match_count on full-range int32 ids at the per-segment shape
    -- every chunk takes the general path of the equality tile -- against
    its plain version, with half the queries copies of data rows so that
    counts of m occur; its SASS is traced by eq_tile_trace."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.match_count import match_count_plain

    n, m = shape
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    d = torch.randint(-2**31, 2**31 - 1, (n, m), generator=gen, device=device, dtype=torch.int32)
    s = torch.randint(-2**31, 2**31 - 1, (q, m), generator=gen, device=device, dtype=torch.int32)
    s[::2] = d[torch.arange(0, q, 2, device=device) * 997 % n]
    ms, got = timed_ms(lambda: ops.match_count(d, s), device, reps=3, warmup=1)
    want = match_count_plain(d, s)
    check(torch.equal(got, want), "match_count differs on full-range int32 ids at the "
                                  "per-segment shape")
    del want
    clock = sm_clock_mhz(lambda: ops.match_count(d, s), device)
    log(f"  match_count on full-range int32 ids (general path) Q={q} N={n} m={m}: {ms:.4f} ms, "
        f"equal to its plain version; SM clock {clock} MHz; "
        f"{pairs_per_sm_clock(q * n * m, ms, clock)} pairs per SM-clock")


def instruction_floors(library, kernel: str, pairs_of, work: int, clock, unit: str) -> list:
    """Phase 5c / 5d: the count bodies of `kernel` in the SASS of `library`
    (None: this checkout's build), and the least time each body's
    instructions allow for `work` pairs or tests at `clock` MHz, by issue and
    by the float16, int and popc pipes."""
    from repro_torch.kernels import build

    bodies = sass_count_bodies(build.sass(library), kernel, pairs_of)
    log_sass_bodies(kernel, bodies)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in bodies:
        floors = {k[:-len("_pairs_per_sm_clock")]: work / (v * sms * clock * 1e6) * 1e3
                  for k, v in b.items() if k.endswith("_pairs_per_sm_clock") and v and clock}
        log(f"  {kernel} [{b['path']}]: floors for {work:.4g} {unit} at {clock} MHz, ms: "
            + json.dumps({k: round(v, 4) for k, v in floors.items()}))
    return bodies


def previous_design(kind: str, device: torch.device, *operands) -> dict:
    """Phase 5c / 5d: this checkout's range_count or packed_tanimoto_count
    ("range" / "packed") beside the previous design's (the int32 count tile,
    built from tools/range_ptan_baseline.cu), in turns on the same operands,
    with the SM clock while each runs, the tests or pairs per SM-clock, and
    both designs' SASS floors (tools/range_ptan_ab.py)."""
    from repro_torch.kernels import build
    from tools import range_ptan_ab as ab

    entries = {"previous": ab.previous_entries(), "this": ab.Entries(build.build())}
    fn, rule, unit = ((ab.range_ab, range_pairs, "tests") if kind == "range" else
                      (ab.ptan_ab, eq_pairs, "pairs"))
    rec = fn(entries, *operands, device)
    kernel = "range_count_kernel" if kind == "range" else "packed_tanimoto_count_kernel"
    rate = rec.get("tests_per_sm_clock") or rec.get("pairs_per_sm_clock")
    log(f"  {kernel[:-7]} in turns with the previous design (ms, each turn): "
        + json.dumps(rec["ms"]) + f"; SM clock {rec['sm_clock_mhz']} MHz; {unit} per SM-clock "
        + json.dumps(rate)
        + (f"; the previous wrapper's torch.stack of lo, hi {rec['stack_ms']:.4f} ms"
           if kind == "range" else ""))
    work = rec["Q"] * rec["N"] * (rec["d"] if kind == "range" else rec["m"])
    instruction_floors(None, kernel, rule, work, rec["sm_clock_mhz"]["this"], unit)
    instruction_floors(ab.previous_entries_path(), f"baseline_{kernel}", rule, work,
                       rec["sm_clock_mhz"]["previous"], unit)
    return rec


def kernel_entry(name: str, source: str, replaces: str, launches: int, err: int, ms: float,
                 plain: float, bound_bytes_ms: float, bound_ops_ms: float, lib) -> dict:
    """One kernel's entry of the `kernels` line: its bound is the larger of
    the bytes' and the operations' least times."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
                library_ms=lib)


def log_kernels(kernels: list) -> None:
    for kern in kernels:
        log(f"  {kern['name']}: {kern['ms']:.4f} ms; bound {kern['bound_ms']:.4f} ms by "
            f"{kern['bound_by']} ({100 * kern['bound_ms'] / kern['ms']:.1f}% of it); plain "
            f"{kern['plain_ms']:.1f} ms; library {kern['library_ms']}")


def phase_kernel_times(data: torch.Tensor, qsigs: torch.Tensor, max_count: int,
                       launches: dict, parity_err: dict, device: torch.device) -> list:
    from repro_torch.kernels import ops
    from repro_torch.kernels.cpq_hist import cpq_hist_plain
    from repro_torch.kernels.match_count import match_count_plain

    n, m = data.shape
    q = qsigs.shape[0]
    nbins = max_count + 1
    log(f"== phase 5: kernel times at the per-segment shape Q={q} N={n} m={m} bins={nbins}")

    ms_match, counts = timed_ms(lambda: ops.match_count(data, qsigs), device, reps=3, warmup=1)
    plain_match, counts_plain = timed_ms(lambda: match_count_plain(data, qsigs), device,
                                         reps=1, warmup=1)
    err_match = max(parity_err["match_count"], max_abs_err(counts, counts_plain))
    check(torch.equal(counts, counts_plain), "match_count differs at the per-segment shape")
    del counts_plain
    lib_match = library_eq_count(data, qsigs, counts, device)
    eq_tile_trace("match_count", lambda: ops.match_count(data, qsigs), ms_match, q * n * m,
                  device)
    eq_general_path(data.shape, q, device)
    match_bytes = (n * m + q * m + q * n) * 4          # inputs read once, output written once
    match_ops = 2 * q * n * m                          # one compare and one add per pair and column
    bound_bytes, bound_ops = match_bytes / PEAK_BYTES_PER_S * 1e3, match_ops / PEAK_ALU_OPS_PER_S * 1e3

    ms_hist, hist = timed_ms(lambda: ops.cpq_hist(counts, max_count), device, reps=10, warmup=1,
                             hold=True)
    plain_hist, hist_plain = timed_ms(lambda: cpq_hist_plain(counts, max_count), device,
                                      reps=1, warmup=1)
    err_hist = max(parity_err["cpq_hist"], max_abs_err(hist, hist_plain))
    check(torch.equal(hist, hist_plain), "cpq_hist differs at the per-segment shape")
    check(int(counts.min().item()) >= 0 and int(counts.max().item()) <= max_count,
          "counts outside [0, max_count]: the bincount yardstick would not compute the same function")
    row_offset = torch.arange(q, device=device, dtype=torch.int32)[:, None] * nbins

    def library_hist():
        # the one PyTorch call for the same function: a bincount over
        # row-offset values (timed here, used nowhere in the port)
        return torch.bincount((counts + row_offset).reshape(-1), minlength=q * nbins)

    lib_hist, hist_lib = timed_ms(library_hist, device, reps=3, warmup=1)
    check(torch.equal(hist_lib.reshape(q, nbins).to(torch.int32), hist),
          "the bincount yardstick disagrees with cpq_hist")
    hist_bytes = (q * n + q * nbins) * 4
    hist_ops = q * n                                   # one add per count
    hb_bytes, hb_ops = hist_bytes / PEAK_BYTES_PER_S * 1e3, hist_ops / PEAK_ALU_OPS_PER_S * 1e3

    kernels = [
        kernel_entry("match_count", "src/repro_torch/kernels/csrc/match_count.cu",
                     "src/repro/kernels/match_count.py:59", launches.get("match_count", 0),
                     err_match, ms_match, plain_match, bound_bytes, bound_ops, lib_match),
        kernel_entry("cpq_hist", "src/repro_torch/kernels/csrc/cpq_hist.cu",
                     "src/repro/kernels/cpq_hist.py:51", launches.get("cpq_hist", 0),
                     err_hist, ms_hist, plain_hist, hb_bytes, hb_ops, lib_hist),
    ]
    log_kernels(kernels)
    log("  library calls: match_count against m - torch.cdist(p=0) on float32 casts; "
        "cpq_hist against torch.bincount")
    log(f"  match_count: {match_ops / 2 / (ms_match / 1e3) / 1e12:.3f} T compare-adds/s, "
        f"{match_bytes / (ms_match / 1e3) / 1e9:.1f} GB/s; "
        f"cpq_hist: {hist_bytes / (ms_hist / 1e3) / 1e9:.1f} GB/s")
    return kernels


def packed_count_turns(d_words: torch.Tensor, q_words: torch.Tensor,
                       device: torch.device) -> dict:
    """Phase 5b: packed_cosine_count in turns with its previous design (the
    first port's tile, built from tools/packed_count_baseline.cu by
    tools/packed_count_ab.py) on the segment's words, with the SM clock while
    each runs, (query, data) pairs per SM-clock, the popcount floor of one
    POPC a word pair, both designs' SASS floors, and the [Q, N] int32 write
    alone (Tensor.fill_, the least a store of the counts takes here)."""
    from repro_torch.kernels import build
    from tools import packed_count_ab as pab

    rec = pab.count_ab({"previous": pab.previous_entry(), "this": pab.Entry(build.build())},
                       d_words, q_words, device)
    log("  packed_cosine_count in turns with the previous design (ms, each turn): "
        + json.dumps(rec["ms"]) + f"; SM clock {rec['sm_clock_mhz']} MHz; (query, data) pairs "
        f"per SM-clock {json.dumps(rec['pairs_per_sm_clock'])}; popcount floor of one POPC a "
        f"word pair {json.dumps(rec['popc_floor_ms'])} ms")
    (n, w), q = d_words.shape, q_words.shape[0]
    instruction_floors(None, "packed_cosine_count_kernel", pab.word_pairs, q * n * w,
                       rec["sm_clock_mhz"]["this"], "word pairs")
    instruction_floors(pab.previous_entry().path, "baseline_packed_cosine_count_kernel",
                       pab.word_pairs, q * n * w, rec["sm_clock_mhz"]["previous"],
                       "word pairs")
    fill_ms = rec["write_alone_fill_ms"]
    log(f"  the [Q, N] int32 write alone (Tensor.fill_): {fill_ms:.4f} ms = "
        f"{q * n * 4 / (fill_ms / 1e3) / 1e12:.3f} TB/s")
    return rec


def phase_cosine_kernel_times(simhash: dict, launches_count: int, parity_err: dict,
                              device: torch.device, k: int = FULL_K) -> list:
    """The three COSINE kernels at the per-segment shape of the simhash path."""
    from repro_torch.core import cpq, packing
    from repro_torch.core.types import SearchParams
    from repro_torch.kernels import common, ops
    from repro_torch.kernels.cosine_count import cosine_count_plain
    from repro_torch.kernels.packed_cosine import (TILE_N, packed_cosine_count_plain,
                                                   packed_cosine_topk_plain)

    wide, packed = simhash["wide"], simhash["packed"]
    model = wide["service"]._index.model
    d_sgn = wide["service"]._index.segments[0].data            # int8 [N, V]
    q_sgn = model.prepare_queries(wide["qsigs"], device)       # int8 [Q, V]
    d_words = packed["service"]._index.segments[0].data        # int32 [N, W]
    q_words = packing.pack_signs_queries(q_sgn)                # int32 [Q, W]
    n, v = d_sgn.shape
    q, w = q_sgn.shape[0], d_words.shape[1]
    log(f"== phase 5b: COSINE kernel times at the per-segment shape Q={q} N={n} V={v} "
        f"W={w} k={k} (fused tile {TILE_N})")

    # cosine_count
    log(f"  cosine_count takes the {common.dot_tile_loader('cosine_count', d_sgn, q_sgn)} "
        f"loader at V={v}")
    ms_cos, counts = timed_ms(lambda: ops.cosine_count(d_sgn, q_sgn), device, reps=3, warmup=1)
    plain_cos, counts_plain = timed_ms(lambda: cosine_count_plain(d_sgn, q_sgn), device,
                                       reps=1, warmup=1)
    err_cos = max(parity_err["cosine_count"], max_abs_err(counts, counts_plain))
    check(torch.equal(counts, counts_plain), "cosine_count differs at the per-segment shape")
    del counts_plain
    # the library yardstick: torch._int_mm on the same +-1 int8 signs, V padded
    # to 240 and N to a multiple of 8 with zeros (as _int_mm demands); the
    # (V + dot) >> 1 shift is not in the time
    v_pad, n_pad = -(-v // 8) * 8, -(-n // 8) * 8
    a = torch.zeros((q, v_pad), dtype=torch.int8, device=device)
    a[:, :v] = q_sgn
    b = torch.zeros((n_pad, v_pad), dtype=torch.int8, device=device)
    b[:n, :v] = d_sgn
    try:
        lib_cos, dot = timed_ms(lambda: torch._int_mm(a, b.T), device, reps=3, warmup=1)
        check(torch.equal((v + dot[:, :n]) >> 1, counts), "the _int_mm yardstick disagrees")
        del dot
    except RuntimeError as e:          # the yardstick only: the port never calls it
        log(f"  torch._int_mm refused these operands ({e}); library_ms not measured")
        lib_cos = None
    del a, b
    cos_bytes = n * v + q * v + q * n * 4
    cos_ops = 2 * q * n * v
    cb_bytes, cb_ops = cos_bytes / PEAK_BYTES_PER_S * 1e3, cos_ops / PEAK_INT8_TC_OPS_PER_S * 1e3

    # packed_cosine_count: the same counts from the packed words
    ms_pc, counts_p = timed_ms(lambda: ops.packed_cosine_count(d_words, q_words), device,
                               reps=3, warmup=1)
    check(torch.equal(counts_p, counts), "packed_cosine_count differs from cosine_count")
    del counts
    plain_pc, counts_pp = timed_ms(lambda: packed_cosine_count_plain(d_words, q_words), device,
                                   reps=1, warmup=1)
    err_pc = max(parity_err["packed_cosine_count"], max_abs_err(counts_p, counts_pp))
    check(torch.equal(counts_p, counts_pp), "packed_cosine_count differs from its plain version")
    del counts_pp
    pc_bytes = (n * w + q * w) * 4 + q * n * 4
    pc_ops = 3 * q * n * w                             # xor, popc, add per word pair
    pb_bytes, pb_ops = pc_bytes / PEAK_BYTES_PER_S * 1e3, pc_ops / PEAK_ALU_OPS_PER_S * 1e3
    packed_count_turns(d_words, q_words, device)

    # packed_cosine_topk at the service's k
    ms_tk, (ids, cnts) = timed_ms(lambda: ops.packed_cosine_topk(d_words, q_words, k=k),
                                  device, reps=5, warmup=1)
    plain_tk, (pids, pcnts) = timed_ms(lambda: packed_cosine_topk_plain(d_words, q_words, k),
                                       device, reps=1, warmup=1)
    err_tk = max(parity_err["packed_cosine_topk"], max_abs_err(ids, pids),
                 max_abs_err(cnts, pcnts))
    check(torch.equal(ids, pids) and torch.equal(cnts, pcnts),
          "packed_cosine_topk differs from its plain version at the per-segment shape")
    del pids, pcnts
    oracle = cpq.sort_select(counts_p, SearchParams(k=k, max_count=v))
    merge_ms, (mids, mcnts) = timed_ms(lambda: fused_result(ids, cnts, k), device,
                                       reps=3, warmup=1)
    check(torch.equal(mids, oracle.ids) and torch.equal(mcnts, oracle.counts),
          "packed_cosine_topk + topk_from_candidates differs from a sort of the counts")
    del counts_p, oracle
    slots = ids.shape[1]
    tk_bytes = (n * w + q * w) * 4 + 2 * q * slots * 4
    tk_ops = 3 * q * n * w                             # the match; selection not counted
    tb_bytes, tb_ops = tk_bytes / PEAK_BYTES_PER_S * 1e3, tk_ops / PEAK_ALU_OPS_PER_S * 1e3
    log(f"  packed_cosine_topk buffers [{q}, {slots}] x2 = {2 * q * slots * 4 / 1e6:.1f} MB; "
        f"reducing them with topk_from_candidates: {merge_ms:.3f} ms")
    clock = sm_clock_mhz(lambda: ops.packed_cosine_topk(d_words, q_words, k=k), device)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor = q * n * w / (POPC_PER_SM_CLOCK * sms * clock * 1e6) * 1e3 if clock else None
    log(f"  packed_cosine_topk: popcount floor {floor} ms (Q*N*W = {q * n * w:.4g} word pairs, "
        f"{POPC_PER_SM_CLOCK} popcounts per SM-clock on {sms} SMs at the {clock} MHz read while "
        f"it runs); the kernel takes {ms_tk / floor if floor else float('nan'):.2f}x it")

    kernels = [
        kernel_entry("cosine_count", "src/repro_torch/kernels/csrc/cosine_count.cu",
              "src/repro/kernels/cosine_count.py:70",
              wide["launches"].get("cosine_count", 0), err_cos, ms_cos, plain_cos,
              cb_bytes, cb_ops, lib_cos),
        kernel_entry("packed_cosine_count", "src/repro_torch/kernels/csrc/packed_cosine.cu",
              "src/repro/kernels/packed_cosine.py:97", launches_count, err_pc, ms_pc,
              plain_pc, pb_bytes, pb_ops, None),
        kernel_entry("packed_cosine_topk", "src/repro_torch/kernels/csrc/packed_cosine.cu",
              "src/repro/kernels/packed_cosine.py:151",
              packed["launches"].get("packed_cosine_topk", 0), err_tk, ms_tk, plain_tk,
              tb_bytes, tb_ops, None),
    ]
    log_kernels(kernels)
    log("  library calls: cosine_count against torch._int_mm (int8 tensor cores); "
        "packed_cosine_count and packed_cosine_topk have none (PyTorch has no popcount, "
        "and no one call selects per tile)")
    log(f"  cosine_count {q * n * v / (ms_cos / 1e3) / 1e12:.3f} T sign-MACs/s; "
        f"packed_cosine_count {q * n * w / (ms_pc / 1e3) / 1e12:.3f} T word-pairs/s, "
        f"{pc_bytes / (ms_pc / 1e3) / 1e9:.1f} GB/s; "
        f"packed_cosine_topk {q * n * w / (ms_tk / 1e3) / 1e12:.3f} T word-pairs/s")
    return kernels


# ---------------------------------------------------------------------------
# The TANIMOTO slice: minhash (WIDE and PACKED) and rbh
# ---------------------------------------------------------------------------

def _buckets(gen: torch.Generator, rows: int, m: int, device: torch.device,
             hi: int = 254) -> torch.Tensor:
    """int32 bucket ids in [0, hi), the domain's ends 0 and hi - 1 included."""
    b = torch.randint(0, hi, (rows, m), generator=gen, dtype=torch.int32)
    b.view(-1)[0], b.view(-1)[-1] = 0, hi - 1
    return b.to(device)


def tanimoto_parity(device: torch.device) -> dict:
    """Phase 2c: the three TANIMOTO kernels against their plain versions,
    bit-exact; returns the worst absolute difference per kernel."""
    from repro_torch.core import packing
    from repro_torch.kernels import ops
    from repro_torch.kernels.packed_tanimoto import (packed_tanimoto_count_plain,
                                                     packed_tanimoto_topk_plain)
    from repro_torch.kernels.tanimoto_count import tanimoto_count_plain

    log("== phase 2c: the TANIMOTO kernels against their plain PyTorch versions")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    worst = {"tanimoto_count": 0, "packed_tanimoto_count": 0, "packed_tanimoto_topk": 0,
             "packed_tanimoto_topk[tile_n=1024]": 0}
    for q, n, m in TANIMOTO_SHAPES:
        d, s = _buckets(gen, n, m, device, hi=64), _buckets(gen, q, m, device, hi=64)
        got = ops.tanimoto_count(d, s)
        want = tanimoto_count_plain(d, s)
        sync(device)
        err = max_abs_err(got, want)
        worst["tanimoto_count"] = max(worst["tanimoto_count"], err)
        check(got.shape == (q, n) and got.dtype == torch.int32 and torch.equal(got, want),
              f"tanimoto_count differs from its plain version at (Q,N,m)=({q},{n},{m}): "
              f"max abs err {err}")
        log(f"  tanimoto_count (Q,N,m)=({q},{n},{m}): equal")
    worst["tanimoto_count"] = max(
        worst["tanimoto_count"],
        eq_parity("tanimoto_count", ops.tanimoto_count, tanimoto_count_plain,
                  TANIMOTO_SHAPES + EQ_EXTRA_SHAPES, device, gen),
        eq_parity("tanimoto_count[tile_q=128]", eq_variant("tanimoto_count", 128),
                  tanimoto_count_plain, TANIMOTO_SHAPES + EQ_EXTRA_SHAPES, device, gen),
        eq_identity("tanimoto_count", ops.tanimoto_count, device))
    worst["tanimoto_count[tile_q=32]"] = max(
        eq_parity("tanimoto_count[tile_q=32]",
                  lambda d, s: ops.tanimoto_count(d, s, tile_q=32), tanimoto_count_plain,
                  NARROW_EQ_SHAPES, device, gen),
        eq_parity("tanimoto_count[tile_q=32]", eq_variant("tanimoto_count", 32),
                  tanimoto_count_plain, TANIMOTO_SHAPES + EQ_EXTRA_SHAPES, device, gen),
        eq_identity("tanimoto_count[tile_q=32]", eq_variant("tanimoto_count", 32), device))
    for q, n, m in PACKED_TANIMOTO_SHAPES:
        d, s = _buckets(gen, n, m, device), _buckets(gen, q, m, device)
        s[0] = d[min(1, n - 1)]                    # one full collision
        du, su = packing.pack_buckets(d), packing.pack_buckets(s)
        got = ops.packed_tanimoto_count(du, su)
        want = packed_tanimoto_count_plain(du, su)
        sync(device)
        err = max_abs_err(got, want)
        worst["packed_tanimoto_count"] = max(worst["packed_tanimoto_count"], err)
        check(got.shape == (q, n) and torch.equal(got, want)
              and torch.equal(got, tanimoto_count_plain(d, s)),
              f"packed_tanimoto_count differs from its plain version at (Q,N,m)=({q},{n},{m}): "
              f"max abs err {err}")
        log(f"  packed_tanimoto_count (Q,N,m)=({q},{n},{m}) ids 0..253: equal")
    cases = [(q, n, m, k, False) for q, n, m, k in TANIMOTO_TOPK_CASES] + [(2, 3000, 64, 5, True)]
    for q, n, m, k, all_equal in cases:
        if all_equal:                      # identical rows: the lowest ids must come out
            du = torch.full((n, m), 253, dtype=torch.uint8, device=device)
            su = torch.full((q, m), 253, dtype=torch.uint8, device=device)
        else:                              # few buckets: many ties at the threshold
            du = packing.pack_buckets(_buckets(gen, n, m, device, hi=8))
            su = packing.pack_buckets(_buckets(gen, q, m, device, hi=8))
        want_ids, want_cnts = sort_oracle(packed_tanimoto_count_plain(du, su), k)
        for tile in FUSED_TILES:               # each tile through its C entries
            key = "packed_tanimoto_topk" + ("" if tile == 2048 else f"[tile_n={tile}]")
            ids, cnts = fused_variant("packed_tanimoto_topk", tile)(du, su, k)
            pids, pcnts = packed_tanimoto_topk_plain(du, su, k, tile)
            sync(device)
            err = max(max_abs_err(ids, pids), max_abs_err(cnts, pcnts))
            worst[key] = max(worst[key], err)
            kc = min(k, tile)
            check(ids.shape == (q, -(-n // tile) * kc) and torch.equal(ids, pids)
                  and torch.equal(cnts, pcnts),
                  f"packed_tanimoto_topk buffers differ from the plain version at "
                  f"(Q,N,m,k)=({q},{n},{m},{k}) tile {tile}: max abs err {err}")
            got_ids, got_cnts = fused_result(ids, cnts, k)
            check(torch.equal(got_ids, want_ids) and torch.equal(got_cnts, want_cnts),
                  f"packed_tanimoto_topk after topk_from_candidates differs from a sort "
                  f"at (Q,N,m,k)=({q},{n},{m},{k}) tile {tile}")
            if all_equal:
                check(got_ids.tolist() == [list(range(k))] * q,
                      "all-equal rows: not the lowest ids")
        ids, cnts = ops.packed_tanimoto_topk(du, su, k=k)     # the wrapper's own pick
        check(torch.equal(fused_result(ids, cnts, k)[0], want_ids),
              f"packed_tanimoto_topk's wrapper at (Q,N,m,k)=({q},{n},{m},{k})")
        log(f"  packed_tanimoto_topk (Q,N,m,k)=({q},{n},{m},{k}) tiles {FUSED_TILES}"
            f"{' all-equal rows' if all_equal else ''}: buffers equal, merged == sort")
    return worst


def phase_small_minhash(device: torch.device) -> int:
    """Phase 3c: minhash (m = 96, 128 buckets, the reference's packed serving
    parity shape) WIDE and PACKED through small_layout_round_trip, whose
    padded PACKED plan runs packed_tanimoto_count; then rbh -> EQ on both
    paths.  Returns that plan's packed_tanimoto_count launches."""
    from repro_torch.core.lsh import rbh

    log("== phase 3c: small minhash round trip, WIDE and PACKED, and rbh "
        "(kernel path vs plain path)")
    k, max_segments = 10, 16
    launches, corpus = small_layout_round_trip(
        device, "minhash", "packed_tanimoto_count", SEED + 4, k=k, max_segments=max_segments,
        m_override=96, n_buckets=128)
    # rbh -> EQ: sigma by the median heuristic on the corpus
    sigma = rbh.median_heuristic_sigma(corpus[1], torch.Generator(device="cpu").manual_seed(SEED))
    small_wide_round_trip(device, f"rbh (sigma {sigma:.3f})", corpus, k=k,
                          max_segments=max_segments, scheme="rbh", m_override=96, sigma=sigma)
    return launches


def phase_full_width_minhash(device: torch.device, **sizes) -> dict:
    """Phase 4c: RetrievalService(scheme="minhash", n_buckets=254) at full
    width, WIDE then PACKED, on the corpus of phases 4 and 4b; PACKED must
    equal WIDE on every row."""
    log("== phase 4c: RetrievalService(scheme='minhash', n_buckets=254) at full width, "
        "WIDE and PACKED")
    segs = sizes.get("n_segments", FULL_SEGMENTS)
    out = {}
    for layout, per_search in (("wide", {"tanimoto_count": segs, "cpq_hist": segs}),
                               ("packed", {"packed_tanimoto_topk": segs})):
        out[layout] = drive_full_width(device, per_search, (0.0, 1.0), scheme="minhash",
                                       n_buckets=254, signature_layout=layout, **sizes)
        profile_one_search(service_search(out[layout], sizes.get("k", FULL_K)), device)
    wide, packed = out["wide"]["result"], out["packed"]["result"]
    check(torch.equal(wide.ids, packed.ids) and torch.equal(wide.counts, packed.counts),
          "minhash PACKED differs from WIDE")
    log(f"  PACKED ids and counts equal WIDE on all {wide.ids.shape[0]} rows")
    return out


def phase_full_width_rbh(device: torch.device, n_rows: int = OCR_ROWS,
                         n_segments: int = OCR_SEGMENTS, dim: int = OCR_DIM, **sizes) -> dict:
    """Phase 4c': RetrievalService(scheme="rbh") at the OCR configuration's
    width, 2 of its 16 adds; sigma by the median heuristic on that corpus
    (drawn as drive_full_width draws it)."""
    from repro_torch.core.lsh import rbh

    log(f"== phase 4c': RetrievalService(scheme='rbh') at OCR's width, {n_segments} of its "
        f"16 adds of {n_rows}")
    gen = torch.Generator(device=device).manual_seed(SEED)
    corpus = torch.cat([torch.randn((n_rows, dim), generator=gen, device=device)
                        for _ in range(n_segments)])
    sigma = rbh.median_heuristic_sigma(corpus, torch.Generator(device="cpu").manual_seed(SEED))
    del corpus
    log(f"  sigma = median_heuristic_sigma(corpus) = {sigma:.4f}")
    out = drive_full_width(device, {"match_count": n_segments, "cpq_hist": n_segments},
                           (0.0, 1.0), n_total=n_rows * n_segments, dim=dim,
                           n_segments=n_segments, scheme="rbh", sigma=sigma, **sizes)
    profile_one_search(service_search(out, sizes.get("k", FULL_K)), device)
    return out


def phase_tanimoto_kernel_times(minhash: dict, launches_count: int, parity_err: dict,
                                device: torch.device, k: int = FULL_K,
                                flash_n: int = 16_384, flash_m: int = 4096) -> list:
    """Phase 5c: the three TANIMOTO kernels at the per-segment shape of the
    minhash path, and tanimoto_count at a FLASH-scale m on a narrower N."""
    from repro_torch.core import cpq, packing
    from repro_torch.core.types import SearchParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.packed_tanimoto import (TILE_N, packed_tanimoto_count_plain,
                                                     packed_tanimoto_topk_plain)
    from repro_torch.kernels.tanimoto_count import tanimoto_count_plain

    wide, packed = minhash["wide"], minhash["packed"]
    d_sig = wide["service"]._index.segments[0].data             # int32 [N, m]
    q_sig = wide["qsigs"]                                        # int32 [Q, m]
    d_u8 = packed["service"]._index.segments[0].data            # uint8 [N, m]
    q_u8 = packing.pack_buckets(q_sig)                           # uint8 [Q, m]
    n, m = d_sig.shape
    q = q_sig.shape[0]
    words = -(-m // 4)
    log(f"== phase 5c: TANIMOTO kernel times at the per-segment shape Q={q} N={n} m={m} "
        f"({words} words of 4 lanes) k={k} (fused tile {TILE_N})")

    ms_tc, counts = timed_ms(lambda: ops.tanimoto_count(d_sig, q_sig), device, reps=3, warmup=1)
    plain_tc, counts_plain = timed_ms(lambda: tanimoto_count_plain(d_sig, q_sig), device,
                                      reps=1, warmup=1)
    err_tc = max(parity_err["tanimoto_count"], max_abs_err(counts, counts_plain))
    check(torch.equal(counts, counts_plain), "tanimoto_count differs at the per-segment shape")
    del counts_plain
    lib_tc = library_eq_count(d_sig, q_sig, counts, device)
    eq_tile_trace("tanimoto_count", lambda: ops.tanimoto_count(d_sig, q_sig), ms_tc, q * n * m,
                  device)
    tc_bytes = (n * m + q * m + q * n) * 4
    tc_ops = 2 * q * n * m                             # one compare and one add per pair and column
    tcb_bytes, tcb_ops = tc_bytes / PEAK_BYTES_PER_S * 1e3, tc_ops / PEAK_ALU_OPS_PER_S * 1e3

    ms_pc, counts_p = timed_ms(lambda: ops.packed_tanimoto_count(d_u8, q_u8), device,
                               reps=3, warmup=1)
    check(torch.equal(counts_p, counts), "packed_tanimoto_count differs from tanimoto_count")
    del counts
    plain_pc, counts_pp = timed_ms(lambda: packed_tanimoto_count_plain(d_u8, q_u8), device,
                                   reps=1, warmup=1)
    err_pc = max(parity_err["packed_tanimoto_count"], max_abs_err(counts_p, counts_pp))
    check(torch.equal(counts_p, counts_pp), "packed_tanimoto_count differs from its plain version")
    del counts_pp
    lib_pc = library_eq_count(d_u8, q_u8, counts_p, device)
    previous_design("packed", device, d_sig, q_sig)
    pc_bytes = n * m + q * m + q * n * 4
    pc_ops = 3 * q * n * words                         # xor, lane test, add per word pair
    pcb_bytes, pcb_ops = pc_bytes / PEAK_BYTES_PER_S * 1e3, pc_ops / PEAK_ALU_OPS_PER_S * 1e3

    ms_tk, (ids, cnts) = timed_ms(lambda: ops.packed_tanimoto_topk(d_u8, q_u8, k=k),
                                  device, reps=5, warmup=1)
    plain_tk, (pids, pcnts) = timed_ms(lambda: packed_tanimoto_topk_plain(d_u8, q_u8, k),
                                       device, reps=1, warmup=1)
    err_tk = max(parity_err["packed_tanimoto_topk"], max_abs_err(ids, pids),
                 max_abs_err(cnts, pcnts))
    check(torch.equal(ids, pids) and torch.equal(cnts, pcnts),
          "packed_tanimoto_topk differs from its plain version at the per-segment shape")
    del pids, pcnts
    oracle = cpq.sort_select(counts_p, SearchParams(k=k, max_count=m))
    merge_ms, (mids, mcnts) = timed_ms(lambda: fused_result(ids, cnts, k), device,
                                       reps=3, warmup=1)
    check(torch.equal(mids, oracle.ids) and torch.equal(mcnts, oracle.counts),
          "packed_tanimoto_topk + topk_from_candidates differs from a sort of the counts")
    del counts_p, oracle
    slots = ids.shape[1]
    tk_bytes = n * m + q * m + 2 * q * slots * 4
    tk_ops = 3 * q * n * words                         # the match; selection not counted
    tkb_bytes, tkb_ops = tk_bytes / PEAK_BYTES_PER_S * 1e3, tk_ops / PEAK_ALU_OPS_PER_S * 1e3
    log(f"  packed_tanimoto_topk buffers [{q}, {slots}] x2 = {2 * q * slots * 4 / 1e6:.1f} MB; "
        f"reducing them with topk_from_candidates: {merge_ms:.3f} ms")

    # FLASH-scale sketches: m = 4096 on a narrower N
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    d_f = torch.randint(0, 254, (flash_n, flash_m), generator=gen, device=device, dtype=torch.int32)
    q_f = torch.randint(0, 254, (q, flash_m), generator=gen, device=device, dtype=torch.int32)
    ms_f, counts_f = timed_ms(lambda: ops.tanimoto_count(d_f, q_f), device, reps=3, warmup=1)
    plain_f, counts_fp = timed_ms(lambda: tanimoto_count_plain(d_f, q_f), device, reps=1)
    check(torch.equal(counts_f, counts_fp), "tanimoto_count differs at m = 4096")
    f_ops = 2 * q * flash_n * flash_m
    clock_f = sm_clock_mhz(lambda: ops.tanimoto_count(d_f, q_f), device)
    log(f"  tanimoto_count at m={flash_m}: SM clock {clock_f} MHz; "
        f"{pairs_per_sm_clock(q * flash_n * flash_m, ms_f, clock_f)} pairs per SM-clock")
    log(f"  tanimoto_count at Q={q} N={flash_n} m={flash_m}: {ms_f:.3f} ms; bound "
        f"{f_ops / PEAK_ALU_OPS_PER_S * 1e3:.3f} ms by operations; plain {plain_f:.1f} ms; "
        f"{f_ops / 2 / (ms_f / 1e3) / 1e12:.3f} T compare-adds/s")
    del counts_f, counts_fp
    log(f"  packed_tanimoto_count at Q={q} N={flash_n} m={flash_m}:")
    previous_design("packed", device, d_f, q_f)
    del d_f, q_f

    kernels = [
        kernel_entry("tanimoto_count", "src/repro_torch/kernels/csrc/tanimoto_count.cu",
              "src/repro/kernels/tanimoto_count.py:64",
              wide["launches"].get("tanimoto_count", 0), err_tc, ms_tc, plain_tc,
              tcb_bytes, tcb_ops, lib_tc),
        kernel_entry("packed_tanimoto_count", "src/repro_torch/kernels/csrc/packed_tanimoto.cu",
              "src/repro/kernels/packed_tanimoto.py:72", launches_count, err_pc, ms_pc,
              plain_pc, pcb_bytes, pcb_ops, lib_pc),
        kernel_entry("packed_tanimoto_topk", "src/repro_torch/kernels/csrc/packed_tanimoto.cu",
              "src/repro/kernels/packed_tanimoto.py:120",
              packed["launches"].get("packed_tanimoto_topk", 0), err_tk, ms_tk, plain_tk,
              tkb_bytes, tkb_ops, None),
    ]
    log_kernels(kernels)
    log("  library calls: tanimoto_count and packed_tanimoto_count against m - "
        "torch.cdist(p=0) on float32 casts of their operands; none for packed_tanimoto_topk "
        "(no one call matches and selects per tile); the packed bounds count 3 operations "
        "(xor, lane test, add) per word pair of 4 lanes")
    log(f"  tanimoto_count {q * n * m / (ms_tc / 1e3) / 1e12:.3f} T compare-adds/s; "
        f"packed_tanimoto_count {q * n * words / (ms_pc / 1e3) / 1e12:.3f} T word-pairs/s, "
        f"{pc_bytes / (ms_pc / 1e3) / 1e9:.1f} GB/s; "
        f"packed_tanimoto_topk {q * n * words / (ms_tk / 1e3) / 1e12:.3f} T word-pairs/s")
    return kernels

# ---------------------------------------------------------------------------
# The RANGE / MINSUM / IP slice: Adult, DBLP and Tweets
# ---------------------------------------------------------------------------

# The paper's three non-LSH experiments (src/repro/configs/genie_datasets.py):
# Adult 0.98 M tuples x 14 attributes in 1024 bins, ranges +-50 (RANGE);
# DBLP titles of 40 characters, 3-grams in 4096 buckets, K = 32 candidates,
# then verification (MINSUM); Tweets, 12-word documents as binary vectors of
# 8192 buckets, count bound 16 (IP).  DBLP and Tweets are cut to 1 M rows
# (from 5.0 M and 6.8 M); every width is the configuration's.
SA_SEGMENTS = 16
ADULT_N, ADULT_D, ADULT_BINS, ADULT_RADIUS = 980_000, 14, 1024, 50
DBLP_N, DBLP_LEN, DBLP_GRAM, DBLP_V, DBLP_K = 1_000_000, 40, 3, 4096, 32
DBLP_ALPHABET, DBLP_MUTATION, DBLP_MAX_COUNT, DBLP_VERIFY = "abcdefghij", 0.1, 127, 64
TWEETS_N, TWEETS_V, TWEETS_WORDS, TWEETS_PER_DOC = 1_000_000, 8192, 5000, 12
TWEETS_QUERY_WORDS, TWEETS_MAX_COUNT, TWEETS_ZIPF = 6, 16, 1.05
# (Q, N, width) for the three kernels' parity, nothing a multiple of a tile;
# range_count stages 16 attributes a chunk (d = 16, 17, 33; 2100 past the
# flush of its float16 lanes after 127 chunks), writes 4 counts
# a thread as one 16-byte store where the output row is aligned (N = 1026:
# every other row is not; N = 1027 and 4099: most are not), and takes three
# value classes (range_operands)
RANGE_SHAPES = [(1, 5, 1), (3, 130, 3), (70, 100003, 14), (5, 257, 37), (130, 1026, 16),
                (129, 1027, 17), (7, 4099, 33), (200, 61250, 14), (3, 300, 2100)]
RANGE_KINDS = ("lanes", "mixed", "int32")
# data values at the float16 path's borders (it takes a chunk whose values all
# lie in [-2048, 2048]), values that send a chunk to the int32 path, and query
# bounds around the float16 path's clamp at +-2049 and at the ends of int32
RANGE_LANE_POOL = [-2048, -2047, -1, 0, 1, 1023, 1024, 2047, 2048]
RANGE_GENERAL_POOL = [-2**31, -2**31 + 1, -2050, -2049, 2049, 2050, 2**31 - 2, 2**31 - 1]
RANGE_BOUND_POOL = [-2**31, -2051, -2050, -2049, -2048, -2047, -1, 0, 1, 2047, 2048, 2049,
                    2050, 2051, 2**31 - 1]
# MINSUM: V = 1 to DBLP's 4096 and past the count kernel's 4096-column
# shared-memory window (4097 and 9000, three windows), each shape with dense
# rows (values 0..127), sparse rows (at most 38 non-zero buckets, all-zero
# rows) and values near INT32_MAX whose sums wrap; -1 pad rows in each
MINSUM_SHAPES = [(1, 5, 1), (3, 130, 3), (8, 300, 33), (70, 20003, 4096), (5, 2100, 4095),
                 (5, 2100, 4097), (5, 2100, 4099), (3, 1500, 9000)]
MINSUM_KINDS = ("dense", "sparse", "wrap")
IP_SHAPES = [(1, 5, 1), (3, 130, 3), (8, 300, 17), (70, 20003, 8192), (5, 2100, 8195)]


def minsum_rows(gen: torch.Generator, rows: int, v: int, kind: str) -> torch.Tensor:
    """int32 [rows, v] MINSUM operands on the CPU: "dense" counts 0..127;
    "sparse" at most 38 non-zero counts 1..127 a row (a DBLP title's 3-grams)
    and every 7th row all zero; "wrap" the sparse pattern with values within 8
    of INT32_MAX, INT32_MIN in every 5th column, so that sums wrap."""
    i32 = torch.iinfo(torch.int32)
    if kind == "dense":
        return torch.randint(0, DBLP_MAX_COUNT + 1, (rows, v), generator=gen, dtype=torch.int32)
    x = torch.zeros((rows, v), dtype=torch.int32)
    nz = min(DBLP_LEN - DBLP_GRAM + 1, v)
    cols = torch.randint(0, v, (rows, nz), generator=gen)
    lo, hi = (1, DBLP_MAX_COUNT + 1) if kind == "sparse" else (i32.max - 8, i32.max)
    x.scatter_(1, cols, torch.randint(lo, hi, (rows, nz), generator=gen, dtype=torch.int32))
    x[::7] = 0
    if kind == "wrap":
        x[:, ::5] = i32.min
    return x


def range_operands(gen: torch.Generator, q: int, n: int, d: int, kind: str) -> tuple:
    """(x [n, d], lo [q, d], hi [q, d]) int32 RANGE operands on the CPU.  Data:
    "lanes" values in [-2048, 2048], a third of them from RANGE_LANE_POOL;
    "mixed" the same with one value of RANGE_GENERAL_POOL in one row of every
    third 128-row tile from the second on, so that one call counts on both
    paths; "int32" from the whole int32 range, half of them from both pools.
    Queries: intervals 0 to 60 wide around data values, a third of the bounds
    from RANGE_BOUND_POOL (empty intervals among them), lo == hi in every third
    attribute, and rows 0 to 2 the intervals (INT32_MIN, INT32_MAX) (all),
    (INT32_MAX, INT32_MIN) (none) and (1, 0) (the TPU wrapper's pad)."""
    i32 = torch.iinfo(torch.int32)

    def pick(pool, shape):
        return torch.tensor(pool, dtype=torch.int64)[torch.randint(0, len(pool), shape,
                                                                   generator=gen)]

    if kind == "int32":
        x = torch.randint(i32.min, i32.max, (n, d), generator=gen, dtype=torch.int64)
        share = 0.5
        pool = RANGE_LANE_POOL + RANGE_GENERAL_POOL
    else:
        x = torch.randint(-2048, 2049, (n, d), generator=gen, dtype=torch.int64)
        share, pool = 1 / 3, RANGE_LANE_POOL
    x = torch.where(torch.rand((n, d), generator=gen) < share, pick(pool, (n, d)), x)
    if kind == "mixed":
        for t in range(1, -(-n // 128), 3):
            row = 128 * t + int(torch.randint(0, min(128, n - 128 * t), (1,), generator=gen))
            x[row, t % d] = RANGE_GENERAL_POOL[t % len(RANGE_GENERAL_POOL)]
    centre = x[torch.randint(0, n, (q,), generator=gen)]
    lo = centre - torch.randint(0, 31, (q, d), generator=gen)
    hi = centre + torch.randint(0, 31, (q, d), generator=gen)
    for b in (lo, hi):
        swap = torch.rand((q, d), generator=gen) < 1 / 3
        b[swap] = pick(RANGE_BOUND_POOL, (int(swap.sum()),))
    hi[:, ::3] = lo[:, ::3]
    for row, (a, b) in enumerate(((i32.min, i32.max), (i32.max, i32.min), (1, 0))[:q]):
        lo[row], hi[row] = a, b
    return tuple(t.clamp(i32.min, i32.max).to(torch.int32) for t in (x, lo, hi))


def sa_parity(device: torch.device) -> dict:
    """Phase 2d: range_count, minsum_count and ip_count against their plain
    versions, bit-exact; returns the worst absolute difference per kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ip_count import ip_count_plain
    from repro_torch.kernels.minsum_count import (minsum_count_dense, minsum_count_plain,
                                                  minsum_count_sparse, minsum_csr_plain,
                                                  minsum_lists, minsum_nnz_plain)
    from repro_torch.kernels.range_count import range_count_plain

    log("== phase 2d: the RANGE, MINSUM and IP kernels against their plain PyTorch versions")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 6)
    worst = {"range_count": 0, "minsum_count": 0, "ip_count": 0}

    def compare(name, got, want, what):
        sync(device)
        err = max_abs_err(got, want)
        worst[name] = max(worst[name], err)
        check(got.shape == want.shape and got.dtype == torch.int32 and torch.equal(got, want),
              f"{name} differs from its plain version at {what}: max abs err {err}")

    for q, n, d in RANGE_SHAPES:
        for kind in RANGE_KINDS:
            x, lo, hi = (t.to(device) for t in range_operands(gen, q, n, d, kind))
            compare("range_count", ops.range_count(x, lo, hi), range_count_plain(x, lo, hi),
                    f"(Q,N,d)=({q},{n},{d}) {kind} values")
        log(f"  range_count (Q,N,d)=({q},{n},{d}) {'/'.join(RANGE_KINDS)} values, bounds at "
            f"+-2049 and the ends of int32, empty ranges, lo == hi, the pad: equal")
    for q, n, v in MINSUM_SHAPES:
        for kind in MINSUM_KINDS:
            dc, qc = minsum_rows(gen, n, v, kind), minsum_rows(gen, q, v, kind)
            dc[::9] = -1                                      # the engine's pad rows
            dc, qc = dc.to(device), qc.to(device)
            want = minsum_count_plain(dc, qc)
            # the wrapper's pick, then both count kernels whatever the density
            for how, fn in (("wrapper", ops.minsum_count), ("sparse", minsum_count_sparse),
                            ("dense tile", minsum_count_dense)):
                compare("minsum_count", fn(dc, qc), want, f"(Q,N,V)=({q},{n},{v}) {kind} {how}")
            offsets, entries = minsum_lists(dc)
            sync(device)
            check(torch.equal(entries, minsum_csr_plain(dc)) and
                  torch.equal(offsets[1:].diff(prepend=offsets[:1]).to(torch.int32),
                              minsum_nnz_plain(dc)),
                  f"minsum lists differ from their plain versions at (Q,N,V)=({q},{n},{v}) {kind}")
            log(f"  minsum_count (Q,N,V)=({q},{n},{v}) {kind} rows, -1 pad rows: the wrapper, "
                f"the sparse kernel and the dense tile equal; lists equal")
    for q, n, v in IP_SHAPES:
        db = torch.randint(0, 2, (n, v), generator=gen, dtype=torch.int8).to(device)
        qb = torch.randint(0, 2, (q, v), generator=gen, dtype=torch.int8).to(device)
        want = ip_count_plain(db, qb)
        for dtype in (torch.int8, torch.int32, torch.float32):
            compare("ip_count", ops.ip_count(db.to(dtype), qb.to(dtype)), want,
                    f"(Q,N,V)=({q},{n},{v}) {dtype}")
        log(f"  ip_count (Q,N,V)=({q},{n},{v}) int8 {{0,1}}, and int32 / float32 through the "
            f"wrapper: equal")
    return worst


def gram_table(v: int, device: torch.device) -> torch.Tensor:
    """bucket[code] of every 3-gram over DBLP_ALPHABET, code = 100 c0 + 10 c1
    + c2, from the port's ngram.gram_bucket (crc32)."""
    from repro_torch.core.sa import ngram

    a = DBLP_ALPHABET
    return torch.tensor([ngram.gram_bucket(a[c // 100] + a[c // 10 % 10] + a[c % 10], v)
                         for c in range(1000)], dtype=torch.int64, device=device)


def title_count_vectors(titles: torch.Tensor, table: torch.Tensor, v: int) -> torch.Tensor:
    """ngram.count_vectors(titles, 3, v) on the device: titles int8 [rows,
    L] of letter codes -> int32 [rows, v] 3-gram multiplicities per bucket,
    clipped at 127 as count_vector clips them."""
    t = titles.to(torch.int64)
    codes = t[:, :-2] * 100 + t[:, 1:-1] * 10 + t[:, 2:]
    out = torch.zeros((t.shape[0], v), dtype=torch.int32, device=t.device)
    out.scatter_add_(1, table[codes], torch.ones(codes.shape, dtype=torch.int32, device=t.device))
    return out.clamp_(max=DBLP_MAX_COUNT)


def decode_titles(titles: torch.Tensor) -> list:
    return ["".join(DBLP_ALPHABET[c] for c in row) for row in titles.tolist()]


def word_table(v: int, device: torch.device) -> torch.Tensor:
    """bucket[i] of the word "w{i}" (data/pipeline.synthetic_documents' words)
    from the port's document.word_bucket (crc32)."""
    from repro_torch.core.sa import document

    return torch.tensor([document.word_bucket(f"w{i}", v) for i in range(TWEETS_WORDS)],
                        dtype=torch.int64, device=device)


def word_vectors(words: torch.Tensor, table: torch.Tensor, v: int) -> torch.Tensor:
    """document.binary_vectors of documents given as word ids on the device:
    int64 [rows, w] -> int8 [rows, v], 1 at every bucket a word falls in."""
    out = torch.zeros((words.shape[0], v), dtype=torch.int8, device=words.device)
    return out.scatter_(1, table[words], 1)


def spread(n_total: int, n: int, device: torch.device) -> torch.Tensor:
    """n row ids spread over [0, n_total), one in every segment."""
    return torch.linspace(0, n_total - 1, n, device=device).to(torch.int64)


def small_index_round_trip(device: torch.device, engine, label: str, batches: list,
                           queries, max_count, k: int = 10, max_segments: int = 8) -> None:
    """An engine's SegmentedIndex on the kernel path and the plain path:
    uneven adds, one compaction down to `max_segments`, CPQ / SPQ / SORT; ids,
    counts and thresholds equal on both paths before and after the
    compaction, and equal to a monolithic GenieIndex.build."""
    from repro_torch.core import GenieIndex, SegmentedIndex, TopKMethod

    segs = {uk: SegmentedIndex(engine, max_count=max_count, use_kernel=uk, device=device)
            for uk in (True, False)}
    for seg in segs.values():
        for batch in batches:
            seg.add(batch)
    mono = GenieIndex.build(engine, torch.cat(batches), max_count=max_count, device=device)
    for compacted in (False, True):
        if compacted:
            for seg in segs.values():
                seg.compact(max_segments=max_segments)
                check(seg.stats.n_segments == max_segments and seg.compaction_count == 1,
                      f"{label}: expected one compaction down to {max_segments} segments")
        for method in (TopKMethod.CPQ, TopKMethod.SPQ, TopKMethod.SORT):
            got = {uk: seg.search(queries, k=k, method=method) for uk, seg in segs.items()}
            want = mono.search(queries, k=k, method=method)
            sync(device)
            for field in ("ids", "counts", "threshold"):
                check(torch.equal(getattr(got[True], field), getattr(got[False], field)),
                      f"{label} {method.value}: kernel path and plain path differ in {field}")
            check(torch.equal(got[True].ids, want.ids) and torch.equal(got[True].counts, want.counts),
                  f"{label} {method.value}: the segmented search differs from GenieIndex.build")
    log(f"  {label}: {len(batches)} uneven adds, one compaction to {max_segments}; CPQ/SPQ/SORT "
        f"equal on both paths and to a monolithic GenieIndex")


def phase_small_sa(device: torch.device) -> None:
    """Phase 3d: RANGE, MINSUM and IP through SegmentedIndex at small sizes."""
    from repro_torch.core import Engine

    log("== phase 3d: small RANGE, MINSUM and IP round trips through SegmentedIndex "
        "(kernel path vs plain path)")
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    sizes = [900, 1500, 300, 2000, 700] + [40] * 12          # 17 uneven adds
    n_total = sum(sizes)
    picks = spread(n_total, 64, device)
    x = torch.randint(0, ADULT_BINS, (n_total, ADULT_D), generator=gen, device=device,
                      dtype=torch.int32)
    lohi = ((x[picks] - ADULT_RADIUS).clamp(0, ADULT_BINS - 1),
            (x[picks] + ADULT_RADIUS).clamp(0, ADULT_BINS - 1))
    titles = torch.randint(0, len(DBLP_ALPHABET), (n_total, DBLP_LEN), generator=gen,
                           device=device, dtype=torch.int8)
    counts = title_count_vectors(titles, gram_table(DBLP_V, device), DBLP_V)
    words = torch.randint(0, 300, (n_total, TWEETS_PER_DOC), generator=gen, device=device)
    vecs = word_vectors(words, word_table(TWEETS_V, device), TWEETS_V)
    for engine, label, data, queries, max_count in (
            (Engine.RANGE, "RANGE d=14", x, lohi, None),
            (Engine.MINSUM, "MINSUM V=4096", counts, counts[picks], DBLP_MAX_COUNT),
            (Engine.IP, "IP V=8192", vecs, vecs[picks], TWEETS_MAX_COUNT)):
        small_index_round_trip(device, engine, label, list(torch.split(data, sizes)), queries,
                               max_count)


def drive_index_full_width(device: torch.device, label: str, engine, batch, n_segments: int,
                           queries, k: int, max_count, expect_launches: dict,
                           n_searches: int = N_SEARCHES) -> dict:
    """Fill a SegmentedIndex of `engine` with `n_segments` adds of `batch(s)`
    and search it `n_searches` times by c-PQ; `expect_launches` is each
    kernel's launches per search.  Returns the index, the launch counts and
    the last result."""
    from repro_torch.core import SegmentedIndex, TopKMethod
    from repro_torch.kernels import common

    common.reset_launch_counts()           # the path starts here
    index = SegmentedIndex(engine, max_count=max_count, device=device)
    add_seconds = []
    for s in range(n_segments):
        raw = batch(s)
        sync(device)
        t0 = time.perf_counter()
        index.add(raw)
        sync(device)
        add_seconds.append(time.perf_counter() - t0)
        del raw
    stats = index.stats
    check(stats.n_segments == n_segments, f"expected {n_segments} segments, got {stats.n_segments}")
    n_queries = (queries[0] if isinstance(queries, tuple) else queries).shape[0]
    log(f"  {label}: N = {stats.n_objects} in {n_segments} adds of {stats.segment_rows[0]}; "
        f"row width {stats.n_lists}; Q = {n_queries}; k = {k}; max_count = {index.max_count}")
    log(f"  add: {statistics.median(add_seconds):.4f} s/batch median "
        f"(first {add_seconds[0]:.4f} s, total {sum(add_seconds):.3f} s); "
        f"on the device: {stats.bytes_device / 1e9:.4f} GB")
    res = timed_searches(lambda: index.search(queries, k=k, method=TopKMethod.CPQ),
                         n_queries, n_searches, expect_launches, device)
    launches = common.launch_counts()
    check_result(res, n_queries, k, stats.n_objects)
    check_sample_on_plain_path(index, queries, res, k, device)
    profile_one_search(lambda: index.search(queries, k=k), device)
    return dict(index=index, launches=launches, result=res, queries=queries)


def phase_full_width_adult(device: torch.device, n_total: int = ADULT_N,
                           n_segments: int = SA_SEGMENTS, n_queries: int = FULL_Q,
                           k: int = FULL_K) -> dict:
    """Phase 4d: Adult -> RANGE at full size.  Tuples from a seeded Gaussian,
    discretised by the port's relational.fit_discretizer; queries are
    point_range_queries(radius=50) of corpus tuples, whose top-1 count must
    be 14 and held by the source tuple."""
    import numpy as np

    from repro_torch.core import Engine
    from repro_torch.core.sa import relational

    log("== phase 4d: Adult -> SegmentedIndex(Engine.RANGE) at full size")
    vals = np.random.default_rng(SEED).standard_normal((n_total, ADULT_D))
    tuples = relational.fit_discretizer(vals, n_bins=ADULT_BINS).transform(vals)
    del vals
    picks = spread(n_total, n_queries, torch.device("cpu")).numpy()
    lo, hi = relational.point_range_queries(tuples[picks], radius=ADULT_RADIUS,
                                            n_bins=ADULT_BINS)
    queries = (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device))
    rows = n_total // n_segments
    out = drive_index_full_width(
        device, "Adult", Engine.RANGE,
        lambda s: torch.from_numpy(tuples[s * rows:(s + 1) * rows]).to(device), n_segments,
        queries, k, None, {"range_count": n_segments, "cpq_hist": n_segments})
    res = out["result"]
    src = torch.from_numpy(picks).to(device=device, dtype=torch.int32)[:, None]
    full = res.counts == ADULT_D
    check(bool(full[:, 0].all()), "a range query of a corpus tuple has a top-1 count below d")
    check(bool(((res.ids == src) & full).any(dim=1).all()),
          "the source tuple is not among the rows holding count d")
    log(f"  top-1 count {ADULT_D} on every query; the source tuple among them on every query "
        f"(rows at count {ADULT_D}: {float(full.sum(dim=1).float().mean()):.2f} per query)")
    return out


def mutate(s: str, rng) -> str:
    """data/pipeline.mutate_sequence's edit: round(rate * len) distinct
    positions, each redrawn from the alphabet (one generator for the batch)."""
    chars = list(s)
    for i in rng.choice(len(chars), size=int(round(DBLP_MUTATION * len(chars))), replace=False):
        chars[i] = DBLP_ALPHABET[rng.integers(0, len(DBLP_ALPHABET))]
    return "".join(chars)


def phase_full_width_dblp(device: torch.device, n_total: int = DBLP_N,
                          n_segments: int = SA_SEGMENTS, n_queries: int = FULL_Q,
                          k: int = DBLP_K, n_verify: int = DBLP_VERIFY) -> dict:
    """Phase 4e: DBLP -> MINSUM at V = 4096, 3-grams, K = 32 candidates, then
    verification by edit distance; N cut to 1 M.  Titles are drawn on the
    device, their count vectors made there; queries are corpus titles with
    10 % of their characters redrawn."""
    import numpy as np

    from repro_torch.core import Engine
    from repro_torch.core.sa import ngram, verify

    log(f"== phase 4e: DBLP -> SegmentedIndex(Engine.MINSUM), V = {DBLP_V}, N cut to {n_total}")
    gen = torch.Generator(device=device).manual_seed(SEED)
    titles = torch.randint(0, len(DBLP_ALPHABET), (n_total, DBLP_LEN), generator=gen,
                           device=device, dtype=torch.int8)
    table = gram_table(DBLP_V, device)
    sample = spread(n_total, 256, device)
    want = ngram.count_vectors(decode_titles(titles[sample]), DBLP_GRAM, DBLP_V)
    check(torch.equal(title_count_vectors(titles[sample], table, DBLP_V).cpu(),
                      torch.from_numpy(want)),
          "the device-built count vectors differ from ngram.count_vectors")
    log("  256 sampled corpus rows equal ngram.count_vectors of their decoded titles")
    picks = spread(n_total, n_queries, device)
    rng = np.random.default_rng(SEED)
    qstrs = [mutate(t, rng) for t in decode_titles(titles[picks])]
    queries = torch.from_numpy(ngram.count_vectors(qstrs, DBLP_GRAM, DBLP_V)).to(device)
    rows = n_total // n_segments
    out = drive_index_full_width(
        device, "DBLP", Engine.MINSUM,
        lambda s: title_count_vectors(titles[s * rows:(s + 1) * rows], table, DBLP_V),
        n_segments, queries, k, DBLP_MAX_COUNT,
        {"minsum_nnz": n_segments, "minsum_csr": n_segments, "minsum_count": n_segments,
         "cpq_hist": n_segments})
    res = out["result"]
    found = (res.ids == picks[:, None].to(torch.int32)).any(dim=1)
    log(f"  source title among the K = {k} candidates: {float(found.float().mean()):.4f}")
    # verification (Algorithm 2) of a sample: the best candidate by edit
    # distance must be the source title
    certified = 0
    for i in range(0, n_queries, n_queries // n_verify)[:n_verify]:
        ids = res.ids[i]
        cands = decode_titles(titles[ids.clamp(min=0).to(torch.int64)])
        enc, lens = ngram.encode_sequences(
            [c if int(j) >= 0 else "" for c, j in zip(cands, ids.tolist())], DBLP_LEN + 8)
        qenc, qlen = ngram.encode_sequences([qstrs[i]], DBLP_LEN + 8)
        ver = verify.verify_topk(torch.from_numpy(qenc[0]).to(device), int(qlen[0]),
                                 torch.from_numpy(enc).to(device),
                                 torch.from_numpy(lens).to(device), res.counts[i], k=1,
                                 n=DBLP_GRAM)
        best = int(ids[int(ver["order"][0])])
        check(best == int(picks[i]), f"query {i}: verification picked {best}, "
              f"not the source title {int(picks[i])}")
        certified += bool(ver["certified_exact"])
    log(f"  verify_topk(k=1) on {n_verify} queries: the best candidate is the source title on "
        f"all; certified_exact (Theorem 5.2) on {certified} of {n_verify}")
    del titles
    return out


def phase_full_width_tweets(device: torch.device, n_total: int = TWEETS_N,
                            n_segments: int = SA_SEGMENTS, n_queries: int = FULL_Q,
                            k: int = FULL_K) -> dict:
    """Phase 4f: Tweets -> IP at V = 8192, N cut to 1 M.  Documents of 12
    Zipf(1.05) words over 5000 drawn on the device, their binary vectors made
    there; a query is the first 6 words of a corpus document, so its top-1
    count is its number of distinct buckets."""
    from repro_torch.core import Engine
    from repro_torch.core.sa import document

    log(f"== phase 4f: Tweets -> SegmentedIndex(Engine.IP), V = {TWEETS_V}, N cut to {n_total}")
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    ranks = torch.arange(1, TWEETS_WORDS + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -TWEETS_ZIPF, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((n_total, TWEETS_PER_DOC), generator=gen, device=device, dtype=torch.float64)
    words = torch.searchsorted(cdf, u, right=True).clamp_(max=TWEETS_WORDS - 1)
    del u
    table = word_table(TWEETS_V, device)
    sample = spread(n_total, 256, device)
    docs = [" ".join(f"w{i}" for i in row) for row in words[sample].tolist()]
    check(torch.equal(word_vectors(words[sample], table, TWEETS_V).cpu(),
                      torch.from_numpy(document.binary_vectors(docs, TWEETS_V))),
          "the device-built word vectors differ from document.binary_vectors")
    log("  256 sampled corpus rows equal document.binary_vectors of their documents")
    picks = spread(n_total, n_queries, device)
    queries = word_vectors(words[picks, :TWEETS_QUERY_WORDS], table, TWEETS_V)
    rows = n_total // n_segments
    out = drive_index_full_width(
        device, "Tweets", Engine.IP,
        lambda s: word_vectors(words[s * rows:(s + 1) * rows], table, TWEETS_V),
        n_segments, queries, k, TWEETS_MAX_COUNT,
        {"ip_count": n_segments, "cpq_hist": n_segments})
    res = out["result"]
    distinct = queries.sum(dim=1, dtype=torch.int32)
    check(torch.equal(res.counts[:, 0], distinct),
          "the top-1 count differs from the query's number of distinct buckets")
    ties = (res.counts == distinct[:, None]).sum(dim=1).float()
    log(f"  top-1 count = the query's distinct buckets on every query; rows at that count in "
        f"the top {k}: mean {float(ties.mean()):.1f}, {int((ties == k).sum())} queries fill it")
    del words
    return out


def sa_entry(name: str, replaces: str, run: dict, err: int, ms: float, plain: float,
             n_bytes: int, n_ops: int, peak_ops: float, lib) -> dict:
    """kernel_entry of a RANGE / MINSUM / IP kernel, logged; its launches are
    those of its full-width run."""
    kern = kernel_entry(name, f"src/repro_torch/kernels/csrc/{name}.cu", replaces,
                        run["launches"].get(name, 0), err, ms, plain,
                        n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / peak_ops * 1e3, lib)
    log_kernels([kern])
    return kern


def _kernel_and_plain(name: str, kernel, plain, parity_err: dict, device: torch.device):
    """(kernel ms, plain ms, kernel result, worst error): the kernel timed on
    the device alone over 10 calls, its plain version once, bit-equal."""
    ms, got = timed_ms(kernel, device, reps=10, warmup=1, hold=True)
    plain_ms, want = timed_ms(plain, device, reps=1, warmup=1)
    check(torch.equal(got, want), f"{name} differs at the per-segment shape")
    return ms, plain_ms, got, max(parity_err[name], max_abs_err(got, want))


def hist_at_segment(label: str, counts: torch.Tensor, max_count: int,
                    device: torch.device) -> None:
    """Phase 5d: cpq_hist on a path's real counts at its per-segment shape --
    on the device alone over 10 calls behind a hold, beside its plain version
    and its bytes bound, bit-equal; the share of the four largest bins says
    how skewed the counts are."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cpq_hist import cpq_hist_plain

    q, n = counts.shape
    ms, got = timed_ms(lambda: ops.cpq_hist(counts, max_count), device, reps=10, warmup=1,
                       hold=True)
    plain, want = timed_ms(lambda: cpq_hist_plain(counts, max_count), device, reps=1, warmup=1)
    check(torch.equal(got, want), f"cpq_hist differs on the {label} segment's counts")
    bound = (q * n + q * (max_count + 1)) * 4 / PEAK_BYTES_PER_S * 1e3
    top4 = float(want.sum(0).double().topk(min(4, max_count + 1)).values.sum() / (q * n))
    log(f"  cpq_hist on the {label} segment's counts (Q={q} N={n} bins={max_count + 1}, "
        f"{100 * top4:.1f}% of them in the four largest bins): {ms:.4f} ms; bytes bound "
        f"{bound:.4f} ms ({100 * bound / ms:.1f}% of it), {q * n * 4 / (ms / 1e3) / 1e9:.1f} "
        f"GB/s; plain {plain:.1f} ms; equal")


def range_kernel_times(adult: dict, parity_err: dict, device: torch.device) -> dict:
    """Phase 5d, RANGE: range_count at the per-segment shape of phase 4d (no
    one PyTorch call counts per-attribute interval hits: no library_ms)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.range_count import range_count_plain

    x = adult["index"].segments[0].data                       # int32 [N, d]
    lo, hi = adult["index"].model.prepare_queries(adult["queries"], device)
    n, d = x.shape
    q = lo.shape[0]
    log(f"== phase 5d: range_count at the per-segment shape Q={q} N={n} d={d}")
    ms, plain, counts, err = _kernel_and_plain(
        "range_count", lambda: ops.range_count(x, lo, hi), lambda: range_count_plain(x, lo, hi),
        parity_err, device)
    log(f"  range_count {q * n * d / (ms / 1e3) / 1e12:.3f} T interval tests/s, "
        f"{q * n * 4 / (ms / 1e3) / 1e9:.1f} GB/s of counts written")
    previous_design("range", device, x, lo, hi)
    hist_at_segment("Adult", counts, adult["index"].max_count, device)
    return sa_entry("range_count", "src/repro/kernels/range_count.py:51", adult, err, ms, plain,
                     (n * d + 2 * q * d + q * n) * 4, 3 * q * n * d, PEAK_ALU_OPS_PER_S, None)


def minsum_kernel_times(dblp: dict, parity_err: dict, device: torch.device) -> list:
    """Phase 5d, MINSUM: minsum_count at the per-segment shape of phase 4e --
    the whole call (conversion + count) against the bytes the function must
    move, and the conversion kernels minsum_nnz and minsum_csr and the count
    kernel alone; then a dense segment of the same shape through the sparse
    kernel and the dense tile, and the densities around the wrapper's
    crossover (minsum_count.DENSE_ABOVE).  library_ms: for minsum_count
    (sum q + sum d - torch.cdist(p=1)) / 2, of which only the cdist is timed;
    for minsum_nnz torch.count_nonzero; for minsum_csr Tensor.to_sparse_csr
    (timed here, used nowhere in the port)."""
    from repro_torch.kernels import minsum_count as ms
    from repro_torch.kernels import ops

    dc, qc = dblp["index"].segments[0].data, dblp["queries"]   # int32 [N, V], [Q, V]
    n, v = dc.shape
    q = qc.shape[0]
    launches = dblp["launches"]
    log(f"== phase 5d: minsum_count at the per-segment shape Q={q} N={n} V={v}")
    ms_fn, plain, counts, err = _kernel_and_plain(
        "minsum_count", lambda: ops.minsum_count(dc, qc), lambda: ms.minsum_count_plain(dc, qc),
        parity_err, device)
    hist_at_segment("DBLP", counts, dblp["index"].max_count, device)
    # min(a, b) = (a + b - |a - b|) / 2: exact in float32 for these counts
    qf, df = qc.float(), dc.float()
    try:
        lib, dist = timed_ms(lambda: torch.cdist(qf, df, p=1), device, reps=1, warmup=1)
        rebuilt = (qf.sum(1)[:, None] + df.sum(1)[None, :] - dist) / 2
        check(torch.equal(rebuilt.to(torch.int32), counts),
              "the cdist(p=1) yardstick disagrees with minsum_count")
        del dist, rebuilt
    except RuntimeError as e:          # the yardstick only: the port never calls it
        log(f"  torch.cdist(p=1) refused these operands ({e}); library_ms not measured")
        lib = None
    del qf, df

    # the parts: each kernel alone, on the device alone (10 calls behind a hold)
    ms_nnz, nnz = timed_ms(lambda: ms.minsum_nnz(dc), device, reps=10, warmup=1, hold=True)
    plain_nnz, want_nnz = timed_ms(lambda: ms.minsum_nnz_plain(dc), device, reps=1, warmup=1)
    lib_nnz, _ = timed_ms(lambda: torch.count_nonzero(dc, dim=1), device, reps=10, warmup=1,
                          hold=True)
    err_nnz = max_abs_err(nnz, want_nnz)
    check(torch.equal(nnz, want_nnz), "minsum_nnz differs at the per-segment shape")
    offsets, total = ms.row_offsets(nnz)
    ms_csr, entries = timed_ms(lambda: ms.minsum_csr(dc, offsets, total), device, reps=10,
                               warmup=1, hold=True)
    plain_csr, want_entries = timed_ms(lambda: ms.minsum_csr_plain(dc), device, reps=1, warmup=1)
    with warnings.catch_warnings():    # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        lib_csr, csr = timed_ms(lambda: dc.to_sparse_csr(), device, reps=3, warmup=1)
    err_csr = max_abs_err(entries, want_entries) if entries.shape == want_entries.shape else -1
    check(torch.equal(entries, want_entries)
          and torch.equal(entries[:, 0], csr.col_indices().to(torch.int32))
          and torch.equal(entries[:, 1], csr.values()),
          "minsum_csr differs from its plain version or from to_sparse_csr")
    del want_entries, csr
    ms_count, got = timed_ms(lambda: ms.minsum_count_sparse(dc, qc, (offsets, entries)), device,
                             reps=10, warmup=1, hold=True)
    check(torch.equal(got, counts), "the sparse count kernel differs at the per-segment shape")
    del got
    per_row = total / n
    log(f"  lists: {total} non-zero entries ({per_row:.2f} a row, {100 * total / (n * v):.3f} % "
        f"of the segment), {(total * 8 + (n + 1) * 8) / 1e6:.1f} MB of entries and offsets")
    log(f"  minsum_count (the call): {ms_fn:.4f} ms = conversion (minsum_nnz {ms_nnz:.4f} ms, "
        f"cumsum and read-back, minsum_csr {ms_csr:.4f} ms) + count kernel {ms_count:.4f} ms")
    log(f"  count kernel {q * total / (ms_count / 1e3) / 1e12:.3f} T (entry, query) pairs/s; "
        f"conversion {2 * n * v * 4 / ((ms_nnz + ms_csr) / 1e3) / 1e12:.3f} TB/s of the segment "
        f"read twice")
    del nnz, want_nnz, offsets, entries, counts

    # a dense segment of the same shape: every column non-zero
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    dd = torch.randint(1, DBLP_MAX_COUNT + 1, (n, v), generator=gen, device=device,
                       dtype=torch.int32)
    dense_sparse, a = timed_ms(lambda: ms.minsum_count_sparse(dd, qc), device, reps=2, warmup=1)
    dense_tile, b = timed_ms(lambda: ms.minsum_count_dense(dd, qc), device, reps=2, warmup=1)
    dense_call, c = timed_ms(lambda: ops.minsum_count(dd, qc), device, reps=2, warmup=1)
    check(torch.equal(a, b) and torch.equal(b, c), "the two count kernels differ on a dense segment")
    log(f"  dense segment (values 1..127, every column non-zero): sparse kernel with its "
        f"conversion {dense_sparse:.3f} ms, dense tile {dense_tile:.3f} ms "
        f"({dense_sparse / dense_tile:.2f}x), the wrapper (dense tile) {dense_call:.3f} ms")
    for share in (0.05, 0.1, 0.2, 0.3):
        x = dd * (torch.rand((n, v), generator=gen, device=device) < share)
        t_sparse, a = timed_ms(lambda: ms.minsum_count_sparse(x, qc), device, reps=2, warmup=1)
        t_tile, b = timed_ms(lambda: ms.minsum_count_dense(x, qc), device, reps=1, warmup=1)
        check(torch.equal(a, b), f"the two count kernels differ at {share:.2f} non-zero")
        log(f"  {share:.2f} of the entries non-zero: sparse {t_sparse:.3f} ms, dense tile "
            f"{t_tile:.3f} ms -> {'sparse' if share <= ms.DENSE_ABOVE else 'dense tile'} "
            f"(DENSE_ABOVE = {ms.DENSE_ABOVE})")
        del x, a, b
    del dd

    src = "src/repro_torch/kernels/csrc/minsum_count.cu"
    replaces = "src/repro/kernels/minsum_count.py:55"
    kernels = [
        kernel_entry("minsum_count", src, replaces, launches.get("minsum_count", 0), err,
                     ms_fn, plain, (n * v + q * v + q * n) * 4 / PEAK_BYTES_PER_S * 1e3, 0.0,
                     lib),
        kernel_entry("minsum_nnz", src, replaces, launches.get("minsum_nnz", 0), err_nnz, ms_nnz,
                     plain_nnz, (n * v + n) * 4 / PEAK_BYTES_PER_S * 1e3, 0.0, lib_nnz),
        kernel_entry("minsum_csr", src, replaces, launches.get("minsum_csr", 0), err_csr, ms_csr,
                     plain_csr, (n * v * 4 + (n + 1) * 8 + total * 8) / PEAK_BYTES_PER_S * 1e3,
                     0.0, lib_csr),
    ]
    log_kernels(kernels)
    log("  bounds: minsum_count the bytes the function must move, (N*V + Q*V + Q*N) * 4 "
        "(a sparse kernel does far fewer than the 2*Q*N*V minimum-adds of the dense form, "
        "so they bound nothing); the conversion kernels their own bytes")
    return kernels


def ip_kernel_times(tweets: dict, parity_err: dict, device: torch.device) -> dict:
    """Phase 5d, IP: ip_count at the per-segment shape of phase 4f; library_ms
    is torch._int_mm on the int8 tensor cores, N padded to a multiple of 8
    with zero rows as _int_mm demands (timed here, used nowhere in the
    port)."""
    from repro_torch.kernels import common, ops
    from repro_torch.kernels.ip_count import ip_count_plain

    db, qb = tweets["index"].segments[0].data, tweets["queries"]   # int8 [N, V], [Q, V]
    n, v = db.shape
    q = qb.shape[0]
    log(f"== phase 5d: ip_count at the per-segment shape Q={q} N={n} V={v}, "
        f"{common.dot_tile_loader('ip_count', db, qb)} loader")
    ms, plain, dots, err = _kernel_and_plain(
        "ip_count", lambda: ops.ip_count(db, qb), lambda: ip_count_plain(db, qb),
        parity_err, device)
    hist_at_segment("Tweets", dots, tweets["index"].max_count, device)
    b = torch.zeros((-(-n // 8) * 8, v), dtype=torch.int8, device=device)
    b[:n] = db
    try:
        lib, mm = timed_ms(lambda: torch._int_mm(qb, b.T), device, reps=3, warmup=1)
        check(torch.equal(mm[:, :n], dots), "the _int_mm yardstick disagrees with ip_count")
    except RuntimeError as e:          # the yardstick only: the port never calls it
        log(f"  torch._int_mm refused these operands ({e}); library_ms not measured")
        lib = None
    log(f"  ip_count {q * n * v / (ms / 1e3) / 1e12:.3f} T MACs/s")
    return sa_entry("ip_count", "src/repro/kernels/ip_count.py:52", tweets, err, ms, plain,
                     n * v + q * v + q * n * 4, 2 * q * n * v, PEAK_INT8_TC_OPS_PER_S, lib)


# ---------------------------------------------------------------------------
# Phase 4g: multiple loading (paper section III-D)
# ---------------------------------------------------------------------------

# DBLP at its full size (src/repro/configs/genie_datasets.py:54-57): 5.0 M
# titles in 80 parts of 62,500 rows, 4096 int32 counts a row (1.024 GB a
# part, 81.9 GB in all), held in pinned host memory and streamed through the
# card; the host keeps this much memory free beside the pinned parts
DBLP_FULL_N, DBLP_PART_ROWS = 5_000_000, 62_500
HOST_HEADROOM_BYTES = 10e9


def pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` in a pinned host tensor of its own, from PyTorch's
    pinned allocator (cudaHostAlloc; it rounds each request up to a power
    of two, so parts are pinned one by one -- 1.074 GB for a 1.024 GB DBLP
    part); a plain host tensor where there is no card.  Page-locking the
    exact size with cudaHostRegister instead copied at 41.4 GB/s against
    50.8 (PERF.md), so the rounding is kept."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=torch.cuda.is_available())
    host.copy_(t)
    return host


def release_pinned() -> None:
    """Hand the pinned allocator's freed blocks back to the host."""
    if torch.cuda.is_available():
        torch._C._host_emptyCache()


def h2d_ms(parts: list, device: torch.device) -> float:
    """The copy alone: every part copied host -> device, back to back into
    one buffer on a side stream, timed by events (ms)."""
    buf = torch.empty((max(p.shape[0] for p in parts),) + tuple(parts[0].shape[1:]),
                      dtype=parts[0].dtype, device=device)
    if device.type != "cuda":
        return timed_ms(lambda: [buf[:p.shape[0]].copy_(p) for p in parts], device)[0]
    stream = torch.cuda.Stream(device)
    sync(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        start.record(stream)
        for p in parts:
            buf[:p.shape[0]].copy_(p, non_blocking=True)
        stop.record(stream)
    stream.synchronize()
    return start.elapsed_time(stop)


def log_streaming(label: str, parts: list, host_ms: float, compute_ms: float,
                  device: torch.device, how: str = "") -> dict:
    """Pinned bytes, the H2D rate of the copy alone (the median of three
    runs), and the share of the copy hidden under the match: (copy +
    compute - search) / copy, where `compute_ms` is the same search with its
    parts already on the card.  The share is logged as computed, not
    clipped: above compute / copy, the copy inside the search ran faster
    than the copy alone, which is then flagged as no floor of the search."""
    nbytes = sum(p.numel() * p.element_size() for p in parts)
    copy_ms = statistics.median(h2d_ms(parts, device) for _ in range(3))
    hidden = (copy_ms + compute_ms - host_ms) / copy_ms
    rec = dict(case=label, pinned_bytes=nbytes, h2d_ms=copy_ms,
               h2d_gb_per_s=nbytes / (copy_ms / 1e3) / 1e9, search_ms=host_ms,
               compute_ms=compute_ms, compute_how=how or "the parts on the card",
               hidden_share_of_copy=hidden, copy_alone_above_search=copy_ms > host_ms)
    log(f"  {label}: {len(parts)} parts, {nbytes / 1e9:.3f} GB pinned; the copy alone "
        f"{copy_ms:.2f} ms = {rec['h2d_gb_per_s']:.2f} GB/s host -> device; search "
        f"{host_ms:.2f} ms against {compute_ms:.2f} ms with {rec['compute_how']}: "
        f"(copy + compute - search) / copy = {100 * hidden:.1f}% of the copy hidden "
        f"under the match")
    if copy_ms > host_ms:
        log(f"  FLAG {label}: the copy alone ({copy_ms:.2f} ms) is slower than the search "
            f"that holds it ({host_ms:.2f} ms), so it is no floor of the search and the "
            f"hidden share above overstates what was hidden")
    log("  multiload streaming: " + json.dumps(rec))
    return rec


def same_result(got, want, what: str) -> None:
    check(torch.equal(got.ids, want.ids) and torch.equal(got.counts, want.counts)
          and torch.equal(got.threshold, want.threshold),
          f"{what}: ids, counts or threshold differ")


def phase_multiload_eq(run: dict, device: torch.device, k: int = FULL_K,
                       n_searches: int = N_SEARCHES) -> None:
    """Phase 4g (EQ): the e2lsh corpus of phase 4 searched (i) through
    GenieIndex.search_multiload(n_parts=16), the scanned form over a stacked
    copy of the corpus, and (ii) through multiload_search_host over its 16
    segments copied into pinned host memory; both must equal the SEGMENTED
    service search bit for bit."""
    from repro_torch.core import Engine, GenieIndex, SearchParams, TopKMethod
    from repro_torch.core.multiload import multiload_search_host
    from repro_torch.kernels import common

    svc, qsigs, want = run["service"], run["qsigs"], run["result"]
    index = svc._index
    segs = len(index.segments)
    n_queries = qsigs.shape[0]
    log(f"== phase 4g: multiple loading, e2lsh -> EQ at the SIFT shape ({segs} parts of "
        f"{index.segment_rows[0]})")
    mono = GenieIndex.build(Engine.EQ, torch.cat([s.data for s in index.segments]),
                            max_count=index.max_count, device=device)
    per_search = {"match_count": segs, "cpq_hist": segs}
    log(f"  (i) GenieIndex.search_multiload(n_parts={segs}), the scanned form")
    common.reset_launch_counts()
    res = timed_searches(lambda: mono.search_multiload(qsigs, k=k, n_parts=segs), n_queries,
                         n_searches, per_search, device)
    same_result(res, want, "scanned EQ multiload against the SEGMENTED service search")
    log("  ids, counts and threshold equal the SEGMENTED service search on every row")
    profile_one_search(lambda: mono.search_multiload(qsigs, k=k, n_parts=segs), device)
    del mono, res
    torch.cuda.empty_cache()

    log(f"  (ii) multiload_search_host over the {segs} segments in pinned host memory")
    q_exec = index.model.prepare_queries_for(qsigs, device, index.signature_layout)
    params = SearchParams(k=k, max_count=index.max_count, method=TopKMethod.CPQ)
    parts = [pinned_copy(s.data) for s in index.segments]
    common.reset_launch_counts()
    res = timed_searches(lambda: multiload_search_host(parts, q_exec, params, Engine.EQ),
                         n_queries, n_searches, per_search, device)
    same_result(res, want, "host-loop EQ multiload against the SEGMENTED service search")
    log("  ids, counts and threshold equal the SEGMENTED service search on every row")
    profile_one_search(lambda: multiload_search_host(parts, q_exec, params, Engine.EQ), device)
    host_ms = statistics.median(timed_ms(lambda: multiload_search_host(
        parts, q_exec, params, Engine.EQ), device)[0] for _ in range(3))
    resident = [s.data for s in index.segments]
    compute_ms = statistics.median(timed_ms(lambda: multiload_search_host(
        resident, q_exec, params, Engine.EQ), device)[0] for _ in range(3))
    log_streaming("EQ host loop", parts, host_ms, compute_ms, device)
    del parts
    release_pinned()


def phase_multiload_packed(run: dict, scheme: str, count_kernel: str, device: torch.device,
                           k: int = FULL_K, n_searches: int = N_SEARCHES) -> dict:
    """Phase 4g (PACKED simhash / minhash): SegmentedIndex.search_multiload on
    the PACKED service index of phase 4b / 4c -- the count kernel once a part,
    the pad mask and cpq_hist, never the fused kernel -- equal to the fused
    SEGMENTED service search bit for bit.  Returns the launch counts."""
    from repro_torch.kernels import common

    index, qsigs, want = run["service"]._index, run["qsigs"], run["result"]
    segs = len(index.segments)
    log(f"== phase 4g: multiple loading, {scheme} -> PACKED, SegmentedIndex.search_multiload "
        f"over {segs} segments")
    common.reset_launch_counts()           # the path starts here
    res = timed_searches(lambda: index.search_multiload(qsigs, k=k), qsigs.shape[0],
                         n_searches, {count_kernel: segs, "cpq_hist": segs}, device)
    launches = common.launch_counts()
    same_result(res, want, f"PACKED {scheme} multiload against the fused SEGMENTED search")
    log("  ids, counts and threshold equal the fused SEGMENTED service search on every row")
    profile_one_search(lambda: index.search_multiload(qsigs, k=k), device)
    return launches


# (engine, signature layout, kernel that counts a part) of the padded
# multiload round trips: every engine and layout, so that each engine's pad
# fill reaches its count kernel (EQ's -1 and RANGE's INT32_MIN leave the
# float16 lanes for the int32 paths of their tiles; MINSUM's -1 rows go
# through the sparse lists)
PAD_CASES = [("eq", "wide", "match_count"), ("range", "wide", "range_count"),
             ("minsum", "wide", "minsum_count"), ("ip", "wide", "ip_count"),
             ("cosine", "wide", "cosine_count"), ("cosine", "packed", "packed_cosine_count"),
             ("tanimoto", "wide", "tanimoto_count"),
             ("tanimoto", "packed", "packed_tanimoto_count")]


def phase_multiload_pads(device: torch.device, n: int = 5000, n_queries: int = 33,
                         n_parts: int = 7, k: int = 20) -> None:
    """Phase 4g (pads): GenieIndex.search_multiload with n_parts not dividing
    N, so the last part carries the engine's pad rows, for every engine and
    layout: the kernel path launches its count kernel once a part and equals
    the plain path (CPQ, SPQ, SORT), and no pad id reaches a result."""
    import numpy as np

    from repro_torch.core import Engine, GenieIndex, TopKMethod, engines
    from repro_torch.kernels import common

    log(f"== phase 4g: padded multiload round trips, N = {n} in {n_parts} parts of "
        f"{-(-n // n_parts)} (kernel path vs plain path)")
    for name, layout, kernel in PAD_CASES:
        engine = Engine(name)
        rng = np.random.default_rng(SEED + 11)
        raw, queries, mc = engines.get(engine).example(rng, n, n_queries)
        built = {uk: GenieIndex.build(engine, raw, max_count=mc, use_kernel=uk,
                                      signature_layout=layout, device=device)
                 for uk in (True, False)}
        for method in TopKMethod:
            common.reset_launch_counts()
            got = built[True].search_multiload(queries, k=k, n_parts=n_parts, method=method)
            launches = common.launch_counts()
            want = built[False].search_multiload(queries, k=k, n_parts=n_parts, method=method)
            check(common.launch_counts() == launches, "the plain path launched a kernel")
            check(launches.get(kernel) == n_parts,
                  f"{name} {layout}: {kernel} launched {launches} for {n_parts} parts")
            same_result(got, want, f"padded {name} {layout} multiload {method.value}: kernel "
                                   f"path against plain path")
            check(bool(((got.ids < n) | (got.counts == -1)).all()), "a pad row holds a count")
        log(f"  {name} {layout}: {kernel} {n_parts}x a search; CPQ / SPQ / SORT equal the "
            f"plain path; no pad row in a result")


def mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("chip_smoke: /proc/meminfo has no MemAvailable")


def phase_multiload_dblp(device: torch.device, n_total: int = DBLP_FULL_N,
                         part_rows: int = DBLP_PART_ROWS, n_queries: int = FULL_Q,
                         k: int = DBLP_K, n_verify: int = DBLP_VERIFY,
                         n_searches: int = N_SEARCHES, resident_parts: int = 8) -> dict:
    """Phase 4g (DBLP): DBLP -> MINSUM at its full 5.0 M titles, streamed
    from pinned host memory through multiload_search_host: each part drawn
    on the card as phase 4e draws it and copied into a pinned tensor of its
    own.  N is cut only if the host cannot pin the parts and keep
    HOST_HEADROOM_BYTES free.  Queries come from every part; the source
    title must be among the K candidates of every query, 64 are verified by
    edit distance, and 8 rows equal a sort-method search of the same parts
    through the plain path."""
    import numpy as np

    from repro_torch.core import Engine, SearchParams, TopKMethod
    from repro_torch.core.multiload import multiload_search_host
    from repro_torch.core.sa import ngram, verify
    from repro_torch.kernels import common

    n_parts = n_total // part_rows
    part_bytes = part_rows * DBLP_V * 4
    pinned_each = 1 << (part_bytes - 1).bit_length()     # the allocator's rounding
    avail = mem_available_bytes()
    fit = int((avail - HOST_HEADROOM_BYTES) // pinned_each)
    log(f"== phase 4g: multiple loading, DBLP -> MINSUM at {n_total} titles: {n_parts} parts "
        f"of {part_rows} x {DBLP_V} int32 ({n_parts * part_bytes / 1e9:.1f} GB); host "
        f"MemAvailable {avail / 1e9:.1f} GB, {pinned_each / 1e9:.3f} GB pinned a part, "
        f"{HOST_HEADROOM_BYTES / 1e9:.0f} GB kept free")
    if fit < n_parts:
        check(fit >= 2, "the host cannot pin two DBLP parts")
        log(f"  CUT: the host can pin {fit} parts with {HOST_HEADROOM_BYTES / 1e9:.0f} GB "
            f"left, so N = {fit * part_rows} of {n_total}")
        n_parts = fit
    n = n_parts * part_rows
    gen = torch.Generator(device=device).manual_seed(SEED)
    table = gram_table(DBLP_V, device)
    picks = spread(n, n_queries, device)
    t0 = time.perf_counter()
    parts, titles = [], []
    for p in range(n_parts):
        t = torch.randint(0, len(DBLP_ALPHABET), (part_rows, DBLP_LEN), generator=gen,
                          device=device, dtype=torch.int8)
        parts.append(pinned_copy(title_count_vectors(t, table, DBLP_V)))
        titles.append(t.cpu())
    titles = torch.cat(titles)
    sync(device)
    log(f"  {n_parts} parts drawn on the card and pinned in {time.perf_counter() - t0:.1f} s")
    sample = spread(n, 64, torch.device("cpu"))
    want = ngram.count_vectors(decode_titles(titles[sample]), DBLP_GRAM, DBLP_V)
    got = torch.stack([parts[int(i) // part_rows][int(i) % part_rows] for i in sample])
    check(torch.equal(got, torch.from_numpy(want)),
          "pinned count vectors differ from ngram.count_vectors of their titles")
    log("  64 sampled rows of the pinned parts equal ngram.count_vectors of their titles")
    rng = np.random.default_rng(SEED)
    qstrs = [mutate(t, rng) for t in decode_titles(titles[picks.cpu()])]
    queries = torch.from_numpy(ngram.count_vectors(qstrs, DBLP_GRAM, DBLP_V)).to(device)
    params = SearchParams(k=k, max_count=DBLP_MAX_COUNT, method=TopKMethod.CPQ)

    def search():
        return multiload_search_host(parts, queries, params, Engine.MINSUM)

    common.reset_launch_counts()           # the path starts here
    res = timed_searches(search, n_queries, n_searches,
                         {"minsum_nnz": n_parts, "minsum_csr": n_parts,
                          "minsum_count": n_parts, "cpq_hist": n_parts}, device)
    check_result(res, n_queries, k, n)
    found = (res.ids == picks[:, None].to(torch.int32)).any(dim=1)
    log(f"  source title among the K = {k} candidates: {float(found.float().mean()):.4f}")
    check(bool(found.all()), "a source title is missing from its query's candidates")
    certified = 0
    for i in range(0, n_queries, n_queries // n_verify)[:n_verify]:
        ids = res.ids[i].cpu()
        cands = decode_titles(titles[ids.clamp(min=0).to(torch.int64)])
        enc, lens = ngram.encode_sequences(
            [c if int(j) >= 0 else "" for c, j in zip(cands, ids.tolist())], DBLP_LEN + 8)
        qenc, qlen = ngram.encode_sequences([qstrs[i]], DBLP_LEN + 8)
        ver = verify.verify_topk(torch.from_numpy(qenc[0]).to(device), int(qlen[0]),
                                 torch.from_numpy(enc).to(device),
                                 torch.from_numpy(lens).to(device), res.counts[i], k=1,
                                 n=DBLP_GRAM)
        best = int(ids[int(ver["order"][0])])
        check(best == int(picks[i]), f"query {i}: verification picked {best}, "
              f"not the source title {int(picks[i])}")
        certified += bool(ver["certified_exact"])
    log(f"  verify_topk(k=1) on {n_verify} queries: the best candidate is the source title on "
        f"all of them ({certified} certified exact by the count filter)")
    rows = torch.arange(0, n_queries, n_queries // 8, device=device)[:8]
    before = common.launch_counts()
    oracle = multiload_search_host(parts, queries[rows], SearchParams(
        k=k, max_count=DBLP_MAX_COUNT, method=TopKMethod.SORT, use_kernel=False), Engine.MINSUM)
    check(common.launch_counts() == before, "the plain path launched a kernel")
    check(torch.equal(oracle.ids, res.ids[rows]) and torch.equal(oracle.counts, res.counts[rows])
          and torch.equal(oracle.threshold, res.threshold[rows]),
          "the kernel path differs from the sort oracle on the sampled rows")
    log(f"  rows {rows.tolist()} equal a sort-method search of the same parts through the "
        f"plain path")
    profile_one_search(search, device)
    host_ms = statistics.median(timed_ms(search, device)[0] for _ in range(2))
    # the match of every part with its data on the card: the parts in
    # chunks of `resident_parts` (they do not all fit the card), each
    # chunk searched on its own, the chunks' times summed
    compute_ms = 0.0
    for c in range(0, n_parts, resident_parts):
        resident = [q.to(device) for q in parts[c:c + resident_parts]]
        compute_ms += statistics.median(timed_ms(lambda: multiload_search_host(
            resident, queries, params, Engine.MINSUM), device)[0] for _ in range(3))
        del resident
    stream = log_streaming("DBLP host loop", parts, host_ms, compute_ms, device,
                           f"all {n_parts} parts on the card, {resident_parts} a search, "
                           f"the searches' times summed")
    out = dict(n=n, n_parts=n_parts, result=res, streaming=stream)
    del parts
    release_pinned()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 3e, 4h, 4i: coarse routing and the serving front-end
# ---------------------------------------------------------------------------

ROUTE_SEGMENTS = [2000, 700, 1500, 300, 1500]     # 3e: five uneven segments


def selected_oracle(index, q_exec, mask, k: int):
    """The top k of the segments `mask` selects, and only those, by a stable
    sort of their plain counts (ids ascending within equal counts); slots
    past the selected rows hold -1 / -1."""
    match = index.model.match_fn(False, index.signature_layout)
    counts, ids, offset = [], [], 0
    for keep, seg in zip(mask, index.segments):
        n = seg.stats.n_objects
        if keep:
            counts.append(match(seg.data, q_exec))
            ids.append(torch.arange(offset, offset + n, dtype=torch.int32,
                                    device=seg.data.device))
        offset += n
    counts, ids = torch.cat(counts, dim=1), torch.cat(ids)
    vals, order = torch.sort(counts, dim=1, descending=True, stable=True)
    vals, top = vals[:, :k], ids[order[:, :k]]
    if vals.shape[1] < k:
        fill = vals.new_full((vals.shape[0], k - vals.shape[1]), -1)
        vals, top = torch.cat([vals, fill], 1), torch.cat([top, fill.to(top.dtype)], 1)
    return top, vals


def launches_of(fn, device):
    """(result, launch counts) of one call, the counts reset just before."""
    from repro_torch.kernels import common

    common.reset_launch_counts()
    out = fn()
    sync(device)
    return out, common.launch_counts()


def phase_small_routing(device: torch.device, k: int = 20, n_queries: int = 33) -> None:
    """Phase 3e: routed search on every engine and layout at a small size.
    ROUTED_VERIFIED equals NONE (CPQ / SPQ / SORT, SEGMENTED and the host
    loop); ROUTED equals a sort over the selected segments alone; a cold
    segment is never scanned (one match launch fewer, and from pinned parts
    its bytes are never copied); a tied bound and an unfilled slot each
    force the fallback."""
    import numpy as np

    from repro_torch.core import Engine, SegmentedIndex, TopKMethod, engines, plan
    from repro_torch.core.plan import _host_array

    log(f"== phase 3e: routed search, small, all six engines ({gpu_name_and_power_limit()})")
    for name, layout, _ in PAD_CASES:
        engine = Engine(name)
        model = engines.get(engine)
        rng = np.random.default_rng(SEED + 13)
        raw, queries, mc = model.example(rng, sum(ROUTE_SEGMENTS), n_queries)
        index = SegmentedIndex(engine, max_count=mc, device=device, signature_layout=layout)
        lo = 0
        for rows in ROUTE_SEGMENTS:
            hi = lo + rows
            index.add(raw[lo:hi])
            lo = hi
        # ROUTED on the first two queries at nprobe 1: over the whole batch the
        # union of the queries' picks may hold every segment
        few = tuple(x[:2] for x in queries) if isinstance(queries, tuple) else queries[:2]
        q_wide = model.prepare_queries(few, device)
        q_exec = model.pack_queries(q_wide) if layout == "packed" else q_wide
        mask, _ = index.router().select(_host_array(q_wide), 1)
        for method in TopKMethod:
            for how in ("search", "search_multiload"):
                search = getattr(index, how)
                full = search(queries, k=k, method=method)
                same_result(search(queries, k=k, method=method, routing="routed_verified",
                                   nprobe=1), full,
                            f"{name} {layout} {how} {method.value}: ROUTED_VERIFIED vs NONE")
                routed = search(few, k=k, method=method, routing="routed", nprobe=1)
                ids, counts = selected_oracle(index, q_exec, mask, k)
                check(torch.equal(routed.ids, ids) and torch.equal(routed.counts, counts)
                      and torch.equal(routed.threshold, counts[:, -1]),
                      f"{name} {layout} {how} {method.value}: ROUTED differs from a search "
                      f"of the selected segments")
        log(f"  {name} {layout}: ROUTED_VERIFIED (nprobe 1) = NONE; ROUTED (nprobe 1, two "
            f"queries, segments {np.flatnonzero(mask).tolist()} of {len(mask)}) = a sort of "
            f"those segments alone; CPQ / SPQ / SORT, SEGMENTED and host loop")

    # a cold segment (bucket 0 only) beside a hot one (bucket 7): its bound 0
    # is under the threshold of every query
    m, cold_rows, hot_rows = 64, 4000, 3000
    for value, what in ((0, "cold"), (7, "tied")):
        index = SegmentedIndex(Engine.EQ, device=device)
        index.add(torch.full((cold_rows, m), value, dtype=torch.int32, device=device))
        index.add(torch.full((hot_rows, m), 7, dtype=torch.int32, device=device))
        q = torch.full((4, m), 7, dtype=torch.int32, device=device)
        full, base = launches_of(lambda: index.search(q, k=k), device)
        got, routed = launches_of(
            lambda: index.search(q, k=k, routing="routed_verified", nprobe=1), device)
        same_result(got, full, f"{what} segment: ROUTED_VERIFIED vs NONE")
        want = 1 if what == "cold" else 3          # the tie rescans both
        check(base.get("match_count") == 2 and routed.get("match_count") == want,
              f"{what} segment: match_count {routed} routed, {base} full")
        log(f"  {what} segment: match_count {routed.get('match_count')} routed against "
            f"{base.get('match_count')} in the full scan; result = NONE")
        if what == "cold":
            parts = [pinned_copy(s.data) for s in index.segments]
            p = plan.plan_search(Engine.EQ, k, index.max_count, layout="multiload",
                                 part_rows=tuple(index.segment_rows),
                                 n_objects=index.n_objects, host_loop=True,
                                 routing="routed_verified", nprobe=1)
            plan.reset_copied_bytes()
            got, routed = launches_of(lambda: plan.execute(p, parts, q, router=index.router()),
                                      device)
            copied, selected = plan.copied_bytes(), parts[1].numel() * parts[1].element_size()
            same_result(got, full, "cold segment, host loop: ROUTED_VERIFIED vs NONE")
            check(copied == selected and routed.get("match_count") == 1,
                  f"cold segment, host loop: copied {copied} bytes, the selected part holds "
                  f"{selected}; launches {routed}")
            log(f"  cold segment, host loop from pinned parts: {copied} bytes copied = the "
                f"selected part's {selected} (the cold part's "
                f"{parts[0].numel() * parts[0].element_size()} never copied)")
            del parts
            # an unfilled slot: k above the hot rows leaves threshold -1
            kk = hot_rows + 500
            full, _ = launches_of(lambda: index.search(q, k=kk), device)
            got, routed = launches_of(
                lambda: index.search(q, k=kk, routing="routed_verified", nprobe=1), device)
            same_result(got, full, "unfilled slot: ROUTED_VERIFIED vs NONE")
            check(routed.get("match_count") == 3, f"unfilled slot: no fallback ({routed})")
            log(f"  unfilled slot (k = {kk} > {hot_rows} routed rows): match_count "
                f"{routed.get('match_count')}, the fallback ran; result = NONE")
    release_pinned()


def recall_at_k(got, want) -> float:
    """Mean share of each row's reference ids found in the row (ids >= 0)."""
    hit = (got.ids[:, :, None] == want.ids[:, None, :]) & (want.ids[:, None, :] >= 0)
    return float((hit.any(dim=1).sum(dim=1).float()
                  / (want.ids >= 0).sum(dim=1).clamp(min=1).float()).mean())


def phase_routing_full_width(run: dict, device: torch.device, k: int = FULL_K,
                             n_searches: int = N_SEARCHES) -> list:
    """Phase 4h: the SIFT e2lsh service of phase 4 searched ROUTED and
    ROUTED_VERIFIED at the default nprobe and at 8; VERIFIED must equal NONE
    on every row.  Also the routed host loop over the 16 segments in pinned
    host memory, with the bytes it copies, and the summary's cost per add.
    Returns the records logged."""
    from repro_torch.core import Engine, plan, routing

    svc, queries, qsigs, want = run["service"], run["queries"], run["qsigs"], run["result"]
    index = svc._index
    hw = gpu_name_and_power_limit()
    log(f"== phase 4h: routed search, e2lsh -> EQ at the SIFT shape ({len(index.segments)} "
        f"segments of {index.segment_rows[0]}); {hw}")
    summary_ms = statistics.median(timed_ms(
        lambda: routing.summarize(Engine.EQ, index.segments[0].data), device)[0]
        for _ in range(3))
    add_s = statistics.median(run["add_seconds"])
    records = [dict(case="summary", summary_ms=summary_ms, add_s_median=add_s, card=hw)]
    log(f"  summary of one segment alone: {summary_ms:.3f} ms; add, the summary included: "
        f"{add_s:.4f} s/batch median ({hw})")
    router = svc._router()
    sync(device)
    t0 = time.perf_counter()
    hq = qsigs.cpu().numpy()
    t1 = time.perf_counter()
    ubs = router.upper_bounds(hq)
    t2 = time.perf_counter()
    router.select(hq, None, ubs=ubs)
    t3 = time.perf_counter()
    route = dict(copy_ms=(t1 - t0) * 1e3, upper_bounds_ms=(t2 - t1) * 1e3,
                 select_ms=(t3 - t2) * 1e3)
    records.append(dict(case="route on the host", **route, card=hw))
    log(f"  the route on the host, once a search: the queries' copy {route['copy_ms']:.2f} ms, "
        f"upper bounds {route['upper_bounds_ms']:.2f} ms, select {route['select_ms']:.2f} ms "
        f"({hw})")
    for nprobe in (None, 8):
        mask, ubs = router.select(hq, nprobe)
        selected = [int(i) for i in mask.nonzero()[0]]
        log(f"  nprobe {nprobe or router.default_nprobe()}: {len(selected)} of "
            f"{len(mask)} segments selected {selected}; upper bounds {ubs.min():.0f} to "
            f"{ubs.max():.0f} (m = {svc.m})")
        for mode in ("routed", "routed_verified"):
            from repro_torch.kernels import common

            common.reset_launch_counts()
            times, res = [], None
            for _ in range(n_searches):
                ms, res = timed_ms(lambda: svc.search(None, k=k, embeddings=queries,
                                                      routing=mode, nprobe=nprobe)[0], device)
                times.append(ms)
            per_search = common.launch_counts().get("match_count", 0) / n_searches
            fell_back = per_search > len(selected)
            rec = dict(case=f"{mode} nprobe={nprobe or router.default_nprobe()}",
                       selected=selected, match_launches_per_search=per_search,
                       fell_back=fell_back, first_ms=times[0],
                       median_ms=statistics.median(times[1:]), card=hw)
            if mode == "routed_verified":
                same_result(res, want, f"ROUTED_VERIFIED nprobe={nprobe} against NONE")
                rec["equals_none"] = True
            else:
                rec["recall_at_k_vs_none"] = recall_at_k(res, want)
            records.append(rec)
            log(f"  {rec['case']}: search first {times[0]:.2f} ms, median of the next "
                f"{n_searches - 1} {rec['median_ms']:.2f} ms; match_count {per_search:.0f} a "
                f"search; fell back: {fell_back}; "
                + ("= NONE on every row" if mode == "routed_verified"
                   else f"recall@{k} against NONE {rec['recall_at_k_vs_none']:.4f}"))
    parts = [pinned_copy(s.data) for s in index.segments]
    part_bytes = [p.numel() * p.element_size() for p in parts]
    for mode in ("routed", "routed_verified"):
        p = plan.plan_search(Engine.EQ, k, index.max_count, layout="multiload",
                             part_rows=tuple(index.segment_rows), n_objects=index.n_objects,
                             host_loop=True, routing=mode)
        mask, _ = router.select(hq, None)
        plan.reset_copied_bytes()
        times, res = [], None
        for _ in range(n_searches):
            ms, res = timed_ms(lambda: plan.execute(p, parts, qsigs, router=router), device)
            times.append(ms)
        copied = plan.copied_bytes() / n_searches
        sel_bytes = sum(b for b, keep in zip(part_bytes, mask) if keep)
        check(mode == "routed_verified" or copied == sel_bytes,
              f"routed host loop copied {copied} bytes, the selected parts hold {sel_bytes}")
        if mode == "routed_verified":
            same_result(res, want, "routed host loop ROUTED_VERIFIED against NONE")
        rec = dict(case=f"host loop {mode} nprobe={router.default_nprobe()}",
                   copied_bytes_per_search=copied, selected_part_bytes=sel_bytes,
                   all_part_bytes=sum(part_bytes), first_ms=times[0],
                   median_ms=statistics.median(times[1:]), card=hw)
        records.append(rec)
        log(f"  {rec['case']} over {len(parts)} pinned parts: {copied / 1e9:.4f} GB copied a "
            f"search, the selected parts {sel_bytes / 1e9:.4f} GB of "
            f"{sum(part_bytes) / 1e9:.4f}; search first {times[0]:.2f} ms, median "
            f"{rec['median_ms']:.2f} ms")
    del parts
    release_pinned()
    for rec in records:
        log("  routing: " + json.dumps(rec))
    return records


def frontend_serial_equal(svc, requests: list) -> None:
    """Every (rows, k, (result, sims)) of the front-end equals a serial
    search of the same rows, ids / counts / threshold and sims."""
    import numpy as np

    for rows, k, (got, sims) in requests:
        want, want_sims = svc.search(None, k=k, embeddings=rows)
        check(np.array_equal(got.ids, want.ids.cpu().numpy())
              and np.array_equal(got.counts, want.counts.cpu().numpy())
              and np.array_equal(got.threshold, want.threshold.cpu().numpy())
              and (sims is None or np.array_equal(sims, want_sims)),
              "a front-end request differs from its serial search")


def phase_frontend(run: dict, device: torch.device, sizes=(1, 4, 16, 64), reps: int = 9,
                   n_threads: int = 32, n_requests: int = 256, wait_s: float = 300) -> dict:
    """Phase 4i: the SIFT e2lsh service of phase 4 behind ServingFrontend.
    Single requests of Q = 1 to 64 through the front-end and through
    RetrievalService.search directly (median ms); then 32 submitter threads,
    each sending its share of 256 requests of 1 to 64 queries, k 10 or 100,
    one at a time: every request equal to its serial search, and the
    front-end's queries/s, p50 / p99 latency, dispatches and rows per
    dispatch."""
    import random
    import threading

    from repro_torch.kernels import common
    from repro_torch.serve import ServingFrontend

    svc, queries = run["service"], run["queries"]
    hw = gpu_name_and_power_limit()
    log(f"== phase 4i: the serving front-end over the SIFT e2lsh service; {hw}")
    out = dict(card=hw, single={})
    fe = ServingFrontend(max_wait_us=0)
    try:
        fe.register("sift", svc)
        for q in sizes:
            rows = queries[:q]
            direct, front = [], []
            for i in range(reps + 1):
                sync(device)
                t0 = time.perf_counter()
                svc.search(None, k=FULL_K, embeddings=rows)
                sync(device)
                direct.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                fe.search("sift", None, k=FULL_K, embeddings=rows, timeout=wait_s)
                front.append((time.perf_counter() - t0) * 1e3)
            out["single"][q] = dict(direct_ms=statistics.median(direct[1:]),
                                    frontend_ms=statistics.median(front[1:]))
            log(f"  Q = {q:2d}, k = {FULL_K}: RetrievalService.search "
                f"{out['single'][q]['direct_ms']:.2f} ms, ServingFrontend "
                f"{out['single'][q]['frontend_ms']:.2f} ms (medians of {reps}; {hw})")
    finally:
        fe.close(timeout=wait_s)
    # the same single requests with the equality tile's default pick (32
    # query rows a block up to Q = 32) and with its 128-row shape only
    out["shapes"] = single_requests(svc, queries, device, sizes=sizes, reps=reps,
                                    label="SIFT e2lsh", profile=(1, 4, 16))
    check(out["shapes"]["shapes"].get("match_count[tile_q=32]", 0) > 0,
          "the single requests never launched match_count's 32-row shape")

    fe = ServingFrontend(max_wait_us=2000, max_batch=1024, max_queue=1024)
    done, lock = [], threading.Lock()
    try:
        fe.register("sift", svc)

        def client(worker: int) -> None:
            rng = random.Random(SEED + worker)
            for _ in range(n_requests // n_threads):
                q = rng.randint(1, 64)
                lo = rng.randint(0, queries.shape[0] - q)
                k = rng.choice((10, 100))
                res = fe.submit("sift", None, k=k, embeddings=queries[lo:lo + q]).result(wait_s)
                with lock:
                    done.append((queries[lo:lo + q], k, res))

        threads = [threading.Thread(target=client, args=(w,)) for w in range(n_threads)]
        common.reset_launch_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(wait_s)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a submitter thread did not finish")
        launches = common.launch_counts()
        stats = fe.stats()
    finally:
        fe.close(timeout=wait_s)
    check(len(done) == n_requests, f"{len(done)} of {n_requests} requests answered")
    check(launches.get("match_count", 0) > 0 and launches.get("cpq_hist", 0) > 0,
          f"the front-end's dispatches launched {launches}")
    frontend_serial_equal(svc, done)
    n_rows = sum(r.shape[0] for r, _, _ in done)
    out.update(concurrent=dict(
        threads=n_threads, requests=n_requests, queries=n_rows, wall_s=wall,
        queries_per_s=n_rows / wall, p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
        dispatches=stats["dispatches"], rows_per_dispatch=stats["batch_occupancy"],
        coalesce_ratio=stats["coalesce_ratio"], launches=launches))
    c = out["concurrent"]
    log(f"  {n_threads} threads, {n_requests} requests of 1 to 64 queries ({n_rows} in all), "
        f"k 10 / 100: {c['queries_per_s']:.1f} queries/s; p50 {c['p50_ms']:.2f} ms, p99 "
        f"{c['p99_ms']:.2f} ms; {c['dispatches']} dispatches, {c['rows_per_dispatch']:.1f} rows "
        f"and {c['coalesce_ratio']:.2f} requests a dispatch; every request = its serial "
        f"search; launches {launches} ({hw})")
    log("  frontend: " + json.dumps(out))
    return out


def phase_frontend_range(run: dict, device: torch.device, wait_s: float = 300) -> None:
    """Phase 4i (RANGE): the Adult index of phase 4d as an IndexService
    tenant, its (lo, hi) queries stacked [q, 2, d] with a query_adapter:
    coalesced requests run range_count and equal their serial searches."""
    import numpy as np

    from repro_torch.kernels import common
    from repro_torch.serve import IndexService, ServingFrontend

    index, (lo, hi) = run["index"], run["queries"]
    log(f"== phase 4i: an IndexService tenant over the Adult RANGE index "
        f"({gpu_name_and_power_limit()})")
    stacked = torch.stack([lo, hi], dim=1)
    svc = IndexService(index=index, query_adapter=lambda a: (a[:, 0, :], a[:, 1, :]))
    slices = [(0, 5, 10), (5, 37, 100), (37, 101, 64), (101, 102, 1), (200, 264, 100)]
    fe = ServingFrontend(max_wait_us=0, start=False)
    try:
        fe.register("adult", svc)
        futs = [fe.submit("adult", None, k=k, embeddings=stacked[a:b]) for a, b, k in slices]
        common.reset_launch_counts()
        fe.start()
        results = [f.result(timeout=wait_s) for f in futs]
        sync(device)
        launches = common.launch_counts()
        stats = fe.stats()
    finally:
        fe.close(timeout=wait_s)
    for (a, b, k), (got, _) in zip(slices, results):
        want = index.search((lo[a:b], hi[a:b]), k=k)
        check(np.array_equal(got.ids, want.ids.cpu().numpy())
              and np.array_equal(got.counts, want.counts.cpu().numpy()),
              f"Adult front-end rows {a}:{b} differ from the serial search")
    check(launches.get("range_count", 0) > 0, f"range_count did not launch: {launches}")
    log(f"  {len(slices)} requests in {stats['dispatches']} dispatches; each = its serial "
        f"search; launches {launches}")


# ---------------------------------------------------------------------------
# The tile knobs: the kernels' block-shape variants and the autotuner
# ---------------------------------------------------------------------------

# Q at which phase 5 times match_count's two block shapes at the SIFT
# segment shape, and the batch sizes of the single requests of 4i / 4j
VARIANT_QS = (1, 16, 64, 1024)
SINGLE_QS = (1, 4, 16, 64)


class wide_eq_only:
    """Within the block the equality kernels have their Wide shape only (128
    query rows a block, as before the Narrow shape existed): the picks of
    kernels/match_count.py and tanimoto_count.py see one tile_q variant."""

    def __enter__(self):
        from repro_torch.kernels import match_count, tanimoto_count

        self.tables = (match_count.VARIANTS, tanimoto_count.VARIANTS)
        self.saved = [t["tile_q"] for t in self.tables]
        for t in self.tables:
            t["tile_q"] = (128,)

    def __exit__(self, *exc):
        for t, v in zip(self.tables, self.saved):
            t["tile_q"] = v


def eq_variant_times(name: str, data: torch.Tensor, qsigs: torch.Tensor, launches: int,
                     parity_err: dict, device: torch.device, qs=VARIANT_QS) -> dict:
    """Phase 5 / 5c: the equality kernel `name` in both block shapes (tile_q
    128 and 32, through their C entries) at the segment shape for each Q of
    `qs`; the narrow shape's entry of the kernels line at Q = 1 (the
    front-end's single request), with its plain version, the cdist yardstick
    and its bound there, and `launches` (its launches on the main path)."""
    from repro_torch.kernels.match_count import match_count_plain

    n, m = data.shape
    hw = gpu_name_and_power_limit()
    log(f"  {name} by block shape at N={n}, m={m} ({hw}):")
    times = {}
    for q in qs:
        s = qsigs[:q].contiguous()
        row = {}
        for tq in (128, 32):
            ms, counts = timed_ms(lambda: eq_variant(name, tq)(data, s), device, reps=5,
                                  warmup=1, hold=q < 64)
            row[tq] = ms
            if tq == 128:
                wide = counts
            else:
                check(torch.equal(counts, wide), f"{name} shapes disagree at Q={q}")
        bound = max((n * m + q * m + q * n) * 4 / PEAK_BYTES_PER_S,
                    2 * q * n * m / PEAK_ALU_OPS_PER_S) * 1e3
        times[q] = row
        log(f"    Q = {q:4d}: tile_q=128 {row[128]:.4f} ms, tile_q=32 {row[32]:.4f} ms "
            f"({row[128] / row[32]:.2f}x); bound {bound:.4f} ms")
    s = qsigs[:1].contiguous()
    counts = eq_variant(name, 32)(data, s)
    plain, want = timed_ms(lambda: match_count_plain(data, s), device, reps=1, warmup=1)
    err = max(parity_err[f"{name}[tile_q=32]"], max_abs_err(counts, want))
    check(torch.equal(counts, want), f"{name}[tile_q=32] differs at Q=1")
    lib = library_eq_count(data, s, counts, device)
    log("  " + json.dumps({f"{name}_by_shape": {str(q): v for q, v in times.items()}}))
    return kernel_entry(f"{name}[tile_q=32]", f"src/repro_torch/kernels/csrc/{name}.cu",
                        f"src/repro/kernels/{name}.py:{59 if name == 'match_count' else 64}",
                        launches, err, times[1][32], plain,
                        (n * m + m + n) * 4 / PEAK_BYTES_PER_S * 1e3,
                        2 * n * m / PEAK_ALU_OPS_PER_S * 1e3, lib)


def single_requests(svc, queries: torch.Tensor, device: torch.device, sizes=SINGLE_QS,
                    reps: int = 9, label: str = "", profile=()) -> dict:
    """Single requests of Q = `sizes` through RetrievalService.search, median
    ms of `reps`, with the equality tile's default pick (32 query rows a
    block up to Q = 32) and, in turns, with its Wide shape only (the shape
    every Q took before); the launches of each shape in the default runs;
    one default search of each Q in `profile` under the profiler."""
    from repro_torch.core import TopKMethod
    from repro_torch.kernels import common

    out, shapes = {}, {}
    for q in sizes:
        rows = queries[:q]
        runs = {"default": [], "wide_only": []}
        for i in range(reps + 1):
            for mode in ("default", "wide_only"):
                sync(device)
                common.reset_launch_counts()
                t0 = time.perf_counter()
                if mode == "default":
                    res, _ = svc.search(None, k=FULL_K, embeddings=rows, method=TopKMethod.CPQ)
                else:
                    with wide_eq_only():
                        res2, _ = svc.search(None, k=FULL_K, embeddings=rows,
                                             method=TopKMethod.CPQ)
                sync(device)
                runs[mode].append((time.perf_counter() - t0) * 1e3)
                if mode == "default":
                    for key, v in common.variant_launch_counts().items():
                        shapes[key] = shapes.get(key, 0) + v
            check(torch.equal(res.ids, res2.ids) and torch.equal(res.counts, res2.counts),
                  f"{label} Q={q}: the two block shapes give different results")
        out[q] = {mode: statistics.median(v[1:]) for mode, v in runs.items()}
        log(f"  {label} Q = {q:2d}, k = {FULL_K}: RetrievalService.search {out[q]['default']:.2f} "
            f"ms with the default pick, {out[q]['wide_only']:.2f} ms with 128 query rows a "
            f"block only (medians of {reps}, in turns)")
    log(f"  {label} block shapes launched by the default searches: {shapes}")
    for q in profile:                       # where a single request's time goes
        log(f"  {label} Q = {q}, default pick, under the profiler:")
        profile_one_search(lambda: svc.search(None, k=FULL_K, embeddings=queries[:q]), device)
    return dict(ms=out, shapes=shapes)


def fused_tile_times(run: dict, name: str, kernel_times: dict, device: torch.device,
                     parity_err: dict, k: int = FULL_K) -> dict:
    """Phase 5b / 5c: the fused top-k kernel `name` of the PACKED service
    `run` at its two tiles at the segment shape -- the kernel alone and with
    `topk_from_candidates` -- and the whole PACKED search with an autotune
    entry that picks the 1024-row tile, in turns with the default; the entry
    of the kernels line for the 1024-row tile (its launches from that
    search's run)."""
    from repro_torch.core import autotune
    from repro_torch.kernels import common
    from repro_torch.kernels.packed_cosine import packed_cosine_topk_plain
    from repro_torch.kernels.packed_tanimoto import packed_tanimoto_topk_plain

    svc = run["service"]
    model = svc._index.model
    d = svc._index.segments[0].data
    q_exec = model.prepare_queries_for(run["qsigs"], device, "packed")
    n, width = d.shape
    q = q_exec.shape[0]
    cosine = name == "packed_cosine_topk"
    words = width if cosine else -(-width // 4)
    plain_fn = packed_cosine_topk_plain if cosine else packed_tanimoto_topk_plain
    hw = gpu_name_and_power_limit()
    rows = {}
    for tile in FUSED_TILES:
        ms, (ids, cnts) = timed_ms(lambda: fused_variant(name, tile)(d, q_exec, k), device,
                                   reps=5, warmup=1)
        merge, res = timed_ms(lambda: fused_result(ids, cnts, k), device, reps=3, warmup=1)
        rows[tile] = dict(kernel_ms=ms, merge_ms=merge, slots=ids.shape[1],
                          ids=res[0], counts=res[1])
        log(f"  {name} tile {tile}: kernel {ms:.4f} ms, buffers [{q}, {ids.shape[1]}], "
            f"topk_from_candidates {merge:.4f} ms, together {ms + merge:.4f} ms ({hw})")
    check(torch.equal(rows[1024]["ids"], rows[2048]["ids"])
          and torch.equal(rows[1024]["counts"], rows[2048]["counts"]),
          f"{name}: the two tiles give different results after topk_from_candidates")
    plain, (pids, pcnts) = timed_ms(lambda: plain_fn(d, q_exec, k, 1024), device, reps=1)
    ids, cnts = fused_variant(name, 1024)(d, q_exec, k)
    err = max(parity_err[f"{name}[tile_n=1024]"], max_abs_err(ids, pids), max_abs_err(cnts, pcnts))
    check(err == 0, f"{name}[tile_n=1024] differs from its plain version at the segment shape")
    del pids, pcnts, ids, cnts
    # the whole search through RetrievalService.search with a tuned entry
    cache = autotune.AutotuneCache(device=device)
    cache.put(autotune.TunedEntry(
        engine=model.engine.value, signature_layout="packed",
        n_bucket=autotune.shape_bucket(svc._index.n_objects),
        w_bucket=autotune.shape_bucket(width), tile_overrides=(("tile_n", 1024),)))
    searches = {"default": [], "tile_n=1024": []}
    results = {}
    for i in range(4):
        for mode in searches:
            svc.autotune = cache if mode == "tile_n=1024" else None
            sync(device)
            if mode == "tile_n=1024" and i == 3:
                common.reset_launch_counts()       # the tuned path starts here
            t0 = time.perf_counter()
            results[mode] = svc.search(None, k=k, embeddings=run["queries"])[0]
            sync(device)
            searches[mode].append((time.perf_counter() - t0) * 1e3)
    launches = common.variant_launch_counts().get(f"{name}[tile_n=1024]", 0)
    svc.autotune = None
    check(launches == len(svc._index.segments),
          f"the tuned search launched {name}[tile_n=1024] {launches} times")
    check(torch.equal(results["default"].ids, results["tile_n=1024"].ids)
          and torch.equal(results["default"].counts, results["tile_n=1024"].counts),
          f"{name}: the tuned search differs from the default search")
    med = {m: statistics.median(v[1:]) for m, v in searches.items()}
    log(f"  PACKED search, {q} queries, k {k}: default (tile 2048) {med['default']:.2f} ms, "
        f"tuned tile_n=1024 {med['tile_n=1024']:.2f} ms (medians of 3, in turns; {hw}); "
        f"equal bit for bit")
    kernel_times[name] = dict(rows={t: {kk: v for kk, v in r.items() if kk in
                                         ("kernel_ms", "merge_ms", "slots")}
                                    for t, r in rows.items()}, search_ms=med)
    log("  " + json.dumps({f"{name}_by_tile": kernel_times[name]}))
    slots = rows[1024]["slots"]
    in_bytes = (n * width + q * width) * (4 if cosine else 1)
    return kernel_entry(f"{name}[tile_n=1024]",
                        f"src/repro_torch/kernels/csrc/{name.rsplit('_', 1)[0]}.cu",
                        "src/repro/kernels/packed_cosine.py:151" if cosine
                        else "src/repro/kernels/packed_tanimoto.py:120",
                        launches, err, rows[1024]["kernel_ms"], plain,
                        (in_bytes + 2 * q * slots * 4) / PEAK_BYTES_PER_S * 1e3,
                        3 * q * n * words / PEAK_ALU_OPS_PER_S * 1e3, None)


def phase_autotune(run: dict, label: str, device: torch.device, budget: int = 8,
                   repeats: int = 2, singles: bool = False) -> dict:
    """Phase 4j: RetrievalService.tune() on a full-width service (budget 8,
    2 repeats): the entry, default_us against measured_us, the time tune()
    takes; the tuned search equal to the untuned one bit for bit; the cache
    saved to a file and reloaded (the same entry); a cache with a foreign
    fingerprint keeps the defaults; with `singles`, the single requests of
    4i again through the tuned service."""
    import tempfile

    from repro_torch.core import autotune

    svc, queries = run["service"], run["queries"]
    hw = gpu_name_and_power_limit()
    log(f"== phase 4j: the autotuner on the {label} service ({hw})")
    svc.autotune = None
    before = svc.search(None, k=FULL_K, embeddings=queries)[0]
    sync(device)
    t0 = time.perf_counter()
    entry = svc.tune(None, k=FULL_K, embeddings=queries, budget=budget, repeats=repeats,
                     save=False)
    sync(device)
    tune_s = time.perf_counter() - t0
    after = svc.search(None, k=FULL_K, embeddings=queries)[0]
    sync(device)
    check(isinstance(svc.autotune, autotune.AutotuneCache), "tune() installed no cache")
    check(torch.equal(before.ids, after.ids) and torch.equal(before.counts, after.counts)
          and torch.equal(before.threshold, after.threshold),
          f"{label}: the tuned search differs from the untuned one")
    log(f"  entry: {json.dumps(entry.to_dict())}")
    log(f"  tune() {tune_s:.2f} s; default {entry.default_us / 1e3:.2f} ms, tuned "
        f"{entry.measured_us / 1e3:.2f} ms, speedup {entry.speedup:.4f}; the tuned search "
        f"equals the untuned one bit for bit")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune_torch.json")
        saved = autotune.AutotuneCache(path, device=device)
        saved.put(entry)
        saved.save()
        again = autotune.AutotuneCache(path, device=device)
        check(again.entries == {entry.key(): entry} and again.compatible(),
              "the reloaded cache differs from the saved one")
        hit = again.lookup(entry.engine, entry.signature_layout, svc._index.n_objects,
                           svc._index.segments[0].data.shape[1])
        check(hit == entry, "the reloaded cache does not find the entry")
    foreign = autotune.AutotuneCache(device=device,
                                     fingerprint=dict(svc.autotune.fingerprint,
                                                      device_kind="another card"))
    foreign.put(entry)
    check(foreign.lookup(entry.engine, entry.signature_layout, svc._index.n_objects) is None,
          "a cache with a foreign fingerprint was consulted")
    log("  saved to a file and reloaded: the same entry; a cache with another card's "
        "fingerprint keeps the defaults")
    out = dict(entry=entry.to_dict(), tune_s=tune_s, card=hw)
    if singles:
        out["single"] = single_requests(svc, queries, device, reps=5,
                                        label=f"{label}, tuned service")["ms"]
    log("  autotune: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 4k: the distributed layout on one NCCL rank
# ---------------------------------------------------------------------------

DIST_SEGMENTS = [2000, 701, 1500, 299, 1503]      # 6003 rows: 5 pad rows to a multiple of 8
DIST_Q = 256                                      # full width: PERF.md section 4


def phase_distributed_small(device: torch.device, k: int = 20, n_queries: int = 33) -> None:
    """Phase 4k (i): DISTRIBUTED = SEGMENTED on every engine and layout, both
    paths, CPQ / SPQ / SORT, on a flat and a pod mesh of one rank; the kernel
    path launches the engine's count kernel once a search, the plain path
    nothing; ROUTED_VERIFIED at nprobe 1 = NONE.  SPQ is held to the host
    loop over the same padded data as one part instead: its range narrowing
    starts from the row's least count, which a pad row's -1 lowers, so over
    padded data it may end below the k-th count and lose candidates to the
    cap -- in the JAX package too (ROADMAP, reference quirks)."""
    import numpy as np
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core import Engine, SegmentedIndex, TopKMethod, distributed, engines, plan
    from repro_torch.launch import mesh as mesh_lib

    log(f"== phase 4k (i): the distributed layout, small, all six engines, one NCCL rank "
        f"({gpu_name_and_power_limit()})")
    meshes = {"flat": mesh_lib.make_mesh((1,), ("data",), device),
              "pod": mesh_lib.make_mesh((1, 1, 1), ("pod", "data", "model"), device)}
    for name, layout, count_kernel in PAD_CASES:
        model = engines.get(name)
        raw, queries, mc = model.example(np.random.default_rng(SEED + 17), sum(DIST_SEGMENTS),
                                         n_queries)
        q_wide = model.prepare_queries(queries, device)
        q_exec = model.pack_queries(q_wide) if layout == "packed" else q_wide
        for use_kernel in (True, False):
            index = SegmentedIndex(Engine(name), max_count=mc, use_kernel=use_kernel,
                                   device=device, signature_layout=layout)
            lo = 0
            for rows in DIST_SEGMENTS:
                index.add(raw[lo:lo + rows])
                lo += rows
            data, n = index.concat_data(pad_multiple=8)
            check(n == sum(DIST_SEGMENTS) and data.shape[0] == n + 5, "the padded corpus")
            router = index.router()
            for method in TopKMethod:
                want = index.search(queries, k=k, method=method)
                if method is TopKMethod.SPQ:
                    one = plan.plan_search(name, k, index.max_count, layout="multiload",
                                           part_rows=(int(data.shape[0]),), n_objects=n,
                                           host_loop=True, method=method, use_kernel=use_kernel,
                                           signature_layout=layout)
                    want = plan.execute(one, [data], q_exec)
                for merge, mesh in meshes.items():
                    placed = distribute_tensor(data, mesh, distributed.data_sharding(mesh),
                                               src_data_rank=None)
                    kw = dict(layout="distributed", n_objects=n, method=method,
                              use_kernel=use_kernel, hierarchical=merge == "pod",
                              mesh_axes=mesh.mesh_dim_names, signature_layout=layout)
                    p = plan.plan_search(name, k, index.max_count, **kw)
                    what = f"{name} {layout} {method.value} kernel={use_kernel} {merge} mesh"
                    got, launches = launches_of(lambda: plan.execute(p, placed, q_exec, mesh=mesh),
                                                device)
                    same_result(got, want, f"{what}: DISTRIBUTED vs SEGMENTED (SPQ: one padded part)")
                    check(launches.get(count_kernel) == 1 if use_kernel else launches == {},
                          f"{what}: launches {launches}")
                    p = plan.plan_search(name, k, index.max_count, routing="routed_verified",
                                         nprobe=1, **kw)
                    same_result(plan.execute(p, placed, q_exec, mesh=mesh, router=router,
                                             route_queries=q_wide), got,
                                f"{what}: ROUTED_VERIFIED vs NONE")
        log(f"  {name} {layout}: DISTRIBUTED = SEGMENTED (SPQ: = the padded data as one "
            f"part), ROUTED_VERIFIED (nprobe 1) = NONE; CPQ / SPQ / SORT, kernel and plain "
            f"path, flat and pod mesh; {count_kernel} once a search on the kernel path")


def one_launch_times(svc, q_exec, count_name: str, device: torch.device) -> dict:
    """The count kernel and cpq_hist in one launch over the whole placed
    shard, each equal to its per-segment launches put together; ms by CUDA
    events and the least time the card could take."""
    from repro_torch.kernels import ops

    data = svc._sharded_corpus()[0].to_local()
    count = getattr(ops, count_name)
    n, w = data.shape
    q, bins = q_exec.shape[0], svc._index.max_count + 1
    ms_count, counts = timed_ms(lambda: count(data, q_exec), device, reps=3, warmup=1)
    ms_hist, hist = timed_ms(lambda: ops.cpq_hist(counts, svc._index.max_count), device,
                             reps=3, warmup=1)
    parts = [count(seg.data, q_exec) for seg in svc._index.segments]
    check(torch.equal(counts, torch.cat(parts, dim=1)),
          f"{count_name} over {n} rows differs from its per-segment launches")
    check(torch.equal(hist, sum(ops.cpq_hist(c, svc._index.max_count) for c in parts)),
          f"cpq_hist over {n} rows differs from its per-segment launches")
    del parts, counts
    if count_name == "match_count":                 # Q.N.m compares and adds
        ops_count, bytes_count = 2 * q * n * w, (n * w + q * w + q * n) * 4
    else:                                           # xor, popcount, add a word pair
        ops_count, bytes_count = 3 * q * n * w, (n * w + q * w + q * n) * 4
    bound = {count_name: max(bytes_count / PEAK_BYTES_PER_S, ops_count / PEAK_ALU_OPS_PER_S) * 1e3,
             "cpq_hist": max((q * n + q * bins) * 4 / PEAK_BYTES_PER_S,
                             q * n / PEAK_ALU_OPS_PER_S) * 1e3}
    out = {count_name: ms_count, "cpq_hist": ms_hist}
    for name, ms in out.items():
        log(f"  {name} in one launch over N = {n} rows, Q = {q}: {ms:.4f} ms, bound "
            f"{bound[name]:.4f} ms ({100 * bound[name] / ms:.1f}% of it); equal to its "
            f"{len(svc._index.segments)} per-segment launches")
    return dict(ms=out, bound_ms=bound)


def phase_distributed_full_width(device: torch.device, n_queries: int = DIST_Q,
                                 **sizes) -> dict:
    """Phase 4k (ii): RetrievalService(mesh=make_local_mesh()) at the SIFT
    shape, e2lsh WIDE then simhash PACKED on the same corpus: the search on
    its main path (one launch of the count kernel and of cpq_hist a search),
    equal to the SEGMENTED search of the service's index and ROUTED_VERIFIED
    (nprobe 4) equal to NONE; the gather + merge timed apart; one profiled
    search; the two kernels in one launch over the whole shard."""
    from repro_torch.core import engines
    from repro_torch.core import plan as plan_lib
    from repro_torch.launch import mesh as mesh_lib

    hw = gpu_name_and_power_limit()
    mesh = mesh_lib.make_local_mesh(device=device)
    k = sizes.get("k", FULL_K)
    report = {"card": hw, "mesh": list(mesh.shape), "n_queries": n_queries}
    for scheme, layout, count_name, sim_range in (
            ("e2lsh", "wide", "match_count", (0.0, 1.0)),
            ("simhash", "packed", "packed_cosine_count", (-1.0, 1.0))):
        log(f"== phase 4k (ii): RetrievalService(scheme={scheme!r}, {layout}, "
            f"mesh={tuple(mesh.shape)}) at full width, {n_queries} queries ({hw})")
        per_search = {count_name: 1, "cpq_hist": 1}
        run = drive_full_width(device, per_search, sim_range, n_queries=n_queries, mesh=mesh,
                               scheme=scheme, signature_layout=layout, **sizes)
        svc, res = run["service"], run["result"]
        # the same queries through the service's own SEGMENTED index, hashed
        # as the service hashes them: the unmeshed search at the same Q
        seg_ms = []
        for _ in range(4):
            ms, seg = timed_ms(lambda: svc._index.search(svc._hash(run["queries"]), k=k), device)
            seg_ms.append(ms)
        same_result(seg, res, f"{scheme} {layout}: DISTRIBUTED vs the SEGMENTED search of its index")
        log(f"  the SEGMENTED search of the same index and queries: first {seg_ms[0]:.2f} ms, "
            f"median of the rest {statistics.median(seg_ms[1:]):.2f} ms ({hw})")
        ver = svc.search(None, k=k, embeddings=run["queries"], routing="routed_verified",
                         nprobe=4)[0]
        same_result(ver, res, f"{scheme} {layout}: ROUTED_VERIFIED (nprobe 4) vs NONE")
        log(f"  = the SEGMENTED search of the service's index on all {n_queries} rows; "
            f"ROUTED_VERIFIED (nprobe 4) = NONE")
        profile_one_search(service_search(run, k), device)
        # the collective merge alone, on this search's own buffers
        data, n = svc._sharded_corpus()
        model = engines.get(svc._scheme.engine)
        q_wide = model.prepare_queries(run["qsigs"], device)
        q_exec = model.pack_queries(q_wide) if layout == "packed" else q_wide
        p = plan_lib.plan_search(svc._scheme.engine, k, svc._index.max_count,
                                 layout="distributed", n_objects=n,
                                 mesh_axes=mesh.mesh_dim_names, signature_layout=layout)
        gids, gcnt = plan_lib._part_topk(p, data.to_local(), q_exec, 0)
        merge_ms, merged = timed_ms(lambda: plan_lib._collective_merge(p, mesh, gids, gcnt),
                                    device, reps=20, warmup=3)
        same_result(merged, res, f"{scheme} {layout}: the timed merge")
        log(f"  gather + merge_topk alone: {merge_ms:.4f} ms (buffers [{n_queries}, {k}], "
            f"one rank; {hw})")
        times = one_launch_times(svc, q_exec, count_name, device)
        report[f"{scheme} {layout}"] = dict(
            search_ms=run["timing"]["search_ms"], segmented_ms=seg_ms,
            peak_gb=run["timing"]["peak_bytes"] / 1e9,
            launches=run["launches"], merge_ms=merge_ms, **times)
        del run, svc, res, seg, ver, data, gids, gcnt, merged
        if device.type == "cuda":
            torch.cuda.empty_cache()
    log("  distributed: " + json.dumps(report))
    return report


def phase_distributed(device: torch.device) -> dict:
    """Phase 4k, (i) then (ii), in the one-rank process group that
    `launch.mesh` starts; the group is destroyed after it."""
    import torch.distributed as dist

    phase_distributed_small(device)
    report = phase_distributed_full_width(device)
    dist.destroy_process_group()
    return report


# ---------------------------------------------------------------------------
# Phases 6a-6e: the postings engine and its load balance, the dry-run's memory
# model, LM serving at full width, and the entry points
# ---------------------------------------------------------------------------

POSTINGS_N, POSTINGS_M, POSTINGS_D = FULL_N // FULL_SEGMENTS, 238, 67   # a SIFT segment
POSTINGS_Q, CPU_IDX_Q = 64, 4
BALANCE_M, BALANCE_SPACE, BALANCE_Q = 8, 256, 16      # fig12_load_balance.py's law


def tiled_scans(pidx, qkw: np.ndarray, want: torch.Tensor, device: torch.device,
                hw: str) -> dict:
    """`scan_counts_tiled` at split limits max_list_len, 4096 and 1024 on the
    card, each equal to `want` bit for bit; returns {limit: (tiles, pad
    ratio, ms a query)}."""
    out = {}
    q_dev = torch.from_numpy(qkw).to(device)
    for limit in (pidx.stats.max_list_len, 4096, 1024):
        t0 = time.perf_counter()
        tiles, tile_kw = pidx.split_tiles(limit)
        split_s = time.perf_counter() - t0
        pad_ratio = tiles.size / max(pidx.stats.total_postings, 1)
        t_dev, kw_dev = torch.from_numpy(tiles).to(device), torch.from_numpy(tile_kw).to(device)
        del tiles
        ms, counts = timed_ms(lambda: pidx.scan_counts_tiled(t_dev, kw_dev, q_dev), device,
                              reps=3, warmup=1)
        check(torch.equal(counts, want), f"postings: the tiled scan at limit {limit} differs")
        per_q = ms / qkw.shape[0]
        log(f"  limit {limit}: {t_dev.shape[0]} tiles of {limit}, pad ratio {pad_ratio:.4f}, "
            f"split on the host {split_s:.3f} s; scan_counts_tiled {ms:.3f} ms for Q = "
            f"{qkw.shape[0]}, {per_q:.4f} ms a query ({hw}); = the reference counts")
        out[limit] = (int(t_dev.shape[0]), pad_ratio, per_q)
        del t_dev, kw_dev, counts
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def cpu_idx(pidx, qkw: np.ndarray) -> tuple:
    """(counts, ms a query) of the numpy CPU-Idx baseline."""
    t0 = time.perf_counter()
    counts = pidx.scan_counts_numpy(qkw)
    return counts, (time.perf_counter() - t0) * 1e3 / qkw.shape[0]


def phase_postings_sift(device: torch.device, n: int = POSTINGS_N, m: int = POSTINGS_M,
                        n_buckets: int = POSTINGS_D, dim: int = FULL_DIM,
                        n_queries: int = POSTINGS_Q) -> dict:
    """Phase 6a: the CSR postings engine over the e2lsh signatures of one
    SIFT segment (keywords i * D + sig[:, i]): the host build, the tiled scan
    on the card at three split limits, equal bit for bit to match_count on
    the same signatures, and CPU-Idx (numpy) equal to both on 4 queries."""
    from repro_torch.core.lsh import e2lsh
    from repro_torch.core.postings import PostingsIndex
    from repro_torch.kernels import common, ops

    hw = gpu_name_and_power_limit()
    log(f"== phase 6a: postings (CSR build, tiled scan, CPU-Idx) at one SIFT segment: N = "
        f"{n}, m = {m}, D = {n_buckets}, Q = {n_queries} ({hw})")
    gen = torch.Generator(device=device).manual_seed(SEED)
    pts = torch.randn((n, dim), generator=gen, device=device)
    params = e2lsh.make(torch.Generator().manual_seed(SEED), d=dim, m=m, w=4.0,
                        n_buckets=n_buckets, device=device)
    sigs = e2lsh.hash_points(params, pts)
    qsigs = e2lsh.hash_points(params, pts[:n_queries] + 0.01)
    offsets = torch.arange(m, dtype=torch.int32, device=device) * n_buckets
    keywords, qkw = (sigs + offsets).cpu().numpy(), (qsigs + offsets).cpu().numpy()
    t0 = time.perf_counter()
    pidx = PostingsIndex.build(keywords, m * n_buckets)
    build_s = time.perf_counter() - t0
    st = pidx.stats
    log(f"  build on the host (stable argsort of {keywords.size} keywords): {build_s:.3f} s; "
        f"{st.n_lists} lists, {st.total_postings} postings, longest {st.max_list_len}, "
        f"{st.bytes_device / 1e9:.4f} GB")
    check(st.n_lists <= m * n_buckets and st.total_postings == n * m, "postings: bad stats")
    want, launches = common.launches_during(lambda: ops.match_count(sigs, qsigs))
    check(device.type != "cuda" or launches.get("match_count") == 1,
          f"match_count did not launch: {launches}")
    scans = tiled_scans(pidx, qkw, want, device, hw)
    counts, cpu_ms = cpu_idx(pidx, qkw[:CPU_IDX_Q])
    check(np.array_equal(counts, want[:CPU_IDX_Q].cpu().numpy()),
          "postings: CPU-Idx differs from match_count")
    log(f"  CPU-Idx (numpy) {cpu_ms:.3f} ms a query over {CPU_IDX_Q} queries, = match_count "
        f"= the tiled scans bit for bit")
    return dict(build_s=build_s, scans=scans, cpu_idx_ms=cpu_ms)


def phase_postings_balance(device: torch.device, n: int = ADULT_N, m: int = BALANCE_M,
                           space: int = BALANCE_SPACE, n_queries: int = BALANCE_Q) -> dict:
    """Phase 6b: the paper's load-balance study (Fig 12) with
    benchmarks/fig12_load_balance.py's keyword law (Zipf 1.2 over 256
    keywords, m = 8, its first rows as queries) at Adult's N.  A list a query
    names twice is scanned once by the tiled scan and twice by CPU-Idx, so
    CPU-Idx runs on each query's distinct keywords."""
    from repro_torch.core.postings import PostingsIndex

    hw = gpu_name_and_power_limit()
    log(f"== phase 6b: postings load balance (Fig 12), Zipf 1.2 over {space} keywords, m = "
        f"{m}, N = {n}, Q = {n_queries} ({hw})")
    rng = np.random.default_rng(5)
    probs = 1.0 / np.arange(1, space + 1) ** 1.2
    keywords = rng.choice(space, size=(n, m), p=probs / probs.sum()).astype(np.int32)
    t0 = time.perf_counter()
    pidx = PostingsIndex.build(keywords, space)
    log(f"  build {time.perf_counter() - t0:.3f} s; longest list {pidx.stats.max_list_len} of "
        f"{pidx.stats.total_postings} postings")
    qkw = keywords[:n_queries]
    want, cpu_ms = [], 0.0
    for row in qkw[:CPU_IDX_Q]:
        counts, ms = cpu_idx(pidx, np.unique(row)[None])
        want.append(counts[0])
        cpu_ms += ms / CPU_IDX_Q
    log(f"  CPU-Idx (numpy) {cpu_ms:.3f} ms a query over {CPU_IDX_Q} queries (distinct "
        f"keywords)")
    tiles, tile_kw = pidx.split_tiles(1024)
    first = pidx.scan_counts_tiled(torch.from_numpy(tiles).to(device),
                                   torch.from_numpy(tile_kw).to(device),
                                   torch.from_numpy(qkw).to(device))
    check(np.array_equal(first[:CPU_IDX_Q].cpu().numpy(), np.stack(want)),
          "postings: the tiled scan differs from CPU-Idx on distinct keywords")
    del tiles, tile_kw
    return dict(scans=tiled_scans(pidx, qkw, first, device, hw), cpu_idx_ms=cpu_ms)


def phase_dryrun_memory(device: torch.device, distributed_report: dict) -> dict:
    """Phase 6c: the dry-run's cells for the six datasets on 1 and 4 cards,
    and its memory model against phase 4k's measured peak (e2lsh,
    DISTRIBUTED on one rank, Q = 256, N = 4.5 M); fails beyond 25 %."""
    from repro_torch.core.lsh import tau_ann
    from repro_torch.core.types import SearchParams
    from repro_torch.launch import dryrun

    hw = gpu_name_and_power_limit()
    log(f"== phase 6c: the dry-run's memory model ({hw})")
    for name in dryrun.DATASETS:
        for world in (1, 4):
            rep = dryrun.run_genie_cell(name, world)
            mem = rep["memory"]
            terms = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in mem["per_rank"].items())
            log(f"  {name}, world {world}, {rep['layout']}, Q = {rep['n_queries']}: fits="
                f"{mem['fits']} of {mem['card_bytes'] / 1e9:.3f} GB "
                f"({mem['card_bytes_source']}); GB a rank: {terms}")
    m = tau_ann.required_m(0.06, 0.06)
    model = dryrun.memory_model(
        n_objects=FULL_N, row_bytes=m * 4, n_queries=DIST_Q, part_rows=FULL_N,
        placed_rows=FULL_N, query_bytes=m * 4, max_count=m,
        cap=SearchParams(k=FULL_K, max_count=m).cap())["peak"]
    measured = distributed_report["e2lsh wide"]["peak_gb"] * 1e9
    ratio = model / measured
    log(f"  phase 4k's cell (e2lsh, DISTRIBUTED, one rank, Q = {DIST_Q}, N = {FULL_N}, m = "
        f"{m}): model {model / 1e9:.3f} GB, measured max_memory_allocated "
        f"{measured / 1e9:.3f} GB, model / measured {ratio:.4f} ({hw})")
    check(abs(ratio - 1.0) <= 0.25, f"the memory model is off by more than 25 %: {ratio:.4f}")
    return dict(model_gb=model / 1e9, measured_gb=measured / 1e9, ratio=ratio)


# The compute dtypes at which a case's decode step is held within 5e-2 of
# the teacher-forced forward.  "float32 KV" keeps the hybrid's
# shared-attention K/V in float32 (`prefill_float32_kv`) where prefill
# rounds them to bfloat16, as the reference's does.
AT_BF16 = ("bfloat16",)
LM_CASES = (("smollm-360m", None, 32, AT_BF16),                 # arch, layers, new tokens
            ("qwen2-moe-a2.7b", 4, 16, ("bfloat16", "float32")))
LM_BATCH, LM_PROMPT, LM_CAP = 8, 128, 256


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tree_leaves(v)]
    return [tree]


def prefill_float32_kv(cfg, params, batch: dict, cache_cap: int) -> tuple:
    """hybrid.prefill with the shared block's K/V kept in the compute dtype
    (the shipped prefill rounds them to bfloat16)."""
    from repro_torch.models import hybrid

    logits, _, ((ks, vs), (conv, ssm)) = hybrid.forward(cfg, params, batch["tokens"],
                                                        emit_state=True)
    s = ks.shape[2]
    cache = hybrid.init_cache(cfg, ks.shape[1], max(cache_cap, s), dtype=ks.dtype,
                              device=ks.device)
    cache["attn_k"][:, :, :s], cache["attn_v"][:, :, :s] = ks, vs
    cache["conv"], cache["ssm"] = conv, ssm
    return logits[:, -1, :], cache, s


def check_float32_kv_prefill(cfg, params, batch: dict, cache_cap: int, got: tuple) -> None:
    """`got`, what `prefill_float32_kv` returned, against the shipped
    `hybrid.prefill` on the same inputs: the same last logits, position,
    conv tails and SSM states bit for bit, and K/V equal to the shipped
    bfloat16 cache once rounded to bfloat16.  So a step held on the float32
    K/V holds on the shipped prefill but for the cache's rounding."""
    from repro_torch.models import hybrid

    last, cache, pos = hybrid.prefill(cfg, params, batch["tokens"], cache_cap=cache_cap)
    g_last, g_cache, g_pos = got
    check(pos == g_pos and torch.equal(last, g_last),
          f"{cfg.arch_id}: prefill_float32_kv's logits or position differ from hybrid.prefill's")
    for name in ("conv", "ssm"):
        check(cache[name].dtype == g_cache[name].dtype and torch.equal(cache[name], g_cache[name]),
              f"{cfg.arch_id}: prefill_float32_kv's {name} differs from hybrid.prefill's")
    for name in ("attn_k", "attn_v"):
        check(cache[name].dtype == torch.bfloat16
              and torch.equal(cache[name], g_cache[name].to(torch.bfloat16)),
              f"{cfg.arch_id}: prefill_float32_kv's {name}, rounded to bfloat16, differs from "
              f"hybrid.prefill's")
    log(f"  {cfg.arch_id}: prefill with float32 K/V = hybrid.prefill bit for bit (logits, pos "
        f"{pos}, conv, ssm; attn_k / attn_v once rounded to bfloat16)")


def decode_vs_forward(api, cfg, params, tokens: torch.Tensor, cache_cap: int,
                      frames: torch.Tensor | None = None, float32_kv: bool = False) -> dict:
    """One decode step after prefill against a teacher-forced forward at that
    position: by row, the max |diff| of the logits ("err").  The forward's
    tokens are padded to a whole SSD chunk for the ssm and hybrid families,
    and the encoder-decoder's `frames` go to both paths; `float32_kv`: the
    hybrid's prefill through `prefill_float32_kv`, held to the shipped
    prefill by `check_float32_kv_prefill`.  For the MoE (at
    capacity factor 64: dropping depends on the population) also, by row,
    the (layer, position) places where the forward's top-k experts differ
    from prefill's on the prompt ("prompt_flips") and the layers where they
    differ from the decode step's on the new token ("new_flips")."""
    import dataclasses

    from repro_torch.models import moe

    record = cfg.family == "moe"
    if record:
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)

    def recorded(fn):
        if record:
            moe.start_routing_record()
        out = fn()
        return out, moe.stop_routing_record() if record else []

    extra = {} if frames is None else {"frames": frames}
    prefill = prefill_float32_kv if float32_kv else api.prefill
    (last, cache, pos), r_prefill = recorded(
        lambda: prefill(cfg, params, {"tokens": tokens, **extra}, cache_cap=cache_cap))
    if float32_kv:
        check_float32_kv_prefill(cfg, params, {"tokens": tokens}, cache_cap, (last, cache, pos))
    nt = torch.argmax(last, -1)[:, None].to(torch.int32)
    (step, _), r_decode = recorded(lambda: api.decode_step(cfg, params, nt, cache, pos))
    n_pad = -(pos + 1) % cfg.ssd_chunk if cfg.family in ("ssm", "hybrid") else 0
    pad = torch.zeros((tokens.shape[0], n_pad), dtype=nt.dtype, device=tokens.device)
    forward_tokens = torch.cat([tokens.to(nt.dtype), nt, pad], 1)
    (full, _, _), r_forward = recorded(
        lambda: api.train_logits(cfg, params, {"tokens": forward_tokens, **extra}))
    out = dict(err=[float(x) for x in (step - full[:, pos]).abs().amax(dim=-1)])
    b = tokens.shape[0]
    prompt = torch.zeros(b, dtype=torch.int64, device=tokens.device)
    new = torch.zeros(b, dtype=torch.int64, device=tokens.device)
    for pre, dec, fwd in zip(r_prefill, r_decode, r_forward, strict=True):
        fwd = fwd.sort(dim=-1).values.reshape(b, pos + 1, -1)
        pre = pre.sort(dim=-1).values.reshape(b, pos, -1)
        prompt += (pre != fwd[:, :pos]).any(dim=-1).sum(dim=-1)
        new += (dec.sort(dim=-1).values != fwd[:, pos]).any(dim=-1)
    out["prompt_flips"], out["new_flips"] = prompt.tolist(), new.tolist()
    return out


def check_decode_vs_forward(arch: str, label: str, res: dict, limit: float = 5e-2) -> float:
    """Every row whose routing agrees on both paths (all rows of a dense
    model) within `limit`; a row above it must show a recorded routing
    difference, and at least half the rows must be held.  Returns the
    largest held difference."""
    flips = [p + n for p, n in zip(res["prompt_flips"], res["new_flips"], strict=True)]
    held = [e for e, f in zip(res["err"], flips, strict=True) if f == 0]
    log(f"  decode step vs teacher-forced forward, {label}: "
        f"max |diff| by row {[round(e, 6) for e in res['err']]}; routing places that differ "
        f"by row, prompt {res['prompt_flips']}, new token {res['new_flips']}; {len(held)} of "
        f"{len(flips)} rows agree, their max |diff| {max(held, default=float('nan')):.6f}")
    check(2 * len(held) >= len(flips),
          f"{arch} ({label}): routing differs on {len(flips) - len(held)} of {len(flips)} rows")
    for e, f in zip(res["err"], flips, strict=True):
        check(e < limit or f > 0, f"{arch} ({label}): decode logits differ from the forward's "
              f"by {e} on a row whose routing agrees")
    return max(held)


def moe_dropped(record: list, cfg) -> tuple:
    """(slots dropped, slots) over a routing record at `cfg`'s capacity: a
    slot drops where its expert already holds `capacity` earlier slots."""
    from repro_torch.models import moe

    dropped = 0
    for top_e in record:
        per_expert = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
        dropped += int((per_expert - moe.capacity(top_e.shape[0], cfg)).clamp(min=0).sum())
    return dropped, sum(t.numel() for t in record)


def serve_arch(device: torch.device, phase: str, arch: str, layers: int | None,
               new_tokens: int, steps: tuple, batch_size: int, prompt: int,
               cache_cap: int) -> dict:
    """ServeEngine.generate (greedy, twice: the same tokens) on `arch` (cut to
    `layers` if given) with `batch_size` SyntheticTokens prompts of `prompt`
    tokens (and frames for the encoder-decoder); prefill + one decode step
    against a teacher-forced forward at that position at each compute of
    `steps`, held within 5e-2 (`check_decode_vs_forward`);
    one decode step profiled; for the MoE the slots dropped at its shipped
    capacity factor."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import moe
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.serve import ServeEngine

    hw = gpu_name_and_power_limit()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = get_api(cfg)
    log(f"== phase {phase}: LM serving, {arch} ({cfg.family}, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {cfg.n_layers} of {get_config(arch).n_layers} layers), {batch_size} "
        f"prompts of {prompt} tokens, {new_tokens} new, cache_cap {cache_cap}, greedy, compute "
        f"{cfg.compute_dtype} ({hw})")
    if device.type == "cuda":
        torch.cuda.synchronize(device)       # the context exists before the reset
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    params = api.init_params(cfg, SEED, device=device)
    n_params = sum(t.numel() for t in _tree_leaves(params))
    log(f"  {n_params} parameters ({n_params * 4 / 1e9:.3f} GB float32; the config's "
        f"count {cfg.param_count()})")
    batch = SyntheticTokens(cfg, DataConfig(seed=SEED, global_batch=batch_size,
                                            seq_len=prompt)).batch(0)
    eng = ServeEngine(cfg, api, params, cache_cap=cache_cap)
    toks, stats = eng.generate(batch, max_new_tokens=new_tokens)
    check(toks.shape == (batch_size, new_tokens) and toks.min() >= 0
          and toks.max() < cfg.vocab, f"{arch}: bad tokens")
    toks2, stats2 = eng.generate(batch, max_new_tokens=new_tokens)
    check(np.array_equal(toks, toks2), f"{arch}: greedy decoding is not deterministic")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"  prefill {stats.prefill_seconds:.4f} s / {stats2.prefill_seconds:.4f} s; decode "
        f"{stats.decode_tokens_per_s:.1f} / {stats2.decode_tokens_per_s:.1f} tokens/s "
        f"({stats2.decode_seconds:.4f} s for {stats2.tokens_generated}); peak memory "
        f"{peak / 1e9:.3f} GB ({hw})")
    on_device = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    tokens, frames = on_device["tokens"], on_device.get("frames")
    entry = dict(tokens=toks, prefill_s=stats2.prefill_seconds,
                 decode_tok_s=stats2.decode_tokens_per_s,
                 peak_gb=peak / 1e9)
    for compute in steps:
        c = dataclasses.replace(cfg, compute_dtype=compute.split()[0])
        res = decode_vs_forward(api, c, params, tokens, cache_cap, frames=frames,
                                float32_kv=compute.endswith("KV"))
        entry[f"decode_vs_forward {compute}"] = check_decode_vs_forward(
            arch, f"compute {compute}", res)
    record = cfg.family == "moe"
    if record:
        moe.start_routing_record()
    last, cache, pos = api.prefill(cfg, params, on_device, cache_cap=cache_cap)
    r_prefill = moe.stop_routing_record() if record else []
    nt = torch.argmax(last, -1)[:, None].to(torch.int32)
    profile_one_search(lambda: api.decode_step(cfg, params, nt, cache, pos), device,
                       what="decode step")
    if record:
        moe.start_routing_record()
        api.decode_step(cfg, params, nt, cache, pos)
        entry["dropped"] = {"prefill": moe_dropped(r_prefill, cfg),
                            "decode step": moe_dropped(moe.stop_routing_record(), cfg)}
        log(f"  slots dropped at capacity factor {cfg.capacity_factor}: prefill "
            f"{entry['dropped']['prefill'][0]} of {entry['dropped']['prefill'][1]}, one "
            f"decode step {entry['dropped']['decode step'][0]} of "
            f"{entry['dropped']['decode step'][1]}")
    del last, cache, params, eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return entry


def phase_lm_serving(device: torch.device, cases=LM_CASES, batch_size: int = LM_BATCH,
                     prompt: int = LM_PROMPT, cache_cap: int = LM_CAP) -> dict:
    """Phase 6d: `serve_arch` on smollm-360m at full size and qwen2-moe-a2.7b
    at full width cut to 4 layers, 8 prompts of 128 SyntheticTokens tokens
    (the MoE's decode step also held at float32 compute)."""
    return {arch: serve_arch(device, "6d", arch, layers, new_tokens, steps, batch_size,
                             prompt, cache_cap)
            for arch, layers, new_tokens, steps in cases}


ENTRY_DOCS, ENTRY_Q, ENTRY_BATCHES = 200_000, 1024, 4
SEARCH_KERNELS = {"eq": "match_count", "multiload": "match_count", "segmented": "match_count",
                  "compacted": "match_count", "cosine": "cosine_count",
                  "tanimoto": "tanimoto_count", 0.1: "minsum_count", 0.3: "minsum_count",
                  "rbh": "match_count", "search": "match_count"}


def check_search_launches(label: str, launches: dict, device: torch.device) -> None:
    for search, counts in launches.items():
        log(f"  {label} search {search!r}: launches {counts}")
        if device.type == "cuda":
            check(counts.get(SEARCH_KERNELS[search], 0) >= 1 and counts.get("cpq_hist", 0) >= 1,
                  f"{label} search {search!r} did not launch "
                  f"{SEARCH_KERNELS[search]} and cpq_hist: {counts}")


def phase_entry_points(device: torch.device, n_docs: int = ENTRY_DOCS,
                       n_queries: int = ENTRY_Q, batches: int = ENTRY_BATCHES,
                       examples: dict | None = None) -> dict:
    """Phase 6e: `launch/serve.main` with smollm-360m's full embedding table
    over 200,000 synthetic documents, then each example at the reference's
    sizes; each search must have launched its count kernel and cpq_hist."""
    from repro_torch.examples import ann_kernel_space, quickstart, sequence_search, serve_batch
    from repro_torch.kernels import common
    from repro_torch.launch import serve as serve_lib

    hw = gpu_name_and_power_limit()
    dev_arg = str(device)
    log(f"== phase 6e: python -m repro_torch.launch.serve --arch smollm-360m --n-docs "
        f"{n_docs} --n-queries {n_queries} --batches {batches} --k 10 --device {dev_arg} ({hw})")
    common.reset_launch_counts()
    out = serve_lib.main(["--arch", "smollm-360m", "--n-docs", str(n_docs), "--n-queries",
                          str(n_queries), "--batches", str(batches), "--k", "10",
                          "--device", dev_arg])
    launches = common.launch_counts()
    for counts in out["launches"]:
        check_search_launches("launch/serve", {"search": counts}, device)
    log(f"  launch/serve: {out['qps']:.1f} queries/s, top-1 self-retrieval "
        f"{out['self_retrieval']:.4f}, indexed in {out['index_seconds']:.3f} s; launches "
        f"{launches} ({hw})")
    check(out["self_retrieval"] >= 0.9, f"launch/serve self-retrieval {out['self_retrieval']}")
    report = {"launch/serve": dict(qps=out["qps"], self_retrieval=out["self_retrieval"],
                                   launches=launches)}
    del out
    examples = examples or {}
    for name, module in (("quickstart", quickstart), ("sequence_search", sequence_search),
                         ("ann_kernel_space", ann_kernel_space),
                         ("serve_batch", serve_batch)):
        log(f"== phase 6e: python -m repro_torch.examples.{name} --device {dev_arg} ({hw})")
        common.reset_launch_counts()
        t0 = time.perf_counter()
        res = module.main(device, **examples.get(name, {}))
        sync(device)
        seconds = time.perf_counter() - t0
        check_search_launches(name, res["launches"], device)
        log(f"  {name}: {seconds:.2f} s, launches {common.launch_counts()}")
        report[name] = dict(seconds=seconds, launches=common.launch_counts(),
                            **{k: v for k, v in res.items()
                               if k in ("self_retrieval", "accuracy", "best", "qps")
                               or k.endswith("_same")})
    check(report["quickstart"]["self_retrieval"] == 1.0,
          f"quickstart self-retrieval {report['quickstart']['self_retrieval']} != 1.000")
    same = {k: report["quickstart"].get(k) for k in
            ("multiload_same", "segmented_same", "compacted_same")}
    check(all(v is True for v in same.values()),
          f"quickstart: a multiload, segmented or compacted search differs: {same}")
    target = examples.get("sequence_search", {}).get("target", 1234)
    check(report["sequence_search"]["best"] == {0.1: target, 0.3: target},
          f"sequence_search did not find its target: {report['sequence_search']['best']}")
    return report


# arch, new tokens, decode-step checks: every family of the slice at its
# full published size.  At bfloat16 the SSM's decode step parts from the
# forward by 0.27 at the logits (PERF.md section 6; by block and beside the
# reference: tools/lm_decode_gap.py), so it is held at float32 compute; the
# hybrid's also needs its K/V cache in float32.
FAMILY_CASES = (
    ("mamba2-1.3b", 32, ("float32",)),
    ("zamba2-2.7b", 16, ("float32 KV",)),
    ("seamless-m4t-large-v2", 32, AT_BF16),
)
FAMILY_PROMPT, FAMILY_CAP = 256, 512          # the FULL configs' ssd_chunk; cap two prompts


def phase_lm_families(device: torch.device, cases=FAMILY_CASES, batch_size: int = LM_BATCH,
                      prompt: int = FAMILY_PROMPT, cache_cap: int = FAMILY_CAP,
                      n_docs: int = ENTRY_DOCS, n_queries: int = ENTRY_Q,
                      batches: int = ENTRY_BATCHES, table: str = "mamba2-1.3b") -> dict:
    """Phase 6f: `serve_arch` on mamba2-1.3b (ssm), zamba2-2.7b (hybrid) and
    seamless-m4t-large-v2 (audio, 256 frames a prompt) at full size, 8
    prompts of 256 SyntheticTokens tokens; then `launch/serve.run` over
    `n_docs` documents embedded through mamba2-1.3b's table, each search
    launching match_count and cpq_hist, self-retrieval >= 0.99 (`table`:
    the arch whose table embeds them)."""
    from repro_torch.launch import serve as serve_lib

    report = {arch: serve_arch(device, "6f", arch, None, new_tokens, steps, batch_size,
                               prompt, cache_cap)
              for arch, new_tokens, steps in cases}
    hw = gpu_name_and_power_limit()
    log(f"== phase 6f: launch/serve.run(arch={table!r}, n_docs={n_docs}, "
        f"n_queries={n_queries}, batches={batches}) ({hw})")
    out = serve_lib.run(arch=table, n_docs=n_docs, n_queries=n_queries, batches=batches,
                        device=device)
    for counts in out["launches"]:
        check_search_launches(f"launch/serve {table}", {"search": counts}, device)
    log(f"  launch/serve {table}: {out['qps']:.1f} queries/s, top-1 self-retrieval "
        f"{out['self_retrieval']:.4f}, indexed in {out['index_seconds']:.3f} s ({hw})")
    check(out["self_retrieval"] >= 0.99,
          f"launch/serve over {table}: self-retrieval {out['self_retrieval']}")
    queries = [out["docs"][i] for i in (np.arange(n_queries) * 7) % n_docs]
    profile_one_search(lambda: out["service"].search(queries, k=10), device)
    report["launch/serve"] = dict(qps=out["qps"], self_retrieval=out["self_retrieval"])
    del out
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return report


TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "smollm-360m", 8, 1024, 20
TRAIN_LR = 1e-3
PEAK_BF16_FLOP_PER_S = 989e12          # dense bfloat16 tensor-core rate (data sheet)
# 6d's and 6f's peak memories on the last release (PERF.md section 2; GB)
SERVING_PEAK_GB = {"smollm-360m": 1.91, "qwen2-moe-a2.7b": 13.3, "mamba2-1.3b": 9.373,
                   "zamba2-2.7b": 12.046, "seamless-m4t-large-v2": 10.168}


def train_flops(cfg, tokens: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x the parameters the tokens pass
    through (the head's d x vocab included, the embedding gather not) x the
    tokens, plus the attention's two [S, S] products, forward and backward
    (the port computes every score of the causal mask); recomputation is not
    counted."""
    n = cfg.param_count()
    attn = 12 * cfg.n_layers * batch * seq * seq * cfg.n_heads * cfg.head_dim
    return 6.0 * n * tokens + attn


def _trainer(cfg, device, *, steps: int, remat, batch: int, seq: int, ckpt_dir=None,
             total_steps: int | None = None, shardings=None):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import get_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, TrainHParams

    hp = TrainHParams(optimizer=AdamWConfig(lr=TRAIN_LR), total_steps=total_steps or steps,
                      warmup_steps=2, remat=remat)
    tc = TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=10 ** 9, log_every=1,
                       seed=SEED)
    return Trainer(cfg, get_api(cfg), hp, tc, DataConfig(seed=SEED, global_batch=batch,
                                                         seq_len=seq),
                   shardings=shardings, device=device)


def _train_run(cfg, device, *, steps: int, remat, batch: int, seq: int, **kw) -> dict:
    """A fresh Trainer for `steps` steps: its history, final state, and the
    peak memory of the run."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    tr = _trainer(cfg, device, steps=steps, remat=remat, batch=batch, seq=seq, **kw)
    hist = tr.run()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return dict(history=hist, state=tr.final_state, peak_gb=peak / 1e9, trainer=tr,
                seconds=[r["seconds"] for r in hist], loss=[r["loss"] for r in hist])


def profile_train_step(run: dict, remat, device: torch.device) -> None:
    """One more step of a finished run under the profiler (the state is
    updated in place): the device's busy share and its kernels."""
    tr = run["trainer"]
    batch = tr.pipeline.batch(len(run["history"]))
    profile_one_search(lambda: tr.step_fn(run["state"], batch), device,
                       what=f"training step (remat {remat!r})")


def _state_leaves(state) -> list:
    from repro_torch.tree import leaves

    return (leaves(state.params) + leaves(state.opt.m) + leaves(state.opt.v)
            + [state.opt.step])


def determinism_cost(cfg, device, batch: int, seq: int, reps: int = 5) -> dict:
    """The embedding gradient at the training shape: `layers.gather_rows`
    (a deterministic scatter) against the default backward of
    `table[tokens]`, `reps` runs of each (the median of all but the first);
    whether each repeats its bits, and how far the two are apart."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.device import synchronize
    from repro_torch.models import layers as L

    gen = torch.Generator(device=device).manual_seed(SEED)
    table = (torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=device) * 0.02
             ).requires_grad_(True)
    tokens = torch.from_numpy(SyntheticTokens(cfg, DataConfig(
        seed=SEED, global_batch=batch, seq_len=seq)).batch(0)["tokens"]).to(device).long()
    upstream = torch.randn((batch, seq, cfg.d_model), generator=gen, device=device)
    out, first = {}, {}
    for name, gather in (("gather_rows", lambda: L.gather_rows(table, tokens)),
                         ("default", lambda: table[tokens])):
        grads, times = [], []
        for _ in range(reps):
            rows = gather()
            synchronize(device)
            t0 = time.perf_counter()
            (g,) = torch.autograd.grad(rows, table, upstream)
            synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
            grads.append(g)
        out[name] = dict(ms=statistics.median(times[1:] or times),
                         repeats=all(torch.equal(grads[0], x) for x in grads[1:]))
        first[name] = grads[0]
    out["max_abs_diff"] = float((first["gather_rows"] - first["default"]).abs().max())
    return out


def phase_training(device: torch.device, arch: str = TRAIN_ARCH, batch: int = TRAIN_BATCH,
                   seq: int = TRAIN_SEQ, steps: int = TRAIN_STEPS, remat_steps: int = 3,
                   serving: dict | None = None, min_fall: float = 0.5) -> dict:
    """Phase 7: training on the card (see the module docstring)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import checkpointer
    from repro_torch.models.registry import get_config

    hw = gpu_name_and_power_limit()
    cfg = get_config(arch)
    tokens = batch * seq
    log(f"== phase 7: training {arch} (d_model {cfg.d_model}, {cfg.n_layers} layers, vocab "
        f"{cfg.vocab}, {cfg.param_count()} parameters), float32 parameters and moments, "
        f"{cfg.compute_dtype} compute, {batch} x {seq} tokens a step, lr {TRAIN_LR} ({hw})")
    report = {}
    run = _train_run(cfg, device, steps=steps, remat="nothing", batch=batch, seq=seq)
    secs, loss = run["seconds"], run["loss"]
    median = statistics.median(secs[1:])
    flops = train_flops(cfg, tokens, batch, seq)
    log(f"  remat 'nothing', {steps} steps: first step {secs[0]:.4f} s, median of the rest "
        f"{median:.4f} s (min {min(secs[1:]):.4f}, max {max(secs[1:]):.4f}), "
        f"{tokens / median:.1f} tokens/s, peak memory {run['peak_gb']:.3f} GB ({hw})")
    log(f"  model FLOPs a step {flops / 1e12:.3f} TFLOP (6 x {cfg.param_count()} x {tokens} "
        f"+ attention), {flops / median / 1e12:.2f} TFLOP/s, "
        f"{100 * flops / median / PEAK_BF16_FLOP_PER_S:.2f} % of the dense bfloat16 peak "
        f"({PEAK_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s at 700 W) ({hw})")
    log(f"  loss: step 1 {loss[0]:.4f}, step {steps} {loss[-1]:.4f} (fell by "
        f"{loss[0] - loss[-1]:.4f}); every step: {[round(x, 4) for x in loss]}")
    check(all(np.isfinite(loss)), f"{arch}: a loss is not finite: {loss}")
    check(loss[0] - loss[-1] >= min_fall,
          f"{arch}: the loss fell by {loss[0] - loss[-1]:.4f} in {steps} steps, below {min_fall}")
    report["nothing"] = dict(first_s=secs[0], median_s=median, tokens_per_s=tokens / median,
                             peak_gb=run["peak_gb"], loss_first=loss[0], loss_last=loss[-1],
                             flops=flops, peak_share=flops / median / PEAK_BF16_FLOP_PER_S,
                             losses=list(loss))
    profile_train_step(run, "nothing", device)
    del run
    for remat in ("none", "dots"):
        r = _train_run(cfg, device, steps=remat_steps, remat=remat, batch=batch, seq=seq)
        med = statistics.median(r["seconds"][1:])
        log(f"  remat {remat!r}, {remat_steps} steps: step times "
            f"{[round(x, 4) for x in r['seconds']]} s, median of the last "
            f"{remat_steps - 1} {med:.4f} s, {tokens / med:.1f} tokens/s, peak memory "
            f"{r['peak_gb']:.3f} GB ({hw})")
        check(all(np.isfinite(r["loss"])), f"remat {remat}: a loss is not finite")
        report[remat] = dict(median_s=med, peak_gb=r["peak_gb"], tokens_per_s=tokens / med)
        if remat == "dots":
            profile_train_step(r, remat, device)
        del r
    cost = determinism_cost(cfg, device, batch, seq)
    log(f"  embedding gradient [{cfg.vocab}, {cfg.d_model}] from {batch} x {seq} tokens: "
        f"gather_rows (deterministic) {cost['gather_rows']['ms']:.4f} ms, repeats its bits "
        f"{cost['gather_rows']['repeats']}; default backward {cost['default']['ms']:.4f} ms, "
        f"repeats its bits {cost['default']['repeats']}; max |difference| "
        f"{cost['max_abs_diff']:.3g} ({hw})")
    check(cost["gather_rows"]["repeats"], "gather_rows' gradient changed between runs")
    report["determinism"] = cost

    # bit-exact resume: 4 straight steps == 2 steps + checkpoint + 2 steps
    straight = _train_run(cfg, device, steps=4, remat="nothing", batch=batch, seq=seq)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        first = _train_run(cfg, device, steps=2, remat="nothing", batch=batch, seq=seq,
                           ckpt_dir=ckpt_dir, total_steps=4)
        mid = time.perf_counter()
        resumed = _train_run(cfg, device, steps=4, remat="nothing", batch=batch, seq=seq,
                             ckpt_dir=ckpt_dir)
        end = time.perf_counter()
        size = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(ckpt_dir)
                   for f in fs)
        check(checkpointer.latest_step(ckpt_dir) == 4, "the resumed run saved no step 4")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    got, want = _state_leaves(resumed["state"]), _state_leaves(straight["state"])
    same = [torch.equal(a, b) for a, b in zip(got, want, strict=True)]
    log(f"  resume: 2 steps + checkpoint ({first['history'][-1]['step']} steps, "
        f"{mid - t0:.2f} s with the save) + a fresh Trainer to step 4 ({end - mid:.2f} s with "
        f"the restore); the directory held {size / 1e9:.3f} GB at the end (two checkpoints); "
        f"{sum(same)} of {len(same)} leaves (parameters, m, v, step) equal bit for bit to 4 "
        f"straight steps; losses {[round(x, 4) for x in straight['loss']]} straight, "
        f"{[round(x, 4) for x in first['loss'] + resumed['loss']]} resumed ({hw})")
    check(all(same), f"the resumed state differs from the straight one in "
                     f"{len(same) - sum(same)} of {len(same)} leaves")
    check(int(resumed["state"].opt.step) == 4, "the resumed run did not reach step 4")
    report["resume"] = dict(leaves=len(same), equal=sum(same), checkpoint_gb=size / 2e9)
    del straight, first, resumed

    if serving:
        for name, peak in serving.items():
            was = SERVING_PEAK_GB.get(name)
            log(f"  serving peak memory {name}: {peak:.3f} GB (last release {was} GB) ({hw})")
            check(was is None or peak <= was * 1.05,
                  f"{name}: serving peak memory {peak:.3f} GB above the last release's {was}")
        report["serving_peak_gb"] = dict(serving)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# Phase 8: sharding on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

TRAIN_LAUNCH_STEPS = 3
DRYRUN_MODEL_TOLERANCE = 0.25


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _state_shardings(cfg, mesh):
    from repro_torch.launch import shapes, sharding
    from repro_torch.models.registry import get_api
    from repro_torch.train import step as tsl

    pshapes = shapes.param_specs(cfg, get_api(cfg))
    psh = sharding.params_shardings(pshapes, mesh, cfg.use_tp)
    return sharding.state_shardings(tsl.TrainState(pshapes, None, None), psh, mesh)


def phase_sharded_training(device: torch.device, phase7: dict, arch: str = TRAIN_ARCH,
                           batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                           steps: int = TRAIN_STEPS) -> dict:
    """8a and 8b (see the module docstring); `phase7` is phase 7's report."""
    import shutil
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import checkpointer
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import get_config

    hw = gpu_name_and_power_limit()
    cfg = get_config(arch)
    tokens = batch * seq
    log(f"== phase 8a: launch/train.main on {arch}, {TRAIN_LAUNCH_STEPS} steps of {batch} x "
        f"{seq} tokens, through the shardings of a one-rank mesh ({hw})")
    t0 = time.perf_counter()
    hist = launch_train.main(["--arch", arch, "--steps", str(TRAIN_LAUNCH_STEPS),
                              "--global-batch", str(batch), "--seq", str(seq),
                              "--lr", str(TRAIN_LR)] +
                             (["--device", device.type] if device.type != "cuda" else []))
    log(f"  launch/train: {len(hist)} logged steps in {time.perf_counter() - t0:.2f} s, "
        f"losses {[round(r['loss'], 4) for r in hist]} ({hw})")
    check(len(hist) >= 1 and all(np.isfinite(r["loss"]) for r in hist),
          "launch/train: a loss is not finite")
    mesh = mesh_lib.make_local_mesh(1, device)
    ssh = _state_shardings(cfg, mesh)
    run = _train_run(cfg, device, steps=steps, remat="nothing", batch=batch, seq=seq,
                     shardings=ssh)
    state_leaves, specs = _state_leaves(run["state"]), sharding.leaves_of(ssh)
    placed = [isinstance(x, DTensor) and tuple(x.placements) == sh.placements
              and x.device.type == device.type for x, sh in zip(state_leaves, specs, strict=True)]
    check(all(placed), f"{len(placed) - sum(placed)} of {len(placed)} state leaves are not "
                       f"DTensors on their spec's placements")
    loss, want = run["loss"], phase7["nothing"]["losses"]
    diff = [abs(a - b) for a, b in zip(loss, want, strict=True)]
    bits = sum(a == b for a, b in zip(loss, want))
    median = statistics.median(run["seconds"][1:])
    base = phase7["nothing"]["median_s"]
    log(f"  sharded Trainer, remat 'nothing', {steps} steps: {len(placed)} state leaves, every "
        f"one a DTensor on its spec's placements; losses within {max(diff):.3g} of phase 7's "
        f"(bound 1e-4), {bits} of {len(loss)} equal bit for bit")
    log(f"  step time median {median:.4f} s against phase 7's {base:.4f} s "
        f"({100 * (median / base - 1):+.2f} %: DTensor's dispatch on one rank), "
        f"{tokens / median:.1f} tokens/s, peak memory {run['peak_gb']:.3f} GB (phase 7: "
        f"{phase7['nothing']['peak_gb']:.3f} GB) ({hw})")
    check(max(diff) <= 1e-4, f"sharded losses differ from phase 7's by {max(diff):.3g}")
    report = {"8a": dict(median_s=median, phase7_median_s=base, tokens_per_s=tokens / median,
                         peak_gb=run["peak_gb"], loss_max_diff=max(diff), bit_equal=bits,
                         steps=len(loss), leaves=len(placed))}
    del run

    log(f"== phase 8b: sharded resume and restore onto a new one-rank mesh ({hw})")
    straight = _train_run(cfg, device, steps=4, remat="nothing", batch=batch, seq=seq,
                          shardings=ssh)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        first = _train_run(cfg, device, steps=2, remat="nothing", batch=batch, seq=seq,
                           ckpt_dir=ckpt_dir, total_steps=4, shardings=ssh)
        resumed = _train_run(cfg, device, steps=4, remat="nothing", batch=batch, seq=seq,
                             ckpt_dir=ckpt_dir, shardings=ssh)
        got = [_whole(x) for x in _state_leaves(resumed["state"])]
        want = [_whole(x) for x in _state_leaves(straight["state"])]
        same = [torch.equal(a, b) for a, b in zip(got, want, strict=True)]
        new_mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device)
        new_ssh = _state_shardings(cfg, new_mesh)
        t0 = time.perf_counter()
        restored, _ = checkpointer.restore(ckpt_dir, 4, resumed["state"], new_ssh)
        restore_s = time.perf_counter() - t0
        back = [_whole(x) for x in _state_leaves(restored)]
        on_new = all(x.device_mesh is new_mesh for x in _state_leaves(restored))
        equal = [torch.equal(a, b) for a, b in zip(back, got, strict=True)]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"  2 steps + checkpoint + a fresh sharded Trainer to step 4: {sum(same)} of "
        f"{len(same)} leaves equal bit for bit to 4 straight sharded steps; losses "
        f"{[round(x, 4) for x in straight['loss']]} straight, "
        f"{[round(x, 4) for x in first['loss'] + resumed['loss']]} resumed")
    log(f"  restored with shardings onto a new one-rank mesh in {restore_s:.2f} s: {sum(equal)} "
        f"of {len(equal)} leaves equal the saved ones, every leaf on the new mesh {on_new} "
        f"({hw})")
    check(all(same), f"the sharded resume differs in {len(same) - sum(same)} leaves")
    check(all(equal) and on_new, "the restore onto the new mesh differs from the saved leaves")
    report["8b"] = dict(leaves=len(same), resume_equal=sum(same), restore_equal=sum(equal),
                        restore_s=restore_s)
    del straight, first, resumed, restored, got, want, back
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return report


def phase_sharded_serving(device: torch.device, unsharded: dict, arch: str = "smollm-360m",
                          new_tokens: int = 32, batch_size: int = LM_BATCH,
                          prompt: int = LM_PROMPT, cache_cap: int = LM_CAP) -> dict:
    """8c: `ServeEngine` on parameters placed by `params_shardings(...,
    use_tp_serve)`, the caches by `cache_shardings`; the tokens equal 6d's
    (`unsharded`: 6d's entry for `arch`)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.models import partition
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.serve import ServeEngine

    hw = gpu_name_and_power_limit()
    cfg = get_config(arch)
    api = get_api(cfg)
    log(f"== phase 8c: sharded serving, {arch}, {batch_size} prompts of {prompt} tokens, "
        f"{new_tokens} greedy steps, cache_cap {cache_cap} ({hw})")
    mesh = mesh_lib.make_local_mesh(1, device)
    params = api.init_params(cfg, SEED, device=device)
    placed = sharding.place_tree(params, sharding.params_shardings(params, mesh,
                                                                   cfg.use_tp_serve))
    del params
    batch = SyntheticTokens(cfg, DataConfig(seed=SEED, global_batch=batch_size,
                                            seq_len=prompt)).batch(0)
    eng = ServeEngine(cfg, api, placed, cache_cap=cache_cap)
    toks, stats = eng.generate(batch, max_new_tokens=new_tokens)
    on_device = eng._on_device(batch)
    with partition.sharded_scope(mesh):
        _, cache, _ = api.prefill(cfg, placed, on_device, cache_cap=cache_cap)
        csh = sharding.cache_shardings(cfg, cache, mesh)
        cache = sharding.place_tree(cache, csh)
    cache_ok = all(isinstance(cache[k], DTensor) and tuple(cache[k].placements)
                   == csh[k].placements for k in csh)
    want = unsharded["tokens"]
    same = int((toks == want).all(axis=1).sum())
    log(f"  cache specs {({k: v.spec for k, v in csh.items()})}, every entry a DTensor on "
        f"its placements {cache_ok}; {same} of {batch_size} rows equal 6d's tokens; prefill "
        f"{stats.prefill_seconds:.4f} s, decode {stats.decode_tokens_per_s:.1f} tokens/s "
        f"(6d: {unsharded['decode_tok_s']:.1f}) ({hw})")
    check(cache_ok, "a cache entry is not on its cache_shardings placements")
    check(np.array_equal(toks, want), f"sharded serving's tokens differ from 6d's in "
                                      f"{batch_size - same} rows")
    del placed, eng, cache
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(rows_equal=same, decode_tok_s=stats.decode_tokens_per_s,
                prefill_s=stats.prefill_seconds)


def phase_lm_dryrun(device: torch.device, measured_peak_gb: float, arch: str = TRAIN_ARCH,
                    batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """8d: every LM cell of the dry-run, and its memory model of 8a's run
    against 8a's measured peak."""
    from repro_torch.configs import ALL_ARCHS
    from repro_torch.launch import dryrun, shapes

    hw = gpu_name_and_power_limit()
    log(f"== phase 8d: the LM dry-run, {len(ALL_ARCHS)} archs x {len(shapes.SHAPES)} shapes x "
        f"{len(dryrun.LM_MESHES)} meshes ({hw})")
    t0 = time.perf_counter()
    n = fits = 0
    for a in ALL_ARCHS:
        for shape in shapes.SHAPES:
            for mk in dryrun.LM_MESHES:
                rep = dryrun.run_and_save_lm(a, shape, mk, force=True)
                n += 1
                fits += int(rep.get("skipped") or rep["memory"]["fits"])
    log(f"  {n} cells in {time.perf_counter() - t0:.2f} s; {fits} fit or are skipped")
    check(n == 160, f"the dry-run wrote {n} LM cells, not 160")
    rep = dryrun.lm_cell(arch, shapes.ShapeSpec("phase8a", "train", seq, batch),
                         {"data": 1, "model": 1})
    model = rep["memory"]["per_rank"]["peak"] / 1e9
    ratio = model / measured_peak_gb if measured_peak_gb else float("nan")
    log(f"  model of {arch} training at {batch} x {seq} on world1: "
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in rep["memory"]["per_rank"].items())
        + f" GB; measured peak (8a) {measured_peak_gb:.3f} GB; model / measured {ratio:.3f} "
          f"({hw})")
    if device.type == "cuda":
        check(abs(ratio - 1) <= DRYRUN_MODEL_TOLERANCE,
              f"the dry-run's model {model:.3f} GB is not within 25 % of the measured "
              f"{measured_peak_gb:.3f} GB")
    return dict(cells=n, model_gb=model, measured_gb=measured_peak_gb, ratio=ratio)


def phase_sharding(device: torch.device, phase7: dict, serving: dict) -> dict:
    """Phase 8 (8a to 8d) in the one-rank process group `launch.mesh`
    starts; the group is destroyed after it."""
    import torch.distributed as dist

    report = phase_sharded_training(device, phase7)
    report["8c"] = phase_sharded_serving(device, serving["smollm-360m"])
    report["8d"] = phase_lm_dryrun(device, report["8a"]["peak_gb"])
    dist.destroy_process_group()
    log("  sharding: " + json.dumps(report))
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one "
              "CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    phase_environment_and_build()
    parity_err = phase_kernel_parity(device)
    phase_small_service(device)
    phase_small_simhash(device)
    phase_small_minhash(device)
    phase_small_sa(device)
    phase_multiload_pads(device)
    phase_small_routing(device)
    full = phase_full_width(device)
    svc = full["service"]
    search_split(svc, full["queries"], FULL_K, device)
    profile_one_search(service_search(full, FULL_K), device)
    kernels = phase_kernel_times(svc._index.segments[0].data, full["qsigs"], svc.m,
                                 full["launches"], parity_err, device)
    phase_multiload_eq(full, device)
    phase_routing_full_width(full, device)
    frontend = phase_frontend(full, device)
    log("== phase 5 (block shapes): match_count's two shapes at the SIFT segment shape")
    kernels.append(eq_variant_times(
        "match_count", svc._index.segments[0].data, full["qsigs"],
        frontend["shapes"]["shapes"]["match_count[tile_q=32]"], parity_err, device))
    phase_autotune(full, "SIFT e2lsh", device, singles=True)
    del full, svc                          # free the EQ corpus before the distributed phase
    torch.cuda.empty_cache()
    distributed_report = phase_distributed(device)
    torch.cuda.empty_cache()
    simhash = phase_full_width_simhash(device)
    count_launches = phase_multiload_packed(simhash["packed"], "simhash", "packed_cosine_count",
                                            device).get("packed_cosine_count", 0)
    kernels += phase_cosine_kernel_times(simhash, count_launches, parity_err, device)
    tile_times = {}
    kernels.append(fused_tile_times(simhash["packed"], "packed_cosine_topk", tile_times,
                                    device, parity_err))
    phase_autotune(simhash["packed"], "simhash PACKED", device)
    del simhash                            # free the simhash corpus before the minhash one
    torch.cuda.empty_cache()
    minhash = phase_full_width_minhash(device)
    tanimoto_launches = phase_multiload_packed(minhash["packed"], "minhash",
                                               "packed_tanimoto_count", device).get(
                                                   "packed_tanimoto_count", 0)
    kernels += phase_tanimoto_kernel_times(minhash, tanimoto_launches, parity_err, device)
    kernels.append(fused_tile_times(minhash["packed"], "packed_tanimoto_topk", tile_times,
                                    device, parity_err))
    log("== phase 4c (single requests): the minhash WIDE service, Q = 1 and 16")
    singles = single_requests(minhash["wide"]["service"], minhash["wide"]["queries"], device,
                              sizes=(1, 16), reps=3, label="minhash WIDE")
    check(singles["shapes"].get("tanimoto_count[tile_q=32]", 0) > 0,
          "the single requests never launched tanimoto_count's 32-row shape")
    kernels.append(eq_variant_times(
        "tanimoto_count", minhash["wide"]["service"]._index.segments[0].data,
        minhash["wide"]["qsigs"], singles["shapes"]["tanimoto_count[tile_q=32]"], parity_err,
        device, qs=(1, 1024)))
    del minhash
    torch.cuda.empty_cache()
    phase_full_width_rbh(device)
    torch.cuda.empty_cache()
    for phase, kernel_times in ((phase_full_width_adult, range_kernel_times),
                                (phase_full_width_dblp, minsum_kernel_times),
                                (phase_full_width_tweets, ip_kernel_times)):
        run = phase(device)
        if phase is phase_full_width_adult:
            phase_frontend_range(run, device)
        run["index"].segments[1:] = []     # the kernel times need one segment
        torch.cuda.empty_cache()
        timed = kernel_times(run, parity_err, device)
        kernels += timed if isinstance(timed, list) else [timed]
        del run                            # free the corpus before the next one
        torch.cuda.empty_cache()
    phase_multiload_dblp(device)
    torch.cuda.empty_cache()
    phase_postings_sift(device)
    phase_postings_balance(device)
    phase_dryrun_memory(device, distributed_report)
    lm = phase_lm_serving(device)
    phase_entry_points(device)
    families = phase_lm_families(device)
    serving_peaks = {arch: r["peak_gb"] for arch, r in {**lm, **families}.items()
                     if isinstance(r, dict) and "peak_gb" in r}
    phase7 = phase_training(device, serving=serving_peaks)
    phase_sharding(device, phase7, lm)
    torch.cuda.synchronize()
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(gpu_name_and_power_limit())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
