#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (svtrek_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero before the
last line:

1. environment: torch version, the card's name and power limit; no CUDA
   device is a failure;
2. build: kernels K1 (svtrek_tpu_torch/csrc/consensus.cu), K2 and K3
   (csrc/poa.cu), K4 (csrc/step_probe.cu) and G1 (csrc/poa_graph.cu),
   nvcc for sm_90a, one process per source, from the sources in this
   checkout, with ptxas's register report;
3. kernel: K1 against its plain PyTorch version on the card at the bench
   shapes, the main path's shape, the device-extract path's (512, 1024)
   and edge rows, exact integer equality,
   plus 256 rows against tools/audt_scalar.py's scalar consensus;
   CUDA-event times of both, and at every shape the profiler's time of K1
   alone beside a launch floor (one int32 elementwise op on a [B] tensor,
   which the port never calls); then the second pass's full sweep, K1 at
   W = K against the bounded plain version (`consensus_pos_full`) at
   (64, 2,048) and (8, 16,384), no overflow flag, timed the same way;
4. POA kernels: K2 (banded DP pointers: its strip kernel, a warp a pair,
   and its wide kernel, eight warps a pair for bands above 527) and K3
   (traceback) against their plain PyTorch versions on the card, on seeded
   pair batches (the bench's 256-pair call, 4,096 short pairs, a
   flush-like mix of insert lengths, bands of 256 and 512, degenerate
   pairs, the query that overruns its target by 37 bases, `wide2k`: bands
   of 513-2,048 that take both K2 kernels, `longrun`: K3's left runs
   longer than its window and long up runs, and `wide_main`: the wide
   kernel's pairs as the spread sites of phase 16 make them, members
   540-700 bases longer or shorter than a seed of 3,000-3,400, and a few
   at bands 1,024-2,048 with n past 5,000): pointers (every byte of every
   pair's band), cols and ins exactly equal, K2 and K3 on one plan
   (`dp_cols`'s route) too; CUDA-event times of both, of K2's launch plan
   alone, of K2 + K3 on one plan, and the bounds of K2 and K3, the
   profiler's time of the kernels alone, without the wrappers' host work,
   and K3's longest walk in steps and ns a step; on `wide2k`, `longrun`
   and `wide_main` the profiler's time of K2's wide kernel alone on its
   pairs, their bound and the cycles a row of the longest of them (at
   1.98 GHz), and on `wide_main` the wrapper's and the plain version's
   CUDA-event times;
5. step probe: K4 against its plain version on the default input of
   tools/torch_step_overhead.py (1280 x 256 x 256) and on int8 over its
   whole range at 1000 x 100 x WP, with WP and base alignments that take
   each of K4's 16-, 4- and 1-byte loads, and at rows of more than the
   1,024 vectors a block reads at a time with each load width, every
   rows_per in 1, 2, 4, 8, in one launch and in one launch per step,
   exactly equal; then the probe's own path
   (tools/torch_step_overhead.py's measure, K4 in both launch modes beside
   the plain version and the one library call, CUDA-event medians), which
   must launch K4, and K4's bound beside it;
6. main path: `python -m svtrek_tpu_torch.cli audt --device cuda` (run in
   this process, so the launch counts can be read) on the 5,000-record
   synthetic long-read benchmark fixture of tools/bench_e2e.py (built by
   its copy on the port's BAM writer, tools/torch_fixtures.py); its result
   lines must be byte-identical to those of tools/audt_scalar.py (an
   independent scalar audt that decodes the BAM itself), K1 must have run
   once per batch or more, the plain path never, and the refined
   breakpoints must land within 5 bp of the planted truth;
7. ins-consensus path: `audt --ins-consensus --device cuda --verbose` on
   the 2,000-site fixture of tools/ins_fixture.py; K1 must have run once
   per batch and K2 and K3 once per DP batch of every consensus flush, the
   plain paths never; `band_scalar` must count only degenerate pairs (band
   >= m + n: every band up to K2's 2,048 goes to the card, `band_wide`
   counts those past the JAX package's 512), and each DP batch's cols and
   ins must come back at each pair's own width, in at most 1.1 x (sum m +
   4 sum (m + 1)) bytes of pinned memory; the first 500 sites' lines
   (every insert-length class) must equal an in-process `--device cpu`
   run and a `--device cuda` run of those sites, with the same band-route
   counts on both, the part before `, seq:` must be
   byte-identical to tools/audt_scalar.py, and the `seq:` field equal to
   its scalar star consensus on a subset of sites from every insert-length
   class;
8. disc path: `disc --device cuda` (svtrek_tpu_torch.pipeline.discover,
   in this process, configured by the CLI's parser) on the 500,000-read
   fixture of tools/bench_disc.py; the scan must run on the card in every
   batch, K2 and K3 once per DP batch of the insertion consensus, the
   plain paths never; every line must equal an in-process `--device cpu`
   run, the part before `, seq:` must be byte-identical to
   tools/disc_scalar.py (an independent scalar disc on the Python GAF
   projection) and the `seq:` field equal to its scalar star consensus on
   8 insertion clusters, the largest among them;
9. device extract: `audt --extract device --device cuda` on the fixture
   of phase 6: the C reader fetches, the card walks the CIGARs
   (svtrek_tpu_torch.ops.cigar), groups the candidates and runs K1 at
   (512, 1024); the lines must be byte-identical to phase 6's (which
   equal tools/audt_scalar.py's), the walk must have run on the card once
   per batch, K1 once per batch or more, the plain consensus never; then
   the CUDA-event time of one batch's device step;
10. Python BAM path, reduced: tools/torch_fixtures.py's 500-record fixture
   (the Python reader at 60.2 M ops would take minutes): `audt
   --no-native-io` on cuda and on cpu, equal to each other and to
   tools/audt_scalar.py, the walk on the card once per batch; `scan` over
   the whole chromosome on the native path on cuda and on cpu, and on a
   6 Mbp sub-region on the native and the `--no-native-io` path on cuda
   (the Python path fetches each tile), all equal to tools/scan_scalar.py,
   an independent scalar scan;
11. scan, full size: `scan -c 1 -s 1 -e 120000000 --device cuda` on the
   fixture of phase 6 (120,000 tiles, 15 batches of 8,192), the window
   scan on the card once per batch, the lines equal to a `--device cpu`
   run;
12. standalone: the script refuses every import of `jax`, `jaxlib` and the
   JAX package `svtrek_tpu` from its first line on, and checks at the end,
   after phase 14, that none was loaded;
13. graph POA kernel (run after phase 5, beside the other kernels' checks): G1 (csrc/poa_graph.cu, the graph POA's DP and
   traceback) against its plain PyTorch version on the card, on seeded
   (graph, query) batches: the ins mix (256 pairs, inserts of 50-1,024
   bases, graphs of 2-12 earlier members at 2 % substitutions and 1 %
   insertions and deletions, grown on the card), a graph of V_CAP 2,048
   nodes with queries of N_CAP 1,024 bases, a node with P_CAP 32
   predecessors, and edge pairs (V = 1, n = 1, queries of N, identical
   members), `long`, past those caps, the JAX package's routing
   caps (a graph of 3 copies of a
   4,000-base insert with a query of 4,096 bases, and a two-allele graph of
   two 4,096-base alleles with V past 8,192, grown on the card), and at
   G1's own caps `xlong` (a two-allele graph of two 8,600-base alleles,
   V past 16,384, queries past 8,192: a ring of 4 rows) and `n_cap` (a
   query of 16,384 bases: a ring of 2 rows); score, matched and ins_after
   exactly equal; each batch's ring rows (`kernels.graph_ring_rows` of its
   longest query); CUDA-event times of the wrapper and of the plain
   version on the ins mix (on `long`, `xlong` and `n_cap` the plain
   check's wall time), the profiler's time of G1 alone and its bound on
   those four, the ins mix's share of filled predecessor slots within
   G1's shared ring, and the recorded times of the block-per-pair design
   it replaced (commit c6ff5e5); and the wrapper must refuse a live row
   without a predecessor;
14. graph POA paths: `audt --ins-consensus --poa-engine graph --device
   cuda` on the first 400 sites of phase 7's fixture whose insert is at
   most 700 bases: K1 once per batch or more, G1 once per DP round or
   more, the plain paths never, no cluster on the scalar route; the lines
   before `, seq:` byte-identical to phase 7's lines of the same records,
   `seq:` equal to the port's scalar graph consensus
   (`consensus_sequence_poa`, through tools/audt_scalar.py) on 2 sites of
   each length class, the first 40 sites' lines equal to a `--device cpu`
   run.  Then the long sites: the first 64 sites whose insert passes the
   JAX package's N_CAP 1,024 (its scalar route) and whose every allele
   stays within 4,000 bases, and the cheapest such site (site 675),
   on the card with the same checks (no cluster on the scalar route, the
   lines before `, seq:` equal to phase 7's), G1's wrapper time a DP
   round, the first site's line equal to a `--device cpu` run, and the
   cheapest site's seq equal to the scalar `consensus_sequence_poa` of its
   inserts (timed) and to `consensus_sequence_poa_batch` on the card.
   Then the xlong sites: every site whose longest allele passes 4,000
   bases (45 sites, to 6,416 bases), on the card with the same checks, a
   query past 4,096 bases on G1, the sites/s, rounds, G1's launches and
   wrapper time a round, the largest V and n, and the cheapest such
   site's line equal to a `--device cpu` run.
   `disc --poa-engine graph --device cuda` on phase 8's fixture: G1 once
   per DP round or more, the plain paths never, the lines before `, seq:`
   equal to phase 8's, every line equal to a `--device cpu` graph run, and
   `seq:` equal to the scalar graph consensus on phase 8's 8 clusters;
15. multi-device (run after phase 11; svtrek_tpu_torch.parallel.mesh):
   (a) the four sharded steps at 2 and 4 shards on streams of cuda:0,
   at the main path's widths (audit and CSR audit: B 512, 8 reads a
   window, K 16 and 1,024; consensus B 512 x K 16; disc N 8,192), each
   equal to the same step on CPU shards and to the dense step, K1 once
   per shard per call; 50 consensus dispatches of different batches made
   before the first collect, each equal to the plain version; one batch's
   step time at 1, 2 and 4 shards; (b) `audt --data-shards 4 --device
   cuda` and `--extract device --data-shards 4` on phase 6's fixture,
   lines equal to phase 6's (and 9's), K1 4 times a batch, and `disc
   --data-shards 4` on phase 8's fixture, lines equal to phase 8's, the
   scan on the card 4 times a batch; (c) the audt CLI in a subprocess
   with SVTREK_COORDINATOR, SVTREK_NUM_PROCS=1 and SVTREK_PROC_ID=0
   (NCCL at world size 1), lines equal to phase 6's, and two gloo
   processes on cuda:0 (this script with `--dist-worker`), 2 shards
   each, whose assembled consensus and disc rows equal the dense steps'
   and whose `init_distributed` returns 4;
16. spread-length sites (run after phase 7): `audt --ins-consensus
   --device cuda` on the 40 sites of tools/ins_fixture.py's
   `build_spread_fixture` (a synthetic stress shape for K2's wide class:
   tandem-repeat inserts whose 12-20 reads spread evenly over +-20 % of a
   median of 3,000-3,400 bases, so that the median seed meets members
   600-680 bases away): K2's wide kernel must have launched, `band_wide`
   and `band_wide_k2` (the pairs past 527) be above 0, K1 once per batch,
   K3 once per DP batch, the plain paths never, `band_scalar` degenerate
   pairs only and the copy back pinned; K2's CUDA-event time a DP batch;
   the lines before `, seq:` byte-identical to tools/audt_scalar.py; and
   on the first 24 sites, `--device cuda` and `--device cpu` runs whose
   lines equal each other and the 40-site run's, with the same band
   counts;
17. routes (run after phase 9): the routes that the JAX package's static
   shapes send to the host, on two synthetic route fixtures of
   tools/torch_fixtures.py (shapes that reach a route, not user traffic).
   `disc --device cuda` on the dense disc fixture (24,576 reads of 1 kb,
   30 % with one deletion or clip of 60 bases or more, about 2,450 hits a
   batch of 8,192): `rescans` 0 and a second page a batch or more (the
   hits past the first page's 2,048, compacted on the card), the scan on
   the card once per page, K2 and K3 once per DP batch, the lines equal
   to a `--device cpu` run and, before `, seq:`, to tools/disc_scalar.py;
   the first batch's two pages held to one page of its total and timed
   (CUDA events).  `audt --extract device` and `audt --no-native-io` on
   the route BAM (64 records; windows with a read of 20,000-40,000 CIGAR
   ops, or one of 10-16 candidates): `long_ops` 0 and `dev_ovf` 0, the
   walk and K1 on the card every batch, the lines equal to
   tools/audt_scalar.py and to a `--device cpu` run;
18. deep routes (run after phase 17): the windows past the first passes'
   widths, on the deep BAM of tools/torch_fixtures.py (64 records, 16 of
   150-400 supporting reads and 8 of 1,100-2,500; a synthetic route
   fixture, not user traffic).  `audt` on the host path, `--extract
   device` and `--no-native-io` (batches of 32 windows), on cuda and on
   cpu: the lines equal to tools/audt_scalar.py and to each other;
   `kovf`, `sweep` and `dev_ovf` 0; `wide_k` above 0 on every path and
   `sweep_full` above 0 on the device walk (the host path's first pass
   holds n <= K = W, so its sweep cannot overflow at the defaults), both
   equal on the two devices; K1 launched once for every first pass and
   once for every second pass (a batch that holds a deep window), the
   plain consensus never.  `scan` of a region holding a first- and a
   second-tier INS record (native) and of the second one's tiles
   (`--no-native-io`): lines equal to tools/scan_scalar.py and to cpu,
   `fallbacks` 0, `wide_k` above 0, the window scan on the card once a
   batch and once a second batch.

Every phase prints its wall time.  The line before the last two is
{"kernels": [...]}: each kernel's launches on its path (K1 the
ins-consensus audt, in `launches_extract_device` the device-extract
audt, in `launches_sharded` / `launches_sharded_extract` phase 15's
4-shard host-extract and device-extract audt, in `launches_routes`
phase 17's two route-BAM audt runs, and in `launches_deep` phase 18's
three deep-BAM audt runs by path, with `full_sweep`, phase 3's W = K
rows; K2's strip kernel and K3 disc, and in
`launches_routes` phase 17's dense disc, K2's wide kernel the spread-site audt, K4 the probe, G1 the graph
audt and in `launches_disc` the graph disc), its
largest difference from the plain version, its CUDA-event time beside the
plain version's, its bound (`bound_ms`, `bound_by`: the larger of its bytes
over 3.35 TB/s and its int32 operations over 16.7 Tops/s), the one library
call's time where one computes the same function (`library_ms`, K4's
torch.sum; none computes G1's; G1 also `ring_hit_share`,
`long_device_ms`, `xlong_device_ms`, `n_cap_device_ms`, and on the long
and xlong sites `launches_long_sites`, `long_sites_ms_per_round`,
`launches_xlong_sites` and `xlong_sites_ms_per_round`; K2's wide kernel
its times on `wide_main`, `cycles_per_row` of its longest pair there, on
`wide2k` and on `longrun`, and `spread_k2_ms_per_batch`, phase 16's K2
time a DP batch) and `ms_before`, null: the replaced designs left the
tree, and tools/torch_kernel_ab.py times K1's, K2's, K3's and G1's
beside the new ones.  Those are CUDA-event times of one wrapper
call, which also hold the host's work inside it (the K2/K3 plan, the
ctypes call); `device_ms` and `device_ms_before` are torch.profiler's
time of the kernels alone, and K1's `launch_floor_ms` the profiler's time
of the launch floor of phase 3.  Then the card's nvidia-smi name and
power limit, then
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time


# The port stands alone: it runs where there is no JAX, and it imports
# nothing of the JAX package.
BLOCKED = ("jax", "jaxlib", "svtrek_tpu")


class _Blocked:
    """Refuses jax, jaxlib and svtrek_tpu (not svtrek_tpu_torch)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in chip_smoke.py")
        return None


sys.meta_path.insert(0, _Blocked())

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
# The 5,000-record fixture of tools/bench_e2e.py (10 supporting + 5 noise
# reads per record, 800 CIGAR ops per read); all-'A' SEQ, which changes
# only BGZF decode time, never a candidate.
RECORDS, DEPTH, OPS_PER_READ = 5000, 10, 800
BIG = 0x7FFFFFFF
# (B, K, sweep_width): the bench refine shape B=8192 (bench.py:33) over the
# K buckets the packer ships, K=1024 at B=1024 (the plain version holds a
# [B, W, K] int64 intermediate), sweep_width 8 to raise overflow flags, the
# main path's own shape (512 windows, K=16) and the device-extract path's
# (512 windows, K = 1,024 from --max-candidates).
KERNEL_SHAPES = [
    (512, 16, 128), (512, 1024, 128),
    (8192, 16, 128), (8192, 64, 128), (8192, 128, 128), (8192, 128, 8),
    (8192, 64, 8), (1024, 1024, 128), (1024, 1024, 8),
]
MAIN_SHAPE = (512, 16, 128)
# The reduced fixture of the Python BAM path (tools/torch_fixtures.py at 500
# records: 7,500 reads, 6.0 M CIGAR ops) and the sub-region its
# `--no-native-io` scan covers, 1-based [start, end).
PY_RECORDS = 500
PY_SCAN_REGION = (1, 6_000_000)
CHROM_END = 120_000_000
# The ins-consensus fixture (tools/ins_fixture.py): sites, seed, and the
# first INS_CPU_SITES of them also run on --device cpu (the plain DP takes
# about 0.1 s a site there; every insert-length class is among them).
INS_SITES, INS_SEED, INS_CPU_SITES = 2000, 0, 500
# Sites per insert-length class whose consensus tools/audt_scalar.py
# recomputes (its DP is a Python loop over n*(2*band+1) cells).
SCALAR_SEQ_PER_CLASS = 2
# K4's checks (N, B, WP, fill, byte offset of the base from a 16-byte
# boundary): tools/torch_step_overhead.py's default input
# (tools/pallas_step_overhead.py's, integers in [0, 3)), which takes the
# 16-byte loads; then int8 over its whole range [-128, 127], at a WP that
# takes the 4-byte loads (200), at one that takes the 1-byte loads (203),
# and at WP 256 on a base 4 and 1 bytes off the boundary, which take the
# 4-byte and the 1-byte loads; last, rows wider than the 1,024 vectors a
# block reads at a time (WP / load bytes > 1,024: one b row a tile, read in
# more than one pass) at each load width.
PROBE_CHECKS = [
    (1280, 256, 256, "tool", 0), (1000, 100, 200, "full", 0),
    (1000, 100, 203, "full", 0), (1000, 100, 256, "full", 4),
    (1000, 100, 256, "full", 1), (16, 5, 2049, "full", 0),
    (16, 5, 4100, "full", 0), (16, 3, 16400, "full", 0),
]
# The routes phase's fixtures (tools/torch_fixtures.py, synthetic shapes
# that reach a route of the JAX package's static shapes, not user
# traffic): the dense disc fixture's reads (3 batches of 8,192, about
# 2,450 hits a batch against the scan's first page of 2,048) and the
# device-walk route BAM's records (windows with a read of 20,000-40,000
# ops, or one of 10-16 candidates), and the disc batch and first page.
ROUTE_DISC_READS, ROUTE_RECORDS, ROUTE_SEED = 24_576, 64, 0
# The second pass's full sweep (K1 at W = K) in phase 3: (B, K).
FULL_SHAPES = [(64, 2048), (8, 16384)]
# The deep routes phase: the deep BAM's seed, the audt batch width (so
# that some batches hold a deep window and the last holds none), and the
# scan regions, 1-based [start, end): a first- and a second-tier INS
# record for the native path, the second one's tiles for --no-native-io
# (tools/torch_routes_ab.py's DEEP_SCAN).
DEEP_SEED, DEEP_BATCH = 0, 32
DEEP_SCAN = {"native": (3_195_000, 3_605_000),
             "python": (3_598_000, 3_603_000)}
DISC_BATCH, DISC_PAGE = 8192, 2048
# The disc fixture (tools/bench_disc.py): reads, seed; and how many
# insertion clusters tools/disc_scalar.py recomputes the consensus of.
DISC_READS, DISC_SEED = 500_000, 0
SCALAR_SEQ_CLUSTERS = 8
# The graph POA phases: G1's ins-mix batch (pairs, shortest and longest
# insert, fewest and most earlier members), and the audt graph cell: the
# first GRAPH_SITES sites of the ins fixture whose sites.json length is at
# most GRAPH_MAX_LEN (a two-allele site's longer allele, length + max(30,
# length // 3), stays under the JAX package's N_CAP 1,024 with its
# mutations: the graph engine's first cell), of which the
# first GRAPH_CPU_SITES also run on the CPU (the plain DP takes about a
# second a site there).
GRAPH_MIX = (256, 50, 1024, 2, 12)
# G1's `long` batch: the insert length and the query length of its pairs
# (the ins path's max_len), past the routing caps but within G1's.
GRAPH_LONG_INSERT, GRAPH_LONG_N = 4000, 4096
# G1's batches at its own caps: `xlong`, two alleles of GRAPH_XLONG_ALLELE
# bases (V past 16,384, queries past 8,192: the ring of 4 rows), and
# `n_cap`, a query of kernels.GRAPH_N_CAP bases against a graph of two
# copies of a GRAPH_NCAP_INSERT-base insert (the ring of 2 rows).
GRAPH_XLONG_ALLELE, GRAPH_NCAP_INSERT = 8600, 16000
# The block-per-pair G1 of commit c6ff5e5 on `ins_mix` (PERF.md §6: three
# runs of this script on an NVIDIA H100 80GB HBM3 at 700.00 W), printed
# beside this run's times; tools/torch_kernel_ab.py times that design in
# one process.
GRAPH_BLOCK_DESIGN_MS = {"alone": (4.6024, 4.5962),
                         "call": (5.3423, 5.2682, 5.4567)}
GRAPH_SITES, GRAPH_MAX_LEN, GRAPH_CPU_SITES = 400, 700, 40
# The JAX package's routing caps of the graph engine (graph nodes, query
# bases, predecessors), beyond which it takes its scalar route; phase 13's
# `v_cap`, `p_cap` and `ins_mix` batches are built at them.  The graph
# audt's long-site run: the first GRAPH_LONG_SITES sites of the ins
# fixture whose insert passes JAX_N_CAP and whose longest allele (a
# two-allele site's second, length + max(30, length // 3)) stays at or
# under GRAPH_LONG_ALLELE, so that every read's insert, mutations
# included, stays within 4,096 bases (G1's cap before it took 16,384);
# and the cheapest such site, whose seq is held to the scalar consensus.
# The first GRAPH_LONG_CPU_SITES also run on the CPU (the plain DP takes
# 10-30 s a long site there; 1 since the xlong run's CPU site, for the
# smoke's time).  The sites past GRAPH_LONG_ALLELE are the
# xlong run's.
JAX_V_CAP, JAX_N_CAP, JAX_P_CAP = 2048, 1024, 32
GRAPH_LONG_SITES, GRAPH_LONG_ALLELE, GRAPH_LONG_CPU_SITES = 64, 4000, 1
# K2's `wide_main` batch: pairs of the spread sites' bands (528-700) and
# pairs at bands 1,024-2,048; the spread-site run: sites, seed of
# tools/ins_fixture.py's build_spread_fixture (its default 40), and the
# first SPREAD_CPU_SITES of them also run on --device cpu (the plain DP
# takes about 4 s a site there).
WIDE_MAIN_PAIRS = (96, 6)
SPREAD_SITES, SPREAD_SEED, SPREAD_CPU_SITES = 40, 0, 24
# The SM clock (GHz) at which K2's alone times become cycles a row: the
# boost clock of the bound's int32 rate below.
SM_GHZ = 1.98
# Rows that lead each kernel batch: n = 0, n < min_count, values near
# INT32_MAX and INT32_MIN (where pos +- 25 and pos - loc wrap in int32, as
# in the JAX program, and the scalar consensus, which does not wrap, may
# differ), the early-return tie.  K1 and its plain version must agree on
# them exactly: tolerance 0.
EDGE_ROWS = [
    ([], 1000),
    ([5000, 5001], 5000),
    ([BIG - 10, BIG - 9, BIG - 8, BIG - 3], BIG - 9),
    ([BIG - 100, BIG - 99, BIG - 98], BIG - 5),
    ([995, 996, 997, 1004, 1005, 1006], 1000),
    ([1, 2, 3], -2**31 + 3),
    ([-2**31, -2**31 + 1, -2**31 + 2], 2**31 - 1),
]


# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet, at
# its 700 W limit): HBM3 at 3.35 TB/s, and int32 at 132 SMs x 64 int32
# lanes x 1.98 GHz boost (the clock of the data sheet's 67 TFLOP/s
# float32: 132 x 128 lanes x 2 x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take for a kernel's work: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its int32 operations over the integer rate;
    and which of the two it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def device_ms(fn, kernel: str, reps: int = 5) -> float | None:
    """The card's time (ms) in the kernels whose name holds ``kernel``, per
    fn() call, from torch.profiler (a wrapper's CUDA-event time also holds
    the host work between its launches); None where the profiler records
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # The kernels' own spans, from the trace as tools/torch_audt_measure.py
    # reads it (the event table can leave out a kernel launched through
    # ctypes).
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    us = sum(e.get("dur", 0) for e in events
             if e.get("cat") == "kernel" and kernel in e.get("name", ""))
    return us / reps / 1e3 if us > 0 else None


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_environment():
    import torch

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[env] nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    from svtrek_tpu_torch.kernels import build as kbuild, load_library

    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stderr(report):
        kbuild.build(force=True, verbose=True)
    load_library()
    print(f"[build] K1 K2 K3 K4 G1 {kbuild.LIB} "
          f"{time.perf_counter() - t0:.3f}s",
          flush=True)
    for line in report.getvalue().splitlines():
        if any(w in line for w in ("registers", "spill", "entry function")):
            print(f"[build] {line.strip()}", flush=True)


def kernel_rows(rng, B: int, K: int):
    """Sorted candidate rows: tight clusters, +-600 bp noise and
    duplicates (tests/test_consensus.py:48-75), led by EDGE_ROWS."""
    locs = np.full((B, K), BIG, np.int32)
    n = rng.integers(0, K + 1, B).astype(np.int32)
    pos = np.zeros(B, np.int32)
    for b in range(B):
        center = int(rng.integers(1000, 100_000_000))
        mode = rng.integers(0, 3, n[b])
        vals = center + np.where(
            mode == 0, rng.integers(-4, 5, n[b]),
            np.where(mode == 1, rng.integers(-600, 600, n[b]),
                     rng.integers(-30, 30, n[b])))
        locs[b, :n[b]] = np.sort(vals)
        pos[b] = center + int(rng.integers(-100, 100))
    for i, (vals, p) in enumerate(EDGE_ROWS[:B]):
        locs[i] = BIG
        locs[i, :len(vals)] = vals
        n[i] = len(vals)
        pos[i] = p
    return locs, n, pos


def phase_kernel():
    import torch

    from audt_scalar import consensus_pos
    from svtrek_tpu_torch.kernels import consensus_pos_cuda
    from torch_step_overhead import cuda_ms
    from svtrek_tpu_torch.ops.consensus import (
        consensus_pos_batch_reference, consensus_pos_full_reference,
    )

    rng = np.random.default_rng(2026)
    max_err = 0
    main_times = None
    for B, K, sw in KERNEL_SHAPES:
        locs, n, pos = kernel_rows(rng, B, K)
        args = [torch.from_numpy(a).cuda() for a in (locs, n, pos)]
        kw = dict(min_count=3, interval=5, range_=500, sweep_width=sw)
        got, got_ovf = consensus_pos_cuda(*args, **kw)
        want, want_ovf = consensus_pos_batch_reference(*args, **kw)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want) or not torch.equal(got_ovf, want_ovf):
            fail(f"K1 differs from the plain version at B={B} K={K} "
                 f"sweep_width={sw}: max_abs_err={err}, overflow flags "
                 f"equal={torch.equal(got_ovf, want_ovf)}")
        ms = cuda_ms(lambda: consensus_pos_cuda(*args, **kw), 50)
        plain_ms = cuda_ms(lambda: consensus_pos_batch_reference(*args, **kw),
                           5)
        alone = device_ms(lambda: consensus_pos_cuda(*args, **kw),
                          "consensus_pos_kernel", 20)
        # The launch floor beside it: one int32 elementwise op on a [B]
        # tensor on the same stream (the port never calls it).
        floor = device_ms(lambda: args[2].bitwise_xor(1), "elementwise", 20)
        print(f"[kernel] B={B} K={K} sweep_width={sw}: equal, "
              f"overflow_rows={int(got_ovf.sum())} "
              f"refined_rows={int((got >= 0).sum())} K1 {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; alone (profiler) K1 "
              f"{fmt_ms(alone)}, launch floor (a [B] int32 xor) "
              f"{fmt_ms(floor)}", flush=True)
        if (B, K, sw) == MAIN_SHAPE:
            # Bytes: locs [B, K], n, pos in, refined [B] int32 and
            # overflow [B] bool out.  Operations: one int32 compare per
            # candidate, the least a consensus over them takes.
            main_times = (ms, plain_ms, alone, floor,
                          *bound(B * K * 4 + B * 13, B * K))
        if (B, K, sw) == (8192, 64, 128):
            got_h, ovf_h = got.cpu().numpy(), got_ovf.cpu().numpy()
            checked = 0
            for b in range(len(EDGE_ROWS), len(EDGE_ROWS) + 256):
                if ovf_h[b]:
                    continue
                o = consensus_pos(locs[b, :n[b]].tolist(), int(pos[b]))
                if o != int(got_h[b]):
                    fail(f"K1 differs from the scalar consensus at row {b}: "
                         f"{int(got_h[b])} vs {o}")
                checked += 1
            print(f"[kernel] {checked} rows equal audt_scalar.consensus_pos",
                  flush=True)
    full = []
    for B, K in FULL_SHAPES:
        locs, n, pos = kernel_rows(rng, B, K)
        args = [torch.from_numpy(a).cuda() for a in (locs, n, pos)]
        kw = dict(min_count=3, interval=5, range_=500)
        got, got_ovf = consensus_pos_cuda(*args, sweep_width=K, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want, want_ovf = consensus_pos_full_reference(*args, **kw)
        end.record()
        end.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want) or got_ovf.any() or want_ovf.any():
            fail(f"K1 at W = K differs from the plain full sweep at B={B} "
                 f"K={K}: max_abs_err={err}, overflow rows "
                 f"{int(got_ovf.sum())} / {int(want_ovf.sum())}")
        ms = cuda_ms(lambda: consensus_pos_cuda(*args, sweep_width=K, **kw),
                     20)
        alone = device_ms(lambda: consensus_pos_cuda(*args, sweep_width=K,
                                                     **kw),
                          "consensus_pos_kernel", 5)
        # Bytes: locs in, refined and overflow out, as for the first pass.
        b_ms, b_by = bound(B * K * 4 + B * 13, B * K)
        full.append({"B": B, "K": K, "ms": ms,
                     "plain_ms": start.elapsed_time(end),
                     "device_ms": alone, "bound_ms": b_ms,
                     "bound_by": b_by})
        print(f"[kernel] full sweep B={B} K={K} W={K}: equal, no overflow, "
              f"refined_rows={int((got >= 0).sum())} K1 {ms:.4f} ms, "
              f"plain {full[-1]['plain_ms']:.4f} ms (one call); alone "
              f"(profiler) K1 {fmt_ms(alone)}; bound {b_ms:.6f} ms",
              flush=True)
    return max_err, main_times, full


def poa_batches(rng):
    """Seeded (name, targets, queries, band) pair batches of base codes for
    K2 and K3: the bench's POA call (bench.py:54-56), 4,096 short pairs, a
    mix of the ins fixture's insert lengths at flush size, bands of up to
    256 and 512, degenerate pairs, the m = 1011, n = 1048 pair whose
    query overruns its target's bucket (tests/test_poa_batch.py:96),
    bands of 513-2,048 on both sides of kernels.POA_STRIP_MAX_BAND (both of
    K2's kernels), degenerate pairs and bands above m + n among them, and
    `longrun`: m - n and n - m up to the band (K3's left runs longer than
    its window, and long up runs), bands 64-2,048, degenerate pairs among
    them.  A band is one per batch or one per pair."""
    from ins_fixture import LENGTH_CLASSES, mutate

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    def mutated(ts, **kw):
        return [mutate(rng, t, **kw) for t in ts]

    ts = [rand(1024) for _ in range(256)]
    yield "bench", ts, mutated(ts, sub=0.05, ins=0.02, dele=0.02), 64
    ts = [rand(int(rng.integers(50, 401))) for _ in range(4096)]
    yield "short", ts, mutated(ts), 64
    shares = np.array([c[0] for c in LENGTH_CLASSES[:4]])
    cls = rng.choice(4, 2048, p=shares / shares.sum())
    ts = [rand(int(rng.integers(LENGTH_CLASSES[c][1],
                                LENGTH_CLASSES[c][2] + 1))) for c in cls]
    yield "flush", ts, mutated(ts), 64
    ts = [rand(int(rng.integers(300, 701))) for _ in range(64)]
    qs = [np.insert(q, len(q) // 2, rand(int(rng.integers(*span))))
          for q, span in zip(mutated(ts), [(190, 250), (420, 500)] * 32)]
    yield "wide", ts, qs, 64
    shapes = [(40, 0), (0, 40), (10, 50), (60, 55), (0, 0), (20, 400),
              (1, 1), (5, 300)]
    yield "degenerate", [rand(m) for m, _ in shapes], \
        [rand(n) for _, n in shapes], 8
    t = rand(1011)
    yield "overrun", [t], [np.insert(t, 505, rand(37))], 64
    shapes = [(300, 310), (0, 50), (60, 0), (400, 380), (5, 9), (0, 0),
              (250, 260), (120, 90)] * 3
    ts = [rand(m) for m, _ in shapes]
    qs = [mutate(rng, t)[:n] if n <= m else
          np.concatenate([mutate(rng, t), rand(n)])[:n]
          for t, (m, n) in zip(ts, shapes)]
    wide = [513, 520, 527, 528, 600, 1024, 1500, 2048]
    yield "wide2k", ts, qs, np.array(
        wide + rng.integers(513, 2049, len(shapes) - len(wide)).tolist())
    # Long left runs (a query that is a piece of its target, m - n up to
    # the band) and long up runs (n - m up to the band), bands 64-2,048.
    shapes = [(2000, 60, 2048), (60, 2000, 2048), (1500, 0, 1501),
              (0, 1500, 1501), (300, 40, 300), (40, 300, 300),
              (1200, 1100, 64), (900, 1000, 128), (4000, 2100, 2048),
              (700, 90, 640), (90, 700, 640), (1, 600, 600)]
    shapes += [(m, max(m - d, 0), bd) if d >= 0 else (m, m - d, bd)
               for m, d, bd in ((int(rng.integers(100, 2000)),
                                 int(rng.integers(-600, 601)),
                                 int(rng.integers(64, 2049)))
                                for _ in range(20))]
    ts = [rand(m) for m, _, _ in shapes]
    qs = []
    for t, (m, n, _) in zip(ts, shapes):
        start = int(rng.integers(0, m - n + 1)) if n <= m else 0
        qs.append(mutate(rng, t[start:start + n])[:n] if n <= m else
                  np.insert(t, m // 2, rand(n - m)))
    yield "longrun", ts, qs, np.array([bd for _, _, bd in shapes])
    # The wide kernel's main-path pairs, as the spread sites make them:
    # WIDE_MAIN_PAIRS[0] members 528-700 bases longer or shorter than a
    # median seed of 3,000-3,400 bases, and WIDE_MAIN_PAIRS[1] at bands
    # 1,024-2,048 (a member up to 2,048 bases longer than a seed of up to
    # 4,000: n up to about 6,000).
    ts, qs = [], []
    for near in (True,) * WIDE_MAIN_PAIRS[0] + (False,) * WIDE_MAIN_PAIRS[1]:
        m = int(rng.integers(3000, 3401) if near else rng.integers(3000,
                                                                   4001))
        # (d clear of 527 and 2,048 by more than the mutations' length
        # change)
        d = int(rng.integers(540, 701) if near else rng.integers(1016, 2031))
        t = rand(m)
        q = mutate(rng, t)
        at = int(rng.integers(0, m - d)) if near and rng.random() < 0.5 \
            else -1
        qs.append(np.delete(q, np.s_[at:at + d]) if at >= 0 else
                  np.insert(q, len(q) // 2, rand(d)))
        ts.append(t)
    yield "wide_main", ts, qs, 64


def poa_bounds(ms, ns, bands, M, N, cols=None):
    """K2's and, with its outputs, K3's bound (ms, resource) on a batch.

    K2 reads tpad [B, M], qpad [B, N] and ms, ns, bands [B] int32, writes
    the pointers, sum of n*(2*band+1) bytes, and does 12 int32 operations a
    cell: diag (add, base compare, select), up (add), the pointer's
    compare, the max, the left gap's prefix max (subtract, max, add), its
    compare, the score's and the code's selects.  K3 reads qpad, ms, ns,
    bands, the offsets [B+1] int64 and one pointer a step of its walk
    (n + m - matches steps a pair), writes cols [B, M] int8 and ins
    [B, M+1] int32, and does 4 int32 operations a step (index, compare,
    two updates)."""
    B = len(ms)
    cells = int((ns.astype(np.int64) * (2 * bands.astype(np.int64) + 1))
                .sum())
    k2 = bound(B * M + B * N + 12 * B + cells, 12 * cells)
    if cols is None:
        return k2, None
    steps = int(ns.sum()) + int(ms.sum()) - int((cols >= 0).sum())
    k3 = bound(B * N + 12 * B + 8 * (B + 1) + steps + B * M
               + 4 * B * (M + 1), 4 * steps)
    return k2, k3


def wide_times(k2, name: str, ms, ns, bands, M: int, N: int) -> dict:
    """K2's wide kernel on a batch's pairs past POA_STRIP_MAX_BAND: its
    profiler time alone in k2() (one wrapper call), their bound, the
    longest of them (n * (2*band+1), the first of its work list), and the
    cycles a row of that pair's chain at SM_GHZ, if the kernel's time is
    that chain's."""
    from svtrek_tpu_torch.kernels import POA_STRIP_MAX_BAND

    wide = bands > POA_STRIP_MAX_BAND
    far = int(np.argmax(np.where(wide, ns.astype(np.int64)
                                 * (2 * bands.astype(np.int64) + 1), -1)))
    alone = device_ms(k2, "poa_dp_ptr_wide")
    t = {"wide_device": alone, "wide_pairs": int(wide.sum()),
         "wide_bound": poa_bounds(ms[wide], ns[wide], bands[wide], M, N)[0],
         "far": (int(ms[far]), int(ns[far]), int(bands[far])),
         "cycles_per_row": None if alone is None else
         alone * SM_GHZ * 1e6 / max(int(ns[far]), 1)}
    t["line"] = (
        f"; K2's wide kernel alone (profiler) {fmt_ms(alone)} on its "
        f"{t['wide_pairs']} pairs, bound {t['wide_bound'][0]:.6f} ms "
        f"({t['wide_bound'][1]}); its longest pair (m, n, band) "
        f"{t['far']}: " + ("not measured" if alone is None else
                           f"{t['cycles_per_row']:.1f} cycles a row at "
                           f"{SM_GHZ} GHz") + f" ({name})")
    return t


def phase_poa_kernels():
    """K2 (its strip and wide kernels) and K3 against their plain versions
    on the card, and their times."""
    import torch

    from svtrek_tpu_torch.kernels import (
        POA_STRIP_MAX_BAND, poa_dp_cols_cuda, poa_dp_plan, poa_dp_ptr_cuda,
        poa_traceback_cuda,
    )
    from svtrek_tpu_torch.ops.poa_dp import (
        dp_ptr_reference, pointers_by_pair, traceback_reference,
    )
    from torch_step_overhead import cuda_ms

    rng = np.random.default_rng(2027)
    err = {"dp": 0, "tb": 0, "wide": 0}
    times = {}
    for name, ts, qs, band in poa_batches(rng):
        B = len(ts)
        ms = np.array([len(t) for t in ts], np.int32)
        ns = np.array([len(q) for q in qs], np.int32)
        bands = np.maximum(band, np.abs(ns - ms) + 1).astype(np.int32)
        tpad = np.full((B, max(int(ms.max()), 1)), 5, np.int8)
        qpad = np.full((B, max(int(ns.max()), 1)), 5, np.int8)
        for b in range(B):
            tpad[b, :ms[b]] = ts[b]
            qpad[b, :ns[b]] = qs[b]
        args = [torch.from_numpy(a).cuda()
                for a in (tpad, ms, qpad, ns, bands)]
        _, m_d, q_d, n_d, b_d = args
        W = int(bands.max())
        M, N = tpad.shape[1], qpad.shape[1]

        def plain_dp():
            return pointers_by_pair(dp_ptr_reference(*args, W=W), n_d, b_d,
                                    W=W)

        def k2():
            return poa_dp_ptr_cuda(*args)

        ptr, offsets = k2()
        want_ptr = plain_dp()
        cols, ins = poa_traceback_cuda(ptr, offsets, q_d, m_d, n_d, b_d,
                                       M=M)
        want_cols, want_ins = traceback_reference(ptr, offsets, q_d, m_d,
                                                  n_d, b_d, M=M)
        # K2 and K3 on one plan, as dp_cols runs them on the main path.
        both = poa_dp_cols_cuda(*args)
        torch.cuda.synchronize()
        if not (torch.equal(both[0], want_cols) and
                torch.equal(both[1], want_ins)):
            fail(f"K2 + K3 on one plan differ from the plain version on "
                 f"{name}")
        e_dp = int((ptr.int() - want_ptr.int()).abs().max()) \
            if ptr.numel() else 0
        e_tb = max(int((cols.int() - want_cols.int()).abs().max()),
                   int((ins - want_ins).abs().max()))
        err["dp"], err["tb"] = max(err["dp"], e_dp), max(err["tb"], e_tb)
        if not torch.equal(ptr, want_ptr):
            fail(f"K2 pointers differ from the plain version on {name}: "
                 f"max_abs_err={e_dp}")
        if not (torch.equal(cols, want_cols) and torch.equal(ins, want_ins)):
            fail(f"K3 differs from the plain version on {name}: "
                 f"max_abs_err={e_tb}")
        n_wide = int((bands > POA_STRIP_MAX_BAND).sum())
        if n_wide:
            err["wide"] = max(err["wide"], e_dp)
        if name == "wide2k" and not 0 < n_wide < B:
            fail(f"wide2k takes one of K2's kernels only: {n_wide} of {B} "
                 f"pairs above band {POA_STRIP_MAX_BAND}")
        if name == "wide_main" and n_wide != B:
            fail(f"wide_main has {B - n_wide} pairs of the strip kernel")
        line = (f"[poa] {name}: B={B} m {int(ms.min())}-{int(ms.max())} "
                f"n {int(ns.min())}-{int(ns.max())} band "
                f"{int(bands.min())}-{W} ({B - n_wide} strip, {n_wide} "
                f"wide) pointer_bytes={ptr.numel()}: equal")

        def k3():
            return poa_traceback_cuda(ptr, offsets, q_d, m_d, n_d, b_d, M=M)

        # K3's walks: a pair's steps are n + m - its diag moves.
        steps = ns.astype(np.int64) + ms - (cols >= 0).sum(1).cpu().numpy()
        if name in ("bench", "flush"):
            reps, plain_reps = 20, 2
            k2b, k3b = poa_bounds(ms, ns, bands, M, N,
                                  cols=cols.cpu().numpy())
            t = {"k2": cuda_ms(k2, reps),
                 "k2_plan": cuda_ms(lambda: poa_dp_plan(
                     M, N, m_d, n_d, b_d), reps),
                 "k2_plain": cuda_ms(plain_dp, plain_reps),
                 "k3": cuda_ms(k3, reps),
                 "k23": cuda_ms(lambda: poa_dp_cols_cuda(*args), reps),
                 "k3_plain": cuda_ms(lambda: traceback_reference(
                     ptr, offsets, q_d, m_d, n_d, b_d, M=M), plain_reps),
                 "k2_bound": k2b, "k3_bound": k3b}
            dev = {"K2": device_ms(k2, "poa_dp_ptr"),
                   "K3": device_ms(k3, "poa_traceback")}
            t["k2_device"], t["k3_device"] = dev.values()
            far = int(np.argmax(steps))
            t["k3_steps"], t["k3_rows"] = int(steps[far]), int(ns[far])
            t["k3_ns_per_step"] = None if t["k3_device"] is None else \
                t["k3_device"] * 1e6 / t["k3_steps"]
            times[name] = t
            line += (f"; K3's longest walk {t['k3_steps']} steps over "
                     f"{t['k3_rows']} rows, "
                     + ("not measured" if t["k3_ns_per_step"] is None else
                        f"{t['k3_ns_per_step']:.1f} ns a step alone"))
            line += (f"; K2 {t['k2']:.4f} ms (its plan alone "
                     f"{t['k2_plan']:.4f} ms), plain {t['k2_plain']:.4f} "
                     f"ms, bound {k2b[0]:.4f} ms ({k2b[1]}); K3 "
                     f"{t['k3']:.4f} ms, plain {t['k3_plain']:.4f} ms, "
                     f"bound {k3b[0]:.4f} ms ({k3b[1]}); K2 + K3 on one "
                     f"plan {t['k23']:.4f} ms; kernel time alone "
                     f"(profiler): " + ", ".join(
                         f"{k} {fmt_ms(v)}" for k, v in dev.items()))
        elif name in ("wide2k", "longrun", "wide_main"):
            t = times[name] = wide_times(k2, name, ms, ns, bands, M, N)
            line += t["line"]
            if name == "wide_main":
                # the main path's wide batch: the wrapper and the plain
                # version (all its pairs are the wide kernel's)
                t["k2"], t["k2_plain"] = cuda_ms(k2, 10), cuda_ms(plain_dp,
                                                                  1)
                line += (f"; K2 {t['k2']:.4f} ms, plain "
                         f"{t['k2_plain']:.4f} ms")
            if name == "longrun":
                line += (f"; K3 alone (profiler) "
                         f"{fmt_ms(device_ms(k3, 'poa_traceback'))}, "
                         f"longest walk {int(steps.max())} steps, left runs "
                         f"to {int((ms - ns).max())} and up runs to "
                         f"{int((ns - ms).max())} cells")
        print(line, flush=True)
    return err, times


def probe_check_input(N: int, B: int, WP: int, fill: str, offset: int):
    """A K4 check's int8 [N, B, WP] input on the card, its base `offset`
    bytes past a 16-byte boundary; returns (ptr, the bytes K4 loads at a
    time, as csrc/step_probe.cu chooses them)."""
    import torch

    from torch_step_overhead import probe_input

    if fill == "tool":
        src = probe_input(N, B, WP)
    else:
        src = torch.from_numpy(np.random.default_rng(2028).integers(
            -128, 127, (N, B, WP), dtype=np.int8, endpoint=True)).cuda()
    buf = torch.empty(N * B * WP + 16, dtype=torch.int8, device="cuda")
    skip = (offset - buf.data_ptr()) % 16
    ptr = buf[skip:skip + N * B * WP].view(N, B, WP)
    ptr.copy_(src)
    addr = ptr.data_ptr()
    if addr % 16 != offset:
        fail(f"K4 check input: base at {addr % 16} bytes, wanted {offset}")
    vec = 16 if WP % 16 == 0 and addr % 16 == 0 else \
        4 if WP % 4 == 0 and addr % 4 == 0 else 1
    return ptr, vec


def phase_step_probe():
    """K4 against its plain version, then the probe's own path."""
    import torch

    from svtrek_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, step_probe_cuda,
    )
    from svtrek_tpu_torch.ops.step_probe import (
        COLS, step_probe, step_probe_reference,
    )
    from torch_step_overhead import cuda_ms, measure, probe_input, report

    max_err = 0
    loads = set()
    for N, B, WP, fill, offset in PROBE_CHECKS:
        ptr, vec = probe_check_input(N, B, WP, fill, offset)
        loads.add(vec)
        for rp in (1, 2, 4, 8):
            if N % rp:
                continue
            want = step_probe_reference(ptr, rp)
            for per_step in (False, True):
                got = step_probe(ptr, rp, per_step_launches=per_step)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    fail(f"K4 differs from the plain version at N={N} B={B} "
                         f"WP={WP} fill={fill} offset={offset} rows_per={rp} "
                         f"per_step_launches={per_step}: max_abs_err={err}")
        print(f"[probe] N={N} B={B} WP={WP} fill={fill} base offset "
              f"{offset} ({vec}-byte loads): K4 equal to the plain version "
              f"at rows_per 1, 2, 4, 8, one launch and per-step launches",
              flush=True)
    if loads != {1, 4, 16}:
        fail(f"the K4 checks took the {sorted(loads)}-byte loads only")
    N, B, WP = PROBE_CHECKS[0][:3]
    reset_launch_counts()
    rows = measure(N, B, WP)
    launches = launch_counts["step_probe"]
    if launches < 1:
        fail("the step probe's path never launched K4")
    for line in report(N, rows):
        print(f"[probe] {line}", flush=True)
    ptr = probe_input(N, B, WP)
    out = torch.empty((B, COLS), dtype=torch.int32, device="cuda")
    one = rows[0]  # rows_per 1: N steps in one launch
    one["device_ms"] = device_ms(lambda: step_probe_cuda(ptr, 1, 0, N, out),
                                 "step_probe_kernel", 20)
    # Bytes: ptr read once, out [B, 128] int32 written; one add a byte.
    one["bound_ms"], one["bound_by"] = bound(N * B * WP + B * COLS * 4,
                                             N * B * WP)
    print(f"[probe] rows_per 1, one launch: K4 {one['one_ms']:.4f} ms, "
          f"library torch.sum {one['library_ms']:.4f} ms, plain "
          f"{one['plain_ms']:.4f} ms, bound {one['bound_ms']:.4f} ms "
          f"({one['bound_by']}, {N * B * WP} bytes); kernel time alone "
          f"(profiler): K4 {fmt_ms(one['device_ms'])}", flush=True)
    return max_err, launches, one


def concordance(lines) -> float:
    """bench.py:364-381: share of DEL/INS lines whose every diff is within
    5 bp of the planted truth (INV excluded)."""
    hits = total = 0
    for line in lines:
        if line.startswith("(INV)"):
            continue
        total += 1
        diffs = [int(d) for d in
                 re.findall(r"diff(?: pos| end)?: (-?\d+)", line)]
        if diffs and all(abs(d) <= 5 for d in diffs):
            hits += 1
    return hits / total if total else 0.0


def fixture(records: int = RECORDS) -> tuple[str, str]:
    from torch_fixtures import build_fixture

    d = os.path.join(tempfile.gettempdir(),
                     f"svtrek_smoke_r{records}_d{DEPTH}_o{OPS_PER_READ}_alla")
    marker = os.path.join(d, "done")
    if not os.path.exists(marker):
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        _, _, n_reads, n_ops = build_fixture(d, records, DEPTH, OPS_PER_READ,
                                             realistic_seq=False)
        open(marker, "w").close()
        print(f"[fixture] {records} records, {n_reads} reads, {n_ops} CIGAR "
              f"ops, built in {time.perf_counter() - t0:.1f}s", flush=True)
    return os.path.join(d, "bench.bam"), os.path.join(d, "bench.vcf")


def run_cli(argv, tag: str):
    """svtrek_tpu_torch.cli with --verbose in this process (so the launch
    counts can be read); prints its [VERBOSE] lines and returns (lines of
    the output file, the [VERBOSE] stats by name, wall seconds)."""
    from svtrek_tpu_torch import cli

    out_path = os.path.join(tempfile.gettempdir(),
                            f"svtrek_smoke_out_{os.getpid()}.txt")
    stderr = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(stderr):
        rc = cli.main([*argv, "-o", out_path, "--verbose"])
    wall = time.perf_counter() - t0
    verbose = [l for l in stderr.getvalue().splitlines()
               if l.startswith("[VERBOSE]")]
    for l in verbose:
        print(f"[{tag}] {l}", flush=True)
    if rc != 0:
        fail(f"svtrek_tpu_torch.cli {' '.join(argv)} exited {rc}: "
             f"{stderr.getvalue()[-2000:]}")
    with open(out_path) as fh:
        lines = [l.rstrip("\n") for l in fh if l.startswith("(")]
    os.remove(out_path)
    stats = dict(re.findall(r"(\w+(?:\+\w+)?)=([\d.]+)s?", " ".join(verbose)))
    return lines, stats, wall


def phase_main_path():
    """The host-extract audt on the card; returns its lines, which equal
    tools/audt_scalar.py's."""
    from audt_scalar import audt_lines
    from svtrek_tpu_torch.kernels import launch_counts, reset_launch_counts
    from svtrek_tpu_torch.ops.consensus import plain_calls
    from svtrek_tpu_torch.pipeline.audit import open_native_reader

    bam, vcf = fixture()
    t0 = time.perf_counter()
    open_native_reader(bam)  # builds the native C BAM library at first use
    print(f"[build] native C BAM library {time.perf_counter() - t0:.3f}s",
          flush=True)
    reset_launch_counts()
    plain_calls["consensus_pos"] = 0
    got, stats, wall = run_cli(["audt", "-b", bam, "-v", vcf, "--device",
                                "cuda"], "main")
    launches = launch_counts["consensus_pos"]
    plain = plain_calls["consensus_pos"]
    batches = int(stats["batches"])

    t0 = time.perf_counter()
    want = audt_lines(bam, vcf)
    print(f"[main] tools/audt_scalar.py: {len(want)} lines in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if got != want:
        bad = [(a, b) for a, b in zip(want, got) if a != b][:3]
        fail(f"result lines differ from the scalar audt: {len(got)} vs "
             f"{len(want)} lines; first differences {bad}")
    if launches < batches:
        fail(f"K1 launched {launches} times for {batches} batches")
    if plain != 0:
        fail(f"the plain consensus path ran {plain} times on --device cuda")
    conc = concordance(got)
    if conc < 0.99:
        fail(f"concordance_within_5bp {conc:.4f} < 0.99")
    print(f"[main] {len(got)} result lines byte-identical to the scalar "
          f"audt; records/s={len(got) / wall:.1f} wall={wall:.3f}s "
          f"windows={stats['windows']} batches={batches} "
          f"K1_launches={launches} plain_calls={plain} "
          f"fallbacks kovf={stats['kovf']} sweep={stats['sweep']} "
          f"concordance_within_5bp={conc:.4f}", flush=True)
    print(f"[main] split parse={stats['parse']}s "
          f"fetch+pack={stats['fetch+pack']}s (worker-seconds) "
          f"device_wait={stats['device_wait']}s emit={stats['emit']}s "
          f"total={stats['total']}s", flush=True)
    return got


def reset_path_counts() -> None:
    """Zero every kernel launch count and every plain-path and per-device
    call count, just before a path runs."""
    from svtrek_tpu_torch.kernels import reset_launch_counts
    from svtrek_tpu_torch.ops import (
        cigar, consensus, discover, poa_dp, poa_graph_dp, window_scan,
    )

    reset_launch_counts()
    for calls in (consensus.plain_calls, poa_dp.plain_calls,
                  poa_graph_dp.plain_calls, cigar.walk_calls,
                  window_scan.scan_calls, discover.scan_calls):
        for k in calls:
            calls[k] = 0


def check_walk_path(tag: str, stats) -> int:
    """After a device-walk audt run on cuda: the walk on the card once per
    batch, K1 once per batch or more, no plain path.  Returns K1's
    launches."""
    from svtrek_tpu_torch.kernels import launch_counts
    from svtrek_tpu_torch.ops import cigar, consensus

    batches = int(stats["batches"])
    walks = dict(cigar.walk_calls)
    launches = launch_counts["consensus_pos"]
    if batches < 1 or walks.get("cuda", 0) != batches or \
            sum(walks.values()) != batches:
        fail(f"{tag}: the evidence walk ran {walks} for {batches} batches")
    if launches < batches:
        fail(f"{tag}: K1 launched {launches} times for {batches} batches")
    if consensus.plain_calls["consensus_pos"] != 0:
        fail(f"{tag}: the plain consensus ran on --device cuda")
    return launches


def phase_extract_device(host_lines: list[str]) -> int:
    """`audt --extract device --device cuda` on phase 6's fixture: lines
    byte-identical to phase 6's, the walk and K1 on the card in every
    batch; then one batch's device step timed.  Returns K1's launches."""
    import torch

    from svtrek_tpu_torch.config import AudtConfig
    from svtrek_tpu_torch.ops.audit_step import (
        audit_refine_step_csr, to_device,
    )
    from svtrek_tpu_torch.pipeline.audit import open_native_reader
    from svtrek_tpu_torch.pipeline.pack import (
        pack_chunk_native, windows_for_task,
    )
    from svtrek_tpu_torch.io.vcf import VcfTask, iter_vcf_tasks
    from torch_step_overhead import cuda_ms

    bam, vcf = fixture()
    reset_path_counts()
    got, stats, wall = run_cli(["audt", "-b", bam, "-v", vcf, "--device",
                                "cuda", "--extract", "device"], "extract")
    launches = check_walk_path("--extract device", stats)
    if got != host_lines:
        bad = [(a, b) for a, b in zip(host_lines, got) if a != b][:3]
        fail(f"--extract device lines differ from the host-extract run "
             f"(and tools/audt_scalar.py): {len(got)} vs {len(host_lines)} "
             f"lines; first differences {bad}")
    print(f"[extract] {len(got)} result lines byte-identical to the "
          f"host-extract run and tools/audt_scalar.py; records/s="
          f"{len(got) / wall:.1f} wall={wall:.3f}s batches={stats['batches']} "
          f"walk_on_cuda={stats['batches']} K1_launches={launches} "
          f"fallbacks kovf={stats['kovf']} sweep={stats['sweep']} "
          f"long_ops={stats['long_ops']} dev_ovf={stats['dev_ovf']}",
          flush=True)
    print(f"[extract] split parse={stats['parse']}s "
          f"fetch+pack={stats['fetch+pack']}s (worker-seconds) "
          f"device_wait={stats['device_wait']}s emit={stats['emit']}s "
          f"total={stats['total']}s", flush=True)

    # One batch of the run (the first 512 windows) through the device step.
    cfg = AudtConfig(bam_file=bam, vcf_file=vcf)
    wins = []
    with open(vcf) as fh:
        for task in iter_vcf_tasks(fh):
            if isinstance(task, VcfTask):
                wins += windows_for_task(task, cfg)[0]
            if len(wins) >= cfg.batch_windows:
                break
    b = pack_chunk_native(wins[:cfg.batch_windows],
                          open_native_reader(bam), cfg).batch
    dev = torch.device("cuda")
    args = [to_device(b.ops_flat, dev, np.uint8),
            to_device(b.lens_flat, dev)] + [to_device(a, dev) for a in (
                b.pos, b.n_ops, b.window_id, b.kind, b.inter_start,
                b.inter_end, b.imprecise_pos)]
    kw = dict(num_windows=b.num_windows, K=1024)
    ms = cuda_ms(lambda: audit_refine_step_csr(*args, **kw), 10)
    print(f"[extract] one batch's device step (flat walk, grouping, K1): "
          f"N={b.num_reads} O={int(b.n_ops.max())} T={len(b.ops_flat)} "
          f"B={b.num_windows} K=1024: {ms:.4f} ms (CUDA events, median of "
          f"10)", flush=True)
    return launches


def run_scan_cli(argv: list[str]):
    """`scan` in this process through the port's CLI parser; returns
    (lines, stats, wall seconds)."""
    from svtrek_tpu_torch import cli
    from svtrek_tpu_torch.pipeline.scan import run_scan

    out_path = os.path.join(tempfile.gettempdir(),
                            f"svtrek_smoke_scan_{os.getpid()}.txt")
    args = cli.build_parser().parse_args(["scan", *argv, "-o", out_path])
    stats: dict = {}
    t0 = time.perf_counter()
    _, lines = run_scan(cli.scan_config_from_args(args), out=io.StringIO(),
                        device=args.device, stats=stats)
    wall = time.perf_counter() - t0
    with open(out_path) as fh:
        if fh.read().splitlines() != lines:
            fail(f"scan {' '.join(argv)}: the output file differs from the "
                 f"returned lines")
    os.remove(out_path)
    return lines, stats, wall


def check_scan_on_cuda(tag: str, stats, walk: bool) -> None:
    """After a scan on cuda: the window scan (and on the Python path the
    evidence walk) on the card once per batch, nothing on the CPU."""
    from svtrek_tpu_torch.ops import cigar, window_scan

    batches = stats.get("batches", 0)
    counts = [("window scan", window_scan.scan_calls)]
    if walk:
        counts.append(("evidence walk", cigar.walk_calls))
    for name, calls in counts:
        if batches < 1 or calls.get("cuda", 0) != batches or \
                sum(calls.values()) != batches:
            fail(f"{tag}: the {name} ran {dict(calls)} for {batches} "
                 f"batches")


def phase_python_bam() -> None:
    """The Python BAM path (`--no-native-io`) and scan on the reduced
    fixture, against the scalar tools."""
    from audt_scalar import audt_lines
    from scan_scalar import scan_lines

    bam, vcf = fixture(PY_RECORDS)
    argv = ["audt", "-b", bam, "-v", vcf, "--no-native-io"]
    reset_path_counts()
    got, stats, wall = run_cli([*argv, "--device", "cuda"], "python")
    launches = check_walk_path("--no-native-io", stats)
    cpu, _, cpu_wall = run_cli([*argv, "--device", "cpu"], "python cpu")
    want = audt_lines(bam, vcf)
    if got != cpu or got != want:
        fail(f"--no-native-io: cuda == cpu {got == cpu}, cuda == "
             f"tools/audt_scalar.py {got == want}")
    print(f"[python] audt --no-native-io: {len(got)} lines equal on cuda, "
          f"on cpu and tools/audt_scalar.py; cuda records/s="
          f"{len(got) / wall:.1f} wall={wall:.3f}s (cpu {cpu_wall:.3f}s), "
          f"batches={stats['batches']} walk_on_cuda={stats['batches']} "
          f"K1_launches={launches} fallbacks long_ops={stats['long_ops']} "
          f"dev_ovf={stats['dev_ovf']}; split parse={stats['parse']}s "
          f"fetch+pack={stats['fetch+pack']}s device_wait="
          f"{stats['device_wait']}s emit={stats['emit']}s", flush=True)

    whole = ["-b", bam, "-c", "1", "-s", "1", "-e", str(CHROM_END)]
    reset_path_counts()
    native, st, wall = run_scan_cli([*whole, "--device", "cuda"])
    check_scan_on_cuda("scan (native, reduced)", st, walk=False)
    native_cpu, _, cpu_wall = run_scan_cli([*whole, "--device", "cpu"])
    t0 = time.perf_counter()
    scalar = scan_lines(bam, 1, 1, CHROM_END)
    t_scalar = time.perf_counter() - t0
    if native != native_cpu or native != scalar:
        fail(f"scan of the reduced fixture: cuda == cpu "
             f"{native == native_cpu}, cuda == tools/scan_scalar.py "
             f"{native == scalar}")
    print(f"[python] scan 1-{CHROM_END} native: {len(native)} lines equal "
          f"on cuda ({wall:.3f}s, {st['tiles']} tiles, {st['batches']} "
          f"batches), on cpu ({cpu_wall:.3f}s) and tools/scan_scalar.py "
          f"({t_scalar:.1f}s)", flush=True)

    lo, hi = PY_SCAN_REGION
    region = ["-b", bam, "-c", "1", "-s", str(lo), "-e", str(hi),
              "--device", "cuda"]
    reset_path_counts()
    py, st, wall = run_scan_cli([*region, "--no-native-io"])
    check_scan_on_cuda("scan --no-native-io", st, walk=True)
    sub, _, sub_wall = run_scan_cli(region)
    if py != sub or py != scan_lines(bam, 1, lo, hi):
        fail(f"scan {lo}-{hi}: --no-native-io == native {py == sub}, and "
             f"tools/scan_scalar.py")
    print(f"[python] scan {lo}-{hi}: {len(py)} lines equal on the "
          f"--no-native-io path ({wall:.3f}s, {st['tiles']} tiles, "
          f"{st['batches']} batches, walk and window scan on cuda, "
          f"fallbacks {st.get('fallbacks', 0)}), the native path "
          f"({sub_wall:.3f}s) and tools/scan_scalar.py", flush=True)


def phase_scan_full() -> None:
    """`scan` over the whole chromosome of phase 6's fixture on the card,
    against a --device cpu run."""
    bam, _ = fixture()
    argv = ["-b", bam, "-c", "1", "-s", "1", "-e", str(CHROM_END)]
    reset_path_counts()
    got, st, wall = run_scan_cli([*argv, "--device", "cuda"])
    check_scan_on_cuda("scan", st, walk=False)
    cpu, _, cpu_wall = run_scan_cli([*argv, "--device", "cpu"])
    if got != cpu:
        bad = [(a, b) for a, b in zip(cpu, got) if a != b][:2]
        fail(f"scan --device cuda and --device cpu lines differ: "
             f"{len(got)} vs {len(cpu)} lines; {bad}")
    if len(got) < 2:
        fail("scan found nothing on the fixture")
    print(f"[scan] {len(got)} lines equal on cuda and cpu; tiles="
          f"{st['tiles']} batches={st['batches']} (window scan on cuda in "
          f"each) fallbacks={st.get('fallbacks', 0)} tiles/s="
          f"{st['tiles'] / wall:.1f} wall={wall:.3f}s (cpu "
          f"{cpu_wall:.3f}s); {got[-1]}", flush=True)


def ins_fixture():
    """The 2,000-site ins-consensus fixture, built once and cached under
    the temp dir; returns (bam, vcf, sites)."""
    from ins_fixture import build_ins_fixture

    d = os.path.join(tempfile.gettempdir(),
                     f"svtrek_smoke_ins{INS_SITES}_s{INS_SEED}")
    marker = os.path.join(d, "done")
    if not os.path.exists(marker):
        t0 = time.perf_counter()
        build_ins_fixture(d, INS_SITES, INS_SEED)
        open(marker, "w").close()
        print(f"[fixture] {INS_SITES} INS sites built in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    with open(os.path.join(d, "sites.json")) as fh:
        sites = json.load(fh)
    return os.path.join(d, "ins.bam"), os.path.join(d, "ins.vcf"), sites


def scalar_subset(sites) -> set[int]:
    """SCALAR_SEQ_PER_CLASS sites of every insert-length class with one
    allele, the cheapest first (reads x length), plus the cheapest
    two-allele site and the first site with 2 reads."""
    picked = set()
    for cls in sorted({s["class"] for s in sites}):
        ids = sorted((i for i, s in enumerate(sites)
                      if s["class"] == cls and s["alleles"] == 1
                      and s["reads"] > 2),
                     key=lambda i: sites[i]["reads"] * sites[i]["length"])
        picked.update(ids[:SCALAR_SEQ_PER_CLASS])
    two = sorted((i for i, s in enumerate(sites) if s["alleles"] == 2),
                 key=lambda i: sites[i]["reads"] * sites[i]["length"])
    picked.update(two[:1])
    picked.update([i for i, s in enumerate(sites) if s["reads"] == 2][:1])
    return picked


@contextlib.contextmanager
def star_host_spy():
    """While open, records each DP batch's copy back of the star engine
    (`ops.poa_batch.cols_ins_flat`: its pairs B, its target width M, the
    pairs' sum of m + 1, the bytes that came back, and whether into pinned
    memory) and each pair of its scalar host DP (`banded_align_ins`: m, n
    and the base band)."""
    from svtrek_tpu_torch.ops import poa_batch

    log = {"d2h": [], "scalar": []}
    flat, scalar = poa_batch.cols_ins_flat, poa_batch.banded_align_ins

    def flat_spy(cols, ins, idx):
        out = flat(cols, ins, idx)
        log["d2h"].append((cols.shape[0], cols.shape[1], idx.numel(),
                           sum(t.nbytes for t in out),
                           all(t.is_pinned() for t in out)))
        return out

    def scalar_spy(t, q, band):
        log["scalar"].append((len(t), len(q), band))
        return scalar(t, q, band)

    poa_batch.cols_ins_flat = flat_spy
    poa_batch.banded_align_ins = scalar_spy
    try:
        yield log
    finally:
        poa_batch.cols_ins_flat, poa_batch.banded_align_ins = flat, scalar


def check_star_host(tag: str, stats, spy, dp_calls: int) -> str:
    """After a star-engine run on cuda under `star_host_spy`: band_scalar
    counts the host DP's pairs, each of them degenerate (band >= m + n);
    each DP batch came back in at most 1.1 x (sum m + 4 sum (m + 1))
    bytes, into pinned memory.  Returns the line to print."""
    wide, scalar = int(stats["band_wide"]), int(stats["band_scalar"])
    if scalar != len(spy["scalar"]):
        fail(f"{tag}: band_scalar={scalar}, but {len(spy['scalar'])} pairs "
             f"took the host DP")
    bad = [(m, n) for m, n, band in spy["scalar"]
           if max(band, abs(n - m) + 1) < max(m, 1) + n]
    if bad:
        fail(f"{tag}: {len(bad)} pairs that are not degenerate took the host "
             f"DP (m, n): {bad[:5]}")
    if len(spy["d2h"]) != dp_calls:
        fail(f"{tag}: {len(spy['d2h'])} copies back for {dp_calls} DP "
             f"batches")
    parts = []
    for B, M, lens, nbytes, pinned in spy["d2h"]:
        need = (lens - B) + 4 * lens
        if nbytes > 1.1 * need or not pinned:
            fail(f"{tag}: a DP batch of {B} pairs came back in {nbytes} "
                 f"bytes (sum m + 4 sum (m + 1) = {need}), pinned={pinned}")
        parts.append(f"{nbytes} ({nbytes / need:.4f} x sum m + 4 sum (m+1); "
                     f"padded {B * M + 4 * B * (M + 1)})")
    return (f"band_wide={wide} band_scalar={scalar} (every one degenerate); "
            f"D2H bytes a DP batch, pinned: " + ", ".join(parts))


def phase_ins_path():
    """`audt --ins-consensus` on the card: launch counts, the band and
    copy-back counts, the --device cpu run, and tools/audt_scalar.py."""
    from audt_scalar import audt_lines
    from svtrek_tpu_torch.kernels import launch_counts, reset_launch_counts
    from svtrek_tpu_torch.ops import consensus, poa_dp

    bam, vcf, sites = ins_fixture()
    argv = ["audt", "-b", bam, "-v", vcf, "--ins-consensus"]
    reset_launch_counts()
    for calls in (consensus.plain_calls, poa_dp.plain_calls):
        for k in calls:
            calls[k] = 0
    with star_host_spy() as spy:
        got, stats, wall = run_cli([*argv, "--device", "cuda"], "ins")
    launches = dict(launch_counts)
    plain = sum(consensus.plain_calls.values()) + \
        sum(poa_dp.plain_calls.values())
    batches = int(stats["batches"])
    dp_calls, flushes = (int(stats.get(k, 0)) for k in ("dp_calls", "flushes"))
    if launches["consensus_pos"] < batches:
        fail(f"K1 launched {launches['consensus_pos']} times for {batches} "
             f"batches")
    if dp_calls < max(flushes, 1) or min(
            launches["poa_dp_ptr"], launches["poa_traceback"]) < dp_calls:
        fail(f"K2/K3 launched {launches['poa_dp_ptr']}/"
             f"{launches['poa_traceback']} times for {dp_calls} DP batches "
             f"in {flushes} consensus flushes")
    if plain != 0:
        fail(f"a plain path ran {plain} times on --device cuda")
    cons_sites, cons_s = int(stats["sites"]), float(stats["time"])
    print(f"[ins] {len(got)} lines, records/s={len(got) / wall:.1f} "
          f"wall={wall:.3f}s; consensus sites={cons_sites} "
          f"cons_s={cons_s:.3f}s sites/s={cons_sites / cons_s:.1f}; "
          f"launches K1={launches['consensus_pos']} "
          f"K2={launches['poa_dp_ptr']} K3={launches['poa_traceback']} "
          f"plain_calls={plain}", flush=True)
    print(f"[ins] {check_star_host('ins', stats, spy, dp_calls)}", flush=True)

    keep = list(range(INS_CPU_SITES))
    classes = sorted({sites[i]["class"] for i in keep})
    if classes != sorted({s["class"] for s in sites}):
        fail(f"the first {INS_CPU_SITES} sites hold classes {classes} only")
    argv[4] = sub_vcf(vcf, keep, f"ins_{INS_CPU_SITES}.vcf")
    sub, sub_stats, _ = run_cli([*argv, "--device", "cuda"], "ins sub")
    cpu, cpu_stats, cpu_wall = run_cli([*argv, "--device", "cpu"], "ins cpu")
    if not cpu == sub == got[:INS_CPU_SITES]:
        bad = [(a, b) for a, b in zip(cpu, got) if a != b][:2]
        fail(f"--device cuda and --device cpu lines differ on the first "
             f"{INS_CPU_SITES} sites: {bad}")
    routes = ("band_wide", "band_scalar", "band_wide_k2")
    if [cpu_stats[k] for k in routes] != [sub_stats[k] for k in routes]:
        fail("--device cuda and --device cpu count other band routes")
    print(f"[ins] --device cpu: the first {len(cpu)} sites (classes "
          f"{classes}) equal to a cuda run of them and to the run's lines, "
          f"wall {cpu_wall:.3f}s", flush=True)

    subset = scalar_subset(sites)
    t0 = time.perf_counter()
    want = audt_lines(bam, vcf, ins_consensus=True, seq_lines=subset)
    if [l.split(", seq:")[0] for l in got] != \
            [l.split(", seq:")[0] for l in want]:
        fail("the lines before ', seq:' differ from tools/audt_scalar.py")
    bad = [i for i in subset if got[i] != want[i]]
    if bad:
        fail(f"seq differs from the scalar consensus at sites {bad[:5]}: "
             f"{got[bad[0]][:200]} vs {want[bad[0]][:200]}")
    classes = sorted({sites[i]["class"] for i in subset})
    print(f"[ins] tools/audt_scalar.py: {len(want)} lines byte-identical "
          f"before ', seq:'; seq equal on {len(subset)} sites (classes "
          f"{classes}) in {time.perf_counter() - t0:.1f}s", flush=True)
    return launches, got


def spread_fixture():
    """tools/ins_fixture.py's spread-length sites (SPREAD_SITES, seed
    SPREAD_SEED), built once and cached under the temp dir; returns (bam,
    vcf, sites)."""
    from ins_fixture import build_spread_fixture

    d = os.path.join(tempfile.gettempdir(),
                     f"svtrek_smoke_spread{SPREAD_SITES}_s{SPREAD_SEED}")
    marker = os.path.join(d, "done")
    if not os.path.exists(marker):
        t0 = time.perf_counter()
        build_spread_fixture(d, SPREAD_SITES, SPREAD_SEED)
        open(marker, "w").close()
        print(f"[fixture] {SPREAD_SITES} spread-length INS sites built in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    with open(os.path.join(d, "sites.json")) as fh:
        sites = json.load(fh)
    return os.path.join(d, "ins.bam"), os.path.join(d, "ins.vcf"), sites


@contextlib.contextmanager
def k2_timer():
    """While open, times each K2 launch step of the star engine
    (`kernels._dp_ptr_launch`: the strip and wide kernels of one DP batch,
    the current stream joined to the wide kernel's) with CUDA events on
    the current stream; yields the list of (start, end) event pairs (read
    them after a synchronize)."""
    import torch

    from svtrek_tpu_torch import kernels

    launch, events = kernels._dp_ptr_launch, []

    def timed(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = launch(*args)
        end.record()
        events.append((start, end))
        return out

    kernels._dp_ptr_launch = timed
    try:
        yield events
    finally:
        kernels._dp_ptr_launch = launch


def phase_spread_sites():
    """`audt --ins-consensus` on the spread-length sites: K2's wide kernel
    on the main path, its launches and the band counts, K2's time a DP
    batch, the --device cpu run and tools/audt_scalar.py.  Returns the
    wide kernel's launches and the K2 times (ms) of the DP batches."""
    import torch

    from audt_scalar import audt_lines
    from svtrek_tpu_torch.kernels import launch_counts, reset_launch_counts
    from svtrek_tpu_torch.ops import consensus, poa_dp

    bam, vcf, sites = spread_fixture()
    argv = ["audt", "-b", bam, "-v", vcf, "--ins-consensus"]
    reset_launch_counts()
    for calls in (consensus.plain_calls, poa_dp.plain_calls):
        for k in calls:
            calls[k] = 0
    with star_host_spy() as spy, k2_timer() as events:
        got, stats, wall = run_cli([*argv, "--device", "cuda"], "spread")
    torch.cuda.synchronize()
    k2_ms = [a.elapsed_time(b) for a, b in events]
    launches = dict(launch_counts)
    plain = sum(consensus.plain_calls.values()) + \
        sum(poa_dp.plain_calls.values())
    dp_calls = int(stats.get("dp_calls", 0))
    wide, wide_k2 = int(stats["band_wide"]), int(stats["band_wide_k2"])
    if not (launches["poa_dp_ptr_wide"] > 0 and wide_k2 > 0 and wide > 0):
        fail(f"the spread sites did not take K2's wide kernel: "
             f"{launches['poa_dp_ptr_wide']} launches, band_wide={wide}, "
             f"band_wide_k2={wide_k2}")
    if launches["poa_traceback"] < dp_calls or len(k2_ms) != dp_calls or \
            launches["consensus_pos"] < int(stats["batches"]):
        fail(f"spread sites: K1/K2/K3 launched {launches} for {dp_calls} DP "
             f"batches ({len(k2_ms)} K2 steps)")
    if plain != 0:
        fail(f"a plain path ran {plain} times on --device cuda")
    cons_sites, cons_s = int(stats["sites"]), float(stats["time"])
    print(f"[spread] {len(got)} lines of {len(sites)} sites, wall "
          f"{wall:.3f}s; consensus sites={cons_sites} cons_s={cons_s:.3f}s "
          f"sites/s={cons_sites / cons_s:.3f}; launches K1="
          f"{launches['consensus_pos']} K2 strip={launches['poa_dp_ptr']} "
          f"K2 wide={launches['poa_dp_ptr_wide']} "
          f"K3={launches['poa_traceback']}; band_wide={wide} "
          f"band_wide_k2={wide_k2}; K2 a DP batch (CUDA events) "
          + ", ".join(f"{x:.4f}" for x in k2_ms) + " ms", flush=True)
    print(f"[spread] {check_star_host('spread', stats, spy, dp_calls)}",
          flush=True)

    want = audt_lines(bam, vcf, ins_consensus=True, seq_lines=set())
    if [l.split(", seq:")[0] for l in got] != \
            [l.split(", seq:")[0] for l in want]:
        fail("spread sites: the lines before ', seq:' differ from "
             "tools/audt_scalar.py")

    argv[4] = sub_vcf(vcf, list(range(SPREAD_CPU_SITES)),
                      f"spread_{SPREAD_CPU_SITES}.vcf")
    sub, sub_stats, _ = run_cli([*argv, "--device", "cuda"], "spread sub")
    cpu, cpu_stats, cpu_wall = run_cli([*argv, "--device", "cpu"],
                                       "spread cpu")
    if not cpu == sub == got[:SPREAD_CPU_SITES]:
        bad = [(a, b) for a, b in zip(cpu, got) if a != b][:2]
        fail(f"spread sites: --device cuda and --device cpu lines differ on "
             f"the first {SPREAD_CPU_SITES} sites: {bad}")
    routes = ("band_wide", "band_scalar", "band_wide_k2")
    if [cpu_stats[k] for k in routes] != [sub_stats[k] for k in routes]:
        fail("spread sites: --device cuda and --device cpu count other band "
             "routes")
    print(f"[spread] tools/audt_scalar.py: {len(got)} lines byte-identical "
          f"before ', seq:'; the first {len(cpu)} sites: --device cpu "
          f"(wall {cpu_wall:.3f}s) and cuda lines equal to the run's, "
          f"band_wide={cpu_stats['band_wide']} band_wide_k2="
          f"{cpu_stats['band_wide_k2']} on both", flush=True)
    return launches["poa_dp_ptr_wide"], k2_ms


def disc_fixture() -> list[str]:
    """tools/bench_disc.py's fixture at DISC_READS reads, built once and
    cached under the temp dir; returns the CLI's input flags."""
    from bench_disc import build_fixture

    d = os.path.join(tempfile.gettempdir(),
                     f"svtrek_smoke_disc{DISC_READS}_s{DISC_SEED}")
    marker = os.path.join(d, "done")
    if not os.path.exists(marker):
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        build_fixture(d, DISC_READS, seed=DISC_SEED)
        open(marker, "w").close()
        print(f"[fixture] disc: {DISC_READS} reads built in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return ["-r", os.path.join(d, "bench.gfa"), "-a",
            os.path.join(d, "bench.gaf"), "-q", os.path.join(d, "bench.fq")]


def run_disc(inputs: list[str], device: str, flags=()):
    """`disc --device <device> [flags]` in this process through the port's
    CLI parser; returns (lines, stats, wall seconds)."""
    from svtrek_tpu_torch import cli
    from svtrek_tpu_torch.pipeline.discover import run_discover

    out_path = os.path.join(tempfile.gettempdir(),
                            f"svtrek_smoke_disc_{os.getpid()}.txt")
    args = cli.build_parser().parse_args(
        ["disc", *inputs, "-o", out_path, "--device", device, *flags])
    stats: dict = {}
    t0 = time.perf_counter()
    lines = run_discover(cli.disc_config_from_args(args), out=io.StringIO(),
                         err=io.StringIO(), device=args.device, stats=stats)
    wall = time.perf_counter() - t0
    with open(out_path) as fh:
        if fh.read().splitlines() != lines:
            fail(f"disc --device {device}: the output file differs from "
                 f"the returned lines")
    for p in (out_path, out_path + ".ckpt.npz"):
        os.remove(p)
    return lines, stats, wall


def scalar_clusters(cl) -> set[int]:
    """SCALAR_SEQ_CLUSTERS insertion clusters: the largest, and the others
    spread evenly over the support ranking."""
    ins = sorted((i for i, c in enumerate(cl) if c[0] == "INS"),
                 key=lambda i: (cl[i][3], i))
    k = min(SCALAR_SEQ_CLUSTERS, len(ins))
    return {ins[-1]} | {ins[(j * (len(ins) - 1)) // max(k - 1, 1)]
                        for j in range(k)}


def phase_disc():
    """`disc` on the card: where the scan ran, the K2/K3 launches, the
    --device cpu run, and tools/disc_scalar.py."""
    import disc_scalar
    from svtrek_tpu_torch.kernels import launch_counts, reset_launch_counts
    from svtrek_tpu_torch.ops import discover, poa_dp

    inputs = disc_fixture()
    reset_launch_counts()
    for calls in (discover.scan_calls, poa_dp.plain_calls):
        for k in calls:
            calls[k] = 0
    got, st, wall = run_disc(inputs, "cuda")
    launches = dict(launch_counts)
    scans = dict(discover.scan_calls)
    plain = sum(poa_dp.plain_calls.values())
    batches, dp_calls = st["scan_batches"], st["dp_calls"]
    if batches < 1 or scans.get("cuda", 0) != batches or \
            sum(scans.values()) != batches:
        fail(f"the disc scan ran {scans} for {batches} batches")
    if dp_calls < 1 or min(launches["poa_dp_ptr"],
                           launches["poa_traceback"]) < dp_calls:
        fail(f"K2/K3 launched {launches['poa_dp_ptr']}/"
             f"{launches['poa_traceback']} times for {dp_calls} DP batches")
    if plain != 0:
        fail(f"the plain POA path ran {plain} times on --device cuda")
    print(f"[disc] {len(got)} lines ({st['clusters']} clusters, "
          f"{st['ins_clusters']} INS), reads={st['reads']} "
          f"reads/s={st['reads'] / wall:.1f} wall={wall:.3f}s; "
          f"scan_batches={batches} on cuda, rescans={st['rescans']} "
          f"host_reads={st['host_reads']} breakpoints={st['breakpoints']}; "
          f"launches K2={launches['poa_dp_ptr']} "
          f"K3={launches['poa_traceback']} for dp_calls={dp_calls}, "
          f"plain_calls={plain}", flush=True)
    print(f"[disc] split detect={st['detect_s']:.3f}s (scan_wait="
          f"{st['scan_wait_s']:.3f}s) cluster={st['cluster_s']:.3f}s "
          f"consensus={st['consensus_s']:.3f}s emit={st['emit_s']:.3f}s "
          f"total={st['total_s']:.3f}s", flush=True)

    cpu, cst, cpu_wall = run_disc(inputs, "cpu")
    if cpu != got:
        bad = [(a, b) for a, b in zip(cpu, got) if a != b][:2]
        fail(f"disc --device cuda and --device cpu lines differ: "
             f"{len(got)} vs {len(cpu)} lines; {bad}")
    print(f"[disc] --device cpu: {len(cpu)} lines equal, wall "
          f"{cpu_wall:.3f}s (consensus {cst['consensus_s']:.3f}s)",
          flush=True)

    gfa, gaf, fq = inputs[1::2]
    t0 = time.perf_counter()
    cl = disc_scalar.clusters(disc_scalar.signals(gfa, gaf))
    t_proj = time.perf_counter() - t0
    subset = scalar_clusters(cl)
    want = disc_scalar.disc_lines(fq, cl, seq_clusters=subset)
    prefix = [l.split(", seq:")[0] for l in got]
    if prefix != [l.split(", seq:")[0] for l in want]:
        bad = [(a, b) for a, b in zip(want, prefix)
               if a.split(", seq:")[0] != b][:2]
        fail(f"the lines before ', seq:' differ from tools/disc_scalar.py: "
             f"{len(got)} vs {len(want)} lines; {bad}")
    bad = [i for i in subset if got[i] != want[i]]
    if bad or len(subset) < min(SCALAR_SEQ_CLUSTERS, st["ins_clusters"]):
        fail(f"seq differs from the scalar consensus at clusters {bad[:5]} "
             f"of {sorted(subset)}")
    print(f"[disc] tools/disc_scalar.py: {len(want)} lines byte-identical "
          f"before ', seq:' (Python projection {t_proj:.1f}s); seq equal on "
          f"{len(subset)} INS clusters of support "
          f"{sorted(cl[i][3] for i in subset)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return launches, got, cl, subset


def graph_batches(rng):
    """Seeded (name, graphs, queries) batches of base codes for G1: the ins
    mix (GRAPH_MIX: each pair's graph grown from 2-12 mutated copies of an
    insert, 2 % substitutions, 1 % insertions and deletions, with the
    round structure of the graph consensus, its DP rounds on the card; the
    query one more copy; every sequence cut to N_CAP); a graph of V_CAP
    nodes (an insert of N_CAP bases and a second chain of N_CAP inserted
    nodes: two sources and two sinks) with queries of N_CAP bases; a node
    with P_CAP predecessors (31 insertions before one node); edge pairs:
    V = 1, n = 1, queries of N against a graph of N, identical members
    (matches only); `long`, past those caps (n = 4,096, V past 8,192),
    its graphs grown on the card; and at G1's own caps `xlong` (V past
    16,384, n past 8,192) and `n_cap` (n = GRAPH_N_CAP).  The caps of the
    first batches are the JAX package's (JAX_*: 2,048 nodes, 1,024 bases,
    32 predecessors), which the port routed at until it took G1's own."""
    from ins_fixture import mutate
    from svtrek_tpu_torch.ops.poa_graph import PoaGraph
    from svtrek_tpu_torch.ops.poa_graph_batch import align_batch

    N_CAP, V_CAP, P_CAP = JAX_N_CAP, JAX_V_CAP, JAX_P_CAP

    def codes(x):
        return np.asarray(x, np.int8)

    def copy(t):
        return codes(mutate(rng, t)[:N_CAP])

    def full(t):  # a mutated copy of exactly N_CAP bases
        return codes(np.resize(mutate(rng, t), N_CAP))

    def copy_long(t):
        return codes(mutate(rng, t)[:GRAPH_LONG_N])

    def first(seq):
        g = PoaGraph()
        g.add_first(codes(seq))
        return g

    B, lo, hi, kmin, kmax = GRAPH_MIX
    truths = [rng.integers(0, 4, int(rng.integers(lo, hi + 1)))
              for _ in range(B)]
    members = rng.integers(kmin, kmax + 1, B)
    graphs = [first(copy(t)) for t in truths]
    for r in range(1, kmax):
        grow = [b for b in range(B) if members[b] > r]
        qs = [copy(truths[b]) for b in grow]
        paths, _ = align_batch([graphs[b] for b in grow], qs, device="cuda")
        for b, q, path in zip(grow, qs, paths):
            graphs[b].add_alignment(q, path)
    yield "ins_mix", graphs, [copy(t) for t in truths]

    a = rng.integers(0, 4, N_CAP)
    g = first(a)
    g.add_alignment(full(a), [(None, j) for j in range(N_CAP)])
    if len(g.base) != V_CAP:
        fail(f"the V_CAP graph has {len(g.base)} nodes")
    yield "v_cap", [g, g], [full(a), full(rng.integers(0, 4, N_CAP))]

    s_ = rng.integers(0, 4, 300)
    g = first(s_)
    m = 150
    for k in range(P_CAP - 1):
        q = codes(s_)
        q[m] = (s_[m] + 1 + k % 3) % 4
        g.add_alignment(q, [(v, v) for v in range(m)] + [(None, m)]
                        + [(v, v) for v in range(m + 1, len(s_))])
    if g.max_indegree() != P_CAP:
        fail(f"the P_CAP graph's largest indegree is {g.max_indegree()}")
    yield "p_cap", [g, g], [copy(s_), codes(s_)]

    same = rng.integers(0, 4, 200)
    ident = first(same)
    for _ in range(5):
        ident.add_alignment(codes(same), [(v, v) for v in range(len(same))])
    yield "edges", [first([0]), first([0]), first([4] * 4), ident, first([2])], \
        [codes([0]), codes([4]), codes([4] * 10), codes(same),
         codes(rng.integers(0, 4, 30))]

    # Past the JAX package's caps: a graph of 3 mutated copies of a
    # GRAPH_LONG_INSERT-base insert with a query of GRAPH_LONG_N bases, and
    # a two-allele graph (a second allele of GRAPH_LONG_N bases in as
    # insertions, then a mutated copy of each allele aligned on the card):
    # V past 8,192.
    t = rng.integers(0, 4, GRAPH_LONG_INSERT)
    one = first(copy_long(t))
    a1, a2 = (rng.integers(0, 4, GRAPH_LONG_N) for _ in range(2))
    two = first(a1)
    two.add_alignment(codes(a2), [(None, j) for j in range(GRAPH_LONG_N)])
    for g, qs in ((one, [copy_long(t), copy_long(t)]),
                  (two, [copy_long(a1), copy_long(a2)])):
        for q in qs:
            (path,), _ = align_batch([g], [q], device="cuda")
            g.add_alignment(q, path)
    queries = [codes(np.resize(mutate(rng, t), GRAPH_LONG_N)),
               copy_long(a2)]
    if len(two.base) <= 8192 or max(map(len, queries)) != GRAPH_LONG_N:
        fail(f"the long batch has V {len(two.base)}, n "
             f"{[len(q) for q in queries]}")
    yield "long", [one, two], queries

    # At G1's own caps: a two-allele graph of V past 16,384 with queries
    # past 8,192 (a mutated copy of each allele aligned on the card
    # first), and a query of GRAPH_N_CAP bases against two copies of a
    # GRAPH_NCAP_INSERT-base insert.
    from svtrek_tpu_torch.kernels import GRAPH_N_CAP

    a1, a2 = (rng.integers(0, 4, GRAPH_XLONG_ALLELE) for _ in range(2))
    xl = first(a1)
    xl.add_alignment(codes(a2), [(None, j) for j in range(len(a2))])
    for q in (codes(mutate(rng, a1)), codes(mutate(rng, a2))):
        (path,), _ = align_batch([xl], [q], device="cuda")
        xl.add_alignment(q, path)
    queries = [codes(mutate(rng, a2)), codes(mutate(rng, a1))]
    if len(xl.base) <= 16384 or min(map(len, queries)) <= 8192:
        fail(f"the xlong batch has V {len(xl.base)}, n "
             f"{[len(q) for q in queries]}")
    yield "xlong", [xl, xl], queries

    t = rng.integers(0, 4, GRAPH_NCAP_INSERT)
    cap = first(codes(mutate(rng, t)))
    q = codes(mutate(rng, t))
    (path,), _ = align_batch([cap], [q], device="cuda")
    cap.add_alignment(q, path)
    yield "n_cap", [cap], [codes(np.resize(mutate(rng, t), GRAPH_N_CAP))]


def ring_hits(arrays, ring: int) -> tuple[int, int]:
    """(filled predecessor slots whose row lies within ring - 1 rows of
    their node, all filled slots) of a batch: the share G1 reads from its
    shared-memory ring rather than global H."""
    _, pred_rows, npred, _, Vs, _, _ = arrays
    P = pred_rows.shape[2]
    hit = total = 0
    for b in range(len(Vs)):
        V = int(Vs[b])
        filled = np.arange(P)[None, :] < np.minimum(npred[b, :V], P)[:, None]
        near = np.arange(1, V + 1)[:, None] - pred_rows[b, :V] < ring
        hit += int((filled & near).sum())
        total += int(filled.sum())
    return hit, total


def graph_bound(arrays, P: int, Vmax: int, Nmax: int):
    """G1's bound (ms, resource) on a batch: it reads base_td, pred_rows,
    npred, is_sink [B, Vmax...], Vs, ns [B] and qpad [B, Nmax], writes
    score [B] int32, matched [B, Vmax] int8 and ins_after [B, Vmax+1]
    int32; and does, per cell of each pair's rows 1..V and columns 0..n,
    10 int32 operations per filled predecessor slot (del: add, compare,
    two selects; diag: base compare, score select, add, compare, two
    selects) and 6 for the in-row insertions (subtract, max, add, compare,
    two selects)."""
    _, _, npred, _, Vs, _, ns = arrays
    B = len(Vs)
    nbytes = B * Vmax * (1 + 4 * P + 4 + 1 + 1 + 4) + 4 * B + 8 * B \
        + B * Nmax + 4 * B
    ops = 0
    for b in range(B):
        filled = np.minimum(npred[b, :Vs[b]].astype(np.int64), P)
        ops += int((ns[b] + 1) * (10 * filled + 6).sum())
    return bound(nbytes, ops)


def phase_graph_kernel():
    """G1 against its plain version on the card."""
    import torch

    from svtrek_tpu_torch.kernels import graph_ring_rows, poa_graph_dp_cuda
    from svtrek_tpu_torch.ops.poa_graph_batch import pack_pairs
    from svtrek_tpu_torch.ops.poa_graph_dp import graph_dp_reference
    from torch_step_overhead import cuda_ms

    rng = np.random.default_rng(2029)
    max_err = 0
    times = {}
    for name, graphs, queries in graph_batches(rng):
        _, arrays, shape = pack_pairs(graphs, queries)
        args = [torch.from_numpy(a).cuda() for a in arrays]
        got = poa_graph_dp_cuda(*args, **shape)
        t0 = time.perf_counter()
        want = graph_dp_reference(*args, **shape)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        max_err = max(max_err, err)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"G1 differs from the plain version on {name}: "
                 f"max_abs_err={err}, score equal "
                 f"{torch.equal(got[0], want[0])}, matched equal "
                 f"{torch.equal(got[1], want[1])}, ins_after equal "
                 f"{torch.equal(got[2], want[2])}")
        Vs, ns = arrays[4], arrays[6]
        ring = graph_ring_rows(int(ns.max()))
        line = (f"[graph] {name}: B={len(Vs)} V {int(Vs.min())}-"
                f"{int(Vs.max())} n {int(ns.min())}-{int(ns.max())} "
                f"P={shape['P']} Vmax={shape['Vmax']} Nmax={shape['Nmax']}, "
                f"ring of {ring} rows: score, matched and ins_after equal")
        if name in ("ins_mix", "long", "xlong", "n_cap"):
            def g1():
                return poa_graph_dp_cuda(*args, **shape)

            big = name in ("xlong", "n_cap")
            t = {"ms": cuda_ms(g1, 2 if big else 5),
                 "plain_ms": cuda_ms(lambda: graph_dp_reference(
                     *args, **shape), 1) if name == "ins_mix"
                 else plain_s * 1e3,
                 "device_ms": device_ms(g1, "poa_graph_dp", 1 if big else 3),
                 "ring": ring}
            t["bound_ms"], t["bound_by"] = graph_bound(arrays, **shape)
            times[name] = t
            line += (f"; G1 {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                     f"alone (profiler) {fmt_ms(t['device_ms'])}, bound "
                     f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
                     f"{int(((Vs.astype(np.int64)) * (ns + 1)).sum())} cells")
        print(line, flush=True)
        if name == "ins_mix":
            hit, total = ring_hits(arrays, ring)
            times["ring_hit"] = hit / total
            alone, call = (" / ".join(f"{x:.4f}" for x in
                                      GRAPH_BLOCK_DESIGN_MS[k])
                           for k in ("alone", "call"))
            print(f"[graph] ins_mix: {hit} of {total} filled predecessor "
                  f"slots ({100 * hit / total:.4f} %) lie within "
                  f"{ring - 1} rows of their node, in G1's "
                  f"{ring}-row shared ring; the block-per-pair design "
                  f"(c6ff5e5) on this batch: alone {alone} ms, call {call} "
                  f"ms (recorded)", flush=True)
            # A live row without a predecessor is refused, not computed.
            bad = args[2].clone()
            bad[0, 0] = 0
            try:
                poa_graph_dp_cuda(*args[:2], bad, *args[3:], **shape)
            except ValueError:
                print("[graph] G1's wrapper refuses a live row without a "
                      "predecessor", flush=True)
            else:
                fail("G1's wrapper took a live row without a predecessor")
    return max_err, times


def sub_vcf(vcf: str, keep: list[int], name: str) -> str:
    """A VCF of the records ``keep`` of ``vcf``, as ``name`` beside it;
    returns its path."""
    with open(vcf) as fh:
        lines = fh.read().splitlines()
    recs = [l for l in lines if not l.startswith("#")]
    path = os.path.join(os.path.dirname(vcf), name)
    with open(path, "w") as fh:
        fh.write("\n".join([l for l in lines if l.startswith("#")]
                           + [recs[i] for i in keep]) + "\n")
    return path


def graph_sub_vcf(vcf: str, sites, count: int) -> tuple[str, list[int]]:
    """A VCF of the first ``count`` sites of the ins fixture whose insert
    is at most GRAPH_MAX_LEN bases, beside ``vcf``; returns (its path, the
    sites' indices)."""
    keep = [i for i, s in enumerate(sites)
            if s["length"] <= GRAPH_MAX_LEN][:count]
    return sub_vcf(vcf, keep, f"graph_{count}.vcf"), keep


def longest_allele(s) -> int:
    """A site's longest allele: a two-allele site's second is length +
    max(30, length // 3) bases (tools/ins_fixture.py)."""
    return s["length"] + (max(30, s["length"] // 3)
                          if s["alleles"] == 2 else 0)


def long_site(s) -> bool:
    """A site of the long-site run: its insert passes JAX_N_CAP, its
    longest allele stays at or under GRAPH_LONG_ALLELE."""
    return s["length"] > JAX_N_CAP and longest_allele(s) <= GRAPH_LONG_ALLELE


def cheapest_long_site(sites, ins_lines: list[str]) -> int:
    """The long site whose scalar graph consensus is the cheapest: one
    allele, more than 2 reads and a refined position, by (reads - 1)
    alignments of about length^2 cells each (site 675 of the fixture)."""
    return min((i for i, s in enumerate(sites) if long_site(s) and
                s["reads"] > 2 and s["alleles"] == 1 and
                re.search(r"ref pos: \d", ins_lines[i])),
               key=lambda i: (sites[i]["reads"] - 1) * sites[i]["length"] ** 2)


def graph_long_sub_vcf(vcf: str, sites, ins_lines: list[str]
                       ) -> tuple[str, list[int], int]:
    """The long-site run's VCF beside ``vcf``: the first GRAPH_LONG_SITES
    long sites and the cheapest one; returns (its path, the sites' indices
    in fixture order, the cheapest site's index)."""
    over = cheapest_long_site(sites, ins_lines)
    keep = sorted(set([i for i, s in enumerate(sites) if long_site(s)]
                      [:GRAPH_LONG_SITES]) | {over})
    return sub_vcf(vcf, keep, "graph_long.vcf"), keep, over


@contextlib.contextmanager
def graph_dp_timer():
    """While open, adds to the first list it yields the CUDA-event time
    (ms) of each `graph_dp` call of the graph rounds
    (ops.poa_graph_batch): G1's wrapper with its checks, its host read and
    its launches; and to the second the call's largest (V, n)."""
    import torch
    from svtrek_tpu_torch.ops import poa_graph_batch

    times: list[float] = []
    sizes: list[tuple[int, int]] = []
    dp = poa_graph_batch.graph_dp

    def timed_dp(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in (0, 1))
        start.record()
        out = dp(*args, **kw)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        sizes.append((int(args[4].max()), int(args[6].max())))
        return out

    poa_graph_batch.graph_dp = timed_dp
    try:
        yield times, sizes
    finally:
        poa_graph_batch.graph_dp = dp


def check_graph_path(tag: str, dp_calls: int, graph_scalar: int) -> int:
    """After a graph-engine run on cuda: G1 once per DP round or more, no
    plain path, no cluster on the scalar route.  Returns G1's launches."""
    from svtrek_tpu_torch.kernels import launch_counts
    from svtrek_tpu_torch.ops import consensus, poa_dp, poa_graph_dp

    launches = launch_counts["poa_graph_dp"]
    plain = sum(consensus.plain_calls.values()) + \
        sum(poa_dp.plain_calls.values()) + \
        sum(poa_graph_dp.plain_calls.values())
    if dp_calls < 1 or launches < dp_calls:
        fail(f"{tag}: G1 launched {launches} times for {dp_calls} DP rounds")
    if plain != 0:
        fail(f"{tag}: a plain path ran {plain} times on --device cuda")
    if graph_scalar != 0:
        fail(f"{tag}: {graph_scalar} clusters took the scalar route")
    return launches


def phase_graph_audt(ins_lines: list[str]):
    """`audt --ins-consensus --poa-engine graph` on the card on the graph
    sub-VCF of the ins fixture, then on its long sites
    (`phase_graph_long`); returns (G1's launches on each, G1's time a DP
    round on the long sites)."""
    from audt_scalar import audt_lines
    from svtrek_tpu_torch.kernels import launch_counts
    from svtrek_tpu_torch.ops.poa_graph import consensus_sequence_poa

    bam, vcf, sites = ins_fixture()
    sub, keep = graph_sub_vcf(vcf, sites, GRAPH_SITES)
    argv = ["audt", "-b", bam, "-v", sub, "--ins-consensus", "--poa-engine",
            "graph"]
    reset_path_counts()
    got, stats, wall = run_cli([*argv, "--device", "cuda"], "graph")
    batches = int(stats["batches"])
    if launch_counts["consensus_pos"] < batches:
        fail(f"graph audt: K1 launched {launch_counts['consensus_pos']} "
             f"times for {batches} batches")
    dp_calls = int(stats["dp_calls"])
    launches = check_graph_path("graph audt", dp_calls,
                                int(stats["graph_scalar"]))
    if [l.split(", seq:")[0] for l in got] != \
            [ins_lines[i].split(", seq:")[0] for i in keep]:
        fail("graph audt: the lines before ', seq:' differ from phase 7's")
    cons_sites, cons_s = int(stats["sites"]), float(stats["time"])
    print(f"[graph] audt: {len(got)} lines (sites {keep[0]}-{keep[-1]} of "
          f"the ins fixture, inserts <= {GRAPH_MAX_LEN}), records/s="
          f"{len(got) / wall:.1f} wall={wall:.3f}s; consensus sites="
          f"{cons_sites} cons_s={cons_s:.3f}s sites/s="
          f"{cons_sites / cons_s:.1f} dp_calls={dp_calls} graph_scalar=0; "
          f"launches K1={launch_counts['consensus_pos']} G1={launches} "
          f"K2={launch_counts['poa_dp_ptr']}, plain_calls=0; lines before "
          f"', seq:' equal to phase 7's", flush=True)

    sub_cpu, _ = graph_sub_vcf(vcf, sites, GRAPH_CPU_SITES)
    argv[4] = sub_cpu
    cpu, _, cpu_wall = run_cli([*argv, "--device", "cpu"], "graph cpu")
    if cpu != got[:GRAPH_CPU_SITES]:
        bad = [(a, b) for a, b in zip(cpu, got) if a != b][:2]
        fail(f"graph audt: --device cuda and --device cpu lines differ on "
             f"the first {GRAPH_CPU_SITES} sites: {bad}")
    print(f"[graph] audt --device cpu: the first {len(cpu)} sites' lines "
          f"equal, wall {cpu_wall:.3f}s", flush=True)

    subset = scalar_subset([sites[i] for i in keep])
    t0 = time.perf_counter()
    want = audt_lines(bam, sub, ins_consensus=True, seq_lines=subset,
                      consensus=consensus_sequence_poa)
    bad = [k for k in sorted(subset) if got[k] != want[k]]
    classes = sorted({sites[keep[k]]["class"] for k in subset})
    if bad or classes != sorted({sites[i]["class"] for i in keep}):
        fail(f"graph audt: seq differs from the scalar graph consensus at "
             f"sites {[keep[k] for k in bad[:5]]} (classes {classes})")
    print(f"[graph] audt: seq equal to the scalar consensus_sequence_poa on "
          f"{len(subset)} sites (classes {classes}) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    long_launches, g1_per_round = phase_graph_long(bam, vcf, sites,
                                                   ins_lines)
    xlong = phase_graph_xlong(bam, vcf, sites, ins_lines)
    return launches, long_launches, g1_per_round, xlong


def phase_graph_long(bam: str, vcf: str, sites, ins_lines: list[str]):
    """The graph audt on the long-site VCF (inserts past JAX_N_CAP) on the
    card: K1 once per batch or more, G1 once per DP round or more, no
    plain path and no cluster on the scalar route; the lines before
    `, seq:` equal to phase 7's, the first GRAPH_LONG_CPU_SITES sites'
    lines equal to a `--device cpu` run, and the cheapest site's seq equal
    to the scalar `consensus_sequence_poa` of its inserts (and to a direct
    `consensus_sequence_poa_batch` call on the card).  Returns (G1's
    launches, G1's time a DP round in ms)."""
    from svtrek_tpu_torch.config import AudtConfig
    from svtrek_tpu_torch.constants import SV_MIN_LENGTH
    from svtrek_tpu_torch.kernels import launch_counts
    from svtrek_tpu_torch.ops.poa_graph import consensus_sequence_poa
    from svtrek_tpu_torch.ops.poa_graph_batch import (
        N_CAP, consensus_sequence_poa_batch,
    )
    from svtrek_tpu_torch.pipeline.audit import open_native_reader

    sub, keep, over = graph_long_sub_vcf(vcf, sites, ins_lines)
    past_2k = sum(sites[i]["length"] > 2000 for i in keep)
    two = sum(sites[i]["alleles"] == 2 for i in keep)
    if len(keep) < 60 or past_2k < 10 or two < 1:
        fail(f"graph long: {len(keep)} sites, {past_2k} past 2,000 bases, "
             f"{two} with two alleles")
    argv = ["audt", "-b", bam, "-v", sub, "--ins-consensus", "--poa-engine",
            "graph"]
    reset_path_counts()
    with graph_dp_timer() as (g1_ms, _):
        got, stats, wall = run_cli([*argv, "--device", "cuda"], "graph long")
    if launch_counts["consensus_pos"] < int(stats["batches"]):
        fail(f"graph long: K1 launched {launch_counts['consensus_pos']} "
             f"times for {stats['batches']} batches")
    dp_calls = int(stats["dp_calls"])
    launches = check_graph_path("graph long audt", dp_calls,
                                int(stats["graph_scalar"]))
    if [l.split(", seq:")[0] for l in got] != \
            [ins_lines[i].split(", seq:")[0] for i in keep]:
        fail("graph long: the lines before ', seq:' differ from phase 7's")
    cons_sites, cons_s = int(stats["sites"]), float(stats["time"])
    per_round = sum(g1_ms) / dp_calls
    lengths = [sites[i]["length"] for i in keep]
    print(f"[graph] long sites: {len(got)} lines (sites {keep[0]}-"
          f"{keep[-1]} of the ins fixture, inserts {min(lengths)}-"
          f"{max(lengths)} bases, {past_2k} past 2,000, {two} with two "
          f"alleles), records/s={len(got) / wall:.1f} wall={wall:.3f}s; "
          f"consensus sites={cons_sites} cons_s={cons_s:.3f}s sites/s="
          f"{cons_sites / cons_s:.2f} dp_calls={dp_calls} (DP rounds) "
          f"graph_scalar=0; launches K1={launch_counts['consensus_pos']} "
          f"G1={launches}, plain_calls=0; G1's wrapper {sum(g1_ms):.3f} ms "
          f"in all (CUDA events), {per_round:.4f} ms a round; lines before "
          f"', seq:' equal to phase 7's", flush=True)

    n_cpu = GRAPH_LONG_CPU_SITES
    argv[4] = sub_vcf(vcf, keep[:n_cpu], f"graph_long_{n_cpu}.vcf")
    cpu, _, cpu_wall = run_cli([*argv, "--device", "cpu"], "graph long cpu")
    if cpu != got[:n_cpu]:
        bad = [(a, b) for a, b in zip(cpu, got) if a != b][:2]
        fail(f"graph long: --device cuda and --device cpu lines differ on "
             f"the first {n_cpu} sites: {bad}")
    print(f"[graph] long sites --device cpu: the first {len(cpu)} sites' "
          f"lines (inserts {[sites[i]['length'] for i in keep[:n_cpu]]}) "
          f"equal, wall {cpu_wall:.3f}s", flush=True)

    # The cheapest site's inserts, as the audt path fetches them around
    # the refined position.
    r = int(re.search(r"ref pos: (\d+)", ins_lines[over]).group(1))
    lo, hi = r - AudtConfig().consensus_interval, \
        r + AudtConfig().consensus_interval
    seqs = open_native_reader(bam).ins_seqs(0, max(lo, 0), hi + 1,
                                            SV_MIN_LENGTH, lo, hi)
    t0 = time.perf_counter()
    want = consensus_sequence_poa(seqs)
    scalar_s = time.perf_counter() - t0
    counts = {}
    t0 = time.perf_counter()
    batch = consensus_sequence_poa_batch([seqs], device="cuda",
                                         counts=counts)
    batch_s = time.perf_counter() - t0
    line_seq = got[keep.index(over)].split(", seq: ")[1]
    if len(seqs) < 3 or line_seq != want or batch != [want] or \
            counts.get("graph_scalar") != 0:
        fail(f"graph long: site {over} ({len(seqs)} inserts): seq differs "
             f"from the scalar consensus_sequence_poa, or graph_scalar="
             f"{counts.get('graph_scalar')}")
    print(f"[graph] the cheapest site past {JAX_N_CAP} (site {over}, insert "
          f"{sites[over]['length']} bases, {len(seqs)} reads of "
          f"{min(map(len, seqs))}-{max(map(len, seqs))} bases): seq equal to "
          f"the scalar consensus_sequence_poa ({scalar_s:.3f}s), and to "
          f"consensus_sequence_poa_batch on the card ({batch_s:.3f}s, "
          f"graph_scalar=0, N_CAP {N_CAP})", flush=True)
    return launches, per_round


def phase_graph_xlong(bam: str, vcf: str, sites, ins_lines: list[str]):
    """The graph audt on the xlong sites, every site of the ins fixture
    whose longest allele passes GRAPH_LONG_ALLELE (45 at seed 0, to 6,416
    bases: before G1 took 16,384 bases, the scalar route), on the card: K1
    once per batch or more, G1 once per DP round or more, no plain path
    and no cluster on the scalar route; the lines before `, seq:` equal to
    phase 7's, and the cheapest site's line (by (reads - 1) x longest
    allele^2, more than 2 reads and a refined position) equal to its
    `--device cpu` run.  Returns {launches, ms_per_round, sites_per_s}."""
    from svtrek_tpu_torch.kernels import launch_counts

    keep = [i for i, s in enumerate(sites)
            if longest_allele(s) > GRAPH_LONG_ALLELE]
    if len(keep) < 40 or max(longest_allele(sites[i]) for i in keep) < 6000:
        fail(f"graph xlong: {len(keep)} sites, longest allele "
             f"{max(longest_allele(sites[i]) for i in keep)}")
    sub = sub_vcf(vcf, keep, "graph_xlong.vcf")
    argv = ["audt", "-b", bam, "-v", sub, "--ins-consensus", "--poa-engine",
            "graph"]
    reset_path_counts()
    with graph_dp_timer() as (g1_ms, sizes):
        got, stats, wall = run_cli([*argv, "--device", "cuda"],
                                   "graph xlong")
    if launch_counts["consensus_pos"] < int(stats["batches"]):
        fail(f"graph xlong: K1 launched {launch_counts['consensus_pos']} "
             f"times for {stats['batches']} batches")
    dp_calls = int(stats["dp_calls"])
    launches = check_graph_path("graph xlong audt", dp_calls,
                                int(stats["graph_scalar"]))
    if [l.split(", seq:")[0] for l in got] != \
            [ins_lines[i].split(", seq:")[0] for i in keep]:
        fail("graph xlong: the lines before ', seq:' differ from phase 7's")
    cons_sites, cons_s = int(stats["sites"]), float(stats["time"])
    per_round = sum(g1_ms) / dp_calls
    big_v, big_n = max(v for v, _ in sizes), max(n for _, n in sizes)
    print(f"[graph] xlong sites: {len(got)} lines (sites {keep[0]}-"
          f"{keep[-1]} of the ins fixture, longest alleles "
          f"{min(longest_allele(sites[i]) for i in keep)}-"
          f"{max(longest_allele(sites[i]) for i in keep)} bases, "
          f"{sum(sites[i]['reads'] for i in keep)} reads), records/s="
          f"{len(got) / wall:.2f} wall={wall:.3f}s; consensus sites="
          f"{cons_sites} cons_s={cons_s:.3f}s sites/s="
          f"{cons_sites / cons_s:.3f} dp_calls={dp_calls} (DP rounds) "
          f"graph_scalar=0; launches K1={launch_counts['consensus_pos']} "
          f"G1={launches}, plain_calls=0; G1's wrapper {sum(g1_ms):.3f} ms "
          f"in all (CUDA events), {per_round:.4f} ms a round; largest V "
          f"{big_v}, largest n {big_n}; lines before ', seq:' equal to "
          f"phase 7's", flush=True)
    if big_n <= 4096:
        fail(f"graph xlong: no query past 4,096 bases reached G1 ({big_n})")

    k = min((k for k, i in enumerate(keep) if sites[i]["reads"] > 2 and
             re.search(r"ref pos: \d", ins_lines[i])),
            key=lambda k: (sites[keep[k]]["reads"] - 1) *
            longest_allele(sites[keep[k]]) ** 2)
    argv[4] = sub_vcf(vcf, [keep[k]], "graph_xlong_cpu.vcf")
    cpu, _, cpu_wall = run_cli([*argv, "--device", "cpu"], "graph xlong cpu")
    if cpu != got[k:k + 1] or "seq: NA" in got[k]:
        fail(f"graph xlong: site {keep[k]}'s line differs between --device "
             f"cuda and --device cpu, or has no seq: {cpu[:1]} {got[k]}")
    print(f"[graph] xlong site {keep[k]} (insert {sites[keep[k]]['length']} "
          f"bases, {sites[keep[k]]['reads']} reads) --device cpu: line "
          f"equal, wall {cpu_wall:.3f}s", flush=True)
    return {"launches": launches, "ms_per_round": per_round,
            "sites_per_s": cons_sites / cons_s}


def phase_graph_disc(disc_lines: list[str], cl, subset) -> int:
    """`disc --poa-engine graph` on the card; returns G1's launches."""
    import disc_scalar
    from svtrek_tpu_torch.ops import discover
    from svtrek_tpu_torch.ops.poa_graph import consensus_sequence_poa

    inputs = disc_fixture()
    flags = ["--poa-engine", "graph"]
    reset_path_counts()
    got, st, wall = run_disc(inputs, "cuda", flags)
    scans = dict(discover.scan_calls)
    if scans.get("cuda", 0) != st["scan_batches"] or \
            sum(scans.values()) != st["scan_batches"]:
        fail(f"graph disc: the scan ran {scans} for {st['scan_batches']} "
             f"batches")
    launches = check_graph_path("graph disc", st["dp_calls"],
                                st["graph_scalar"])
    if [l.split(", seq:")[0] for l in got] != \
            [l.split(", seq:")[0] for l in disc_lines]:
        fail("graph disc: the lines before ', seq:' differ from phase 8's")
    print(f"[graph] disc: {len(got)} lines ({st['ins_clusters']} INS), "
          f"reads/s={st['reads'] / wall:.1f} wall={wall:.3f}s "
          f"consensus={st['consensus_s']:.3f}s dp_calls={st['dp_calls']} "
          f"G1={launches} plain_calls=0 graph_scalar=0; lines before "
          f"', seq:' equal to phase 8's", flush=True)

    cpu, cst, cpu_wall = run_disc(inputs, "cpu", flags)
    if cpu != got:
        bad = [(a, b) for a, b in zip(cpu, got) if a != b][:2]
        fail(f"graph disc: --device cuda and --device cpu lines differ: "
             f"{bad}")
    t0 = time.perf_counter()
    want = disc_scalar.disc_lines(inputs[5], cl, seq_clusters=subset,
                                  consensus=consensus_sequence_poa)
    bad = [i for i in sorted(subset) if got[i] != want[i]]
    if bad:
        fail(f"graph disc: seq differs from the scalar graph consensus at "
             f"clusters {bad[:5]}")
    print(f"[graph] disc --device cpu: {len(cpu)} lines equal, wall "
          f"{cpu_wall:.3f}s (consensus {cst['consensus_s']:.3f}s); seq "
          f"equal to the scalar consensus_sequence_poa on {len(subset)} "
          f"clusters in {time.perf_counter() - t0:.1f}s", flush=True)
    return launches


# Phase 15: the multi-device layer (svtrek_tpu_torch.parallel.mesh).  The
# shard counts of the sharded steps' checks, the CLI runs' count, the
# dispatches made before the first collect, and the sizes: the main path's
# B 512 at K 16 and the device walk's K 1,024, disc's batch of 8,192 reads.
SHARD_COUNTS = (2, 4)
CLI_SHARDS = 4
REPEATS = 50
STEP_B, STEP_READS, DISC_N = 512, 8, 8192


def consensus_problem(B: int, K: int, seed: int):
    """Sorted candidate rows clustered within +-4 bp of a base position
    (most refine to a value, some to NA: counts of 0 to K)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(10_000, 1_000_000, B).astype(np.int64)
    counts = rng.integers(0, K + 1, B).astype(np.int32)
    locs = np.full((B, K), BIG, np.int32)
    for i in range(B):
        locs[i, :counts[i]] = np.sort(
            (base[i] + rng.integers(-4, 5, counts[i])).astype(np.int32))
    return locs, counts, base.astype(np.int32)


def disc_problem(N: int, seed: int):
    """Projected-run rows at disc's batch size: 0-31 runs a read, about
    one run in 500 a >= 50 bp INS, DEL or clip (the disc cell's density)."""
    rng = np.random.default_rng(seed)
    O = 32
    ops = np.full((N, O), 9, np.int8)
    lens = np.zeros((N, O), np.int32)
    n_runs = rng.integers(0, O, N).astype(np.int32)
    ref_start = rng.integers(1_000, 50_000_000, N).astype(np.int32)
    cells = np.arange(O)[None, :] < n_runs[:, None]
    ops[cells] = rng.choice([0, 1, 2, 4, 7, 8], int(cells.sum()))
    lens[cells] = np.where(rng.random(int(cells.sum())) < 0.002,
                           rng.integers(50, 400, int(cells.sum())),
                           rng.integers(1, 45, int(cells.sum())))
    return ops, lens, n_runs, ref_start


def demo_csr(args, n: int):
    """The padded shard-blockwise batch `args` in the CSR layout of the
    sharded packer: each shard's runs back to back in its own block of the
    flat streams."""
    ops, lens, pos, n_ops, wid, *win = args
    per = ops.shape[0] // n
    real = np.arange(ops.shape[1])[None, :] < n_ops[:, None]
    t = [int(n_ops[s * per:(s + 1) * per].sum()) for s in range(n)]
    t_loc = 256
    while t_loc < max(t):
        t_loc *= 2
    ops_flat = np.zeros(n * t_loc, np.uint8)
    lens_flat = np.zeros(n * t_loc, np.int32)
    for s in range(n):
        rows = slice(s * per, (s + 1) * per)
        ops_flat[s * t_loc:s * t_loc + t[s]] = ops[rows][real[rows]]
        lens_flat[s * t_loc:s * t_loc + t[s]] = lens[rows][real[rows]]
    return (ops_flat, lens_flat, pos, n_ops, wid, *win)


def host_ms(fn, reps: int = 20) -> float:
    """Median host-clock time (ms) of fn(), which ends in a copy to the
    host, after a warm-up."""
    import statistics

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def same(tag: str, got, want) -> None:
    """Exact equality of two tuples of arrays."""
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape or \
                not np.array_equal(a, b):
            bad = np.argwhere(a != b)[:3].tolist() if a.shape == b.shape \
                else (a.shape, b.shape)
            fail(f"{tag}: output {i} differs ({a.dtype} vs {b.dtype}; "
                 f"first differences at {bad})")


def check_sharded_steps() -> dict:
    """Phase 15 (a): the four sharded steps on streams of cuda:0 at n 2
    and 4, each equal to the same step on CPU shards (the plain path) and
    to the dense step, K1 once per shard per call; the consensus step
    dispatched REPEATS times before any collect; one batch's step time at
    n 1, 2 and 4.  Returns the times."""
    import torch

    from svtrek_tpu_torch.kernels import launch_counts, reset_launch_counts
    from svtrek_tpu_torch.ops.audit_step import (
        audit_consensus_step, audit_refine_step, audit_refine_step_csr,
        to_device,
    )
    from svtrek_tpu_torch.ops.consensus import consensus_pos_batch
    from svtrek_tpu_torch.ops.discover import scan_projected_runs_compact
    from svtrek_tpu_torch.parallel.mesh import (
        make_mesh, make_sharded_demo_batch, sharded_audit_step,
        sharded_audit_step_csr, sharded_consensus_step, sharded_disc_step,
    )

    cuda0 = torch.device("cuda", 0)

    def dense(fn, args, dtypes, **kw):
        out = fn(*(to_device(a, cuda0, d) for a, d in zip(args, dtypes)),
                 **kw)
        return tuple(o.cpu().numpy() for o in out)

    def k1_run(tag, n, call):
        reset_launch_counts()
        out = call().gather()
        if launch_counts["consensus_pos"] != n:
            fail(f"{tag}: K1 launched {launch_counts['consensus_pos']} "
                 f"times on {n} shards")
        return out

    walk_dt = (np.int8,) + (np.int32,) * 8
    csr_dt = (np.uint8,) + (np.int32,) * 8
    locs, counts, ipos = cons = consensus_problem(STEP_B, 16, 15)
    want_cons = dense(consensus_pos_batch, cons, (np.int32,) * 3)
    disc = disc_problem(DISC_N, 15)
    times = {"consensus": {}, "walk_csr": {}}
    for n in SHARD_COUNTS:
        gpu, cpu = make_mesh([cuda0], n), make_mesh(["cpu"], n)
        b_per = STEP_B // n
        demo = make_sharded_demo_batch(n, b_per_shard=b_per,
                                       reads_per_window=STEP_READS, O=16,
                                       seed=n)
        ops, lens, pos, n_ops, wid, *win = demo
        gwid = wid + np.repeat(np.arange(n, dtype=np.int32) * b_per,
                               len(wid) // n)
        csr = demo_csr(demo, n)
        for K in (16, 1024):
            want = dense(audit_refine_step,
                         (ops, lens, pos, n_ops, gwid, *win), walk_dt,
                         num_windows=STEP_B, K=K)
            if want[2].any() or (want[0] < 0).sum() > STEP_B // 4:
                fail(f"the demo batch at K={K} overflowed or refined to NA")
            for name, make, args in (
                    ("audit", sharded_audit_step, demo),
                    ("audit_csr", sharded_audit_step_csr, csr)):
                tag = f"{name} n={n} K={K}"
                got = k1_run(tag, n, lambda: make(
                    gpu, num_windows=STEP_B, K=K)(*args))
                same(tag, got, make(cpu, num_windows=STEP_B,
                                    K=K)(*args).gather())
                same(f"{tag} against the dense step", got, want)
        tag = f"consensus n={n}"
        step = sharded_consensus_step(gpu, num_windows=STEP_B)
        got = k1_run(tag, n, lambda: step(*cons))
        same(tag, got, sharded_consensus_step(
            cpu, num_windows=STEP_B)(*cons).gather())
        same(f"{tag} against the dense step", got, want_cons)
        times["consensus"][n] = host_ms(lambda: step(*cons).gather())
        csr_step = sharded_audit_step_csr(gpu, num_windows=STEP_B, K=1024)
        times["walk_csr"][n] = host_ms(lambda: csr_step(*csr).gather())

        cap = max(256, 2048 // n)
        tag = f"disc n={n}"
        got = sharded_disc_step(gpu, min_len=50, cap=cap)(*disc).gather()
        same(tag, got, sharded_disc_step(cpu, min_len=50,
                                         cap=cap)(*disc).gather())
        totals, *res = got
        if (totals > cap).any() or totals.sum() == 0:
            fail(f"{tag}: shard totals {totals.tolist()} (cap {cap})")
        rows = []
        for s, t in enumerate(totals.tolist()):
            sl = slice(s * cap, s * cap + t)
            rows += zip((res[0][sl] + s * (DISC_N // n)).tolist(),
                        *(a[sl].tolist() for a in res[1:]))
        want = dense(scan_projected_runs_compact, disc,
                     (np.int8,) + (np.int32,) * 3, min_len=50, cap=2048)
        t = int(want[0])
        if rows != list(zip(*(a[:t].tolist() for a in want[1:]))):
            fail(f"{tag}: the shards' rows differ from the dense scan's")
    print(f"[multi] sharded steps on cuda:0 streams at n "
          f"{list(SHARD_COUNTS)}: audit and audit_csr (B {STEP_B}, "
          f"{STEP_READS} reads a window, K 16 and 1,024), consensus "
          f"(B {STEP_B}, K 16), disc (N {DISC_N}): equal to CPU shards and "
          f"to the dense step; K1 once per shard per call", flush=True)

    # REPEATS dispatches of different batches before the first collect:
    # a gather that read a shard before its K1 had written would differ.
    n = CLI_SHARDS
    step = sharded_consensus_step(make_mesh([cuda0], n), num_windows=STEP_B)
    problems = [consensus_problem(STEP_B, 16, 100 + r)
                for r in range(REPEATS)]
    reset_launch_counts()
    outs = [step(*p) for p in problems]
    got = [o.gather() for o in outs]
    if launch_counts["consensus_pos"] != REPEATS * n:
        fail(f"{REPEATS} dispatches on {n} shards launched K1 "
             f"{launch_counts['consensus_pos']} times")
    for r, (p, g) in enumerate(zip(problems, got)):
        same(f"dispatch {r} of {REPEATS}", g, tuple(
            o.numpy() for o in consensus_pos_batch(
                *(torch.from_numpy(a) for a in p))))
    print(f"[multi] {REPEATS} consensus dispatches on {n} shards, all "
          f"made before the first collect: each equal to the plain "
          f"version", flush=True)

    times["consensus"][1] = host_ms(lambda: tuple(
        o.cpu() for o in audit_consensus_step(locs, counts, ipos,
                                              device=cuda0)))
    demo = make_sharded_demo_batch(1, b_per_shard=STEP_B,
                                   reads_per_window=STEP_READS, O=16, seed=1)
    csr = [to_device(a, cuda0, d) for a, d in zip(demo_csr(demo, 1),
                                                   csr_dt)]
    times["walk_csr"][1] = host_ms(lambda: tuple(
        o.cpu() for o in audit_refine_step_csr(
            *csr, num_windows=STEP_B, K=1024)))
    for name, by_n in times.items():
        print(f"[multi] one batch's {name} step, dispatch and gather "
              f"(host clock, median of 20): " + ", ".join(
                  f"n={k} {v:.4f} ms" for k, v in sorted(by_n.items())),
              flush=True)
    return times


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


DIST_PROCS, DIST_LOCAL_SHARDS = 2, 2


def dist_worker(coord: str, pid: int, out_path: str) -> None:
    """One of the DIST_PROCS gloo processes of phase 15 (c), on cuda:0:
    joins the group, runs the consensus and disc steps over its half of
    the shared problems on DIST_LOCAL_SHARDS streams, and writes each
    shard's rows with their global index."""
    import torch

    from svtrek_tpu_torch.parallel.mesh import (
        init_distributed, make_global_array, make_mesh,
        sharded_consensus_step, sharded_disc_step,
    )

    mesh = make_mesh([torch.device("cuda", 0)], DIST_LOCAL_SHARDS)
    world = init_distributed(coord, DIST_PROCS, pid, backend="gloo",
                             local_shards=mesh.size)

    def half(arrays):
        rows = arrays[0].shape[0] // DIST_PROCS
        return [make_global_array(a[pid * rows:(pid + 1) * rows], mesh)
                for a in arrays]

    g = half(consensus_problem(STEP_B, 16, 15))
    out = sharded_consensus_step(
        mesh, num_windows=STEP_B // DIST_PROCS)(*g)
    cons = [[off + k, v, o] for off, (ref, ovf) in zip(g[0].offsets,
                                                       out.shards)
            for k, (v, o) in enumerate(zip(ref.tolist(), ovf.tolist()))]
    g = half(disc_problem(DISC_N, 15))
    cap = max(256, 2048 // world)
    out = sharded_disc_step(mesh, min_len=50, cap=cap)(*g)
    disc = []
    for off, (total, *res) in zip(g[0].offsets, out.shards):
        t = int(total[0])
        if t > cap:
            raise RuntimeError(f"a shard's total {t} passed its cap {cap}")
        disc += [[off + r, *rest] for r, *rest in
                 zip(*(a[:t].tolist() for a in res))]
    with open(out_path, "w") as fh:
        json.dump({"world": world, "consensus": cons, "disc": disc}, fh)


def check_bootstrap(bam: str, vcf: str, host_lines: list[str]) -> None:
    """Phase 15 (c): the audt CLI in a subprocess with SVTREK_COORDINATOR,
    SVTREK_NUM_PROCS=1 and SVTREK_PROC_ID=0 (NCCL at world size 1), its
    lines equal to phase 6's; and DIST_PROCS gloo processes on cuda:0
    whose assembled consensus and disc rows equal the dense steps', with
    init_distributed's global shard count DIST_PROCS times the local one.
    All started together; each waited for, or killed."""
    import torch

    from svtrek_tpu_torch.ops.consensus import consensus_pos_batch
    from svtrek_tpu_torch.ops.discover import scan_projected_runs_compact

    tmp = tempfile.mkdtemp(prefix="svtrek_smoke_dist_")
    out_path = os.path.join(tmp, "nccl.txt")
    env = dict(os.environ, PYTHONPATH=ROOT,
               SVTREK_COORDINATOR=f"127.0.0.1:{free_port()}",
               SVTREK_NUM_PROCS="1", SVTREK_PROC_ID="0")
    procs = {"nccl audt": subprocess.Popen(
        [sys.executable, "-m", "svtrek_tpu_torch.cli", "audt", "-b", bam,
         "-v", vcf, "-o", out_path, "--device", "cuda", "--verbose"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)}
    coord = f"127.0.0.1:{free_port()}"
    dumps = [os.path.join(tmp, f"w{i}.json") for i in range(DIST_PROCS)]
    for i in range(DIST_PROCS):
        procs[f"gloo worker {i}"] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             coord, str(i), dumps[i]], env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    errs = {}
    try:
        for name, p in procs.items():
            errs[name] = p.communicate(timeout=240)[1]
    except subprocess.TimeoutExpired:
        fail("a phase 15 subprocess did not end in 240 s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in procs.items():
        if p.returncode != 0:
            fail(f"{name} exited {p.returncode}: {errs[name][-2000:]}")
    info = [l for l in errs["nccl audt"].splitlines()
            if l.startswith("[INFO] torch.distributed")]
    if not info or "nccl backend, process 0 of 1" not in info[0]:
        fail(f"the coordinated audt did not report an NCCL group: {info}")
    with open(out_path) as fh:
        got = [l.rstrip("\n") for l in fh if l.startswith("(")]
    if got != host_lines:
        fail(f"the coordinated audt's lines differ from phase 6's: "
             f"{len(got)} vs {len(host_lines)}")
    print(f"[multi] audt with SVTREK_COORDINATOR (world 1): {info[0]}; "
          f"{len(got)} lines equal to phase 6's", flush=True)

    res = []
    for path in dumps:
        with open(path) as fh:
            res.append(json.load(fh))
    world = DIST_PROCS * DIST_LOCAL_SHARDS
    if [r["world"] for r in res] != [world] * DIST_PROCS:
        fail(f"init_distributed returned {[r['world'] for r in res]}, "
             f"expected {world} in each process")
    cuda0 = torch.device("cuda", 0)
    cons = consensus_problem(STEP_B, 16, 15)
    ref, ovf = (o.cpu().tolist() for o in consensus_pos_batch(
        *(torch.from_numpy(a).to(cuda0) for a in cons)))
    rows = sorted(tuple(r) for w in res for r in w["consensus"])
    if rows != [(i, v, o) for i, (v, o) in enumerate(zip(ref, ovf))]:
        fail("the gloo processes' consensus rows differ from the dense "
             "step's")
    total, *arrs = scan_projected_runs_compact(
        *(torch.from_numpy(a).to(cuda0) for a in disc_problem(DISC_N, 15)),
        min_len=50, cap=2048)
    t = int(total)
    want = sorted(zip(*(a[:t].tolist() for a in arrs)))
    got = sorted(tuple(r) for w in res for r in w["disc"])
    if not want or got != want:
        fail(f"the gloo processes' disc rows differ from the dense "
             f"scan's: {len(got)} vs {len(want)}")
    print(f"[multi] {DIST_PROCS} gloo processes on cuda:0, "
          f"{DIST_LOCAL_SHARDS} shards each: init_distributed returned "
          f"{world}; {STEP_B} consensus rows and {t} disc rows equal to "
          f"the dense steps'", flush=True)


def phase_multi_device(fx, host_lines: list[str], disc_inputs: list[str],
                       disc_lines: list[str]):
    """Phase 15: the sharded steps (a), the CLI at --data-shards
    CLI_SHARDS on the card against phases 6 and 9 (``host_lines``; phase
    9's equal phase 6's) and 8 (b), and the distributed bootstrap (c).  Returns (K1's launches in the sharded
    host-extract audt, in the sharded device-extract audt, the step
    times)."""
    from svtrek_tpu_torch.kernels import launch_counts
    from svtrek_tpu_torch.ops import cigar, consensus, discover

    times = check_sharded_steps()
    bam, vcf = fx
    flags = ["--device", "cuda", "--data-shards", str(CLI_SHARDS)]
    launches = {}
    for tag, extra, want in (("sharded", [], host_lines),
                             ("sharded extract", ["--extract", "device"],
                              host_lines)):
        reset_path_counts()
        got, stats, wall = run_cli(["audt", "-b", bam, "-v", vcf, *flags,
                                    *extra], tag)
        batches = int(stats["batches"])
        k1 = launches[tag] = launch_counts["consensus_pos"]
        walks = dict(cigar.walk_calls)
        if got != want:
            bad = [(a, b) for a, b in zip(want, got) if a != b][:3]
            fail(f"audt {' '.join(flags + extra)}: lines differ from the "
                 f"one-shard run's: {len(got)} vs {len(want)}; {bad}")
        if int(stats["data_shards"]) != CLI_SHARDS or \
                k1 != CLI_SHARDS * batches or \
                consensus.plain_calls["consensus_pos"] != 0:
            fail(f"audt {' '.join(flags + extra)}: K1 launched {k1} times "
                 f"for {batches} batches on {stats['data_shards']} shards")
        if extra and walks != {"cuda": CLI_SHARDS * batches, "cpu": 0}:
            fail(f"the sharded device walk ran {walks} for {batches} "
                 f"batches")
        print(f"[multi] audt {' '.join(flags + extra)}: {len(got)} lines "
              f"equal to the one-shard run's; records/s="
              f"{len(got) / wall:.1f} wall={wall:.3f}s batches={batches} "
              f"K1_launches={k1} fallbacks kovf={stats['kovf']} "
              f"sweep={stats['sweep']} long_ops={stats['long_ops']} "
              f"dev_ovf={stats['dev_ovf']}", flush=True)

    reset_path_counts()
    got, st, wall = run_disc(disc_inputs, "cuda",
                             ["--data-shards", str(CLI_SHARDS)])
    scans = dict(discover.scan_calls)
    if got != disc_lines:
        fail(f"disc --data-shards {CLI_SHARDS}: lines differ from the "
             f"one-shard run's: {len(got)} vs {len(disc_lines)}")
    if st["data_shards"] != CLI_SHARDS or \
            scans != {"cuda": CLI_SHARDS * st["scan_batches"], "cpu": 0}:
        fail(f"disc --data-shards {CLI_SHARDS}: the scan ran {scans} for "
             f"{st['scan_batches']} batches")
    print(f"[multi] disc --data-shards {CLI_SHARDS}: {len(got)} lines equal "
          f"to the one-shard run's; reads/s={st['reads'] / wall:.1f} "
          f"wall={wall:.3f}s scan_batches={st['scan_batches']} "
          f"rescans={st['rescans']} scans_on_cuda={scans['cuda']}",
          flush=True)

    check_bootstrap(bam, vcf, host_lines)
    return launches["sharded"], launches["sharded extract"], times


def route_fixtures():
    """The routes phase's two fixtures, built once and cached under the
    temp dir; returns (the disc CLI's input flags, route BAM, route VCF)."""
    from torch_fixtures import build_dense_disc_fixture, build_route_bam

    d = os.path.join(tempfile.gettempdir(),
                     f"svtrek_smoke_routes_d{ROUTE_DISC_READS}_"
                     f"r{ROUTE_RECORDS}_s{ROUTE_SEED}")
    marker = os.path.join(d, "done")
    if not os.path.exists(marker):
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        build_dense_disc_fixture(d, ROUTE_DISC_READS, seed=ROUTE_SEED)
        build_route_bam(d, ROUTE_RECORDS, seed=ROUTE_SEED)
        open(marker, "w").close()
        print(f"[fixture] routes: {ROUTE_DISC_READS} dense disc reads and "
              f"{ROUTE_RECORDS} route records built in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return (["-r", os.path.join(d, "bench.gfa"), "-a",
             os.path.join(d, "bench.gaf"), "-q", os.path.join(d, "bench.fq")],
            os.path.join(d, "route.bam"), os.path.join(d, "route.vcf"))


def page2_times(inputs: list[str]) -> dict:
    """The dense fixture's first batch on the card: its hit total, and the
    CUDA-event times of its first page and of its second page (the hits
    past DISC_PAGE, `first`), the two pages laid end to end held to one
    page of the batch's total."""
    import torch

    from svtrek_tpu_torch.io.gaf_native import NativeGafReader
    from svtrek_tpu_torch.io.gfa import parse_gfa
    from svtrek_tpu_torch.ops.discover import scan_projected_runs_compact_csr
    from torch_step_overhead import cuda_ms

    gfa, gaf = inputs[1], inputs[3]
    reader = NativeGafReader(gaf, parse_gfa(gfa))
    try:
        b = reader.next_batch(DISC_BATCH)
        dev = torch.device("cuda")
        args = [torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
                for a, dt in ((b.flat_ops, np.int8), (b.flat_lens, np.int32),
                              (b.n_runs, np.int32),
                              (b.ref_start, np.int32))]
        O = int(b.n_runs.max())
    finally:
        reader.close()

    def page(cap, first=0):
        return scan_projected_runs_compact_csr(*args, O=O, min_len=50,
                                               cap=cap, first=first)

    total = int(page(DISC_PAGE)[0])
    if total <= DISC_PAGE:
        fail(f"routes: the dense disc batch has {total} hits, not past the "
             f"first page's {DISC_PAGE}")
    p1, p2, whole = page(DISC_PAGE), page(total - DISC_PAGE, DISC_PAGE), \
        page(total)
    for a, b_, w in zip(p1[1:], p2[1:], whole[1:]):
        if not torch.equal(torch.cat([a, b_]), w):
            fail("routes: the two disc pages differ from one page of the "
                 "batch's total")
    return {"total": total,
            "page1_ms": cuda_ms(lambda: page(DISC_PAGE), 20),
            "page2_ms": cuda_ms(lambda: page(total - DISC_PAGE, DISC_PAGE),
                                20)}


def phase_routes() -> dict:
    """Phase 17: the routes the JAX package's static shapes send to the
    host, on the card.  The dense disc fixture: no rescan and a second
    page a batch or more, the scan on the card for every page, K2/K3
    launched, the lines equal to --device cpu and, before `, seq:`, to
    tools/disc_scalar.py; the second page timed.  The route BAM on
    `--extract device` and `--no-native-io`: long_ops 0 and dev_ovf 0,
    the walk and K1 on the card every batch, the lines equal to
    tools/audt_scalar.py and to --device cpu.  Returns the launches and
    rates."""
    import disc_scalar
    from audt_scalar import audt_lines
    from svtrek_tpu_torch.kernels import launch_counts
    from svtrek_tpu_torch.ops import discover, poa_dp

    inputs, bam, vcf = route_fixtures()
    reset_path_counts()
    got, st, wall = run_disc(inputs, "cuda")
    k2, k3 = launch_counts["poa_dp_ptr"], launch_counts["poa_traceback"]
    scans = dict(discover.scan_calls)
    batches, pages2, dp_calls = (st["scan_batches"], st["scan_pages2"],
                                 st["dp_calls"])
    if st["rescans"] != 0 or pages2 < batches or batches < 3:
        fail(f"routes: disc rescans={st['rescans']} scan_pages2={pages2} "
             f"for {batches} batches")
    if scans.get("cuda", 0) != batches + pages2 or \
            sum(scans.values()) != batches + pages2:
        fail(f"routes: the disc scan ran {scans} for {batches} batches and "
             f"{pages2} second pages")
    if dp_calls < 1 or min(k2, k3) < dp_calls or \
            sum(poa_dp.plain_calls.values()) != 0:
        fail(f"routes: K2/K3 launched {k2}/{k3} times for {dp_calls} DP "
             f"batches, plain POA {dict(poa_dp.plain_calls)}")
    cpu, _, cpu_wall = run_disc(inputs, "cpu")
    gfa, gaf, fq = inputs[1::2]
    cl = disc_scalar.clusters(disc_scalar.signals(gfa, gaf))
    want = disc_scalar.disc_lines(fq, cl, seq_clusters=set())
    if cpu != got or [l.split(", seq:")[0] for l in got] != \
            [l.split(", seq:")[0] for l in want]:
        fail(f"routes: disc lines: cuda == cpu {cpu == got}; before ', "
             f"seq:' equal to tools/disc_scalar.py: False or not checked")
    pages = page2_times(inputs)
    print(f"[routes] disc dense fixture: {len(got)} lines ({st['clusters']} "
          f"clusters, {st['ins_clusters']} INS) equal on cuda, on cpu "
          f"({cpu_wall:.3f}s) and before ', seq:' to tools/disc_scalar.py; "
          f"reads={st['reads']} reads/s={st['reads'] / wall:.1f} "
          f"wall={wall:.3f}s scan_batches={batches} scan_pages2={pages2} "
          f"rescans={st['rescans']} breakpoints={st['breakpoints']} "
          f"(scan on cuda {scans.get('cuda', 0)} times); K2={k2} K3={k3} "
          f"for dp_calls={dp_calls}; first batch {pages['total']} hits: "
          f"page 1 {pages['page1_ms']:.4f} ms, page 2 "
          f"{pages['page2_ms']:.4f} ms (CUDA events, median of 20)",
          flush=True)

    want = audt_lines(bam, vcf)
    k1 = {}
    for tag, flags in (("extract", ["--extract", "device"]),
                       ("python", ["--no-native-io"])):
        argv = ["audt", "-b", bam, "-v", vcf, *flags]
        reset_path_counts()
        got, stats, wall = run_cli([*argv, "--device", "cuda"],
                                   f"routes {tag}")
        k1[tag] = check_walk_path(f"routes {tag}", stats)
        cpu, _, cpu_wall = run_cli([*argv, "--device", "cpu"],
                                   f"routes {tag} cpu")
        if stats["long_ops"] != "0" or stats["dev_ovf"] != "0" or \
                got != cpu or got != want:
            fail(f"routes {tag}: long_ops={stats['long_ops']} dev_ovf="
                 f"{stats['dev_ovf']}, cuda == cpu {got == cpu}, cuda == "
                 f"tools/audt_scalar.py {got == want}")
        print(f"[routes] audt {' '.join(flags)}: {len(got)} lines equal on "
              f"cuda, on cpu ({cpu_wall:.3f}s) and tools/audt_scalar.py; "
              f"records/s={len(got) / wall:.1f} wall={wall:.3f}s "
              f"batches={stats['batches']} K1={k1[tag]} long_ops=0 "
              f"dev_ovf=0", flush=True)
    return {"k1": k1["extract"] + k1["python"], "k2": k2, "k3": k3,
            "page2_ms": pages["page2_ms"]}


def deep_fixture() -> tuple[str, str]:
    """The deep BAM and its VCF, built once and cached under the temp
    dir."""
    from torch_fixtures import build_deep_bam

    d = os.path.join(tempfile.gettempdir(), f"svtrek_smoke_deep_s{DEEP_SEED}")
    marker = os.path.join(d, "done")
    if not os.path.exists(marker):
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        build_deep_bam(d, seed=DEEP_SEED)
        open(marker, "w").close()
        print(f"[fixture] deep BAM built in {time.perf_counter() - t0:.1f}s",
              flush=True)
    return os.path.join(d, "deep.bam"), os.path.join(d, "deep.vcf")


def phase_deep_routes() -> dict:
    """Phase 18: the windows past --cand-width, --max-candidates and
    --sweep-width take a second pass on the card.  Returns K1's launches
    on each audt path and the runs' rates."""
    from audt_scalar import audt_lines
    from scan_scalar import scan_lines
    from svtrek_tpu_torch.kernels import launch_counts
    from svtrek_tpu_torch.ops import cigar, consensus, window_scan
    from torch_fixtures import deep_records

    bam, vcf = deep_fixture()
    want = audt_lines(bam, vcf)
    # Windows in VCF order; the first two tiers' (a DEL two, an INS one)
    # pass a width.  A batch of DEEP_BATCH windows holding one takes one
    # second pass (on the host path, only its windows past --cand-width:
    # its sweep cannot overflow at n <= K = W).
    deep = [t < 2 for _, sv, t in deep_records()
            for _ in range(1 + (sv == "DEL"))]
    batches = -(-len(deep) // DEEP_BATCH)
    second = sum(any(deep[i:i + DEEP_BATCH])
                 for i in range(0, len(deep), DEEP_BATCH))
    out = {"launches": {}, "records_per_s": {}}
    for tag, flags in (("host", []), ("extract", ["--extract", "device"]),
                       ("python", ["--no-native-io"])):
        argv = ["audt", "-b", bam, "-v", vcf, "--batch-windows",
                str(DEEP_BATCH), *flags]
        reset_path_counts()
        got, st, wall = run_cli([*argv, "--device", "cuda"], f"deep {tag}")
        k1 = launch_counts["consensus_pos"]
        plain = consensus.plain_calls["consensus_pos"]
        if tag != "host":
            check_walk_path(f"deep {tag}", st)
        cpu, cst, cpu_wall = run_cli([*argv, "--device", "cpu"],
                                     f"deep {tag} cpu")
        routes = [st[k] for k in ("kovf", "sweep", "long_ops", "dev_ovf")]
        counts = (st["wide_k"], st["sweep_full"])
        if got != want or cpu != want or routes != ["0"] * 4 or \
                counts != (cst["wide_k"], cst["sweep_full"]) or \
                int(counts[0]) < 1 or \
                (tag != "host" and int(counts[1]) < 1):
            fail(f"deep {tag}: cuda == tools/audt_scalar.py {got == want}, "
                 f"cpu == it {cpu == want}, kovf/sweep/long_ops/dev_ovf "
                 f"{routes}, wide_k/sweep_full cuda {counts} cpu "
                 f"{(cst['wide_k'], cst['sweep_full'])}")
        if int(st["batches"]) != batches or k1 != batches + second or \
                plain != 0:
            fail(f"deep {tag}: K1 launched {k1} times for {st['batches']} "
                 f"batches and {second} second passes; plain {plain}")
        out["launches"][tag] = k1
        out["records_per_s"][tag] = len(got) / wall
        print(f"[deep] audt {' '.join(flags) or 'host extract'}: "
              f"{len(got)} lines equal on cuda, on cpu ({cpu_wall:.3f}s) "
              f"and tools/audt_scalar.py; records/s={len(got) / wall:.1f} "
              f"wall={wall:.3f}s batches={st['batches']} K1={k1} (first "
              f"passes {batches}, second passes {second}) wide_k="
              f"{counts[0]} sweep_full={counts[1]} kovf=0 sweep=0 "
              f"dev_ovf=0", flush=True)

    for tag, native in (("native", True), ("python", False)):
        lo, hi = DEEP_SCAN[tag]
        argv = ["-b", bam, "-c", "1", "-s", str(lo), "-e", str(hi)] + \
            ([] if native else ["--no-native-io"])
        reset_path_counts()
        got, st, wall = run_scan_cli([*argv, "--device", "cuda"])
        scans, walks = dict(window_scan.scan_calls), dict(cigar.walk_calls)
        cpu, cst, cpu_wall = run_scan_cli([*argv, "--device", "cpu"])
        nb = st["batches"]
        if got != cpu or got != scan_lines(bam, 1, lo, hi) or \
                st["fallbacks"] != 0 or st["wide_k"] < 1 or \
                st["wide_k"] != cst["wide_k"] or \
                scans != {"cuda": 2 * nb, "cpu": 0} or \
                (not native and walks.get("cuda", 0) != nb):
            fail(f"deep scan {tag}: cuda == cpu {got == cpu}, fallbacks "
                 f"{st['fallbacks']}, wide_k {st['wide_k']} / cpu "
                 f"{cst['wide_k']}, window scan {scans} and walk {walks} "
                 f"for {nb} batches")
        out[f"scan_{tag}_tiles_per_s"] = st["tiles"] / wall
        print(f"[deep] scan {lo}-{hi} ({tag}): {len(got)} lines equal on "
              f"cuda, on cpu ({cpu_wall:.3f}s) and tools/scan_scalar.py; "
              f"tiles={st['tiles']} tiles/s={st['tiles'] / wall:.1f} "
              f"wall={wall:.3f}s batches={nb} wide_k={st['wide_k']} "
              f"fallbacks=0 (window scan on cuda {scans['cuda']} times)",
              flush=True)
    return out


def phase_jax_check() -> None:
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    print(f"[jax] {len(loaded)} modules of jax, jaxlib or svtrek_tpu loaded",
          flush=True)
    if loaded:
        fail(f"modules of jax, jaxlib or svtrek_tpu were loaded: {loaded}")


def timed(name: str, fn, *args):
    """fn(*args), printing the phase's wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name}: {time.perf_counter() - t0:.1f}s", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_environment()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    import torch

    timed("build", phase_build)
    max_err, (ms, plain_ms, k1_alone, k1_floor, k1_bound, k1_by), \
        k1_full = timed("kernel", phase_kernel)
    poa_err, poa_times = timed("poa kernels", phase_poa_kernels)
    probe_err, probe_launches, probe = timed("step probe", phase_step_probe)
    # Phase 13 runs with the other kernel checks: in one run on the card
    # the profiler recorded no device time for G1 once the pipeline phases
    # had run, and did where phase 13 ran right after the build.
    graph_err, graph = timed("graph kernel", phase_graph_kernel)
    host_lines = timed("main path", phase_main_path)
    launches, ins_lines = timed("ins path", phase_ins_path)
    spread_launches, spread_k2_ms = timed("spread sites", phase_spread_sites)
    disc_launches, disc_lines, disc_cl, disc_subset = timed("disc",
                                                            phase_disc)
    extract_launches = timed("extract device", phase_extract_device,
                             host_lines)
    routes = timed("routes", phase_routes)
    deep = timed("deep routes", phase_deep_routes)
    timed("python bam path", phase_python_bam)
    timed("scan", phase_scan_full)
    sharded_launches, sharded_extract_launches, _ = timed(
        "multi-device", phase_multi_device, fixture(), host_lines,
        disc_fixture(), disc_lines)
    graph_launches, long_launches, long_per_round, xlong = timed(
        "graph audt", phase_graph_audt, ins_lines)
    graph_disc_launches = timed("graph disc", phase_graph_disc, disc_lines,
                                disc_cl, disc_subset)
    phase_jax_check()
    print(f"[time] total: {time.perf_counter() - t_start:.1f}s", flush=True)

    flush, wide_main = poa_times["flush"], poa_times["wide_main"]
    print(json.dumps({"kernels": [{
        "name": "consensus_pos",
        "route": "cuda",
        "source": "svtrek_tpu_torch/csrc/consensus.cu",
        "replaces": "svtrek_tpu/ops/sweep_pallas.py:113",
        "launches": launches["consensus_pos"],
        "launches_extract_device": extract_launches,
        "launches_sharded": sharded_launches,
        "launches_sharded_extract": sharded_extract_launches,
        "launches_routes": routes["k1"],
        "launches_deep": deep["launches"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "ms_before": None,
        "device_ms": k1_alone,
        "device_ms_before": None,
        "launch_floor_ms": k1_floor,
        "full_sweep": k1_full,
    }, {
        "name": "poa_dp_ptr",
        "route": "cuda",
        "source": "svtrek_tpu_torch/csrc/poa.cu",
        "replaces": "svtrek_tpu/ops/poa_pallas.py:165",
        "launches": disc_launches["poa_dp_ptr"],
        "launches_routes": routes["k2"],
        "max_abs_err": poa_err["dp"],
        "ms": flush["k2"],
        "plain_ms": flush["k2_plain"],
        "bound_ms": flush["k2_bound"][0],
        "bound_by": flush["k2_bound"][1],
        "library_ms": None,
        "ms_before": None,
        "device_ms": flush["k2_device"],
        "device_ms_before": None,
    }, {
        "name": "poa_dp_ptr_wide",
        "route": "cuda",
        "source": "svtrek_tpu_torch/csrc/poa.cu",
        "replaces": "svtrek_tpu/ops/poa_pallas.py:165",
        "launches": spread_launches,
        "max_abs_err": poa_err["wide"],
        "ms": wide_main["k2"],
        "plain_ms": wide_main["k2_plain"],
        "bound_ms": wide_main["wide_bound"][0],
        "bound_by": wide_main["wide_bound"][1],
        "library_ms": None,
        "ms_before": None,
        "device_ms": wide_main["wide_device"],
        "device_ms_before": None,
        "cycles_per_row": wide_main["cycles_per_row"],
        "wide2k_device_ms": poa_times["wide2k"]["wide_device"],
        "wide2k_cycles_per_row": poa_times["wide2k"]["cycles_per_row"],
        "longrun_device_ms": poa_times["longrun"]["wide_device"],
        "longrun_cycles_per_row": poa_times["longrun"]["cycles_per_row"],
        "spread_k2_ms_per_batch": spread_k2_ms,
    }, {
        "name": "poa_traceback",
        "route": "cuda",
        "source": "svtrek_tpu_torch/csrc/poa.cu",
        "replaces": "svtrek_tpu/ops/poa_pallas.py:319",
        "launches": disc_launches["poa_traceback"],
        "launches_routes": routes["k3"],
        "max_abs_err": poa_err["tb"],
        "ms": flush["k3"],
        "plain_ms": flush["k3_plain"],
        "bound_ms": flush["k3_bound"][0],
        "bound_by": flush["k3_bound"][1],
        "library_ms": None,
        "ms_before": None,
        "device_ms": flush["k3_device"],
        "device_ms_before": None,
    }, {
        "name": "step_probe",
        "route": "cuda",
        "source": "svtrek_tpu_torch/csrc/step_probe.cu",
        "replaces": "tools/pallas_step_overhead.py:55",
        "launches": probe_launches,
        "max_abs_err": probe_err,
        "ms": probe["one_ms"],
        "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"],
        "bound_by": probe["bound_by"],
        "library_ms": probe["library_ms"],
        "ms_before": None,
        "device_ms": probe["device_ms"],
        "device_ms_before": None,
    }, {
        "name": "poa_graph_dp",
        "route": "cuda",
        "source": "svtrek_tpu_torch/csrc/poa_graph.cu",
        "replaces": "svtrek_tpu/ops/poa_graph_batch.py:127",
        "launches": graph_launches,
        "launches_disc": graph_disc_launches,
        "max_abs_err": graph_err,
        "ms": graph["ins_mix"]["ms"],
        "plain_ms": graph["ins_mix"]["plain_ms"],
        "bound_ms": graph["ins_mix"]["bound_ms"],
        "bound_by": graph["ins_mix"]["bound_by"],
        "library_ms": None,
        "ms_before": None,
        "device_ms": graph["ins_mix"]["device_ms"],
        "device_ms_before": None,
        "ring_hit_share": graph["ring_hit"],
        "long_device_ms": graph["long"]["device_ms"],
        "xlong_device_ms": graph["xlong"]["device_ms"],
        "n_cap_device_ms": graph["n_cap"]["device_ms"],
        "launches_long_sites": long_launches,
        "long_sites_ms_per_round": long_per_round,
        "launches_xlong_sites": xlong["launches"],
        "xlong_sites_ms_per_round": xlong["ms_per_round"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        # A gloo process of phase 15 (c), started by check_bootstrap.
        sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
        dist_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
