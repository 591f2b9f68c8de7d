#!/usr/bin/env python3
"""On-card smoke test of dbcsr_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``dbcsr_tpu_torch/csrc`` with
nvcc (both sources at once) and the multiply's host index engine from
``dbcsr_tpu_torch/native`` with g++, then runs these phases, each
printing one JSON line; any failure raises and the script exits
non-zero:

1. build: the card's name and power limit, CUDA version, nvcc seconds
   and ptxas resource lines of each source, K1's compiled instance of
   every form at one shape of each warp-path register class and at the
   tiled path's shapes, the units its products run on, and the fused
   launch's instances
   (registers, spilled bytes, shared memory, warps a block, blocks an SM), the
   persisting-L2 limit, and the index engine's g++ flags and seconds;
2. kernel_vs_plain: the base stack kernel (K1) against its plain PyTorch
   version, f64/f32/bf16 at block shapes (23,23,23), (23,18,23),
   (18,23,18), (5,13,23), the warp path's edges (32,32,32), (33,24,23)
   and (8,8,4), and the tiled path's (529,23,23), (64,64,64),
   (23,100,23), (100,50,20) and (200,180,300) (k slices), on stacks with
   short runs, one run of 5000 entries, alpha != 1 and a nonzero
   incoming C, two launches bit for bit alike; each case names the path
   it took (warp or tiled), and both paths must run; a tiled case names
   the card's geometry, which must be the host's;
3. crosspack_vs_plain: the crosspack kernel (K3) and its resident launch
   (K4) against their plain version on the same kind of stacks, at
   `choose_pack`'s pack for the same seven shapes and a forced pack
   (3, 5) for (16,24,12), both paths again; (100,50,20) must plan onto
   K1 (P = 1);
4. perf_gates: the `.perf` checksum gates through `run_perf` under
   ``mm_driver="auto"`` on the stack format (f64: K1 must launch, no
   plain version);
5. perf_gates_crosspack: the same gates under ``mm_driver="pallas_cross"``
   (K3 must launch, except on the 100/50/20 blocks, which take K1);
6. northstar: the north-star product (10k x 10k, 23x23 blocks,
   occupancy 0.1, f64, beta 0, 3 repeats) through K1, held against one
   repeat with ``mm_driver="torch"`` (the plain version) at rel <= 1e-10;
   repeats 2-3 must hit the multiply's plan cache, and the host "plan"
   seconds of the first repeat and of the hits are printed;
7. native_index: on the north star's operands, the native engine's
   expansion and stack sort against the NumPy path and `np.lexsort`
   (identical arrays and order), each piece of "index" and "plan" timed,
   then the multiply's host phases, plan-cache miss and hit, under both
   engines in turns (numpy, native, native, numpy), C bit for bit the
   same, and "index" on 10 pairs of plan-cache hits in turns;
   northstar_stacks: K1 and its plain version compared and timed on the
   north star's own stacks, with the least time the card could take
   (every stack of the ``*_stacks`` phases must take the warp path);
8. northstar_f32: the north star as sreal through K3 (no K1 launch, no
   plain call), held against one ``"torch"`` repeat (elementwise at the
   kernel validation tolerance, checksums at rel <= 1e-6), then K3 and
   its plain version timed on its stacks, and the host planning of its
   stacks for K1 and for K3 timed in turns;
9. resident_f32: `test_H2O` as sreal with a tuned ``crosspack_vmem`` row
   in a temporary parameter directory, through K4, held against the
   ``"torch"`` driver likewise, then K4, K3 and the plain version timed
   on its stacks;
10. formats: at the models' size (2208^2, 96 block rows of 23, full
   operands, f64 and f32) ``mm_format`` forced to "stack", "dense" and
   "composite" and left at "auto", and on a banded pattern with
   independent row panels the same four; every leg against the stack
   leg (f64 1e-12, f32 the kernel validation tolerance); the canvas
   GEMM timed alone beside its bound; the north star forced dense
   (`_dense_multiply_general`) beside its stack time and result; the
   `.perf` gates under the planner ("auto");
11. limits: block limits and unaligned element limits with beta 0.7 at
   2208^2 under ``"auto"`` (K1) and ``"torch"``, against each other at
   1e-12 and against a dense windowed oracle on the card; C outside the
   window bit for bit as it was;
12. models: the three linear-scaling DFT loops at `test_H2O`'s blocking
   (96 block rows of 23, 2208^2, f64) on `make_test_density(96, 23)`:
   McWeeny purification of the density, the filtered Newton-Schulz sign
   iteration of the density shifted by -0.5 on its diagonal, and the
   inverse square root of the density shifted by +0.5.  Each runs under
   ``"auto"`` (the planner: the sign loop must launch K1, purify and
   invsqrt must take the dense format; no plain call) and under
   ``"torch"`` on the stack format;
   histories and final iterates must agree (1e-10, or 10 * filter_eps
   where filtered), invsqrt must reach its tol, and purify's and sign's
   convergence measures must fall.  Each run prints its multiplies,
   launches, plan-cache outcomes, host seconds per phase, the stacks'
   device seconds (CUDA events), its format decisions, its wall time,
   the matrices its chains freed and the caching allocator's peak bytes;
   then in turns: the sign loop under the NumPy index path and the
   engine, purify and invsqrt under the planner and on the stack format;
13. models_f32: the sign iteration as f32 on the stack format through
   K3, held against ``"torch"`` elementwise at the kernel validation
   tolerance.
14. tensor_legs: the RI step of the water system below at cut depths
   (`TENSOR_LEGS`): at 32 molecules a contraction into the mapping
   (mu | nu,Q), then `tensor_copy` and `remap` back to (mu,nu | Q), bit
   for bit the direct contraction; at 48 a batched contraction over 4
   mu batches with ``filter_eps`` 1e-10 against one contraction
   (<= 1e-12); at 48 as f32 through the kernel "auto" picks (its line
   names it and its path) against ``"torch"`` at the kernel validation
   tolerance; at 12 `contract_test` against a dense einsum on the host;
   at 84 in complex128 (complex T and M from the same generator; full
   width would need about 84 GB of allocation, so the depth is the
   largest whose peak stays under 60 GB) on K1's tiled c8 form, against
   the plain driver in two mu batches (1e-10, checksums 1e-12), its
   kernel's ms beside the bound;
15. tensor: (mu nu|P) M(P,Q) -> (mu nu|Q) at full width through
   `tensor.contract` on `test_H2O`'s blocking: 96 molecules of 23
   orbitals, T where the density's pair pattern has (mu,nu) and (mu,P)
   (43,526 blocks of 23^3, 4.24 GB, seeded normals drawn on the card), M
   the density, C 190,965 blocks (18.6 GB); the TAS split (64 groups of
   block limits, C's pattern built once before them and its bins kept
   by every group) runs K1's tiled path on (529,23,23) products.  It
   prints nsplit, the wall time, the host phases, the stacks' device
   time beside their bound, the plan-cache outcomes, the allocator's
   peak and retries, and holds every block of C against the plain
   driver (run in two mu batches with ``bounds_2``) at <= 1e-10, the
   checksums at <= 1e-12; then the same contraction under
   ``precision="adaptive"`` and ``abft="verify"``: every stack on K1's
   tiled f64->f32 form, none promoted, C against the plain driver under
   the same precision at `form_tolerance`, the kernel's and the ABFT
   probes' ms timed apart beside the bound and the native leg;
16. resilience: faults injected on the card at `test_H2O`'s blocking
   (2208^2), each counted exactly, and no faulted product on the card
   ever runs a plain version (the card's chain holds the kernels only):
   ``pallas:raise,times=1`` (K1 fails over to the crosspack kernel K3,
   within 1e-12 of the clean product, one ``runtime`` failure and one
   fallback), ``execute_stack:nan,times=1`` (classified ``nan`` and
   recovered on K3), ``pallas:raise`` three times (the shape's breaker
   opens; the next product launches no K1 and runs on K3), ``dense:raise,times=1``
   on full operands (the canvas falls over to the stack format within
   1e-12), ``pallas_cross:raise`` and ``pallas_cross:oom`` on f32 (K3 fails
   over to K1; a runtime failure demotes the shape, so the next product
   plans onto K1, an out-of-memory one does not); ``mm_driver="host"`` on
   CPU matrices against ``"torch"`` (1e-12, both timed) and refused on the
   card's tensors; and `test_H2O.perf`'s checksum gate under a failing
   K1 launch;
17. integrity: on the models' operands (f64, 2208^2) the three loops
   under ``abft="verify"`` and ``"off"`` in turns, histories and iterates
   bit for bit alike, no mismatch and no rollback; each loop with ABFT
   off under a flip its chain invariant catches in the same step
   (`INVARIANT_FLIPS`: it rolls back, bit for bit on the clean loop) and
   under ``execute_stack:flip,seed=13,times=1`` (`FLIP`: each loop must
   end as the JAX package's guarded loop ends at this size,
   `FLIP_OFF_REFERENCE`), and under `FLIP` with "verify" (the probe
   recovers, nothing rolls back, bit for bit); purify under
   ``dense:flip,times=1`` (the canvas probe condemns the product, the
   stack format redoes it, within 1e-12); the north star, f64 (K1) and
   f32 (K3), under "verify" against "off" in turns, C bit for bit, with
   the probe's milliseconds beside the stacks'.
18. complex (before resilience): both complex forms of K1 against their
   plain version on both paths ((23,23,23), (5,13,7), (32,32,32),
   (100,50,20); runs of 1-16 entries and one of 5000; complex alpha)
   within `form_tolerance`; the north star's pattern at complex128
   and complex64 through `run_perf` on K1's complex form (the warp
   path; no crosspack, no plain call), against ``"torch"`` (1e-10 at
   complex128, the kernel validation tolerance at complex64), its
   stacks timed beside their bound and native f64 K1's time on the
   north star; and C = alpha A B^H at 2208^2
   (``transb="C"``) against the plain driver and a dense oracle;
19. precision (before resilience): every demoted form of K1 against its
   plain version on both paths (runs up to 5000 entries) within the
   rounding of the form's sums (`form_tolerance`; every ``*_stacks``
   phase holds each span so); the f64 north star under ``precision="adaptive"``
   and ``abft="verify"`` (every stack demoted, every probe passing, C
   within the ceiling of native, seconds per multiply native and
   demoted in turns); the forced modes "f32" and "bf16" and a tuned
   ``precision`` column on `test_H2O` (each form's launches and stacks,
   the units its products run on, and its time over native K1's on the
   same stacks, native K1 timed here for `test_H2O`);
   a forced promote (ceiling sabotaged; beta 0 and 0.5): a native
   re-execution bit for bit the native product, the cell native after;
   the sign loop under adaptive + verify demoting, promoting once and
   ending below the iteration's tolerance as the native loop does;
20. incremental (after integrity): the f32 north star on K3 and a
   2208^2 f64 product on K1, each repeated until the result cache
   installs, then a zero delta, one block row of A and 0.1%, 1% and 5%
   of A's blocks: every reuse bit for bit an ``incremental="full"`` run,
   its outcome counted (a splice, or a full recompute where a splice
   as large lost), each case timed against "full" in turns with its host phases;
   at 2208^2 the full-product probe under "verify", and an
   ``incremental:flip`` caught, counted and recomputed; the f64 north
   star never cached (its C is over the 512 MB budget); the three DFT
   loops under the default "auto" against "off" in turns, bit for bit.

21. superstack (after perf_gates_crosspack): `mixed_blocks.perf`
   (5000^2, blocks cycling 5, 13, 23, the last 21, occupancy 0.05) at f64
   (``mm_driver="auto"``) and f32 (``"pallas"``: "auto" would take K3,
   whose spans do not fuse), ``superstack`` "auto" and "per_span" in
   turns, 3 pairs of 2 repeats: the checksum gate against the JAX
   package's (`MIXED_BLOCKS_REFERENCE`), fused bit for bit per span, one
   fused dispatch per multi-span C bin and one per span otherwise, no
   plain call; each fused bin's kernel against its plain version and
   its bound; a synthetic fused bin on the tiled path (`TILED_BIN`:
   (48,48) blocks, spans of k 23 and 40) bit for bit its spans' launches;
   one ``execute_superstack:raise`` decomposing bit for bit, counted
   once.  It prints s per multiply, stack device ms and launches of both
   modes;
22. obs (after native_index): the north star (2 repeats) and the sign
   loop under the span tracer and the events sink with
   ``DBCSR_TPU_TORCH_SYNC_TIMING=1``: ``multiply`` spans with their
   phase children and attributes, ``stack`` instants, a loadable Chrome
   trace with one complete event per span, the events JSONL, the
   per-driver roofline rows on the H100 peaks (each fraction <= 1.05),
   Prometheus text that parses, a sealed profile epoch; the sign loop
   under `torch.profiler` (the device's busy and idle share of the
   traced window); the north star with the tracer on and off in turns.

23. acc_bench (after incremental, from the committed tuned table):
   `acc.bench.bench_smm` at 23^3 in f64, f32 and bf16, at 30000 entries
   and at the north star's span size (`acc.tune.NORTHSTAR_SPAN`), and
   `bench_trans` at 23^2 f64: ms, GFLOP/s, both byte conventions, the
   share of the least time (`stack_bound_s`), the kernel that ran, each
   validated against a float64 host oracle (errors must be 0);
24. tune: `acc.tune.tune_smm` on (23,23,23) f64 and f32 and (5,13,23)
   f64 into a temporary table: every candidate a hand-written kernel,
   checked against its plain version, none failing; each candidate's
   GFLOP/s and error, and the winner;
25. tuned: the north star (f64 and f32, its operands kept from the
   northstar phase), `mixed_blocks` f64, `test_H2O` f32 and the sign
   loop at 2208^2, from the committed table and from none in turns
   (`TUNED_PAIRS` pairs): s per multiply (median of the repeats after
   the first) or per loop, launches per kernel, fused and per-span
   dispatches, checksums against the untuned run (1e-9, 1e-6 at f32;
   the sign loop's iterate 10 * filter_eps); every span of a table run
   must have an exact row, and every kernel the table names must launch
   (a bench at one of its rows where no workload reaches it);
26. api (no table: f64 takes K1, f32 K3): `run_tests` with ``TEST_MM``
   at f64 and f32 and with ``TEST_BINARY_IO`` on the card; the north
   star's A through `binary_write`/`binary_read` and through
   `csr_from_matrix`/`matrix_from_csr` (the native COO fill), both bit
   for bit; `hadamard_product` and `function_of_elements` against
   their values on the CPU.
27. mesh (after api): the north star (f64, full width) on one-process
   grids of 1x2x2, 2x2x2 (two 2.5D layers) and 1x2x4 (the all-gather
   engine) with every image on the card (`parallel.sparse_multiply_distributed`
   through `run_perf(grid=...)`), from no table and from the committed
   table in turns, then f32 on 1x2x2: each leg `MESH_NREP` repeats in
   the double-buffered order, one in the serial order (bit for bit),
   one under `torch.profiler` (the stack kernels' device ms beside the
   summed bound of the tick stacks, the card's idle share); checksums
   within 1e-9 (f32 1e-6) of the single-device multiply; s per
   multiply (first and later repeats), host s per phase, stacks per
   multiply and launches per tick by kernel (every tick stack on K1 or
   K3, no plain call), padded against true flops; then the `.perf`
   gates of phase 4 on a 2x2x2 and a 1x2x3 grid (`mesh_gates`; the
   north star's input has no gate, so its checksums are held against
   the single-device multiply);
28. mesh_world: four ranks on the one card over gloo (spawned, a
   `file://` rendezvous), one image each of a 2x2 grid, panels staged
   through the host: the north star (2 repeats) and
   `test_square_sparse_rma.perf` through `run_perf_multiproc`; every
   rank's C bit for bit the others' and the one-process 2x2 grid's;
   each rank's host-staged bytes and seconds (shifts and C's gather),
   s per multiply, the world rate;
29. mesh_models: one sparse McWeeny step at 2208^2 on 1x2x2 against the
   single-device step, and the RI contraction's grid branch at 32
   molecules on 1x2x2 against the single-device contraction (1e-10);
30. telemetry: the health, telemetry and diagnosis plane under
   ``DBCSR_TPU_TORCH_SYNC_TIMING=1`` with a sample at every product and
   incident bundles in a temporary directory: the north star forced
   dense, then on the stack format (a real step on this card); a
   change-point on ``multiply_latency_ms`` in the regressing direction
   (its shift time and magnitude), RCA's top cause the ``knob_change``
   of ``mm_format``, the ``rca:multiply_latency_ms`` bundle on disk, the
   verdict OK before the step; a ``pallas`` fault on one shape until its
   breaker opens (``drivers`` DEGRADED with its reason, OK after the
   reset); the store's (driver, mnk, dtype) cells; `mesh_world`'s
   ``mp_world_join`` watchdog outcomes; the hooks' cost (the north star
   with the store and health on against off, in pairs of turns);
31. autotune: from an empty temporary table, the north star and
   `mixed_blocks.perf` with the store on (what the health detectors
   fire during the warm-up, OK once warm), then `TuneService.cycle()`:
   the mined cells with their wasted FLOP-seconds, the trial's
   candidates (K1, K3 at its legal packs, K4 where the persisting-L2
   window admits them, K1's demoted forms) with GFLOP/s and their check
   against the plain version, the winner, the promotion and the params
   generation before and after (a second cycle with the margin at -1
   when the first held); a cycle with ``tune_trial`` injected promotes
   nothing; an idle cycle's format trial (or the format trial of the
   north star's cell) beside the north star's own stack and dense
   times; the next north-star multiply after the promotion misses the
   plan cache, launches the kernel the row names and keeps its checksum
   within 1e-9; the committed table is byte for byte unchanged.
32. serve (after autotune): an in-process `ServeEngine` on the card, 4
   tenants with north-star operands (one pattern, each tenant's own
   values drawn on the card), with the quotas and the product cache's
   bytes raised past a north-star request (`SERVE_CFG`, printed; the
   JAX package's defaults shed it): warm legs until admission reads OK;
   the 4 requests inside one batching window, serialized and coalesced,
   with no table (the composite takes K1's fused launch) and the
   committed table (K3), each tenant's C bit for bit its standalone
   product and within 1e-10 of one ``mm_driver="torch"`` product, the
   launches and dispatches of each; `SERVE_PAIRS` coalesced/serialized
   pairs in turns (committed table): requests/s, each tenant's median
   and largest latency (n = the legs), the composite's host phases
   (from each member's attribution row), the card's busy share over one
   coalesced leg; the product cache (an identical request hits with no
   launch, A scaled in place misses and gives the new product's bits);
   a served NaN (``serve_execute:nan``) caught by the per-request
   ABFT probe and re-executed, bit for bit the clean C; a
   ``serve_admit`` fault shed with the structured rejection.  No stack
   reaches a plain version;
33. serve_http: the obs endpoint on a free localhost port in this
   process: ``/serve/session/open``, ``/serve/matrix`` (north-star
   specs made on the card), ``/serve/submit`` with ``wait``,
   ``/serve/status``, ``/serve/tenants``, ``/serve/checksum`` (equal to
   the in-process checksum), ``/healthz``, ``/metrics``, ``/usage``,
   and a shed answered 429 with the rejection;
34. fleet: `Fleet(n=2, device="cuda")`, two worker processes on the one
   card (coalescing off), each one's start seconds: the router places
   two tenants on different workers, each submits north-star requests;
   the first tenant's worker is SIGKILLed with `FLEET_REQUESTS` in
   flight, `failover` replays its journal on the peer, `audit` shows
   every request landed exactly once, and every checksum equals a
   clean in-process run's bit for bit; then, the killed worker
   respawned, a product-cache hit through the peer tier on the models'
   2208^2 operands (a north-star C is 792 MB) with no launch and no
   dispatch on the second worker.  The workers' launches come from
   their kernel wrappers' own counts on their ``/metrics``
   (`obs.server.kernel_counts_text`), each read as a difference from the
   worker's start; no worker's stack may call a plain version.

Phases 1-22, 28-30 and 33-34 (and 27's gates and f32 leg, and 32's
no-table leg) run with an empty tuned-table directory, so on the untuned rules, as before the committed
table existed; every phase line names the table it ran from
(``"table"``: "none", "committed" or "temporary").

The phases before `incremental` run with ``incremental="off"``, as the
perf driver's repeats do: they time the engine.  Every phase but
resilience, integrity, incremental, telemetry and autotune injects
nothing and must end with
no driver failure, fallback, ABFT mismatch or rollback (`_clean`); those
three clear their faults and reset the breakers whatever happens.

The line before the last is the kernels' JSON summary (K1's entry lists
its complex and demoted ``forms``, each with its launches on its
phase's main path, time, error, bound, units and ratio to native K1; K1's fused launch
``smm_superstack`` has its own entry, its launches by phase beside it;
"auto" fuses every C bin of several K1 spans, so the phases that
require K1 count its per-span and fused launches together); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints
no result.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import itertools
import json
import os
import re
import subprocess
import sys
import statistics
import tempfile
import time

import numpy as np
import torch

from dbcsr_tpu_torch import native
from dbcsr_tpu_torch.acc import abft, build, crosspack_kernel, params, stack_kernel
from dbcsr_tpu_torch.acc import precision as port_precision
from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.acc.bench import bench_smm, bench_trans
from dbcsr_tpu_torch.acc.crosspack import choose_pack, resident_limit_bytes
from dbcsr_tpu_torch.acc.smm import prepare_stack
from dbcsr_tpu_torch.acc.tune import NORTHSTAR_SPAN, tune_smm
from dbcsr_tpu_torch.core import digests, mempool, timings
from dbcsr_tpu_torch.core.config import set_config
from dbcsr_tpu_torch.core.kinds import dtype_of, name_of
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix, _Bin
from dbcsr_tpu_torch.interop import matrix_from_numpy_state, matrix_to_numpy_state
from dbcsr_tpu_torch.device import resolve_device
from dbcsr_tpu_torch.mm import incremental as port_inc
from dbcsr_tpu_torch.mm import format_planner
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.mm.multiply import (
    _build_spans,
    _candidates,
    _candidates_numpy,
    _effective,
    _to_dense_device,
)
from dbcsr_tpu_torch.models import integrity
from dbcsr_tpu_torch.models import (
    invsqrt_iteration,
    make_test_density,
    mcweeny_purify,
    mcweeny_step,
    mcweeny_step_sparse_distributed,
    sign_iteration,
)
from dbcsr_tpu_torch.ops.operations import (
    add_on_diag,
    added,
    copy,
    frobenius_norm,
    gershgorin_norm,
    maxabs_norm,
    scale,
    trace,
)
from dbcsr_tpu_torch.ops.csr import csr_from_matrix, matrix_from_csr
from dbcsr_tpu_torch.ops.io import binary_read, binary_write
from dbcsr_tpu_torch.ops.operations import FUNC_TANH, function_of_elements, hadamard_product
from dbcsr_tpu_torch.ops.test_methods import checksum, make_random_matrix
from dbcsr_tpu_torch.ops.tests import TEST_BINARY_IO, TEST_MM, run_tests
from dbcsr_tpu_torch.obs import costmodel as port_costmodel
from dbcsr_tpu_torch.obs import changepoint, events, health, metrics, profiler, rca, slo
from dbcsr_tpu_torch.obs import server as obs_server
from dbcsr_tpu_torch.obs import timeseries as obs_ts
from dbcsr_tpu_torch.obs import tracer as obs_tracer
from dbcsr_tpu_torch.obs.costmodel import (
    crosspack_entries,
    demoted_abft_tolerance,
    form_tolerance,
    kernel_validation_tolerance,
    H100_BYTES_PER_S,
    H100_PEAK_FLOPS,
    stack_bound_s,
    stack_bytes,
    stack_min_bytes,
)
from dbcsr_tpu_torch.parallel import sparse_dist
from dbcsr_tpu_torch.parallel.mesh import Grid
from dbcsr_tpu_torch.perf.driver import (
    expand_block_sizes,
    parse_perf_file,
    run_perf,
    run_perf_multiproc,
)
from dbcsr_tpu_torch.resilience import breaker, faults
from dbcsr_tpu_torch.serve import engine as serve_engine
from dbcsr_tpu_torch.serve import product_cache
from dbcsr_tpu_torch.serve import session as serve_session
from dbcsr_tpu_torch.serve.engine import ServeEngine
from dbcsr_tpu_torch.serve.fleet import Fleet
from dbcsr_tpu_torch.serve.session import Session
from dbcsr_tpu_torch.tune import miner as tune_miner
from dbcsr_tpu_torch.tune import service as tune_service
from dbcsr_tpu_torch.tune import trials as tune_trials
from dbcsr_tpu_torch.tensor import (
    batched_contraction,
    contract,
    contract_test,
    copy_matrix_to_tensor,
    create_tensor,
    remap,
    tensor_copy,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(ROOT, "tests", "inputs")

KERNELS = {
    "smm_stack": ("dbcsr_tpu_torch/csrc/smm_stack.cu",
                  "dbcsr_tpu/acc/pallas_smm.py:132"),
    "smm_crosspack": ("dbcsr_tpu_torch/csrc/smm_crosspack.cu",
                      "dbcsr_tpu/acc/pallas_smm.py:456"),
    "smm_crosspack_resident": ("dbcsr_tpu_torch/csrc/smm_crosspack.cu",
                               "dbcsr_tpu/acc/pallas_smm.py:535"),
    # K1's fused launch over every span of one C bin: the chain of K1
    # launches in one jit (`process_launches` inside `_fused_fn`)
    "smm_superstack": ("dbcsr_tpu_torch/csrc/smm_stack.cu",
                       "dbcsr_tpu/acc/pallas_smm.py:765"),
}
LIBRARY_NOTE = "no single PyTorch call computes this function"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# the committed parameter tables (`dbcsr_tpu_torch/acc/params/`)
TABLE_DIR = os.path.join(ROOT, "dbcsr_tpu_torch", "acc", "params")


def _table_label() -> str:
    """Which tuned table dispatch reads: "none" (no table for this card
    in the directory in force), "committed" or "temporary"."""
    path = params.params_path()
    if not os.path.exists(path):
        return "none"
    return "committed" if os.path.dirname(path) == TABLE_DIR else "temporary"


def _use_table(directory: str) -> None:
    """Point dispatch at the tuned table of ``directory`` (plans cached
    under another table miss: the plan key holds the table's path and
    generation)."""
    os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = directory
    params.invalidate()


def _emit(obj: dict) -> None:
    print(json.dumps({**obj, "table": obj.get("table", _table_label())}), flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# K1's fused launches on each phase's main path: `_reset_counts` moves
# the wrapper's count into the phase in force (`_clean` and `main` set
# it); a phase that launches the fused kernel to compare or time it
# resets the wrapper's count directly, so those launches count nowhere
_PHASE_NOW = ["build"]
_SUPERSTACK_BY_PATH: dict = {}


def _reset_counts() -> None:
    n = stack_kernel.superstack_launches
    if n:
        _SUPERSTACK_BY_PATH[_PHASE_NOW[0]] = _SUPERSTACK_BY_PATH.get(_PHASE_NOW[0], 0) + n
    stack_kernel.reset_counts()
    crosspack_kernel.reset_counts()


def _counts() -> dict:
    return {"smm_stack": stack_kernel.launches,
            "smm_superstack": stack_kernel.superstack_launches,
            "smm_crosspack": crosspack_kernel.launches_cross,
            "smm_crosspack_resident": crosspack_kernel.launches_resident,
            "plain": stack_kernel.plain_calls + crosspack_kernel.plain_calls}


def _k1(counts: dict) -> int:
    """K1's launches, per span and fused: under ``superstack="auto"`` a C
    bin with several spans takes the fused launch instead of K1's."""
    return counts["smm_stack"] + counts["smm_superstack"]


def _calls(plan, resident=None):
    """(kernel, plain) callables running ``plan``'s kernel and its plain
    version as ``f(c, a, b, alpha)`` (at the plan's precision);
    ``resident`` overrides a crosspack plan's launch."""
    if plan.driver != "crosspack":
        args = (plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c)
        prec = plan.precision
        return (lambda c, a, b, al: stack_kernel.smm_stack(c, a, b, *args, al, precision=prec),
                lambda c, a, b, al: stack_kernel.smm_stack_plain(c, a, b, *args, al,
                                                                 precision=prec))
    args = (plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c, plan.pack_runs, plan.pack)
    res = plan.resident if resident is None else resident
    return (lambda c, a, b, al: crosspack_kernel.smm_crosspack(
                c, a, b, *args, al, resident=res, window=plan.window),
            lambda c, a, b, al: crosspack_kernel.smm_crosspack_plain(c, a, b, *args, al))


def _written(kernel, c, a, b, alpha):
    """``kernel`` on a copy of ``c``, which it must mark as written (its
    version counter moves, as `mm.multiply._dense_canvas_cached` needs)."""
    out = c.clone()
    version = out._version
    kernel(out, a, b, alpha)
    _require(out._version > version, "a kernel wrapper wrote C without bumping its version")
    return out


def _wide(t):
    """``t`` in float64, or complex128 for a complex tensor."""
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def _rel_err(got, want) -> float:
    diff = float((_wide(got) - _wide(want)).abs().max())
    return diff / max(float(_wide(want).abs().max()), 1.0)


def phase_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    build.build_all()
    native.get_lib()
    _emit({"phase": "build", "card": card, "k1_instances": _k1_instances(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
           "nvcc_s": {src: build.build_seconds[src] for src in build.SOURCES},
           "ptxas": {src: [ln.strip() for ln in build.build_logs.get(src, "").splitlines()
                           if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
                     for src in build.SOURCES},
           "persisting_l2_bytes": resident_limit_bytes(resolve_device()),
           "index_engine": {"compiler": "g++", "flags": list(native.FLAGS),
                            "seconds": native.build_seconds,
                            "library": os.path.basename(native.library_path())}})
    return card


def _k1_instances() -> list:
    """Every form of K1 at one shape of each warp-path register class
    (2, 3 and 4 tiles of 8) and at the tiled path's shapes (the RI
    contraction's (529,23,23) first), and the fused launch's warp and
    tiled instances: the compiled instance's registers, local (spilled)
    bytes, shared bytes, warps a block and blocks an SM, as the card
    reports them, with the units the form's products run on."""
    rows = []
    for dtype, spec in K1_FORMS:
        for m, n, k in ((5, 13, 7), (23, 23, 23), (32, 32, 32)) + TILED_SHAPES:
            rows.append({"form": stack_kernel.form_name(dtype, spec), "mnk": [m, n, k],
                         "path": stack_kernel.kernel_path(m, n, k, dtype),
                         "units": stack_kernel.form_units(dtype, spec),
                         **stack_kernel.kernel_attrs(m, n, k, dtype, spec)})
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for m, n, ks in ((23, 23, (23, 18)), TILED_BIN):
            rows.append({"form": stack_kernel.form_name(dtype), "fused": True, "mn": [m, n],
                         "k": list(ks), "path": stack_kernel.kernel_path(m, n, max(ks), dtype),
                         **stack_kernel.superstack_attrs(m, n, ks, dtype)})
    return rows


def _synthetic_stack(rng, m, n, k, dtype, long_run=5000, max_len=4):
    """Operand bins and a sorted stack: 300 C blocks with runs of 1 to
    ``max_len`` entries, plus one C block with a run of ``long_run``
    entries (complex values for a complex dtype)."""
    na, nb, nc = 700, 600, 301
    dev = resolve_device()

    def values(shape):
        x = rng.standard_normal(shape)
        if dtype.is_complex:
            x = x + 1j * rng.standard_normal(shape)
        return torch.from_numpy(x).to(dev, dtype)
    a, b, c = values((na, m, k)), values((nb, k, n)), values((nc, m, n))
    lens = rng.integers(1, max_len + 1, size=nc)
    lens[150] = long_run
    c_idx = np.repeat(np.arange(nc), lens)
    a_idx = rng.integers(0, na, size=len(c_idx))
    b_idx = rng.integers(0, nb, size=len(c_idx))
    return a, b, c, a_idx, b_idx, c_idx


# block shapes of the kernel-vs-plain phases: the north star's, shapes of
# the `.perf` inputs, and the warp path's edges: (32,32,32) at its limit,
# (33,24,23) just above it, (8,8,4) with no padding
SHAPES = ((23, 23, 23), (23, 18, 23), (18, 23, 18), (5, 13, 23), (32, 32, 32),
          (33, 24, 23), (8, 8, 4))
# the tiled path's shapes: the RI contraction's (529,23,23) (one chunk of
# 67 x 3 tiles), square (64,64,64), wide (23,100,23), the old checks
# (100,50,20) and (33,24,23), and (200,180,300), whose entries exceed the
# shared memory and run in k slices
TILED_SHAPES = ((529, 23, 23), (64, 64, 64), (23, 100, 23), (100, 50, 20), (200, 180, 300))


def phase_kernel_vs_plain() -> None:
    """K1 against its plain version on synthetic stacks (runs of 1-4
    entries and one of 5000), f64, f32 and bf16, at the warp path's shapes
    and the tiled path's: within `kernel_validation_tolerance`, and two
    launches on the same C bit for bit equal; each tiled case names its
    geometry (`stack_kernel.tiled_geometry`)."""
    rng = np.random.default_rng(20261016)
    alpha = -0.75
    cases = []
    paths = set()
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for m, n, k in SHAPES + tuple(s for s in TILED_SHAPES if s not in SHAPES):
            a, b, c, a_idx, b_idx, c_idx = _synthetic_stack(rng, m, n, k, dtype)
            plan = prepare_stack(c, a, b, a_idx, b_idx, c_idx, variant="kmerge")
            kernel, plain = _calls(plan)
            path = stack_kernel.kernel_path(m, n, k)
            paths.add(path)
            got = _written(kernel, c, a, b, alpha)
            again = _written(kernel, c, a, b, alpha)
            want = plain(c.clone(), a, b, alpha)
            torch.cuda.synchronize()
            _require(torch.equal(got, again),
                     f"K1 {dtype} {(m, n, k)} ({path} path): two launches differ")
            rel = _rel_err(got, want)
            tol = kernel_validation_tolerance(name_of(dtype), k, plan.max_run)
            _require(np.isfinite(rel) and rel <= tol,
                     f"kernel != plain for {dtype} {(m, n, k)} ({path} path): "
                     f"rel {rel:.3e} > {tol:.1e}")
            del got, again, want
            scratch = c.clone()
            ms = _time_ms(lambda: kernel(scratch, a, b, alpha), 10)
            plain_ms = _time_ms(lambda: plain(scratch, a, b, alpha), 3)
            bound, by = stack_bound_s(name_of(dtype), m, n, k, plan.entries,
                                      len(np.unique(a_idx)), len(np.unique(b_idx)), plan.nruns)
            case = {"dtype": name_of(dtype), "mnk": [m, n, k], "path": path,
                    "entries": plan.entries, "runs": plan.nruns,
                    "longest_run": plan.max_run, "max_rel_err": rel,
                    "tolerance": tol, "repeat_bitwise": True, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound * 1e3, "bound_by": by}
            if path == "tiled":
                case["geometry"] = stack_kernel.tiled_geometry(m, n, k, dtype)
            cases.append(case)
            del a, b, c, scratch
    _require(paths == {"warp", "tiled"}, f"K1 ran the paths {sorted(paths)}, not both")
    _emit({"phase": "kernel_vs_plain", "alpha": alpha, "library_ms": None,
           "library_note": LIBRARY_NOTE, "cases": cases})


def phase_crosspack_vs_plain() -> None:
    rng = np.random.default_rng(20261017)
    alpha = -0.75
    cases = []
    paths = set()
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for (m, n, k), pack in [(mnk, None) for mnk in SHAPES] + [((16, 24, 12), (3, 5))]:
            a, b, c, a_idx, b_idx, c_idx = _synthetic_stack(rng, m, n, k, dtype)
            plan = prepare_stack(c, a, b, a_idx, b_idx, c_idx, variant="crosspack",
                                 pack=pack)
            _require(plan.driver == "crosspack" and plan.pack == (pack or choose_pack(m, n, k)),
                     f"{(m, n, k)} did not plan onto crosspack at its pack")
            tol = kernel_validation_tolerance(name_of(dtype), k, plan.max_run)
            bound, by = stack_bound_s(name_of(dtype), m, n, k, plan.entries,
                                      len(np.unique(a_idx)), len(np.unique(b_idx)), plan.nruns)
            path = crosspack_kernel.kernel_path(dtype, plan.pack, m, n, k)
            paths.add(path)
            row = {"dtype": name_of(dtype), "mnk": [m, n, k], "pack": list(plan.pack),
                   "path": path,
                   "entries": plan.entries, "runs": plan.nruns, "packs": plan.pack_runs.numel()
                   // plan.pack[0], "entry_slots": crosspack_entries(plan),
                   "longest_run": plan.max_run, "tolerance": tol,
                   "bound_ms": bound * 1e3, "bound_by": by, "library_ms": None}
            _, plain = _calls(plan)
            want = plain(c.clone(), a, b, alpha)
            scratch = c.clone()
            row["plain_ms"] = _time_ms(lambda: plain(scratch, a, b, alpha), 3)
            for tag, resident in (("cross", False), ("resident", True)):
                kernel, _ = _calls(plan, resident=resident)
                got = _written(kernel, c, a, b, alpha)
                torch.cuda.synchronize()
                rel = _rel_err(got, want)
                _require(np.isfinite(rel) and rel <= tol,
                         f"crosspack ({tag}) != plain for {dtype} {(m, n, k)} pack "
                         f"{plan.pack} ({path} path): rel {rel:.3e} > {tol:.1e}")
                row[f"{tag}_max_rel_err"] = rel
                row[f"{tag}_ms"] = _time_ms(lambda: kernel(scratch, a, b, alpha), 10)
            cases.append(row)
    # blocks too wide to pack side by side plan onto the base kernel
    a, b, c, a_idx, b_idx, c_idx = _synthetic_stack(rng, 100, 50, 20, torch.float32, 10)
    plan = prepare_stack(c, a, b, a_idx, b_idx, c_idx, variant="crosspack")
    _require(plan.driver == "kernel" and choose_pack(100, 50, 20)[0] == 1,
             f"(100, 50, 20) planned onto {plan.driver}, not the base kernel")
    _require(paths == {"warp", "tiled"}, f"K3 ran the paths {sorted(paths)}, not both")
    _emit({"phase": "crosspack_vs_plain", "alpha": alpha, "library_ms": None,
           "library_note": LIBRARY_NOTE, "p1_shape_takes_base_kernel": [100, 50, 20],
           "cases": cases})


PERF_GATES = (("test_H2O", 3), ("test_square_sparse", 1), ("test_rect1_sparse", 1),
              ("test_rect2_sparse", 1), ("test_singleblock", 1),
              ("test_square_sparse_bigblocks", 1))


def phase_perf_gates(driver: str) -> None:
    """The `.perf` gates under ``mm_driver=driver``: "auto" (f64 takes
    K1) or "pallas_cross" (K3, except where P = 1)."""
    rows = []
    set_config(mm_driver=driver, mm_format="stack")
    try:
        for name, nrep in PERF_GATES:
            cfg = parse_perf_file(os.path.join(INPUTS, f"{name}.perf"))
            cfg.nrep = nrep
            _reset_counts()
            res = run_perf(cfg, verbose=False)  # raises on a mismatch (no retry)
            _require("checksum_retry" not in res,
                     f"{name} under {driver}: the gate passed only on the safe driver's "
                     f"retry ({res.get('checksum_retry')})")
            counts = _counts()
            wanted = "smm_crosspack" if driver == "pallas_cross" else "smm_stack"
            if driver == "pallas_cross" and all(
                    choose_pack(m, n, k)[0] == 1 for m, n, k, *_ in res["spans"]):
                wanted = "smm_stack"  # every span has P = 1
            _require((_k1(counts) if wanted == "smm_stack" else counts[wanted]) > 0,
                     f"{name} under {driver}: {wanted} never launched")
            _require(counts["plain"] == 0,
                     f"{name} under {driver}: the plain versions ran {counts['plain']} times")
            rows.append({"input": name, "nrep": nrep, "checksum": res["checksum"],
                         "checksum_pos": res["checksum_pos"],
                         "refs": list(cfg.check_refs), "threshold": cfg.check_threshold,
                         "launches": counts, "kernels": sorted({s[4] for s in res["spans"]}),
                         "times_s": res["times_s"], "gflops_best": res["gflops_best"]})
    finally:
        set_config(mm_driver="auto", mm_format="auto")
    _emit({"phase": "perf_gates" if driver == "auto" else "perf_gates_crosspack",
           "mm_driver": driver, "mm_format": "stack", "passed": len(rows), "inputs": rows})


# `mixed_blocks.perf` (no reference of its own): checksum(C_out) and the
# positional checksum of the JAX package on the CPU, and the gate's
# threshold, by data type (`tools/perf_reference.py`; the f32 product
# sums in another order than the JAX package's, so its gate is 1e-5)
MIXED_BLOCKS_REFERENCE = {3: (319347450.2883681, 22136.340151119803, 1e-9),
                          1: (319347450.1070105, 22136.35605660081, 1e-5)}
SUPERSTACK_PAIRS = 3


def _mixed_cfg(data_type: int, nrep: int):
    cfg = parse_perf_file(os.path.join(INPUTS, "mixed_blocks.perf"))
    cfg.data_type, cfg.nrep = data_type, nrep
    ref, ref_pos, threshold = MIXED_BLOCKS_REFERENCE[data_type]
    cfg.check, cfg.check_refs, cfg.check_threshold = True, (ref, ref_pos), threshold
    return cfg


def _bins_of(spans) -> dict:
    """Spans per C bin, a C bin being the (m, n) of its blocks."""
    bins: dict = {}
    for sp in spans:
        bins[tuple(sp[:2])] = bins.get(tuple(sp[:2]), 0) + 1
    return bins


def _dispatches() -> dict:
    out = {"fused": 0.0, "per_span": 0.0}
    for lab, v in metrics.counter_items("dbcsr_tpu_dispatches_total"):
        out[lab["mode"]] = v
    return out


def _fused_bins_vs_plain(a, b, c, reps: int = 5) -> dict:
    """Every fused bin of the product ``c = a * b`` (beta 0), re-planned:
    the fused kernel against `smm_superstack_plain` on a zero bin (within
    `kernel_validation_tolerance` at the bin's largest k and summed
    longest runs), timed by CUDA events (kernel mean of ``reps``, plain
    mean of 2) beside the least time the card could take (each span's
    referenced A and B blocks and index arrays read once, the bin's C
    blocks read and written once, or the true flops at the FP64/FP32
    peak), and once under `torch.profiler` (``device_ms``: the kernels'
    own time, without the host work between launches).  These launches
    are no part of the main path: the wrapper's count is reset after
    them."""
    i, j, a_ent, b_ent = _candidates(a, b, None)
    spans = _build_spans(c, a, b, i * c.nblkcols + j, a_ent, b_ent)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "max_rel_err": 0.0, "bins": 0, "min_bytes": 0, "flops": 0}
    rows, by_bytes, launches = [], 0, []
    for cbin in sorted({sp.cbin for sp in spans}):
        group = [sp for sp in spans if sp.cbin == cbin]
        if len(group) < 2:
            continue
        cd = c.bins[cbin].data
        splan = port_smm.prepare_superstack([sp.plan for sp in group],
                                            [(sp.m, sp.n, sp.k) for sp in group], cd)
        _require(splan is not None and splan.family == "pallas",
                 f"superstack: the ({group[0].m}, {group[0].n}) bin cannot fuse")
        args = [(a.bins[sp.abin].data, b.bins[sp.bbin].data, sp.plan.a_idx, sp.plan.b_idx,
                 sp.plan.run_ptr, sp.plan.run_c) for sp in group]
        got = stack_kernel.smm_superstack(torch.zeros_like(cd), args, splan.table, 1.0)
        want = stack_kernel.smm_superstack_plain(torch.zeros_like(cd), args, 1.0)
        kmax = max(sp.k for sp in group)
        depth = sum(sp.plan.max_run for sp in group)
        tol = kernel_validation_tolerance(name_of(cd.dtype), kmax, depth)
        rel = _rel_err(got, want)
        _require(np.isfinite(rel) and rel <= tol,
                 f"superstack: the fused kernel on ({group[0].m}, {group[0].n}) against its "
                 f"plain version: rel {rel:.3e} > {tol:.1e}")
        scratch = torch.zeros_like(cd)
        ms = _time_ms(lambda: stack_kernel.smm_superstack(scratch, args, splan.table, 1.0), reps)
        plain_ms = _time_ms(lambda: stack_kernel.smm_superstack_plain(scratch, args, 1.0), 2)
        dname = name_of(cd.dtype)
        nruns = int(splan.table[4].numel())
        nbytes = sum(stack_min_bytes(dname, sp.m, sp.n, sp.k, sp.entries,
                                     len(torch.unique(sp.plan.a_idx)),
                                     len(torch.unique(sp.plan.b_idx)), 0) for sp in group)
        nbytes += cd.element_size() * 2 * nruns * group[0].m * group[0].n \
            + 4 * (3 * int(splan.table[0].numel()) + nruns + 1)
        flops = sum(2 * sp.m * sp.n * sp.k * sp.entries for sp in group)
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_PEAK_FLOPS[dname]
        rows.append({"mn": [group[0].m, group[0].n], "k": [sp.k for sp in group],
                     "entries": sum(sp.entries for sp in group), "runs": nruns,
                     "path": stack_kernel.kernel_path(group[0].m, group[0].n, kmax, cd.dtype),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
                     "rel_err": rel, "tolerance": tol})
        by_bytes += t_bytes >= t_ops
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += max(t_bytes, t_ops) * 1e3
        tot["max_abs_err"] = max(tot["max_abs_err"],
                                 float((_wide(got) - _wide(want)).abs().max()))
        tot["max_rel_err"] = max(tot["max_rel_err"], rel)
        tot["bins"] += 1
        tot["min_bytes"] += nbytes
        tot["flops"] += flops
        launches.append((scratch, args, splan.table))
        del got, want
    # the kernels' own device time, apart from the host work between
    # launches that the events above include: one launch of each bin
    # under torch.profiler
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for scratch, args, table in launches:
            stack_kernel.smm_superstack(scratch, args, table, 1.0)
        torch.cuda.synchronize()
    tot["device_ms"] = sum(getattr(e, "self_device_time_total", 0.0)
                           for e in prof.key_averages() if "superstack" in e.key) / 1e3
    del launches
    stack_kernel.reset_counts()  # comparison launches: no part of the main path
    tot["bound_by"] = "bytes" if 2 * by_bytes >= len(rows) else "operations"
    tot["rows"] = rows
    return tot


# a synthetic fused bin on the tiled path: (48, 48) C blocks, spans of
# depth 23 and 40 (two segments a run where both spans reach a C block)
TILED_BIN = (48, 48, (23, 40))


def _tiled_bin_vs_per_span(dtype, reps: int = 5) -> dict:
    """One fused bin of tiled shapes (`TILED_BIN`): 400 C blocks, each
    span with runs of 0-4 entries and one of 300; the fused launch bit
    for bit the spans' own launches one after the other, and within
    `kernel_validation_tolerance` of its plain version; both timed.  These
    launches are no part of the main path: the wrapper's count is reset
    after them."""
    m, n, ks = TILED_BIN
    rng = np.random.default_rng(20261020)
    dev = resolve_device()
    nc = 400
    c = torch.from_numpy(rng.standard_normal((nc, m, n))).to(dev, dtype)
    spans, plans = [], []
    for k in ks:
        a = torch.from_numpy(rng.standard_normal((300, m, k))).to(dev, dtype)
        b = torch.from_numpy(rng.standard_normal((200, k, n))).to(dev, dtype)
        lens = rng.integers(0, 5, size=nc)
        lens[7] = 300
        c_idx = np.repeat(np.arange(nc), lens)
        plan = prepare_stack(c, a, b, rng.integers(0, 300, size=len(c_idx)),
                             rng.integers(0, 200, size=len(c_idx)), c_idx, variant="kmerge")
        spans.append((a, b, plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c))
        plans.append(plan)
    table = stack_kernel.superstack_table([p.run_ptr.cpu().numpy() for p in plans],
                                          [p.run_c.cpu().numpy() for p in plans], dev)

    def per_span(out):
        for sp in spans:
            stack_kernel.smm_stack(out, *sp, 0.6)
        return out
    fused = stack_kernel.smm_superstack(c.clone(), spans, table, 0.6)
    each = per_span(c.clone())
    plain = stack_kernel.smm_superstack_plain(c.clone(), spans, 0.6)
    torch.cuda.synchronize()
    path = stack_kernel.kernel_path(m, n, max(ks), dtype)
    _require(path == "tiled", f"superstack: the synthetic bin took the {path} path")
    _require(torch.equal(fused, each),
             f"superstack {dtype}: the fused tiled bin differs from its spans' launches")
    rel = _rel_err(fused, plain)
    tol = kernel_validation_tolerance(name_of(dtype), max(ks), sum(p.max_run for p in plans))
    _require(np.isfinite(rel) and rel <= tol,
             f"superstack {dtype}: the fused tiled bin against its plain version: "
             f"rel {rel:.3e} > {tol:.1e}")
    scratch = c.clone()
    ms = _time_ms(lambda: stack_kernel.smm_superstack(scratch, spans, table, 0.6), reps)
    per_span_ms = _time_ms(lambda: per_span(scratch), reps)
    stack_kernel.reset_counts()  # comparison launches: no part of the main path
    return {"mn": [m, n], "k": list(ks), "path": path, "runs": int(table[4].numel()),
            "segments": int(table[0].numel()), "entries": sum(p.entries for p in plans),
            "bitwise_per_span": True, "rel_err": rel, "tolerance": tol, "ms": ms,
            "per_span_ms": per_span_ms,
            "instance": stack_kernel.superstack_attrs(m, n, ks, dtype)}


def phase_superstack() -> dict:
    """`mixed_blocks.perf` (5000^2, blocks cycling 5, 13, 23, the last 21,
    occupancy 0.05) at f64 and f32 through `run_perf`, ``superstack``
    "auto" and "per_span" in turns (`SUPERSTACK_PAIRS` pairs, 2 repeats a
    run): the checksum gate, fused bit for bit per span, one fused
    dispatch per multi-span C bin and one per span otherwise, no plain
    call; the fused kernel against its plain version; one injected
    ``execute_superstack:raise`` decomposing bit for bit, counted once."""
    out = {"phase": "superstack", "input": "mixed_blocks.perf", "pairs": SUPERSTACK_PAIRS,
           "dtypes": {}}
    row = None
    # f32 forces K1 ("auto" would take K3, whose spans keep the per-span
    # path, as `pallas_cross` spans do in the JAX package)
    for data_type, driver in ((3, "auto"), (1, "pallas")):
        dname = name_of(dtype_of(data_type))
        modes = {"auto": [], "per_span": []}
        last = {}
        for turn in range(SUPERSTACK_PAIRS):
            for mode in (("auto", "per_span") if turn % 2 == 0 else ("per_span", "auto")):
                set_config(superstack=mode, mm_driver=driver)
                metrics.reset()
                _reset_counts()
                try:
                    res = run_perf(_mixed_cfg(data_type, 2), verbose=False)  # the gate
                finally:
                    set_config(superstack="auto", mm_driver="auto")
                counts = _counts()
                disp = _dispatches()
                bins = _bins_of(res["spans"])
                multi = sum(n > 1 for n in bins.values())
                want = ({"fused": 2.0 * multi, "per_span": 2.0 * (len(bins) - multi)}
                        if mode == "auto" else {"fused": 0.0, "per_span": 2.0 * len(res["spans"])})
                _require(disp == want, f"superstack {dname} {mode}: dispatches {disp}, want {want}")
                _require(counts["plain"] == 0, f"superstack {dname} {mode}: launches {counts}")
                _require((counts["smm_superstack"] > 0) == (mode == "auto") and _k1(counts) > 0,
                         f"superstack {dname} {mode}: launches {counts}")
                modes[mode].append({
                    "times_s": res["times_s"], "device_s": res["device_s"],
                    "host_phase_s": res["host_phase_s"], "launches": counts,
                    "dispatches_per_multiply": {k: v / 2 for k, v in disp.items()},
                    "checksum": res["checksum"], "checksum_pos": res["checksum_pos"]})
                last[mode] = res
        ca, cp = last["auto"]["matrices"]["c_out"], last["per_span"]["matrices"]["c_out"]
        _require(_same_bits(ca, cp), f"superstack {dname}: fused differs from per-span")
        bins = _bins_of(last["auto"]["spans"])
        info = {"mm_driver": driver, "c_bins": len(bins), "spans": len(last["auto"]["spans"]),
                "multi_span_bins": sum(n > 1 for n in bins.values()),
                "products": sum(sp[3] for sp in last["auto"]["spans"]),
                "flops": last["auto"]["flops"], "reference": MIXED_BLOCKS_REFERENCE[data_type],
                "runs": modes}
        for mode in modes:
            info[f"s_per_multiply_{mode}"] = [t for r in modes[mode] for t in r["times_s"]]
            info[f"stack_device_ms_{mode}"] = [d * 1e3 for r in modes[mode]
                                               for d in r["device_s"] if d is not None]
        a, b = last["auto"]["matrices"]["a"], last["auto"]["matrices"]["b"]
        _reset_counts()  # the last run's launches belong to the main path
        set_config(mm_driver=driver)
        try:
            timing = _fused_bins_vs_plain(a, b, ca)
        finally:
            set_config(mm_driver="auto")
        info["fused_kernel"] = timing
        info["tiled_bin"] = _tiled_bin_vs_per_span(dtype_of(data_type))
        # one injected fault in a fused launch: decomposed per span from
        # the pristine (zero) bin, bit for bit, counted once
        def fresh_c():
            return BlockSparseMatrix("C", ca.row_blk_sizes, ca.col_blk_sizes, ca.dtype,
                                     device=ca.device)
        set_config(mm_driver=driver)
        try:
            clean = fresh_c()
            mm.multiply("N", "N", 1.0, a, b, 0.0, clean)
            metrics.reset()
            events.clear()
            breaker.reset_board()
            c = fresh_c()
            with faults.inject_faults("execute_superstack:raise,times=1") as sp:
                mm.multiply("N", "N", 1.0, a, b, 0.0, c)
            _require(sp[0].fired == 1, f"superstack {dname}: the fault fired {sp[0].fired} times")
            got = _expect_counts(f"superstack {dname} fault", {("fused", "runtime"): 1.0},
                                 {("fused", "per_span"): 1.0})
            _require(_same_bits(c, clean), f"superstack {dname}: the decomposed product differs")
            info["fault"] = {**got, "decompose_events":
                             len(events.records(kind="superstack_decompose"))}
        finally:
            set_config(mm_driver="auto")
            faults.clear()
            breaker.reset_board()
            metrics.reset()
            stack_kernel.reset_counts()  # the fault run is no main-path run
        out["dtypes"][dname] = info
        if data_type == 3:
            row = {"name": "smm_superstack", "route": "cuda",
                   "source": KERNELS["smm_superstack"][0],
                   "replaces": KERNELS["smm_superstack"][1],
                   "launches": modes["auto"][0]["launches"]["smm_superstack"],
                   "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
                   "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
                   "bound_by": timing["bound_by"], "library_ms": None}
        else:
            row["forms"] = [{"form": dname, **{k: timing[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
                "launches": modes["auto"][0]["launches"]["smm_superstack"]}]
        del last, ca, cp, a, b, c
    _emit(out)
    return row


def _northstar_multiply(a, b) -> float:
    """C = A B into a new C (the north star's beta 0), synchronized;
    returns the wall seconds."""
    c = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype, device=a.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _busy_share(trace_path: str) -> dict:
    """The device's busy and idle shares of a `torch.profiler` Chrome
    trace: the union of the CUDA kernel intervals over the traced window
    (first to last event of any kind)."""
    with open(trace_path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if "ts" in e and e.get("ph") == "X"]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                     for e in evs if e.get("cat") == "kernel")
    _require(kernels, "obs: torch.profiler recorded no CUDA kernel")
    t0 = min(float(e["ts"]) for e in evs)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in evs)
    busy, end = 0.0, t0
    for s0, s1 in kernels:
        s0 = max(s0, end)
        if s1 > s0:
            busy += s1 - s0
            end = s1
    window = t1 - t0
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3, "kernels": len(kernels),
            "busy_share": busy / window, "idle_share": 1.0 - busy / window}


_PROM_LINE = r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+="[^"]*"(,[a-zA-Z_]+="[^"]*")*\})? \S+$'


def phase_obs(a, b) -> dict:
    """The obs core on the card: the north star (2 repeats) and the
    models' sign loop under the span tracer and the events sink, with
    ``DBCSR_TPU_TORCH_SYNC_TIMING=1`` (device seconds in the statistics):
    ``multiply`` spans with their phase children and m, n, k, ``stack``
    instants with mnk and driver, a Chrome trace with one complete event
    per span, the events JSONL; the roofline rows on the H100 peaks
    (every fraction <= 1.05), the Prometheus text, a sealed profile
    epoch; the sign loop once under `torch.profiler` (the device's busy
    and idle share); the north star with the tracer on and off in turns."""
    import re

    out = {"phase": "obs"}
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED)
    _, loops = _model_loops(p0, SIGN_STEPS, SIGN_EPS)
    sign = loops["sign"]
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["DBCSR_TPU_TORCH_SYNC_TIMING"] = "1"
        try:
            metrics.reset()
            profiler.reset()
            tr = obs_tracer.enable(os.path.join(tmp, "trace.jsonl"))
            events.enable_sink(os.path.join(tmp, "events.jsonl"))
            try:
                out["northstar_s"] = [_northstar_multiply(a, b) for _ in range(2)]
                t0 = time.perf_counter()
                sign()
                torch.cuda.synchronize()
                out["sign_s"] = time.perf_counter() - t0
            finally:
                obs_tracer.disable()
                events.disable_sink()  # settles the shard's name
            ev_path = events.sink_path()
            snap = metrics.snapshot()
            prom = metrics.prometheus_text()
        finally:
            del os.environ["DBCSR_TPU_TORCH_SYNC_TIMING"]
        with open(tr.path) as f:
            recs = [json.loads(line) for line in f]
        spans = [r for r in recs if r["ev"] == "span"]
        tops = [r for r in spans if r["name"] == "multiply" and r["depth"] == 0]
        multiplies = snap["totals"]["multiplies"]
        _require(len(tops) == multiplies and multiplies >= 2,
                 f"obs: {len(tops)} multiply spans for {multiplies} multiplies")
        _require(all({"m", "n", "k", "algorithm"} <= set(t.get("attrs", {})) for t in tops),
                 "obs: a multiply span lacks its m, n, k or algorithm")
        children = {r["name"] for r in spans if r["depth"] == 1}
        _require({"multiply_index", "multiply_c_assemble", "multiply_stacks"} <= children,
                 f"obs: the multiply spans' children are {sorted(children)}")
        stacks = [r for r in recs if r["ev"] == "instant" and r["name"] == "stack"]
        _require(stacks and all({"mnk", "entries", "driver"} <= set(s["args"]) for s in stacks),
                 "obs: no stack instant with mnk, entries and driver")
        with open(tr.chrome_path) as f:
            chrome = json.load(f)["traceEvents"]
        n_x = sum(e["ph"] == "X" for e in chrome)
        _require(n_x == len(spans), f"obs: {n_x} complete events for {len(spans)} spans")
        with open(ev_path) as f:
            ev_lines = [json.loads(line) for line in f]
        kinds: dict = {}
        for e in ev_lines:
            kinds[e["event"]] = kinds.get(e["event"], 0) + 1
        _require(kinds.get("multiply_end") == multiplies,
                 f"obs: the events sink holds {kinds}")
        out["trace"] = {"spans": len(spans), "multiply_spans": len(tops),
                        "children": sorted(children), "stack_instants": len(stacks),
                        "chrome_events": len(chrome), "jsonl_bytes": os.path.getsize(tr.path),
                        "events_lines": len(ev_lines), "events_by_kind": kinds}
    roof = snap["roofline"]
    _require(roof, "obs: no roofline rows")
    for driver, row in roof.items():
        _require("h100" in row["device_kind"].lower() and row["peak_gbs"] == 3350.0,
                 f"obs: the {driver} roofline is not on the H100 row: {row}")
        _require(row["sync"] and 0.0 < row["roofline_fraction"] <= 1.05,
                 f"obs: the {driver} roofline fraction is {row['roofline_fraction']:.3f}")
    out["roofline"] = roof
    out["jit"] = snap["jit"]
    pattern = re.compile(_PROM_LINE)
    bad = [ln for ln in prom.splitlines() if not ln.startswith("#") and not pattern.match(ln)]
    _require(not bad, f"obs: Prometheus lines that do not parse: {bad[:3]}")
    out["prometheus_lines"] = len(prom.splitlines())
    sealed = profiler.seal()
    _require(sealed is not None and profiler.epochs(),
             "obs: no profile epoch sealed")
    out["profile_epoch"] = {"n": sealed["n"], "generation": sealed["generation"],
                            "cells": len(sealed["cells"])}
    # the sign loop once under torch.profiler: the device's busy share
    sign()  # warm: the profiled run meets no first use
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            sign()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "sign_trace.json")
        prof.export_chrome_trace(path)
        out["sign_device"] = _busy_share(path)
    # the tracer's cost on the north star, in turns
    turns = {"off": [], "on": []}
    with tempfile.TemporaryDirectory() as tmp:
        for k, mode in enumerate(("off", "on", "on", "off")):
            if mode == "on":
                obs_tracer.enable(os.path.join(tmp, f"t{k}.jsonl"))
            try:
                turns[mode] += [_northstar_multiply(a, b) for _ in range(2)]
            finally:
                obs_tracer.disable()
    out["northstar_tracer_s"] = turns
    _emit(out)
    return out


def _northstar_cfg(nrep: int, data_type: int = 3):
    cfg = parse_perf_file(os.path.join(INPUTS, "northstar.perf"))
    cfg.beta = 0.0  # as bench.py runs it
    cfg.nrep = nrep
    cfg.data_type = data_type
    return cfg


def _against_torch_driver(res, cfg, tol_el: float, tol_cs: float) -> dict:
    """One repeat of ``cfg`` under ``mm_driver="torch"`` (the plain
    version): C's pattern must be equal, the elementwise error relative
    to max |C| within ``tol_el`` and both checksums within ``tol_cs``."""
    cfg.nrep = 1
    set_config(mm_driver="torch")
    try:
        ref = run_perf(cfg, verbose=False)
    finally:
        set_config(mm_driver="auto")
    c_out, c_ref = res["matrices"]["c_out"], ref["matrices"]["c_out"]
    _require(np.array_equal(c_out.keys, c_ref.keys), "C patterns differ from the torch driver's")
    rel_cs = abs(res["checksum"] - ref["checksum"]) / abs(ref["checksum"])
    rel_pos = abs(res["checksum_pos"] - ref["checksum_pos"]) / abs(ref["checksum_pos"])
    scale = max(float(b.data.abs().max()) for b in c_ref.bins if b.count)
    rel_el = max(float((_wide(x.data) - _wide(y.data)).abs().max())
                 for x, y in zip(c_out.bins, c_ref.bins) if x.count) / scale
    _require(rel_cs <= tol_cs and rel_pos <= tol_cs and rel_el <= tol_el,
             f"kernel vs torch driver rel {rel_cs:.3e}/{rel_pos:.3e}/{rel_el:.3e} "
             f"> {tol_cs:.1e}/{tol_cs:.1e}/{tol_el:.1e}")
    return {"torch_driver_checksum": ref["checksum"],
            "torch_driver_checksum_pos": ref["checksum_pos"],
            "torch_driver_times_s": ref["times_s"],
            "rel_checksum": rel_cs, "rel_checksum_pos": rel_pos,
            "rel_elementwise": rel_el, "tolerance_elementwise": tol_el,
            "tolerance_checksum": tol_cs}


def _run_summary(res, nrep: int, counts: dict) -> dict:
    return {"nrep": nrep, "times_s": res["times_s"], "host_s": res["host_s"],
            "host_phase_s": res["host_phase_s"], "device_s": res["device_s"],
            "algorithms": res["algorithms"],
            "flops": res["flops"],
            "gflops_true": [res["flops"] / t / 1e9 for t in res["times_s"]],
            "launches": counts,
            "launches_per_multiply": {k: v / nrep for k, v in counts.items()},
            "spans": res["spans"], "checksum": res["checksum"],
            "checksum_pos": res["checksum_pos"],
            "c_blocks": int(res["matrices"]["c_out"].nblks)}


def phase_northstar() -> dict:
    _reset_counts()
    res = run_perf(_northstar_cfg(3), verbose=False)
    counts = _counts()
    _require(_k1(counts) > 0, "north star: the stack kernel never launched")
    _require(counts["plain"] == 0, f"north star: the plain versions ran {counts['plain']} times")
    _require(res["plan_cache"][1:] == ["hit", "hit"],
             f"north star: repeats 2-3 did not hit the plan cache: {res['plan_cache']}")
    _require(res["algorithms"] == ["stack"] * 3,
             f"north star: the planner chose {res['algorithms']}, not the stack format")
    out = {"phase": "northstar", "shape": [10000, 10000, 10000], "block": 23,
           "occupancy": 0.1, "dtype": "float64", **_run_summary(res, 3, counts),
           "plan_cache": res["plan_cache"],
           "plan_s_first": res["host_phase_s"][0]["plan"],
           "plan_s_hits": [p["plan"] for p in res["host_phase_s"][1:]]}
    out.update(_against_torch_driver(res, _northstar_cfg(1), 1e-10, 1e-10))
    _emit(out)
    return {"launches": counts["smm_stack"], "a": res["matrices"]["a"],
            "b": res["matrices"]["b"], "c": res["matrices"]["c_out"],
            "checksum": res["checksum"], "checksum_pos": res["checksum_pos"]}


def _stacks_phase(phase: str, a, b, c, kernels=(None,), reps=5, path="warp") -> dict:
    """Each stack of the product ``c = a * b``, re-planned from its
    operands under the config in force (every one must take its kernel's
    ``path``), run through
    its plan's kernel (``kernels``: None for the
    plan's own launch, False/True to force a crosspack plan's plain or
    resident launch) and its plain version: compared (within the form's
    `form_tolerance` at the stack's k and longest run), and timed by CUDA
    events (kernel mean of ``reps`` launches, plain mean of 2); times
    summed per multiply, beside the least time the card could take."""
    t0 = time.perf_counter()
    i, j, a_ent, b_ent = _candidates(a, b, None)
    keys = i * c.nblkcols + j
    t1 = time.perf_counter()
    spans = _build_spans(c, a, b, keys, a_ent, b_ent)
    host_s = {"index": t1 - t0, "plan": time.perf_counter() - t1}
    alpha = 1.0
    rows = []
    tot = {"ms": [0.0] * len(kernels), "plain_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": [0.0] * len(kernels)}
    modeled_bytes = min_bytes = 0
    for sp in spans:
        ad, bd, cd = a.bins[sp.abin].data, b.bins[sp.bbin].data, c.bins[sp.cbin].data
        plan = sp.plan
        _, plain = _calls(plan)
        want = plain(cd.clone(), ad, bd, alpha)
        scratch = cd.clone()
        kpath = (crosspack_kernel.kernel_path(cd.dtype, plan.pack, sp.m, sp.n, sp.k)
                 if plan.driver == "crosspack"
                 else stack_kernel.kernel_path(sp.m, sp.n, sp.k, cd.dtype))
        _require(kpath == path, f"{phase}: the {(sp.m, sp.n, sp.k)} span took the {kpath} path")
        row = {"mnk": [sp.m, sp.n, sp.k], "entries": sp.entries, "runs": plan.nruns,
               "kernel": sp.driver, "path": kpath, "ms": [], "max_abs_err": [],
               "form": stack_kernel.form_name(cd.dtype, plan.precision)}
        if plan.driver == "crosspack":
            row["pack"] = list(plan.pack)
            row["entry_slots"] = crosspack_entries(plan)
        tol = form_tolerance(name_of(cd.dtype), plan.precision, sp.k, plan.max_run)
        row["tolerance"] = tol
        for ki, resident in enumerate(kernels):
            kernel, _ = _calls(plan, resident=resident)
            got = kernel(cd.clone(), ad, bd, alpha)
            err = float((_wide(got) - _wide(want)).abs().max())
            rel = _rel_err(got, want)
            _require(np.isfinite(rel) and rel <= tol,
                     f"{phase}: {row['form']} {(sp.m, sp.n, sp.k)} ({kpath} path) against its "
                     f"plain version: rel {rel:.3e} > {tol:.1e}")
            row.setdefault("max_rel_err", []).append(rel)
            del got
            ms = _time_ms(lambda: kernel(scratch, ad, bd, alpha), reps)
            row["ms"].append(ms)
            row["max_abs_err"].append(err)
            tot["ms"][ki] += ms
            tot["max_abs_err"][ki] = max(tot["max_abs_err"][ki], err)
        row["plain_ms"] = _time_ms(lambda: plain(scratch, ad, bd, alpha), 2)
        del scratch, want
        counts = (name_of(cd.dtype), sp.m, sp.n, sp.k, sp.entries,
                  len(torch.unique(plan.a_idx)), len(torch.unique(plan.b_idx)), plan.nruns)
        bound, by = stack_bound_s(*counts, precision=plan.precision)
        row.update(n_a=counts[5], n_b=counts[6])
        min_bytes += stack_min_bytes(*counts)
        modeled_bytes += stack_bytes(sp.m, sp.n, sp.k, sp.entries, nseg=plan.nruns,
                                     itemsize=cd.element_size())
        row.update(bound_ms=bound * 1e3, bound_by=by)
        rows.append(row)
        tot["plain_ms"] += row["plain_ms"]
        tot["bound_ms"] += bound * 1e3
    flops = sum(2 * r["mnk"][0] * r["mnk"][1] * r["mnk"][2] * r["entries"] for r in rows)
    # what bounds the stack with the largest bound bounds the multiply
    tot["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
    _emit({"phase": phase, "spans": rows, "launches_per_multiply": len(rows),
           "replan_host_s": host_s,
           "kernels_timed": [("plan" if r is None else "resident" if r else "cross")
                             for r in kernels],
           "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
           "bound_by": tot["bound_by"],
           "kernel_gflops": [flops / ms / 1e6 for ms in tot["ms"]], "flops": flops,
           "min_bytes": min_bytes, "modeled_stack_bytes": modeled_bytes,
           "max_abs_err": tot["max_abs_err"]})
    return tot


def _with_engine(on: bool, fn):
    """``fn()`` with the native index engine on or off (the NumPy path)."""
    prev = os.environ.get("DBCSR_TPU_TORCH_NATIVE")
    os.environ["DBCSR_TPU_TORCH_NATIVE"] = "1" if on else "0"
    try:
        return fn()
    finally:
        if prev is None:
            os.environ.pop("DBCSR_TPU_TORCH_NATIVE", None)
        else:
            os.environ["DBCSR_TPU_TORCH_NATIVE"] = prev


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_native_index(a, b, c) -> None:
    """The native engine on the north star's operands: its expansion and
    stack sort identical to the NumPy path and `np.lexsort`, each piece
    of the host's "index" and "plan" timed (in turns, 3 pairs), then the
    multiply's host phases on a plan-cache miss and hit under both
    engines in turns, with C bit for bit the same."""
    pieces = {k: [] for k in ("expand_native", "expand_numpy", "union1d", "sort_native",
                              "sort_lexsort")}
    for rep in range(3):
        for eng in (("numpy", "native") if rep % 2 == 0 else ("native", "numpy")):
            if eng == "native":
                got, sec = _timed(lambda: native.symbolic_product(
                    a.row_ptr, a.keys % a.nblkcols, b.row_ptr, b.keys % b.nblkcols))
            else:
                want, sec = _timed(lambda: _candidates_numpy(a, b, None, None, None))
            pieces[f"expand_{eng}"].append(sec)
    _require(all(np.array_equal(x, y) for x, y in zip(got, want)),
             "native_index: the native expansion differs from the NumPy path")
    i, j, a_ent, _ = got
    keys = i * c.nblkcols + j
    new_keys, sec = _timed(lambda: np.union1d(c.keys, np.unique(keys)))
    pieces["union1d"].append(sec)
    _require(np.array_equal(new_keys, c.keys), "native_index: C's pattern is not the product's")
    c_ent = np.searchsorted(c.keys, keys)
    g = ((c.ent_bin[c_ent].astype(np.int64) * len(a.bins) + a.ent_bin[a_ent]) * len(b.bins)
         + b.ent_bin[got[3]])
    ngroups = len(c.bins) * len(a.bins) * len(b.bins)
    c_slot = c.ent_slot[c_ent]
    for rep in range(3):
        for eng in (("lexsort", "native") if rep % 2 == 0 else ("native", "lexsort")):
            if eng == "native":
                (order, bounds), sec = _timed(lambda: native.group_sort_stacks(
                    g, ngroups, c_slot, a_ent))
            else:
                lex, sec = _timed(lambda: np.lexsort((a_ent, c_slot, g)))
            pieces[f"sort_{eng}"].append(sec)
    _require(np.array_equal(order, lex), "native_index: the native sort differs from np.lexsort")
    _require(np.array_equal(bounds, np.concatenate([[0], np.cumsum(np.bincount(
        g, minlength=ngroups))])), "native_index: the native sort's group bounds are wrong")
    groups = np.bincount(g, minlength=ngroups)
    runs = {}
    results = {}
    for eng in ("numpy", "native", "native", "numpy"):
        mm.clear_plan_cache()
        mm.reset_totals()
        phases = []
        for _ in range(2):  # a plan-cache miss, then a hit
            out = c.copy()

            def run():
                mm.multiply("N", "N", 1.0, a, b, 0.0, out)
                torch.cuda.synchronize()
            _with_engine(eng == "native", run)
            phases.append(dict(out._mm_phase_s, plan_cache=out._mm_plan_cache))
        totals = mm.read_totals()["index_engine"]
        _require(totals["expand"][eng] == 2 and totals["sort"][eng] == 1,
                 f"native_index: the {eng} engine did not run: {totals}")
        runs.setdefault(eng, []).append(phases)
        if eng not in results:
            results[eng] = out
        else:
            del out
    x, y = results["native"], results["numpy"]
    _require(np.array_equal(x.keys, y.keys) and all(
        bx.data.equal(by.data) for bx, by in zip(x.bins, y.bins)),
        "native_index: C differs between the engines")
    del results, x, y
    # "index" on plan-cache hits, 10 pairs in turns
    index_s = {"numpy": [], "native": []}
    for rep in range(10):
        for eng in (("numpy", "native") if rep % 2 == 0 else ("native", "numpy")):
            out = c.copy()
            _with_engine(eng == "native", lambda: mm.multiply("N", "N", 1.0, a, b, 0.0, out))
            _require(out._mm_plan_cache == "hit", "native_index: a repeat missed the plan cache")
            index_s[eng].append(out._mm_phase_s["index"])
            del out
    _emit({"phase": "native_index", "candidates": int(len(i)), "groups": int(ngroups),
           "largest_group": int(groups.max()), "threads": torch.get_num_threads(),
           "cpu_count": os.cpu_count(), "pieces_s": pieces,
           "median_s": {k: float(np.median(v)) for k, v in pieces.items()},
           "multiply_host_phase_s": runs, "index_s_hits_in_turns": index_s,
           "index_median_s": {k: float(np.median(v)) for k, v in index_s.items()}})


# the models' size: test_H2O's blocking, 96 block rows of 23 (2208^2)
MODEL_BLOCKS, MODEL_BLOCK, MODEL_SEED = 96, 23, 0


def _canvas_rel(x, y) -> float:
    """max |x - y| over max |y|, on the card's dense canvases."""
    dx, dy = _to_dense_device(x), _to_dense_device(y)
    return float((dx - dy).abs().max()) / max(float(dy.abs().max()), 1e-300)


def _launched_since(before: dict) -> dict:
    """The launches counted since `_counts` gave ``before``."""
    return {k: v - before[k] for k, v in _counts().items()}


def _format_legs(a, b, c0, legs, tol, reps=3) -> dict:
    """C = 0.7 A B + 0.5 C0 under each ``mm_format`` of ``legs``, after
    one untimed run: wall seconds (synchronized), host phases and device
    seconds of the last repeat, the format run, K1/K3 launches of the
    last repeat and the difference to the "stack" leg (the first)."""
    out, ref = {}, None
    try:
        for fmt in legs:
            set_config(mm_format=fmt)
            times = []
            for rep in range(reps + 1):
                c = c0.copy()
                torch.cuda.synchronize()
                before = _counts()
                t0 = time.perf_counter()
                mm.multiply("N", "N", 0.7, a, b, 0.5, c)
                torch.cuda.synchronize()
                if rep:
                    times.append(time.perf_counter() - t0)
            launched = _launched_since(before)
            ev = c._mm_device_events
            row = {"ran": c._mm_algorithm, "times_s": times, "host_phase_s": c._mm_phase_s,
                   "device_s": ev[0].elapsed_time(ev[1]) / 1e3 if ev else None,
                   "launches": launched, "c_blocks": int(c.nblks)}
            if ref is None:
                ref = c
            else:
                row["rel_to_stack"] = rel = _canvas_rel(c, ref)
                _require(rel <= tol, f"formats: {fmt} differs from stack by {rel:.3e} > {tol:.1e}")
            _require(launched["plain"] == 0, f"formats: {fmt} ran the plain versions")
            out[fmt] = row
    finally:
        set_config(mm_format="auto")
    return out


def _gemm_ms(n: int, dtype) -> dict:
    """The canvas GEMM alone (`torch.matmul` of two n x n canvases), by
    CUDA events, beside the least time the card could take for it."""
    x = torch.randn((n, n), dtype=dtype, device=resolve_device())
    y = torch.randn((n, n), dtype=dtype, device=resolve_device())
    ms = _time_ms(lambda: torch.matmul(x, y), 10)
    flops = 2.0 * n ** 3
    t_ops = flops / H100_PEAK_FLOPS[name_of(dtype)]
    t_bytes = 3 * n * n * x.element_size() / H100_BYTES_PER_S
    return {"n": n, "ms": ms, "tflops": flops / ms / 1e9, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _banded(name, band, rng, dtype):
    """A 96 x 96 block matrix of 23 x 23 blocks within ``band`` of the
    diagonal, standard-normal values."""
    sizes = np.full(MODEL_BLOCKS, MODEL_BLOCK)
    rows = [i for i in range(MODEL_BLOCKS) for j in range(MODEL_BLOCKS) if abs(i - j) <= band]
    cols = [j for i in range(MODEL_BLOCKS) for j in range(MODEL_BLOCKS) if abs(i - j) <= band]
    m = BlockSparseMatrix(name, sizes, sizes, dtype)
    m.put_blocks(rows, cols, rng.standard_normal((len(rows), MODEL_BLOCK, MODEL_BLOCK)))
    return m.finalize()


def phase_formats() -> int:
    """Every format on the models' size, the canvas GEMM alone, the north
    star forced dense, and the `.perf` gates under the planner.  Returns
    the K1 launches of the whole phase."""
    sizes = np.full(MODEL_BLOCKS, MODEL_BLOCK)
    out = {"phase": "formats", "n": MODEL_BLOCKS * MODEL_BLOCK, "block": MODEL_BLOCK}
    _reset_counts()
    mm.reset_totals()
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(20261017)
        full = [make_random_matrix(nm, sizes, sizes, dtype=dtype, occupation=occ, rng=rng)
                for nm, occ in (("A", 1.0), ("B", 1.0), ("C", 0.3))]
        band = [_banded("A", 4, rng, dtype), _banded("B", 4, rng, dtype), full[2]]
        name = name_of(dtype)
        tol = 1e-12 if dtype == torch.float64 else kernel_validation_tolerance(
            "float32", MODEL_BLOCK, MODEL_BLOCKS)
        legs = ("stack", "dense", "composite", "auto")
        res = {"full": _format_legs(*full, legs, tol), "banded": _format_legs(*band, legs, tol)}
        ran = {pat: {fmt: r["ran"] for fmt, r in legs_.items()} for pat, legs_ in res.items()}
        _require(ran == {"full": {"stack": "stack", "dense": "dense", "composite": "stack",
                                  "auto": "dense"},
                         "banded": {"stack": "stack", "dense": "dense",
                                    "composite": "composite", "auto": "stack"}},
                 f"formats {name}: the formats run were {ran}")
        wanted = "smm_stack" if dtype == torch.float64 else "smm_crosspack"
        for pat in res:
            _require(res[pat]["stack"]["launches"][wanted] > 0,
                     f"formats {name} {pat}: the stack leg never launched {wanted}")
        out[name] = {"tolerance": tol, "gemm": _gemm_ms(MODEL_BLOCKS * MODEL_BLOCK, dtype), **res}
        del full, band
    out["decisions"] = mm.read_totals()["formats"]
    # the north star forced dense, beside its stack run
    ns = {}
    for fmt in ("stack", "dense"):
        set_config(mm_format=fmt)
        try:
            res = run_perf(_northstar_cfg(2), verbose=False)
        finally:
            set_config(mm_format="auto")
        _require(res["algorithms"] == [fmt] * 2, f"north star forced {fmt} ran {res['algorithms']}")
        ns[fmt] = res
    rel = _canvas_rel(ns["dense"]["matrices"]["c_out"], ns["stack"]["matrices"]["c_out"])
    _require(rel <= 1e-12, f"north star: dense differs from stack by {rel:.3e}")
    out["northstar_dense"] = {
        fmt: {"times_s": r["times_s"], "host_phase_s": r["host_phase_s"],
              "device_s": r["device_s"], "checksum": r["checksum"],
              "c_blocks": int(r["matrices"]["c_out"].nblks)} for fmt, r in ns.items()}
    out["northstar_dense"]["rel_dense_to_stack"] = rel
    out["northstar_dense"]["gemm"] = _gemm_ms(10000, torch.float64)
    del ns, res
    # the .perf gates under the planner
    gates = []
    for name, nrep in PERF_GATES:
        cfg = parse_perf_file(os.path.join(INPUTS, f"{name}.perf"))
        cfg.nrep = nrep
        res = run_perf(cfg, verbose=False)  # raises on a mismatch (no retry)
        gates.append({"input": name, "algorithms": res["algorithms"], "checksum": res["checksum"],
                      "refs": list(cfg.check_refs), "times_s": res["times_s"]})
    out["perf_gates_auto"] = gates
    out["launches"] = _counts()
    _emit(out)
    return out["launches"]["smm_stack"]


LIMIT_CASES = (
    ("block", dict(first_row=10, last_row=70, first_col=5, last_col=90, first_k=3, last_k=85)),
    ("element", dict(element_limits=(101, 1700, 37, 2150, 11, 2000))),
)


def _window(c, limits) -> tuple:
    """The element window (r0, r1, c0, c1, k0, k1), inclusive, of a limit set."""
    if "element_limits" in limits:
        return limits["element_limits"]
    roff, coff = c.row_blk_offsets, c.col_blk_offsets
    return (int(roff[limits["first_row"]]), int(roff[limits["last_row"] + 1]) - 1,
            int(coff[limits["first_col"]]), int(coff[limits["last_col"] + 1]) - 1,
            int(coff[limits["first_k"]]), int(coff[limits["last_k"] + 1]) - 1)


def phase_limits() -> int:
    """Block and unaligned element limits with beta 0.7 at 2208^2 under
    "auto" (K1) and "torch"; returns the K1 launches under "auto"."""
    sizes = np.full(MODEL_BLOCKS, MODEL_BLOCK)
    rng = np.random.default_rng(20261018)
    a, b, c0 = (make_random_matrix(nm, sizes, sizes, occupation=0.3, rng=rng) for nm in "ABC")
    alpha, beta = 1.3, 0.7
    da, db, dc = (_to_dense_device(m) for m in (a, b, c0))
    rows, k1 = {}, 0
    for case, limits in LIMIT_CASES:
        r0, r1, c0w, c1w, k0, k1w = _window(c0, limits)
        row = {"limits": limits, "window": [r0, r1, c0w, c1w, k0, k1w]}
        got = {}
        for driver in ("auto", "torch"):
            set_config(mm_driver=driver)
            try:
                c = c0.copy()
                _reset_counts()
                t0 = time.perf_counter()
                mm.multiply("N", "N", alpha, a, b, beta, c, **limits)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _counts()
            finally:
                set_config(mm_driver="auto")
            _require(c._mm_algorithm == "stack", f"limits {case}: ran {c._mm_algorithm}")
            row[driver] = {"launches": counts, "wall_s": wall, "host_phase_s": c._mm_phase_s,
                           "c_blocks": int(c.nblks)}
            got[driver] = c
        la, lt = row["auto"]["launches"], row["torch"]["launches"]
        _require(_k1(la) > 0 and la["plain"] == 0, f"limits {case}: auto launched {la}")
        _require(lt["plain"] > 0 and lt["smm_stack"] == 0, f"limits {case}: torch launched {lt}")
        k1 += la["smm_stack"]
        _require(np.array_equal(got["auto"].keys, got["torch"].keys),
                 f"limits {case}: C's patterns differ between the drivers")
        row["rel_auto_to_torch"] = rel = _canvas_rel(got["auto"], got["torch"])
        _require(rel <= 1e-12, f"limits {case}: auto vs torch {rel:.3e} > 1e-12")
        want = dc.clone()
        want[r0:r1 + 1, c0w:c1w + 1] = (alpha * (da[r0:r1 + 1, k0:k1w + 1] @ db[k0:k1w + 1,
                                                                             c0w:c1w + 1])
                                        + beta * dc[r0:r1 + 1, c0w:c1w + 1])
        dgot = _to_dense_device(got["auto"])
        row["rel_to_oracle"] = rel = float((dgot - want).abs().max()) / float(want.abs().max())
        _require(rel <= 1e-12, f"limits {case}: against the dense oracle {rel:.3e} > 1e-12")
        outside = torch.ones_like(dgot, dtype=torch.bool)
        outside[r0:r1 + 1, c0w:c1w + 1] = False
        _require(bool(torch.equal(dgot[outside], dc[outside])),
                 f"limits {case}: C outside the window changed")
        rows[case] = row
        del got, want, dgot, outside
    _emit({"phase": "limits", "n": MODEL_BLOCKS * MODEL_BLOCK, "block": MODEL_BLOCK,
           "occupancy": 0.3, "alpha": alpha, "beta": beta, "tolerance": 1e-12, **rows})
    return k1


def _kernel_row(name: str, launches: int, timing: dict, ki: int = 0) -> dict:
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": timing["max_abs_err"][ki],
            "ms": timing["ms"][ki], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": None}


def phase_northstar_f32() -> dict:
    _reset_counts()
    res = run_perf(_northstar_cfg(3, data_type=1), verbose=False)
    counts = _counts()
    _require(counts["smm_crosspack"] > 0, "f32 north star: the crosspack kernel never launched")
    _require(counts["smm_stack"] == 0 and counts["smm_crosspack_resident"] == 0,
             f"f32 north star: other kernels launched: {counts}")
    _require(counts["plain"] == 0, f"f32 north star: the plain versions ran {counts['plain']} times")
    _require(all(s[4] == "smm_crosspack" for s in res["spans"]),
             f"f32 north star: not every span took crosspack: {res['spans']}")
    longest = max(s[5] for s in res["spans"])
    out = {"phase": "northstar_f32", "shape": [10000, 10000, 10000], "block": 23,
           "occupancy": 0.1, "dtype": "float32", "mm_driver": "auto",
           **_run_summary(res, 3, counts)}
    out.update(_against_torch_driver(res, _northstar_cfg(1, data_type=1),
                                     kernel_validation_tolerance("float32", 23, longest), 1e-6))
    out["longest_run"] = longest
    _emit(out)
    operands = _operands(res, _northstar_cfg(1))
    del res
    timing = _stacks_phase("northstar_f32_stacks", *operands)
    _plan_ab("northstar_f32_plan", *operands)
    return _kernel_row("smm_crosspack", counts["smm_crosspack"], timing)


def _plan_ab(phase: str, a, b, c, pairs: int = 3) -> None:
    """Host seconds of planning the product's stacks for the base kernel
    (``mm_driver="pallas"``) and for crosspack (``"auto"``), in turns on
    the same operands in one process: what dealing runs into packs adds."""
    i, j, a_ent, b_ent = _candidates(a, b, None)
    keys = i * c.nblkcols + j
    plan_s = {"pallas": [], "auto": []}
    try:
        for rep in range(pairs):
            for driver in (("pallas", "auto") if rep % 2 == 0 else ("auto", "pallas")):
                set_config(mm_driver=driver)
                t0 = time.perf_counter()
                spans = _build_spans(c, a, b, keys, a_ent, b_ent)
                plan_s[driver].append(time.perf_counter() - t0)
                want = "smm_stack" if driver == "pallas" else "smm_crosspack"
                _require(all(sp.driver == want for sp in spans),
                         f"{phase}: {driver} planned {[sp.driver for sp in spans]}")
                del spans
    finally:
        set_config(mm_driver="auto")
    _emit({"phase": phase, "plan_s": plan_s,
           "median_s": {d: float(np.median(v)) for d, v in plan_s.items()}})


def _operands(res, cfg):
    """op(A), op(B) and C of a `run_perf` result."""
    mats = res["matrices"]
    return (_effective(mats["a"], cfg.transa), _effective(mats["b"], cfg.transb),
            mats["c_out"])


def _block_shapes(cfg):
    sizes = [np.unique(expand_block_sizes(total, pat))
             for total, pat in ((cfg.m, cfg.m_sizes), (cfg.n, cfg.n_sizes), (cfg.k, cfg.k_sizes))]
    return [tuple(int(x) for x in t) for t in itertools.product(*sizes)]


RESIDENT_CANDIDATES = ("test_H2O", "test_rect2_sparse", "test_rect1_sparse",
                       "test_square_sparse", "test_singleblock")


def phase_resident_f32() -> dict:
    """`test_H2O` as sreal through K4, steered there by a tuned
    ``crosspack_vmem`` row; the largest other `.perf` input whose
    operands fit the persisting-L2 limit if its do not."""
    limit = resident_limit_bytes(resolve_device())
    prev_dir = os.environ.get("DBCSR_TPU_TORCH_PARAMS_DIR")
    skipped = []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = tmp
        try:
            for name in RESIDENT_CANDIDATES:
                cfg = parse_perf_file(os.path.join(INPUTS, f"{name}.perf"))
                cfg.data_type, cfg.nrep, cfg.check = 1, 2, False
                for m, n, k in _block_shapes(cfg):
                    P, R = choose_pack(m, n, k)
                    params.save_entry({"m": m, "n": n, "k": k, "dtype": "float32",
                                       "driver": "pallas", "variant": "crosspack_vmem",
                                       "grouping": R, "pack_p": P, "gflops": 0.0})
                _reset_counts()
                res = run_perf(cfg, verbose=False)
                counts = _counts()
                mats = res["matrices"]
                operand_bytes = max(
                    x.data.numel() * x.data.element_size() + y.data.numel() * y.data.element_size()
                    for x in mats["a"].bins for y in mats["b"].bins)
                if counts["smm_crosspack_resident"] > 0:
                    break
                skipped.append({"input": name, "operand_bytes": operand_bytes})
                _require(operand_bytes > limit,
                         f"{name}: operands fit ({operand_bytes} <= {limit} B) but K4 never launched")
            else:
                raise RuntimeError(f"no .perf input fits the persisting-L2 limit {limit} B")
            _require(counts["plain"] == 0 and counts["smm_stack"] == 0,
                     f"{name}: other launches on the resident path: {counts}")
            longest = max(s[5] for s in res["spans"])
            out = {"phase": "resident_f32", "input": name, "dtype": "float32",
                   "persisting_l2_bytes": limit, "operand_bytes": operand_bytes,
                   "skipped": skipped, "tuned_rows": params.params_path(),
                   **_run_summary(res, 2, counts)}
            k_max = max(k for _, _, k in _block_shapes(cfg))
            out.update(_against_torch_driver(
                res, cfg, kernel_validation_tolerance("float32", k_max, longest), 1e-6))
            out["longest_run"] = longest
            _emit(out)
            operands = _operands(res, cfg)
            del res, mats
            timing = _stacks_phase("resident_f32_stacks", *operands,
                                   kernels=(True, False), reps=10)
        finally:
            if prev_dir is None:
                os.environ.pop("DBCSR_TPU_TORCH_PARAMS_DIR", None)
            else:
                os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = prev_dir
            params.invalidate()
    return _kernel_row("smm_crosspack_resident", counts["smm_crosspack_resident"], timing)


# the models' workload: the density drawn from MODEL_SEED at the models'
# size; steps and tolerances of each loop
PURIFY_STEPS = 6
SIGN_STEPS, SIGN_EPS = 25, 1e-10
INVSQRT_TOL = 1e-10
SIGN_F32_STEPS = 3


def _drive(driver: str, loop, fmt: str = "auto"):
    """``loop()`` under ``mm_driver=driver`` and ``mm_format=fmt``, with
    the kernel counts, the engine's totals and the allocator's peak set
    to 0 just before it and read just after (``pool``: the chains' frees
    and the caching allocator's bytes, `core.mempool.pool_stats`)."""
    set_config(mm_driver=driver, mm_format=fmt)
    try:
        _reset_counts()
        mm.reset_totals()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        freed0 = mempool.pool_stats()
        t0 = time.perf_counter()
        out = loop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        totals = mm.read_totals()
        pool = mempool.pool_stats(resolve_device(None))
    finally:
        set_config(mm_driver="auto", mm_format="auto")
    for key in ("freed", "freed_bytes"):
        pool[key] -= freed0[key]
    return out, {"wall_s": wall, "launches": counts, **totals, "pool": pool}


def _history_diff(got, want) -> dict:
    """Each history entry's difference, relative to the entry and, for
    the bound, to the larger of the entry and the history's first (a
    residual at the rounding floor differs by its own size)."""
    _require(len(got) == len(want), f"histories differ in length: {len(got)} vs {len(want)}")
    d = np.abs(np.asarray(got) - np.asarray(want))
    w = np.abs(np.asarray(want))
    return {"rel_entry": (d / np.maximum(w, 1e-300)).tolist(),
            "rel_bound": float((d / np.maximum(w, w[0])).max())}


def _iterate_diff(got, want) -> float:
    """max |got - want| over max |want|, on the union of the patterns."""
    return maxabs_norm(added(got, want, 1.0, -1.0)) / maxabs_norm(want)


def _squared(x):
    """X^2 through the engine (the driver in force)."""
    x2 = BlockSparseMatrix("X2", x.row_blk_sizes, x.col_blk_sizes, x.dtype, x.dist,
                           device=x.device)
    mm.multiply("N", "N", 1.0, x, x, 0.0, x2)
    return x2


def _sign_measure(x) -> float:
    """||X^2 - I||_F, the sign iteration's convergence measure."""
    return frobenius_norm(add_on_diag(_squared(x), -1.0))


def _idempotency(p) -> float:
    """|tr(P^2) - tr(P)|, McWeeny's convergence measure."""
    return abs(trace(_squared(p)) - trace(p))


def _model_loops(p0, sign_steps: int, sign_eps):
    """The sign input (``p0`` - 0.5 I) and the three loops on ``p0``."""
    a = copy(p0, "A")
    add_on_diag(a, -0.5)  # spectrum straddling zero
    s = copy(p0, "S")
    add_on_diag(s, 0.5)  # SPD, spectrum near [0.9, 1.1]

    def invsqrt():
        hist = []
        z, sf, iters = invsqrt_iteration(s, tol=INVSQRT_TOL, history=hist)
        return z, hist, sf, iters

    return a, {
        "purify": lambda: mcweeny_purify(p0, steps=PURIFY_STEPS),
        "sign": lambda: sign_iteration(a, steps=sign_steps, filter_eps=sign_eps),
        "invsqrt": invsqrt,
    }


def _in_turns(first: str, first_info: dict, second: str, drive, check) -> dict:
    """Two variants of one loop in turns: the phase's own run of
    ``first`` (``first_info``), then ``second``, ``first``, ``second``;
    ``drive(variant)`` runs one and returns `_drive`'s (output, info),
    and ``check(variant, output, info)`` holds it against the plain
    version and returns what it found."""
    keys = ("wall_s", "host_phase_s", "device_s", "formats", "index_engine", "launches")
    out = {first: [{k: first_info[k] for k in keys}], second: []}
    for variant in (second, first, second):
        result, info = drive(variant)
        out[variant].append({k: info[k] for k in keys} | check(variant, result, info))
    return out


def phase_models() -> dict:
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED)
    a, loops = _model_loops(p0, SIGN_STEPS, SIGN_EPS)
    x0 = copy(a, "X0")
    scale(x0, 1.0 / gershgorin_norm(a))  # the sign iteration's start
    start = {"purify": _idempotency(p0), "sign": _sign_measure(x0)}
    rows = {}
    k1 = 0
    for name, loop in loops.items():
        runs = {}
        # the planner under "auto"; the plain version on the stack format
        for driver, fmt in (("auto", "auto"), ("torch", "stack")):
            out, info = _drive(driver, loop, fmt)
            runs[driver] = (out, info)
        (xa, ha, *rest_a), info_a = runs["auto"]
        (xt, ht, *rest_t), info_t = runs["torch"]
        la, lt = info_a["launches"], info_t["launches"]
        _require(la["plain"] == 0 and la["smm_crosspack"] == 0
                 and la["smm_crosspack_resident"] == 0,
                 f"models {name} under auto: launches {la}")
        dense = sum(n for d, n in info_a["formats"].items() if d.startswith("dense:"))
        if name == "sign":
            _require(_k1(la) > 0, f"models sign under auto: K1 never launched: {la}")
        else:
            _require(dense > 0, f"models {name} under auto: no dense multiply: "
                                f"{info_a['formats']}")
        _require(lt["plain"] > 0 and lt["smm_stack"] == 0 and lt["smm_crosspack"] == 0,
                 f"models {name} under torch: launches {lt}")
        k1 += la["smm_stack"]
        bound = 10 * SIGN_EPS if name == "sign" else 1e-10
        hist = _history_diff(ha, ht)
        rel_x = _iterate_diff(xa, xt)
        _require(hist["rel_bound"] <= bound and rel_x <= bound,
                 f"models {name}: auto vs torch history {hist['rel_bound']:.3e}, "
                 f"iterate {rel_x:.3e} > {bound:.1e}")
        row = {"history_auto": ha, "history_torch": ht, "history_rel": hist["rel_entry"],
               "history_rel_bound": hist["rel_bound"], "iterate_rel": rel_x, "bound": bound,
               "auto": info_a, "torch": info_t}
        if name == "purify":
            row["measure"] = {"start": start["purify"], "auto": _idempotency(xa),
                              "torch": _idempotency(xt)}
        elif name == "sign":
            row["measure"] = {"start": start["sign"], "auto": _sign_measure(xa),
                              "torch": _sign_measure(xt)}
        else:
            (sf_a, it_a), (sf_t, it_t) = rest_a, rest_t
            _require(it_a == it_t and sf_a == sf_t,
                     f"models invsqrt: iterations {it_a}/{it_t}, scale {sf_a}/{sf_t}")
            _require(ha[-1] < INVSQRT_TOL and ht[-1] < INVSQRT_TOL,
                     f"models invsqrt: residual {ha[-1]:.3e}/{ht[-1]:.3e} did not reach "
                     f"{INVSQRT_TOL:.0e}")
            row.update(iterations=it_a, scale_factor=sf_a, tol=INVSQRT_TOL,
                       measure={"start": ha[0], "auto": ha[-1], "torch": ht[-1]})
        if name != "invsqrt":
            m = row["measure"]
            _require(m["auto"] < m["start"] and m["torch"] < m["start"],
                     f"models {name}: the convergence measure did not fall: {m}")
        def check(variant, result, info, name=name, xt=xt, ht=ht, bound=bound):
            """Every run in turns against the "torch" run, and K1 on the
            stack format's filled iterates."""
            x, h = result[:2]
            d_h, d_x = _history_diff(h, ht)["rel_bound"], _iterate_diff(x, xt)
            _require(d_h <= bound and d_x <= bound,
                     f"models {name} ({variant}, in turns) vs torch: history {d_h:.3e}, "
                     f"iterate {d_x:.3e} > {bound:.1e}")
            if variant in ("stack", "native", "numpy"):
                _require(_k1(info["launches"]) > 0,
                         f"models {name} ({variant}, in turns): K1 never launched")
            return {"history_rel_bound": d_h, "iterate_rel": d_x}

        if name == "sign":  # the index engine against the NumPy path
            row["in_turns"] = _in_turns("native", info_a, "numpy", lambda eng: _with_engine(
                eng == "native", lambda: _drive("auto", loop)), check)
        else:  # the planner's formats against the stack format through K1
            row["in_turns"] = _in_turns("auto", info_a, "stack",
                                        lambda fmt: _drive("auto", loop, fmt), check)
        rows[name] = row
        del runs, xa, xt
    _emit({"phase": "models", "blocks": MODEL_BLOCKS, "block": MODEL_BLOCK,
           "n": MODEL_BLOCKS * MODEL_BLOCK, "dtype": "float64", "seed": MODEL_SEED,
           "density_blocks": int(p0.nblks), "purify_steps": PURIFY_STEPS,
           "sign_steps": SIGN_STEPS, "sign_filter_eps": SIGN_EPS, "invsqrt_tol": INVSQRT_TOL,
           **rows})
    return k1


def phase_models_f32() -> int:
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED,
                           dtype=torch.float32)
    _, loops = _model_loops(p0, SIGN_F32_STEPS, None)
    # the stack format in both legs: this phase checks K3 on the loop
    (xa, ha), info_a = _drive("auto", loops["sign"], "stack")
    (xt, ht), info_t = _drive("torch", loops["sign"], "stack")
    la = info_a["launches"]
    _require(la["smm_crosspack"] > 0 and la["smm_stack"] == 0 and la["plain"] == 0,
             f"models_f32 under auto: launches {la}")
    tol = kernel_validation_tolerance("float32", MODEL_BLOCK, info_a["longest_run"])
    rel_x = _iterate_diff(xa, xt)
    _require(rel_x <= tol, f"models_f32: auto vs torch iterate {rel_x:.3e} > {tol:.1e}")
    _emit({"phase": "models_f32", "loop": "sign", "dtype": "float32", "mm_format": "stack",
           "steps": SIGN_F32_STEPS,
           "history_auto": ha, "history_torch": ht, "iterate_rel": rel_x, "tolerance": tol,
           "longest_run": info_a["longest_run"], "auto": info_a, "torch": info_t})
    return la["smm_crosspack"]


# the tensor phases: the RI step of the water system, (mu nu|P) M(P,Q) ->
# (mu nu|Q), on test_H2O's blocking (MODEL_BLOCKS molecules of 23
# orbitals) and the density's pair pattern; T's values from TENSOR_SEED
TENSOR_SEED = 20261017
# the legs' depths (molecules), each cut from MODEL_BLOCKS; the batched
# leg runs TENSOR_BATCHES mu batches
TENSOR_LEGS = {"remap": 32, "batched": 48, "f32": 48, "contract_test": 12, "c128": 84}
# the complex128 leg's depth: the largest whose allocator peak stays
# under C128_PEAK_BYTES of the card's 80 GB (the peak runs 1.82-1.88
# times T's and C's bytes: 84 molecules about 55 GB, 86 about 59, 88
# about 65; full width about 84; PERF.md, Cells)
C128_PEAK_BYTES = 60e9
TENSOR_BATCHES = 4
RI_KW = dict(contract_a=(2,), notcontract_a=(0, 1), contract_b=(0,), notcontract_b=(1,),
             map_1=(0, 1), map_2=(2,))


def _ri_pattern(d) -> dict:
    """T's block indices (mu, nu, P) where the pair pattern ``d`` has (mu,
    nu) and (mu, P), and the counts the phase reckons from the pattern:
    T's and C's blocks and the block products."""
    rows, cols = d.entry_coords()
    per_row = [cols[rows == mu] for mu in range(d.nblkrows)]
    idx = np.concatenate([np.stack([np.full(len(s) ** 2, mu), np.repeat(s, len(s)),
                                    np.tile(s, len(s))], axis=1)
                          for mu, s in enumerate(per_row) if len(s)]).astype(np.int64)
    row_len = np.array([len(s) for s in per_row], np.int64)
    c_blocks = sum(len(s) * len(np.unique(np.concatenate([per_row[p] for p in s])))
                   for s in per_row if len(s))
    return {"idx": idx, "t_blocks": len(idx), "c_blocks": int(c_blocks),
            "products": int(row_len[idx[:, 2]].sum()), "m_blocks": int(d.nblks)}


def _ri_operands(nmol: int, dtype=torch.float64):
    """T(mu,nu,P), mapped rows (mu,nu) cols (P), with seeded normal blocks
    drawn on the card; M(P,Q), the density as a rank-2 tensor; the
    pattern's counts; and a maker of empty C tensors (mu,nu|Q).  Complex
    data: the real parts as at the real dtype, then the imaginary parts
    drawn from the same generator (T's normals, M's a tenth of the
    density's scale), so neither operand's imaginary part is zero."""
    real = torch.empty((), dtype=dtype).real.dtype
    d = make_test_density(nmol, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED, dtype=real)
    pat = _ri_pattern(d)
    sizes = [[MODEL_BLOCK] * nmol] * 3
    t = create_tensor("T", sizes, (0, 1), (2,), dtype=dtype)
    idx = pat["idx"]
    gen = torch.Generator(device=resolve_device()).manual_seed(TENSOR_SEED + nmol)

    def normals(shape):
        return torch.randn(shape, generator=gen, dtype=real, device=resolve_device())
    shape = (len(idx), MODEL_BLOCK ** 2, MODEL_BLOCK)
    blocks = normals(shape)
    if dtype.is_complex:
        blocks = torch.complex(blocks, normals(shape))
    t.matrix.stage_device_blocks(idx[:, 0] * nmol + idx[:, 1], idx[:, 2], blocks)
    del blocks
    t.finalize()
    if dtype.is_complex:
        d = _converted(d, dtype)
        for bn in d.bins:
            bn.data.imag.copy_(normals(bn.data.shape) * (0.1 / (nmol * MODEL_BLOCK) ** 0.5))
    m = copy_matrix_to_tensor(d, create_tensor("M", sizes[:2], (0,), (1,), dtype=dtype))
    del d

    def empty_c(name="C", row_dims=(0, 1), col_dims=(2,)):
        return create_tensor(name, sizes, row_dims, col_dims, dtype=dtype).finalize()
    return t, m, pat, empty_c


def _blocks_rel(got, want) -> dict:
    """C's patterns equal, then max |got - want| over max |want|, both on
    the card a bounded chunk of blocks at a time, and both checksums."""
    _require(np.array_equal(got.matrix.keys, want.matrix.keys),
             "tensor: C's block patterns differ")
    diff = scale_ = 0.0
    for bg, bw in zip(got.matrix.bins, want.matrix.bins):
        for xg, xw in zip(bg.data.split(1 << 12), bw.data.split(1 << 12)):
            diff = max(diff, float((xg.double() - xw.double()).abs().max()))
            scale_ = max(scale_, float(xw.double().abs().max()))
    cs = {k: (got.checksum(pos=p), want.checksum(pos=p))
          for k, p in (("checksum", False), ("checksum_pos", True))}
    return {"rel_elementwise": diff / max(scale_, 1e-300),
            "bit_identical": diff == 0.0,
            **{f"rel_{k}": abs(g - w) / abs(w) for k, (g, w) in cs.items()},
            **{k: g for k, (g, _) in cs.items()}}


def _contract_run(driver: str, t, m, c, **kw) -> dict:
    """``contract`` into ``c`` under ``mm_driver=driver``, with the kernel
    counts, the engine's totals, the timer and the allocator's peak set to
    0 just before it and read just after (``alloc_retries``: the times
    the caching allocator had to free its cache and retry a cudaMalloc)."""
    set_config(mm_driver=driver)
    try:
        _reset_counts()
        mm.reset_totals()
        timings.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries0 = mempool.pool_stats(resolve_device())["num_alloc_retries"]
        t0 = time.perf_counter()
        flops = contract(1.0, t, m, kw.pop("beta", 0.0), c, **RI_KW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        totals = mm.read_totals()
        retries = mempool.pool_stats(resolve_device())["num_alloc_retries"] - retries0
    finally:
        set_config(mm_driver="auto")
    return {"driver": driver, "wall_s": wall, "flops": flops,
            "nsplit": getattr(c.matrix, "_tas_nsplit", None), "alloc_retries": retries,
            "launches": counts, **totals,
            "timed_s": {k: {"calls": st.calls, "total": st.total, "self": st.self_time}
                        for k, st in timings._stats.items()},
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "c_blocks": int(c.nblks)}


def phase_tensor() -> dict:
    """The RI contraction at full width through `tensor.contract` (TAS
    split, K1's tiled path), held block by block against the plain
    driver in two mu batches, then again under adaptive precision
    (`_tensor_adaptive`, K1's tiled f64->f32 form); returns K1's row for
    this path and the adaptive leg's form row."""
    gc.collect()
    torch.cuda.empty_cache()
    t, m, pat, empty_c = _ri_operands(MODEL_BLOCKS)
    _require(t.nblks == pat["t_blocks"] and m.nblks == pat["m_blocks"],
             f"tensor: T/M hold {t.nblks}/{m.nblks} blocks, the pattern {pat['t_blocks']}/"
             f"{pat['m_blocks']}")
    mnk = (MODEL_BLOCK ** 2, MODEL_BLOCK, MODEL_BLOCK)
    path = stack_kernel.kernel_path(*mnk)
    _require(path == "tiled", f"tensor: (529,23,23) takes K1's {path} path")
    c = empty_c()
    run = _contract_run("auto", t, m, c)
    ngroups = run["multiplies"]
    la = run["launches"]
    _require(_k1(la) > 0 and la["plain"] == 0 and la["smm_crosspack"] == 0,
             f"tensor: launches {la}")
    _require(c.nblks == pat["c_blocks"], f"tensor: C holds {c.nblks} blocks, the pattern "
                                         f"{pat['c_blocks']}")
    _require(run["flops"] == 2 * int(np.prod(mnk)) * pat["products"],
             f"tensor: {run['flops']} flops, the pattern {2 * int(np.prod(mnk)) * pat['products']}")
    _require(all(f.startswith("stack:") for f in run["formats"]),
             f"tensor: formats {run['formats']}")
    # C's pattern is built once before the groups, which then keep its bins
    _require(run["c_rebuild"] == {"rebuilt": 0, "kept": ngroups, "prebuilt": 1},
             f"tensor: C was rebuilt, kept and pre-built {run['c_rebuild']}")
    _require(run["index_engine"]["expand"]["native"] == ngroups + run["c_rebuild"]["prebuilt"],
             f"tensor: the native expansion ran {run['index_engine']}")
    _require(run["plan_cache"]["hit"] == 0, f"tensor: the groups' plans collided: "
                                            f"{run['plan_cache']}")
    bound, by = stack_bound_s("float64", *mnk, pat["products"], pat["t_blocks"],
                              pat["m_blocks"], pat["c_blocks"])
    out = {"phase": "tensor", "molecules": MODEL_BLOCKS, "block": MODEL_BLOCK,
           "dtype": "float64", "mnk": list(mnk), "path": path,
           "t_blocks": pat["t_blocks"], "m_blocks": pat["m_blocks"],
           "c_blocks": pat["c_blocks"], "products": pat["products"],
           "t_bytes": pat["t_blocks"] * mnk[0] * mnk[2] * 8,
           "c_bytes": pat["c_blocks"] * mnk[0] * mnk[1] * 8,
           "groups": ngroups, "bound_ms": bound * 1e3, "bound_by": by,
           "stack_ms": run["stack_device_s"] * 1e3, "auto": run}
    cmp = _against_plain_batches("tensor", t, m, c, empty_c, MODEL_BLOCKS)
    _require(cmp["rel_to_plain"] <= 1e-10 and cmp["rel_checksum"] <= 1e-12
             and cmp["rel_checksum_pos"] <= 1e-12,
             f"tensor: K1 vs the plain driver rel {cmp['rel_to_plain']:.3e} (<= 1e-10), "
             f"checksums {cmp['rel_checksum']:.3e}/{cmp['rel_checksum_pos']:.3e} (<= 1e-12)")
    out.update(cmp)
    del c
    out["adaptive"] = _tensor_adaptive(t, m, pat, empty_c, out["stack_ms"])
    _emit(out)
    del t, m
    ad = out["adaptive"]
    return {"launches": la["smm_stack"], "path": path, "ms": out["stack_ms"],
            "plain_ms": out["plain_stack_ms"], "bound_ms": out["bound_ms"], "bound_by": by,
            "max_abs_err": out["max_abs_err"], "mnk": list(mnk),
            "adaptive_launches": ad["launches"]["smm_stack"],
            "form_row": _leg_form_row(ad, torch.float64, ("float32", False), out["stack_ms"])}


def _against_plain_batches(what: str, t, m, c, empty_c, nmol: int) -> dict:
    """``c`` (the contraction's C under the config in force) held block by
    block against the plain driver under the same config, run in two mu
    batches (a second C beside the first would need its size again):
    the largest difference over the largest plain value, both checksums,
    and the plain batches' runs (their stack ms summed, ``plain_stack_ms``)."""
    half = nmol // 2
    refs, diff, scale_ = [], 0.0, 0.0
    for lo, hi in ((0, half - 1), (half, nmol - 1)):
        ref = empty_c("C_ref")
        refs.append(_contract_run("torch", t, m, ref, bounds_2=[(lo, hi), None]))
        lt = refs[-1]["launches"]
        _require(lt["plain"] > 0 and lt["smm_stack"] == 0, f"{what}: torch launched {lt}")
        rk = ref.matrix.keys
        pos = np.searchsorted(c.matrix.keys, rk)
        _require(bool(np.all(c.matrix.keys[np.minimum(pos, c.nblks - 1)] == rk)),
                 f"{what}: the plain batch holds blocks C lacks")
        mu = rk // c.matrix.nblkcols // nmol
        _require(bool(np.all((mu >= lo) & (mu <= hi))), f"{what}: a batch left its mu range")
        _require(len(c.matrix.bins) == len(ref.matrix.bins) == 1,
                 f"{what}: C has more than one block shape")
        cb, rb = c.matrix.bins[0].data, ref.matrix.bins[0].data
        slots = c.matrix.ent_slot[pos]
        for s0 in range(0, len(rk), 1 << 12):
            x = cb[torch.from_numpy(slots[s0: s0 + (1 << 12)].astype(np.int64)).to(cb.device)]
            y = rb[torch.from_numpy(ref.matrix.ent_slot[s0: s0 + (1 << 12)].astype(
                np.int64)).to(cb.device)]
            diff = max(diff, float((x - y).abs().max()))
            scale_ = max(scale_, float(y.abs().max()))
        refs[-1]["checksums"] = (ref.checksum(), ref.checksum(pos=True))
        refs[-1]["c_blocks_batch"] = int(ref.nblks)
        del ref, cb, rb
    _require(sum(r["c_blocks_batch"] for r in refs) == c.nblks,
             f"{what}: the plain batches do not cover C")
    cs, cs_pos = c.checksum(), c.checksum(pos=True)
    return {"rel_to_plain": diff / scale_, "max_abs_err": diff,
            "rel_checksum": abs(cs - sum(r["checksums"][0] for r in refs)) / abs(cs),
            "rel_checksum_pos": abs(cs_pos - sum(r["checksums"][1] for r in refs)) / abs(cs_pos),
            "checksum": cs, "checksum_pos": cs_pos,
            "plain_stack_ms": sum(r["stack_device_s"] for r in refs) * 1e3, "torch_batches": refs}


def _leg_form_row(leg: dict, dtype, spec, native_ms: float) -> dict:
    """One of K1's tiled forms in the kernels line, from a contraction leg:
    its launches there beside its kernel's device ms (``stack_ms`` the
    stacks' window, under "verify" with the ABFT probes, ``probe_ms``),
    the plain driver's stacks, the error against it and the bound, and
    its ms over native f64 K1's on the full-width contraction in this run
    (the complex128 leg's is at its own depth)."""
    return {"form": stack_kernel.form_name(dtype, spec), "path": "tiled", "leg": leg["leg"],
            "launches": leg["launches"]["smm_stack"], "max_abs_err": leg["max_abs_err"],
            "ms": leg["kernel_ms"], "stack_ms": leg["stack_ms"], "probe_ms": leg["probe_ms"],
            "plain_ms": leg["plain_stack_ms"], "bound_ms": leg["bound_ms"],
            "bound_by": leg["bound_by"], "library_ms": None,
            "units": stack_kernel.form_units(dtype, spec),
            "native_k1_ms": native_ms, "ratio_to_native": leg["kernel_ms"] / native_ms}


@contextlib.contextmanager
def _event_window(into: dict, key: str, module, name: str):
    """CUDA-event ms of every call of ``module.name`` inside the block
    (its device work, from the stream's position at the call to its
    end), summed into ``into[key]``: K1's wrapper (`stack_kernel.smm_stack`)
    or the ABFT stack probe (`abft.stack_probe`, right after its launch)."""
    real, pairs = getattr(module, name), []

    def timed(*args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*args, **kw)
        e1.record()
        pairs.append((e0, e1))
        return out
    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, real)
        torch.cuda.synchronize()
        into[key] = sum(e0.elapsed_time(e1) for e0, e1 in pairs)


def _timed_contract(t, m, c) -> dict:
    """``contract`` under "auto" (`_contract_run`) with K1's launches and
    the ABFT probes timed apart (`_event_window`): ``kernel_ms`` and
    ``probe_ms`` beside the stacks' window."""
    ms: dict = {}
    with _event_window(ms, "kernel_ms", stack_kernel, "smm_stack"), \
            _event_window(ms, "probe_ms", abft, "stack_probe"):
        run = _contract_run("auto", t, m, c)
    return {**run, **ms}


def _tensor_adaptive(t, m, pat, empty_c, native_ms: float) -> dict:
    """The full-width contraction under ``precision="adaptive"`` and
    ``abft="verify"``: every (529,23,23) f64 stack demotes to f32 and runs
    K1's tiled f64->f32 form, every probe passes (no promotion), and C
    holds block by block to the plain driver under the same precision
    (forced ``"torch"`` resolves the same demotion) at `form_tolerance`
    for k = 23 and the longest run.  A contraction at `TENSOR_LEGS`'
    remap depth validates the form first, so the timed stacks hold no
    first-use check."""
    mnk = (MODEL_BLOCK ** 2, MODEL_BLOCK, MODEL_BLOCK)
    spec = ("float32", False)
    form = stack_kernel.form_name(torch.float64, spec)
    set_config(precision="adaptive", abft="verify")
    try:
        port_precision.reset()
        tw, mw, _, ew = _ri_operands(TENSOR_LEGS["remap"])
        warm = _contract_run("auto", tw, mw, ew("C_warm"))
        del tw, mw
        c = empty_c("C_adaptive")
        ctrs = ("dbcsr_tpu_precision_launches_total", "dbcsr_tpu_precision_promotions_total",
                "dbcsr_tpu_abft_mismatches_total")
        before = [_ctr(x) for x in ctrs]
        run = _timed_contract(t, m, c)
        by_form = _forms_since_reset()
        la = run["launches"]
        demoted, promoted, mismatched = (_ctr(x) - b for x, b in zip(ctrs, before))
        _require(la["plain"] == 0 and la["smm_crosspack"] == 0 and la["smm_superstack"] == 0
                 and set(by_form) == {form} and by_form[form] == la["smm_stack"] > 0
                 and demoted == la["smm_stack"] and promoted == 0 and mismatched == 0,
                 f"tensor adaptive: launches {la}, by form {by_form}, {demoted} demoted, "
                 f"{promoted} promoted, {mismatched} mismatched")
        cells = port_precision.cells_snapshot()
        _require(cells and all(i["state"] == "demoted" for i in cells.values()),
                 f"tensor adaptive: cells {cells}")
        cmp = _against_plain_batches("tensor adaptive", t, m, c, empty_c, MODEL_BLOCKS)
        tol = form_tolerance("float64", spec, MODEL_BLOCK, run["longest_run"])
        _require(cmp["rel_to_plain"] <= tol,
                 f"tensor adaptive: {form} vs the plain driver rel {cmp['rel_to_plain']:.3e} "
                 f"> {tol:.1e}")
        bound, by = stack_bound_s("float64", *mnk, pat["products"], pat["t_blocks"],
                                  pat["m_blocks"], pat["c_blocks"], precision=spec)
        del c
    finally:
        set_config(precision="native", abft="off")
        port_precision.reset()
    return {"leg": "tensor", "precision": "adaptive", "abft": "verify", "form": form,
            "path": stack_kernel.kernel_path(*mnk), "launches": la,
            "launches_by_form": by_form, "warm_launches": warm["launches"],
            "cells": {"x".join(map(str, k)): v for k, v in cells.items()},
            "tolerance": tol, "stack_ms": run["stack_device_s"] * 1e3,
            "kernel_ms": run["kernel_ms"], "probe_ms": run["probe_ms"],
            "bound_ms": bound * 1e3, "bound_by": by,
            "ratio_to_native": run["kernel_ms"] / native_ms,
            "wall_s": run["wall_s"], "peak_allocated_bytes": run["peak_allocated_bytes"],
            "alloc_retries": run["alloc_retries"], **cmp, "auto": run}


def phase_tensor_legs() -> dict:
    """The smaller legs, each at a depth cut to `TENSOR_LEGS`: remap and
    `tensor_copy` (32 molecules), a batched contraction (48), f32 (48),
    `contract_test` against a dense einsum on the host (12) and complex128
    on K1's tiled c8 form (84, `_tensor_c128`).  Returns K1's launches
    and the complex128 leg."""
    out = {"phase": "tensor_legs"}
    k1 = 0
    # remap and tensor_copy: (mu|nu,Q), then back to (mu,nu|Q), bit for bit
    n = TENSOR_LEGS["remap"]
    t, m, _, empty_c = _ri_operands(n)
    c1, c2 = empty_c("C1"), empty_c("C2", (0,), (1, 2))
    r1 = _contract_run("auto", t, m, c1)
    r2 = _contract_run("auto", t, m, c2)
    c3 = empty_c("C3")
    tensor_copy(c3, c2)
    back = remap(c2, (0, 1), (2,), name="C2_back")
    for name, x in (("tensor_copy", c3), ("remap", back)):
        _require(np.array_equal(x.matrix.keys, c1.matrix.keys) and all(
            bx.data.equal(b1.data) for bx, b1 in zip(x.matrix.bins, c1.matrix.bins)),
            f"tensor_legs: {name} back to (mu,nu|Q) is not bit for bit the direct contraction")
    k1 += r1["launches"]["smm_stack"] + r2["launches"]["smm_stack"]
    out["remap"] = {"molecules": n, "c_blocks": int(c1.nblks), "bit_identical": True,
                    "direct": r1, "via_remap": r2}
    del t, m, c1, c2, c3, back
    # batched: four mu batches with filter_eps, against one contraction
    n = TENSOR_LEGS["batched"]
    per = -(-n // TENSOR_BATCHES)
    t, m, _, empty_c = _ri_operands(n)
    cu, cb = empty_c("Cu"), empty_c("Cb")
    ru = _contract_run("auto", t, m, cu, filter_eps=1e-10)
    batches = []
    with batched_contraction(cb):
        for lo in range(0, n, per):
            batches.append(_contract_run("auto", t, m, cb, beta=1.0, filter_eps=1e-10,
                                         bounds_2=[(lo, min(lo + per, n) - 1), None]))
    cmp = _blocks_rel(cb, cu)
    _require(cmp["rel_elementwise"] <= 1e-12, f"tensor_legs: batched vs one contraction "
                                              f"{cmp['rel_elementwise']:.3e} > 1e-12")
    k1 += ru["launches"]["smm_stack"] + sum(b["launches"]["smm_stack"] for b in batches)
    out["batched"] = {"molecules": n, "batches": len(batches), "filter_eps": 1e-10, **cmp,
                      "unbatched": ru, "batched_wall_s": [b["wall_s"] for b in batches],
                      "batched_nsplit": [b["nsplit"] for b in batches]}
    del cu, cb
    # f32 through the kernel "auto" picks, against the plain driver
    n = TENSOR_LEGS["f32"]
    t32, m32, _, empty_c32 = _ri_operands(n, torch.float32)
    ca, ct = empty_c32("Ca"), empty_c32("Ct")
    ra = _contract_run("auto", t32, m32, ca)
    rt = _contract_run("torch", t32, m32, ct)
    kernel = [k for k in ("smm_stack", "smm_crosspack", "smm_crosspack_resident")
              if ra["launches"][k]]
    _require(len(kernel) == 1 and ra["launches"]["plain"] == 0,
             f"tensor_legs f32: launches {ra['launches']}")
    mnk = (MODEL_BLOCK ** 2, MODEL_BLOCK, MODEL_BLOCK)
    path = (stack_kernel.kernel_path(*mnk) if kernel[0] == "smm_stack"
            else crosspack_kernel.kernel_path(torch.float32, choose_pack(*mnk), *mnk))
    tol = kernel_validation_tolerance("float32", MODEL_BLOCK, ra["longest_run"])
    cmp = _blocks_rel(ca, ct)
    _require(cmp["rel_elementwise"] <= tol and cmp["rel_checksum"] <= 1e-6,
             f"tensor_legs f32: {cmp['rel_elementwise']:.3e} > {tol:.1e} or checksum "
             f"{cmp['rel_checksum']:.3e} > 1e-6")
    if kernel[0] == "smm_stack":
        k1 += ra["launches"]["smm_stack"]
    out["f32"] = {"molecules": n, "kernel": kernel[0], "path": path, "tolerance": tol,
                  **cmp, "auto": ra, "torch": rt}
    del t32, m32, ca, ct
    # contract_test: the dense einsum oracle on the host
    n = TENSOR_LEGS["contract_test"]
    t, m, _, empty_c = _ri_operands(n)
    msgs = []
    ok = contract_test(1.0, t, m, 0.0, empty_c(), **RI_KW, io=msgs.append)
    _require(ok, f"tensor_legs: contract_test failed: {msgs}")
    out["contract_test"] = {"molecules": n, "ok": ok, "message": msgs[0].strip()}
    del t, m
    # complex128 through K1's tiled c8 form, against the plain driver
    out["c128"] = leg = _tensor_c128(TENSOR_LEGS["c128"])
    k1 += leg["launches"]["smm_stack"]
    out["k1_launches"] = k1
    _emit(out)
    return {"launches": k1, "c128": leg}


def _tensor_c128(nmol: int) -> dict:
    """The RI contraction in complex128 at ``nmol`` molecules (full width
    would need about 84 GB of allocation; `C128_PEAK_BYTES`): every stack
    on K1's tiled c8 form, no plain call; C block by block against the
    plain driver (two mu batches) within 1e-10 of max |C|, the checksums
    within 1e-12."""
    gc.collect()
    torch.cuda.empty_cache()
    mnk = (MODEL_BLOCK ** 2, MODEL_BLOCK, MODEL_BLOCK)
    # the form's first-use validation, at a shallow depth
    tw, mw, _, ew = _ri_operands(TENSOR_LEGS["contract_test"], torch.complex128)
    warm = _contract_run("auto", tw, mw, ew("C_warm"))
    del tw, mw
    t, m, pat, empty_c = _ri_operands(nmol, torch.complex128)
    c = empty_c()
    run = _timed_contract(t, m, c)
    la, by_form = run["launches"], _forms_since_reset()
    _require(la["plain"] == 0 and la["smm_crosspack"] == 0 and la["smm_superstack"] == 0
             and set(by_form) == {"complex128"} and by_form["complex128"] == la["smm_stack"] > 0,
             f"tensor_legs c128: launches {la}, by form {by_form}")
    _require(c.nblks == pat["c_blocks"], f"tensor_legs c128: C holds {c.nblks} blocks, the "
                                         f"pattern {pat['c_blocks']}")
    _require(run["peak_allocated_bytes"] < C128_PEAK_BYTES,
             f"tensor_legs c128: allocator peak {run['peak_allocated_bytes']} at {nmol} "
             f"molecules, over {C128_PEAK_BYTES:.0f}")
    cmp = _against_plain_batches("tensor_legs c128", t, m, c, empty_c, nmol)
    _require(cmp["rel_to_plain"] <= 1e-10 and cmp["rel_checksum"] <= 1e-12
             and cmp["rel_checksum_pos"] <= 1e-12,
             f"tensor_legs c128: c8 vs the plain driver rel {cmp['rel_to_plain']:.3e} "
             f"(<= 1e-10), checksums {cmp['rel_checksum']:.3e}/{cmp['rel_checksum_pos']:.3e} "
             f"(<= 1e-12)")
    bound, by = stack_bound_s("complex128", *mnk, pat["products"], pat["t_blocks"],
                              pat["m_blocks"], pat["c_blocks"])
    del c, t, m
    return {"leg": "tensor_legs", "molecules": nmol, "cut": f"{nmol} of {MODEL_BLOCKS} molecules: "
            f"the largest depth whose allocator peak stays under {C128_PEAK_BYTES / 1e9:.0f} GB",
            "dtype": "complex128", "path": stack_kernel.kernel_path(*mnk, torch.complex128),
            "t_blocks": pat["t_blocks"], "c_blocks": pat["c_blocks"],
            "products": pat["products"], "launches": la, "launches_by_form": by_form,
            "warm_launches": warm["launches"], "stack_ms": run["stack_device_s"] * 1e3,
            "kernel_ms": run["kernel_ms"], "probe_ms": run["probe_ms"],
            "bound_ms": bound * 1e3, "bound_by": by,
            "wall_s": run["wall_s"], "peak_allocated_bytes": run["peak_allocated_bytes"],
            "alloc_retries": run["alloc_retries"], **cmp, "auto": run}


# the integrity plane's counters that a phase injecting nothing must
# leave at zero: a kernel that starts failing on the card fails the
# smoke instead of running on another driver
_INTEGRITY_COUNTERS = ("dbcsr_tpu_driver_failures_total", "dbcsr_tpu_driver_fallback_total",
                       "dbcsr_tpu_abft_mismatches_total", "dbcsr_tpu_chain_rollback_total",
                       "dbcsr_tpu_checksum_retry_total")


def _integrity_counts() -> dict:
    return {name: {json.dumps(lab, sort_keys=True): v for lab, v in metrics.counter_items(name)}
            for name in _INTEGRITY_COUNTERS}


def _clean(phase: str, fn, *args):
    """Run a phase that injects nothing: no fault may be configured, and
    it must end with zero driver failures, fallbacks, ABFT mismatches,
    rollbacks and checksum retries."""
    _require(not faults.active(), f"{phase}: a fault spec is configured")
    metrics.reset()
    _reset_counts()
    _PHASE_NOW[0] = phase
    out = fn(*args)
    _reset_counts()
    took = {k: v for k, v in _integrity_counts().items() if v}
    _require(not took, f"{phase} injects nothing but took the integrity plane: {took}")
    return out


def _ctr(name: str, **labels) -> float:
    return sum(v for lab, v in metrics.counter_items(name)
               if all(lab.get(k) == x for k, x in labels.items()))


def _expect_counts(what: str, failures: dict, fallbacks: dict) -> dict:
    """The failure and fallback counters must read exactly ``failures``
    ({(driver, kind): n}) and ``fallbacks`` ({(from, to): n})."""
    got_f = {(lab["driver"], lab["kind"]): v
             for lab, v in metrics.counter_items("dbcsr_tpu_driver_failures_total")}
    got_b = {(lab["from"], lab["to"]): v
             for lab, v in metrics.counter_items("dbcsr_tpu_driver_fallback_total")}
    _require(got_f == failures and got_b == fallbacks,
             f"resilience {what}: failures {got_f} (want {failures}), "
             f"fallbacks {got_b} (want {fallbacks})")
    return {"failures": {f"{d}:{k}": v for (d, k), v in got_f.items()},
            "fallbacks": {f"{a}->{b}": v for (a, b), v in got_b.items()}}


def _product(a, b, c0, alpha=0.7, beta=0.5):
    """C = alpha A B + beta C0 on a copy of C0, synchronized."""
    c = c0.copy()
    mm.multiply("N", "N", alpha, a, b, beta, c)
    torch.cuda.synchronize()
    return c


def _resilience_operands(dtype, occ=(0.2, 0.2, 0.3), seed=20261018, device=None):
    sizes = np.full(MODEL_BLOCKS, MODEL_BLOCK)
    rng = np.random.default_rng(seed)
    return [make_random_matrix(nm, sizes, sizes, dtype=dtype, occupation=o, rng=rng,
                               device=device) for nm, o in zip("ABC", occ)]


def phase_resilience() -> dict:
    """The failover chain on the card, at `test_H2O`'s blocking (2208^2),
    f64 and f32: a failed K1 launch, non-finite output, the breaker, the
    crosspack demotion, the canvas failover and the host driver, each
    fault counted exactly; then one `.perf` gate under a failing launch.
    Returns K1's and K3's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "resilience", "n": MODEL_BLOCKS * MODEL_BLOCK, "block": MODEL_BLOCK}
    key64, key32 = (MODEL_BLOCK,) * 3 + ("float64",), (MODEL_BLOCK,) * 3 + ("float32",)
    _reset_counts()
    try:
        set_config(mm_format="stack")
        a, b, c0 = _resilience_operands(torch.float64)
        ref = _product(a, b, c0)
        _require(stack_kernel.launches > 0, "resilience: the clean product never took K1")

        def faulted(spec, what, failures, fallbacks, tol=1e-12, ops=(a, b, c0), want=ref):
            # a failover heals the cached plan: every product here plans
            # anew, and each case starts from closed breakers
            mm.clear_plan_cache()
            breaker.reset_board()
            metrics.reset()
            before = _counts()
            with faults.inject_faults(spec) as sp:
                c = _product(*ops)
            took = _launched_since(before)
            mm.clear_plan_cache()
            rel = _canvas_rel(c, want)
            _require(sp[0].fired == 1 and rel <= tol and took["plain"] == 0,
                     f"resilience {what}: fired {sp[0].fired}, rel {rel:.3e} > {tol:.1e}, "
                     f"launched {took}")
            return {"spec": spec, "rel": rel, "launched": took,
                    **_expect_counts(what, failures, fallbacks)}

        out["launch_failover"] = faulted("pallas:raise,times=1", "launch failover",
                                         {("pallas", "runtime"): 1},
                                         {("pallas", "pallas_cross"): 1})
        out["non_finite"] = faulted("execute_stack:nan,times=1", "non-finite output",
                                    {("pallas", "nan"): 1}, {("pallas", "pallas_cross"): 1})
        # the breaker: three failures open it, the next launch skips K1
        breaker.reset_board()
        metrics.reset()
        board = breaker.get_board()
        with faults.inject_faults("pallas:raise") as sp:
            for _ in range(3):
                mm.clear_plan_cache()
                _product(a, b, c0)
            state = board.state("pallas", key64)
            _require(state == breaker.OPEN, f"resilience breaker: {state} after 3 failures")
            calls, before = sp[0].calls, _counts()
            mm.clear_plan_cache()
            c = _product(a, b, c0)
            took = _launched_since(before)
            _require(sp[0].calls == calls and _k1(took) == 0
                     and took["smm_crosspack"] > 0 and took["plain"] == 0,
                     f"resilience breaker: the quarantined product launched {took}")
        mm.clear_plan_cache()
        rel = _canvas_rel(c, ref)
        _require(rel <= 1e-12, f"resilience breaker: quarantined product rel {rel:.3e}")
        out["breaker"] = {"state_after_3": state, "board": board.snapshot(), "rel": rel,
                          "quarantined_launched": took,
                          **_expect_counts("breaker", {("pallas", "runtime"): 3},
                                           {("pallas", "pallas_cross"): 4})}
        breaker.reset_board()
        # the canvas failover on full operands
        full = _resilience_operands(torch.float64, occ=(1.0, 1.0, 0.3))
        set_config(mm_format="dense")
        ref_dense = _product(*full)
        _require(ref_dense._mm_algorithm == "dense", "resilience: the clean canvas leg ran "
                 f"{ref_dense._mm_algorithm}")
        out["canvas_failover"] = faulted("dense:raise,times=1", "canvas failover",
                                         {("dense", "runtime"): 1}, {("dense", "stack"): 1},
                                         ops=full, want=ref_dense)
        set_config(mm_format="stack")
        del full, ref_dense
        # the crosspack demotion, f32: a deterministic failure demotes the
        # shape, an out-of-memory one does not
        a32, b32, c32 = _resilience_operands(torch.float32)
        k3_before = crosspack_kernel.launches_cross
        ref32 = _product(a32, b32, c32)
        _require(crosspack_kernel.launches_cross > k3_before, "resilience: f32 never took K3")
        tol32 = kernel_validation_tolerance("float32", MODEL_BLOCK, MODEL_BLOCKS)
        demotion = {}
        for kind in ("raise", "oom"):
            port_smm._cross_disabled.discard(key32)
            demotion[kind] = faulted(f"pallas_cross:{kind},times=1", f"crosspack {kind}",
                                     {("pallas_cross", "oom" if kind == "oom" else "runtime"): 1},
                                     {("pallas_cross", "pallas"): 1}, tol=tol32,
                                     ops=(a32, b32, c32), want=ref32)
            demoted = key32 in port_smm._cross_disabled
            _require(demoted == (kind == "raise"),
                     f"resilience crosspack {kind}: demoted {demoted}")
            before = _counts()
            c = _product(a32, b32, c32)  # planned anew, without a fault
            took = _launched_since(before)
            want = "smm_stack" if demoted else "smm_crosspack"
            _require(took[want] > 0 and took["plain"] == 0,
                     f"resilience crosspack {kind}: the next product launched {took}")
            rel = _canvas_rel(c, ref32)
            _require(rel <= tol32, f"resilience crosspack {kind}: next product rel {rel:.3e}")
            demotion[kind].update(demoted=demoted, next_product=took, next_rel=rel)
        port_smm._cross_disabled.discard(key32)
        out["crosspack_demotion"] = demotion
        del a32, b32, c32, ref32
        # the host driver: CPU matrices on the card's host, against the
        # plain version; the same request on the card's tensors raises
        cpu = _resilience_operands(torch.float64, device="cpu")
        host = {}
        for driver in ("host", "torch", "host", "torch"):
            set_config(mm_driver=driver)
            c = cpu[2].copy()
            t0 = time.perf_counter()
            mm.multiply("N", "N", 0.7, cpu[0], cpu[1], 0.5, c)
            host.setdefault(driver, {"wall_s": [], "c": c})["wall_s"].append(
                time.perf_counter() - t0)
        rel = (maxabs_norm(added(host["host"]["c"], host["torch"]["c"], 1.0, -1.0))
               / maxabs_norm(host["torch"]["c"]))
        _require(rel <= 1e-12, f"resilience host driver vs torch: rel {rel:.3e}")
        set_config(mm_driver="host")
        mm.clear_plan_cache()
        try:
            mm.multiply("N", "N", 0.7, a, b, 0.5, c0.copy())
        except ValueError as exc:
            refused = str(exc)
        else:
            raise RuntimeError("resilience: mm_driver='host' ran on the card's tensors")
        out["host_driver"] = {"stacks": "cpu", "rel_to_torch": rel, "cuda_refused": refused,
                              "wall_s": {d: v["wall_s"] for d, v in host.items()}}
        set_config(mm_driver="auto")
        del cpu, host
        # one `.perf` gate with a failing K1 launch: the checksum holds
        cfg = parse_perf_file(os.path.join(INPUTS, "test_H2O.perf"))
        cfg.nrep = 1
        mm.clear_plan_cache()
        metrics.reset()
        before = _counts()
        with faults.inject_faults("pallas:raise,times=1") as sp:
            res = run_perf(cfg, verbose=False)  # raises on a mismatch (no retry)
        took = _launched_since(before)
        _require(took["plain"] == 0, f"resilience perf gate: launched {took}")
        out["perf_gate"] = {"input": "test_H2O", "checksum": res["checksum"], "fired":
                            sp[0].fired, "launched": took,
                            **_expect_counts("perf gate", {("pallas", "runtime"): 1},
                                             {("pallas", "pallas_cross"): 1})}
    finally:
        faults.clear()
        breaker.reset_board()
        mm.clear_plan_cache()
        port_smm._cross_disabled.discard(key32)
        set_config(mm_driver="auto", mm_format="auto", abft="off")
    counts = _counts()
    out["launches"] = counts
    _emit(out)
    return {"smm_stack": counts["smm_stack"], "smm_crosspack": counts["smm_crosspack"]}


def _probe_ms(a, b, c, reps: int = 5) -> dict:
    """Each stack of ``c = a * b`` timed by CUDA events beside its ABFT
    probe: the first-touch form (C was zero) and the delta form (a
    pristine copy of C subtracted), summed per multiply."""
    i, j, a_ent, b_ent = _candidates(a, b, None)
    spans = _build_spans(c, a, b, i * c.nblkcols + j, a_ent, b_ent)
    tot = {"stack_ms": 0.0, "probe_ms_c_zero": 0.0, "probe_ms_delta": 0.0, "spans": len(spans)}
    for sp in spans:
        ad, bd, cd = a.bins[sp.abin].data, b.bins[sp.bbin].data, c.bins[sp.cbin].data
        kernel, _ = _calls(sp.plan)
        scratch, base = cd.clone(), torch.zeros_like(cd)
        tot["stack_ms"] += _time_ms(lambda: kernel(scratch, ad, bd, 1.0), reps)
        tot["probe_ms_c_zero"] += _time_ms(
            lambda: abft.stack_probe(None, cd, ad, bd, sp.plan, 1.0, c_zero=True), reps)
        tot["probe_ms_delta"] += _time_ms(
            lambda: abft.stack_probe(base, cd, ad, bd, sp.plan, 1.0), reps)
        del scratch, base
    return tot


def _same_bits(x, y) -> bool:
    return np.array_equal(x.keys, y.keys) and all(
        bx.data.equal(by.data) for bx, by in zip(x.bins, y.bins))


# the silent flip of the integrity phase, and for each loop a flip its
# chain invariant catches in the same step at the models' size (ABFT
# off): purify's trace bound sees a diagonal element of its first
# product, the sign bound a flip in X' (the step's second product),
# invsqrt's residual contraction a flip in the second residual.
FLIP = "execute_stack:flip,seed=13,times=1"
# `FLIP` with ABFT off, as the JAX package's own guarded loops end at
# this size on the CPU (`tools/flip_reference.py --package jax`): purify
# misses the off-diagonal flip and runs on to a wrong iterate, sign sees
# it a step late, after accepting the iterate, and raises; invsqrt rolls
# it back.  (outcome, rollbacks), required of the port alike.
FLIP_OFF_REFERENCE = {"purify": ("differs", 0), "sign": ("ChainIntegrityError", 1),
                      "invsqrt": ("bitwise", 1)}
INVARIANT_FLIPS = {"purify": "execute_stack:flip@stack==1,seed=0,times=1",
                   "sign": "execute_stack:flip@stack==2,seed=13,times=1",
                   "invsqrt": "execute_stack:flip@stack==4,seed=13,times=1"}


def phase_integrity() -> dict:
    """The integrity plane on the models' operands (2208^2, f64): the
    three loops under ``abft="verify"`` bit for bit as without it, in
    turns; a silent flip caught by the chain invariant (ABFT off,
    `INVARIANT_FLIPS`) and by the probe (verify, `FLIP`), both ending bit
    for bit on the clean loop, and `FLIP` with ABFT off ending as the JAX
    package's loops end (`FLIP_OFF_REFERENCE`); a canvas flip in purify
    redone on the stack format; and the north star
    (f64, K1; f32, K3) under "verify" against "off" in turns, with the
    probe's milliseconds beside the stacks'.  Returns K1's and K3's
    launches."""
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED)
    _, loops = _model_loops(p0, SIGN_STEPS, SIGN_EPS)
    out = {"phase": "integrity", "n": MODEL_BLOCKS * MODEL_BLOCK, "dtype": "float64"}
    _reset_counts()
    try:
        rows = {}
        for name, loop in loops.items():
            runs = {"off": [], "verify": []}
            for mode in ("off", "verify", "verify", "off"):
                set_config(abft=mode)
                metrics.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, hist = loop()[:2]
                torch.cuda.synchronize()
                runs[mode].append((time.perf_counter() - t0, x, hist,
                                   _ctr("dbcsr_tpu_abft_checks_total")))
                took = {k: v for k, v in _integrity_counts().items() if v}
                _require(not took, f"integrity {name} ({mode}, no fault) took {took}")
            set_config(abft="off")
            x0, h0 = runs["off"][0][1:3]
            for mode, rs in runs.items():
                for _, x, h, _ in rs:
                    _require(list(h) == list(h0) and _same_bits(x, x0),
                             f"integrity {name}: a run under {mode} differs from the "
                             f"unguarded loop")
            row = {"wall_s": {m: [r[0] for r in rs] for m, rs in runs.items()},
                   "abft_checks": runs["verify"][0][3], "steps": len(h0)}
            # a silent flip: the chain invariant with ABFT off, on a launch
            # it catches at this size, and on the first launch (as the
            # reference ends); then the probe under "verify"
            for case, mode, spec in (("flip_off", "off", INVARIANT_FLIPS[name]),
                                     ("flip_off_first_launch", "off", FLIP),
                                     ("flip_verify", "verify", FLIP)):
                set_config(abft=mode)
                metrics.reset()
                outcome = None
                try:
                    with faults.inject_faults(spec) as sp:
                        x, h = loop()[:2]
                except (integrity.ChainIntegrityError, port_smm.CorruptedOutputError) as exc:
                    outcome = type(exc).__name__
                finally:
                    set_config(abft="off")
                    # a failover heals cached plans and feeds the breakers:
                    # the next run starts from neither
                    mm.clear_plan_cache()
                    breaker.reset_board()
                if outcome is None:
                    outcome = "bitwise" if (_same_bits(x, x0) and list(h) == list(h0)) \
                        else "differs"
                rollbacks = _ctr("dbcsr_tpu_chain_rollback_total")
                recov = _ctr("dbcsr_tpu_abft_recoveries_total")
                row[case] = {"spec": spec, "fired": sp[0].fired, "outcome": outcome,
                             "rollbacks": rollbacks, "abft_recoveries": recov,
                             "abft_mismatches": _ctr("dbcsr_tpu_abft_mismatches_total")}
                if case == "flip_off_first_launch":
                    want = FLIP_OFF_REFERENCE[name]
                    row[case]["reference"] = want
                    _require(sp[0].fired == 1 and (outcome, rollbacks) == want,
                             f"integrity {name} {case}: {row[case]}, the JAX package "
                             f"ends {want}")
                    continue
                detector = rollbacks if mode == "off" else recov
                _require(sp[0].fired == 1 and detector >= 1 and outcome == "bitwise"
                         and (mode == "off" or rollbacks == 0),
                         f"integrity {name} {case}: {row[case]}")
            rows[name] = row
            del runs
        # a canvas flip in purify: the canvas probe condemns it and the
        # product is redone on the stack format
        set_config(abft="verify")
        metrics.reset()
        with faults.inject_faults("dense:flip,times=1") as sp:
            x, h = loops["purify"]()
        set_config(abft="off")
        x0 = mcweeny_purify(p0, steps=PURIFY_STEPS)[0]
        rel = _iterate_diff(x, x0)
        _require(sp[0].fired == 1 and rel <= 1e-12
                 and _ctr("dbcsr_tpu_abft_mismatches_total", driver="dense") == 1
                 and _ctr("dbcsr_tpu_abft_recoveries_total", driver="dense") == 1
                 and _ctr("dbcsr_tpu_driver_fallback_total", **{"from": "dense",
                                                                "to": "stack"}) == 1,
                 f"integrity canvas flip: fired {sp[0].fired}, rel {rel:.3e}, "
                 f"{_integrity_counts()}")
        rows["purify"]["canvas_flip"] = {"rel": rel, **_integrity_counts()}
        out["loops"] = rows
        # the north star under "verify" against "off", in turns
        ns = {}
        for dtype_code, dname in ((3, "float64"), (1, "float32")):
            res = run_perf(_northstar_cfg(1, dtype_code), verbose=False)
            a, b = res["matrices"]["a"], res["matrices"]["b"]
            c_out = res["matrices"]["c_out"]
            empty = BlockSparseMatrix("C", c_out.row_blk_sizes, c_out.col_blk_sizes, c_out.dtype)
            walls = {"off": [], "verify": []}
            ref = None
            for mode in ("off", "verify", "verify", "off"):
                set_config(abft=mode)
                metrics.reset()
                for rep in range(3):
                    c = empty.copy()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
                    torch.cuda.synchronize()
                    if rep:
                        walls[mode].append(time.perf_counter() - t0)
                took = {k: v for k, v in _integrity_counts().items() if v}
                _require(not took, f"integrity north star {dname} ({mode}) took {took}")
                if ref is None:
                    ref = c
                _require(_same_bits(c, ref), f"integrity north star {dname} ({mode}): C differs")
            set_config(abft="off")
            ns[dname] = {"s_per_multiply": walls, **_probe_ms(a, b, c_out)}
            del res, a, b, c_out, c, ref
        out["northstar"] = ns
    finally:
        faults.clear()
        breaker.reset_board()
        mm.clear_plan_cache()
        abft.discard_pending()
        set_config(abft="off", mm_driver="auto", mm_format="auto")
    counts = _counts()
    out["launches"] = counts
    _emit(out)
    return {"smm_stack": counts["smm_stack"], "smm_crosspack": counts["smm_crosspack"]}


# ----------------------------------------------------------------- complex
COMPLEX_NREP = 2


def _form_row(form: str, launches: int, timing: dict, units: str, native_ms: float) -> dict:
    """One of K1's forms in the kernels line: its launches on the main
    path beside its stacks' times, error and bound (one `_stacks_phase`),
    the units its products run on, and its time over native K1's on the
    same product's stacks in this run."""
    return {"form": form, "launches": launches, "max_abs_err": timing["max_abs_err"][0],
            "ms": timing["ms"][0], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"], "library_ms": None,
            "units": units, "native_k1_ms": native_ms,
            "ratio_to_native": timing["ms"][0] / native_ms}


# K1's complex forms against their plain version: one shape of each
# warp-path register class and one on the tiled path
COMPLEX_SHAPES = ((23, 23, 23), (5, 13, 7), (32, 32, 32), (100, 50, 20))


def _forms_vs_plain(forms, shapes, seed: int, alpha, max_len: int = 4) -> list:
    """Every form of ``forms`` ((dtype, precision spec) pairs) at every
    block shape against its plain version on synthetic stacks (runs of 1
    to ``max_len`` entries and one of 5000), timed: both compute the same
    function from the same operands, so they agree within the rounding of
    the form's sums (`form_tolerance` at the stack's k and longest run).
    Both K1 paths must run."""
    rng = np.random.default_rng(seed)
    cases, paths = [], set()
    for dtype, spec in forms:
        for m, n, k in shapes:
            a, b, c, a_idx, b_idx, c_idx = _synthetic_stack(rng, m, n, k, dtype,
                                                            max_len=max_len)
            plan = prepare_stack(c, a, b, a_idx, b_idx, c_idx, variant="kmerge")
            args = (plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c)

            def kernel(c_, a_, b_, al, spec=spec, args=args):
                return stack_kernel.smm_stack(c_, a_, b_, *args, al, precision=spec)

            def plain(c_, a_, b_, al, spec=spec, args=args):
                return stack_kernel.smm_stack_plain(c_, a_, b_, *args, al, precision=spec)
            path = stack_kernel.kernel_path(m, n, k, dtype)
            paths.add(path)
            got = _written(kernel, c, a, b, alpha)
            want = plain(c.clone(), a, b, alpha)
            torch.cuda.synchronize()
            rel = _rel_err(got, want)
            form = stack_kernel.form_name(dtype, spec)
            tol = form_tolerance(name_of(dtype), spec, k, plan.max_run)
            _require(np.isfinite(rel) and rel <= tol,
                     f"{form} != plain at {(m, n, k)} ({path} path): rel {rel:.3e} > {tol:.1e}")
            scratch = c.clone()
            bound, by = stack_bound_s(name_of(dtype), m, n, k, plan.entries,
                                      len(np.unique(a_idx)), len(np.unique(b_idx)), plan.nruns,
                                      precision=spec)
            cases.append({"form": form, "mnk": [m, n, k], "path": path,
                          "entries": plan.entries, "runs": plan.nruns,
                          "longest_run": plan.max_run, "max_rel_err": rel, "tolerance": tol,
                          "ms": _time_ms(lambda: kernel(scratch, a, b, alpha), 10),
                          "plain_ms": _time_ms(lambda: plain(scratch, a, b, alpha), 3),
                          "bound_ms": bound * 1e3, "bound_by": by})
            if path == "tiled":
                cases[-1]["geometry"] = stack_kernel.tiled_geometry(m, n, k, dtype, spec)
            del a, b, c, got, want, scratch
    _require(paths == {"warp", "tiled"}, f"the forms {forms} ran the paths {sorted(paths)}")
    return cases


def _complex_vs_plain() -> list:
    """Both complex forms on both K1 paths against their plain version,
    complex alpha, runs of 1-16 entries and one of 5000."""
    return _forms_vs_plain(((torch.complex128, None), (torch.complex64, None)),
                           COMPLEX_SHAPES, 20261022, 0.75 - 0.5j, max_len=16)


def _forms_since_reset() -> dict:
    return dict(stack_kernel.launches_by_form)


def phase_complex(native_ms: float) -> dict:
    """Both complex forms against their plain version on both K1 paths
    (`_complex_vs_plain`); the north star's pattern (10,000^2, 23x23
    blocks, occupancy 0.1) at
    complex128 and then complex64 through `run_perf`, on K1's complex form
    (its warp path): no crosspack launch, no plain call; C against one
    repeat under ``"torch"`` (elementwise and checksums within 1e-10 at
    complex128, the kernel validation tolerance at complex64); the stacks
    by CUDA events beside their bound, the plain version's time and
    native f64 K1's on the north star (``native_ms``, this run); then
    C = alpha A B^H at `test_H2O`'s blocking (2208^2), ``transb="C"``,
    against the plain driver and a dense oracle on the card.  Returns
    K1's launches and its complex form rows."""
    out = {"phase": "complex", "kernel_vs_plain": _complex_vs_plain(), "northstar": {}}
    forms, launches = [], 0
    for data_type in (7, 5):
        dtype = dtype_of(data_type)
        dname = name_of(dtype)
        _reset_counts()
        res = run_perf(_northstar_cfg(COMPLEX_NREP, data_type), verbose=False)
        counts, by_form = _counts(), _forms_since_reset()
        _require(counts["smm_stack"] > 0 and counts["plain"] == 0
                 and counts["smm_crosspack"] == 0 and counts["smm_crosspack_resident"] == 0,
                 f"complex north star {dname}: launches {counts}")
        _require(set(by_form) == {dname}, f"complex north star {dname}: forms {by_form}")
        longest = max(s[5] for s in res["spans"])
        tol = 1e-10 if dtype == torch.complex128 else kernel_validation_tolerance(dname, 23,
                                                                                  longest)
        row = {"dtype": dname, "path": stack_kernel.kernel_path(23, 23, 23, dtype),
               **_run_summary(res, COMPLEX_NREP, counts), "launches_by_form": by_form,
               "longest_run": longest, "a_bytes": sum(x.data.numel() * x.data.element_size()
                                                      for x in res["matrices"]["a"].bins),
               "c_bytes": sum(x.data.numel() * x.data.element_size()
                              for x in res["matrices"]["c_out"].bins)}
        row.update(_against_torch_driver(res, _northstar_cfg(1, data_type), tol, tol))
        row.pop("spans")
        out["northstar"][dname] = row
        launches += counts["smm_stack"]
        operands = _operands(res, _northstar_cfg(1, data_type))
        del res
        timing = _stacks_phase(f"complex_{dname}_stacks", *operands, path="warp")
        forms.append(_form_row(dname, counts["smm_stack"], timing,
                               stack_kernel.form_units(dtype), native_ms))
        del operands
    # C = alpha A B^H at 2208^2, complex128
    a, b = _resilience_operands(torch.complex128, seed=20261019)[:2]
    c = BlockSparseMatrix("C", a.row_blk_sizes, b.row_blk_sizes, torch.complex128)
    alpha = 0.5 - 0.25j
    _reset_counts()
    mm.multiply("N", "C", alpha, a, b, 0.0, c)
    torch.cuda.synchronize()
    counts = _counts()
    _require(counts["smm_stack"] > 0 and counts["plain"] == 0, f"A B^H: launches {counts}")
    launches += counts["smm_stack"]
    set_config(mm_driver="torch")
    try:
        ref = BlockSparseMatrix("R", a.row_blk_sizes, b.row_blk_sizes, torch.complex128)
        mm.multiply("N", "C", alpha, a, b, 0.0, ref)
    finally:
        set_config(mm_driver="auto")
    oracle = alpha * (_to_dense_device(a) @ _to_dense_device(b).conj().T)
    rel_plain, rel_dense = _canvas_rel(c, ref), float(
        (_to_dense_device(c) - oracle).abs().max()) / float(oracle.abs().max())
    _require(rel_plain <= 1e-12 and rel_dense <= 1e-12,
             f"A B^H: rel {rel_plain:.3e} vs the plain driver, {rel_dense:.3e} vs dense")
    out["hermitian_product"] = {"n": MODEL_BLOCKS * MODEL_BLOCK, "transb": "C",
                                "alpha": [alpha.real, alpha.imag], "launches": counts,
                                "rel_plain_driver": rel_plain, "rel_dense_oracle": rel_dense,
                                "spans": c._mm_spans}
    out["forms"] = forms
    _emit(out)
    return {"launches": launches, "forms": forms}


# --------------------------------------------------------------- precision
# every demoted form of K1 and the data dtypes it takes
DEMOTED_FORMS = ((torch.float64, ("float32", False)), (torch.float64, ("float32", True)),
                 (torch.float64, ("bfloat16", False)), (torch.float64, ("bfloat16", True)),
                 (torch.float32, ("bfloat16", False)), (torch.float32, ("bfloat16", True)))
# a shape of each warp-path register class (the north star's in the
# middle one) and 100/50/20 on the tiled path, as `COMPLEX_SHAPES`
DEMOTED_SHAPES = ((23, 23, 23), (5, 13, 7), (32, 32, 32), (100, 50, 20))


def _demoted_vs_plain() -> list:
    """Every demoted form on both K1 paths against its plain version on
    synthetic stacks (runs of 1-4 and one of 5000), timed: both round the
    same operands, so they agree within the rounding of the form's sums
    (`form_tolerance` at the stack's k and longest run), far inside the
    demotion ceiling."""
    return _forms_vs_plain(DEMOTED_FORMS, DEMOTED_SHAPES, 20261020, -0.75)


# every form of K1: native real, complex, demoted
K1_FORMS = ((torch.float64, None), (torch.float32, None), (torch.bfloat16, None),
            (torch.complex128, None), (torch.complex64, None)) + DEMOTED_FORMS


def _demoted_counts() -> int:
    return int(_ctr("dbcsr_tpu_precision_launches_total"))


def _h2o_form(data_type: int, mode: str, column=None) -> tuple:
    """`test_H2O` at ``data_type`` under ``precision=mode`` (a tuned row's
    ``precision`` column where given) against its native run: checksums
    and C within the form's ceiling; returns (row, main-path launches by
    form, the stacks' timing)."""
    cfg = parse_perf_file(os.path.join(INPUTS, "test_H2O.perf"))
    cfg.data_type, cfg.nrep, cfg.check = data_type, 1, False
    native_res = run_perf(cfg, verbose=False)
    set_config(precision=mode, abft="verify" if mode == "adaptive" else "off")
    try:
        if column is not None:
            for m, n, k in _block_shapes(cfg):
                params.save_entry({"m": m, "n": n, "k": k, "dtype": name_of(dtype_of(data_type)),
                                   "driver": "pallas", "precision": column, "gflops": 0.0})
        _reset_counts()
        metrics.reset()
        res = run_perf(cfg, verbose=False)
        counts, by_form = _counts(), _forms_since_reset()
        timing = _stacks_phase(f"precision_h2o_{data_type}_{mode}_{column}_stacks",
                               *_operands(res, cfg))
    finally:
        set_config(precision="native", abft="off")
    spec = {"f32": ("float32", True), "bf16": ("bfloat16", True)}.get(mode) or \
        port_precision.column_spec(column, dtype_of(data_type))
    form = stack_kernel.form_name(dtype_of(data_type), spec)
    _require(set(by_form) == {form} and counts["plain"] == 0 and counts["smm_crosspack"] == 0,
             f"test_H2O {mode}/{column}: launches {counts}, forms {by_form}, want {form}")
    longest = max(s[5] for s in res["spans"])
    tol = demoted_abft_tolerance(name_of(dtype_of(data_type)), *spec, 23, longest)
    rel_cs = abs(res["checksum"] - native_res["checksum"]) / abs(native_res["checksum"])
    rel_el = _canvas_rel(res["matrices"]["c_out"], native_res["matrices"]["c_out"])
    _require(rel_cs <= tol and rel_el <= tol,
             f"test_H2O {form}: rel {rel_cs:.3e}/{rel_el:.3e} against native > {tol:.1e}")
    row = {"form": form, "spec": spec, "mode": mode, "column": column, "launches": counts,
           "demoted_launches": _demoted_counts(), "times_s": res["times_s"],
           "native_times_s": native_res["times_s"], "rel_checksum": rel_cs,
           "rel_elementwise": rel_el, "tolerance": tol,
           "abft_mismatches": _ctr("dbcsr_tpu_abft_mismatches_total")}
    return row, by_form.get(form, 0), timing


def _sabotaged(fn):
    """``fn()`` with every demotion ceiling at 1e-30: each demoted probe
    breaches."""
    real = port_costmodel.demoted_abft_tolerance
    port_costmodel.demoted_abft_tolerance = lambda *args: 1e-30
    try:
        return fn()
    finally:
        port_costmodel.demoted_abft_tolerance = real


def _h2o_native_ms(data_type: int) -> float:
    """Native K1 on `test_H2O`'s stacks at ``data_type`` (K1 forced: f32
    would take K3 under "auto"), summed over the stacks."""
    cfg = parse_perf_file(os.path.join(INPUTS, "test_H2O.perf"))
    cfg.data_type, cfg.nrep, cfg.check = data_type, 1, False
    set_config(mm_driver="pallas")
    try:
        res = run_perf(cfg, verbose=False)
        return _stacks_phase(f"precision_h2o_{data_type}_native_stacks",
                             *_operands(res, cfg))["ms"][0]
    finally:
        set_config(mm_driver="auto")


def phase_precision(native_ms: float) -> dict:
    """The precision planner and K1's demoted forms: every form against its
    plain version on both paths; the f64 north star under
    ``precision="adaptive"``, ``abft="verify"`` (every stack demoted,
    every probe passing, C within the ceiling of the native product,
    seconds per multiply native and demoted in turns); the forced modes
    and the tuned ``precision`` column on `test_H2O`; a forced promote
    (the ceiling sabotaged for one product, beta = 0 and beta = 0.5):
    native re-execution bit for bit, the cell native afterwards; and the
    sign loop at the models' size under adaptive + verify, demoting,
    promoting and converging as the native loop does.  Returns K1's
    launches on the main path and its demoted form rows, each with its
    units and its time over native K1's on the same stacks (``native_ms``
    on the north star; `test_H2O` timed here)."""
    out = {"phase": "precision", "kernel_vs_plain": _demoted_vs_plain()}
    forms, launches = {}, 0
    port_precision.reset()
    # the f64 north star, native and adaptive, under verify
    cfg = _northstar_cfg(1)
    res = run_perf(cfg, verbose=False)
    a, b, c_nat = _operands(res, cfg)
    empty = BlockSparseMatrix("C", c_nat.row_blk_sizes, c_nat.col_blk_sizes, c_nat.dtype)
    del res
    set_config(abft="verify")
    try:
        walls = {"native": [], "adaptive": []}
        c_dem = None
        for mode in ("native", "adaptive", "adaptive", "native"):
            set_config(precision=mode)
            for rep in range(2):
                metrics.reset()
                _reset_counts()
                c = empty.copy()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mm.multiply("N", "N", 1.0, a, b, 0.0, c)
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
                if mode == "adaptive":
                    spans = len(c._mm_spans)
                    _require(_demoted_counts() == spans
                             and _ctr("dbcsr_tpu_abft_checks_total") >= spans
                             and not _ctr("dbcsr_tpu_abft_mismatches_total")
                             and not _ctr("dbcsr_tpu_precision_promotions_total"),
                             f"adaptive north star: {_demoted_counts()} demoted launches of "
                             f"{spans} stacks, {metrics.snapshot()}")
                    if c_dem is None:
                        c_dem, launches = c, stack_kernel.launches
                        forms["float64:float32"] = stack_kernel.launches_by_form.get(
                            "float64:float32", 0)
        longest = max(s[5] for s in c_dem._mm_spans)
        tol = demoted_abft_tolerance("float64", "float32", False, 23, longest)
        rel = _canvas_rel(c_dem, c_nat)
        _require(0 < rel <= tol, f"adaptive north star: rel {rel:.3e} to native, ceiling {tol:.1e}")
        cells = port_precision.cells_snapshot()
        _require(cells and all(i["state"] == "demoted" for i in cells.values()),
                 f"adaptive north star: cells {cells}")
        out["northstar"] = {"s_per_multiply": walls, "rel_to_native": rel, "ceiling": tol,
                            "spans": len(c_dem._mm_spans), "cells": {
                                "x".join(map(str, k)): v for k, v in cells.items()}}
        set_config(precision="adaptive")
        ns_timing = _stacks_phase("precision_northstar_stacks", a, b, c_dem)
    finally:
        set_config(precision="native", abft="off")
    del a, b, c_nat, c_dem, c, empty
    rows = [_form_row("float64:float32", forms["float64:float32"], ns_timing,
                      stack_kernel.form_units(torch.float64, ("float32", False)), native_ms)]
    h2o_native = {dt: _h2o_native_ms(dt) for dt in (3, 1)}
    # the forced modes and the tuned column on test_H2O
    prev_dir = os.environ.get("DBCSR_TPU_TORCH_PARAMS_DIR")
    h2o = []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = tmp
        try:
            for data_type, mode, column in ((3, "f32", None), (3, "bf16", None),
                                            (1, "bf16", None), (3, "adaptive", "bf16"),
                                            (1, "adaptive", "bf16")):
                port_precision.reset()
                row, n, timing = _h2o_form(data_type, mode, column)
                h2o.append(row)
                rows.append(_form_row(row["form"], n, timing,
                                      stack_kernel.form_units(dtype_of(data_type),
                                                              row.pop("spec")),
                                      h2o_native[data_type]))
                launches += n
        finally:
            if prev_dir is None:
                os.environ.pop("DBCSR_TPU_TORCH_PARAMS_DIR", None)
            else:
                os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = prev_dir
            params.invalidate()
    out["test_H2O"] = h2o
    # a forced promote at 2208^2: the deferred flush (beta 0) and the
    # immediate check (beta 0.5)
    promote = {}
    a, b, c0 = _resilience_operands(torch.float64, seed=20261021)
    for beta in (0.0, 0.5):
        port_precision.reset()
        want = _product(a, b, c0, beta=beta)
        set_config(precision="adaptive", abft="verify")
        try:
            metrics.reset()
            events.clear()
            got = _sabotaged(lambda: _product(a, b, c0, beta=beta))
            cells = port_precision.cells_snapshot()
            _require(_same_bits(got, want), f"forced promote (beta {beta}): C is not the native C")
            _require(cells and all(i["state"] == "promoted" for i in cells.values())
                     and port_precision.resolve(23, 23, 23, torch.float64) is None
                     and events.records(kind="precision_promote_reexec"),
                     f"forced promote (beta {beta}): cells {cells}")
            took = {k: v for k, v in _integrity_counts().items() if v}
            _require(not took, f"forced promote (beta {beta}) took the integrity plane: {took}")
            again = _product(a, b, c0, beta=beta)  # resolves native up front
            _require(_same_bits(again, want), "after the promote: C is not the native C")
            promote[f"beta_{beta}"] = {
                "promotions": _ctr("dbcsr_tpu_precision_promotions_total"),
                "reexecutions": len(events.records(kind="precision_promote_reexec")),
                "demoted_launches": _demoted_counts(), "bitwise_native": True}
        finally:
            set_config(precision="native", abft="off")
    out["forced_promote"] = promote
    del a, b, c0, want, got, again
    # the sign loop: native, then adaptive + verify
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED)
    steps = 2 * SIGN_STEPS  # room to converge: the loops stop at their tolerance
    sign = {}
    for mode in ("native", "adaptive"):
        port_precision.reset()
        set_config(precision=mode, abft="verify" if mode == "adaptive" else "off")
        try:
            events.clear()
            metrics.reset()
            _, loops = _model_loops(p0, steps, SIGN_EPS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, hist = loops["sign"]()
            torch.cuda.synchronize()
            evs = events.records(kind="precision_schedule")
            sign[mode] = {"wall_s": time.perf_counter() - t0, "steps": len(hist),
                          "history": list(hist), "demoted_launches": _demoted_counts(),
                          "schedule": [e["precision"] for e in evs],
                          "promoted_at": [e["step"] for e in evs if e.get("promoted")],
                          "floor": evs[0]["floor"] if evs else None, "x": x}
        finally:
            set_config(precision="native", abft="off")
    nat, dem = sign["native"], sign["adaptive"]
    tol = 1e-10  # sign_iteration's tolerance, which the native loop reaches
    _require(nat["history"][-1] < tol, f"native sign loop ends {nat['history'][-1]:.3e}")
    _require(dem["schedule"] and dem["schedule"][0] == "demoted"
             and dem["schedule"][-1] == "native" and len(dem["promoted_at"]) == 1
             and dem["promoted_at"][0] < len(dem["schedule"]) and dem["demoted_launches"] > 0,
             f"adaptive sign loop: schedule {dem['schedule']}")
    _require(dem["history"][-1] < tol,
             f"sign loops: native ends {nat['history'][-1]:.3e}, adaptive "
             f"{dem['history'][-1]:.3e} (tolerance {tol:.3e})")
    sign["tolerance"] = tol
    sign["adaptive"]["iterate_rel_to_native"] = _iterate_diff(dem.pop("x"), nat.pop("x"))
    out["sign"] = sign
    out["forms"] = rows
    _emit(out)
    return {"launches": launches, "forms": rows}


# ------------------------------------------------------------- incremental
def _new_values(m, sel, rng) -> int:
    """New values, same pattern, in ``m``'s entries ``sel`` (a
    same-pattern finalize: the journal sees exactly those keys)."""
    r, col = m.entry_coords()
    m.put_blocks(r[sel], col[sel], [rng.standard_normal(m.block_shape(r[e], col[e]))
                                    for e in sel])
    m.finalize()
    return len(sel)


def _rows_delta(m, rows, rng) -> int:
    return _new_values(m, np.nonzero(np.isin(m.entry_coords()[0], rows))[0], rng)


def _blocks_delta(m, frac, rng) -> int:
    return _new_values(m, np.sort(rng.choice(m.nblks, max(1, int(frac * m.nblks)),
                                             replace=False)), rng)


def _inc_counts() -> dict:
    return {lab["result"]: v for lab, v in metrics.counter_items("dbcsr_tpu_incremental_total")}


def _incremental_leg(name: str, a, b, kernel: str) -> dict:
    """The incremental multiply on one product C = A B (beta 0): full
    products until the cache installs, a zero delta, a delta of one
    block row of A and deltas of 0.1%, 1% and 5% of A's blocks.  A delta
    is spliced, or recomputed in full when a splice at least as large
    lost to the full run (``fallback_costly``) or it dirties more than
    `mm.incremental`'s share of the product (``fallback_all_dirty``);
    either way C is bit for bit an ``incremental="full"`` run; each case
    timed against "full" in turns (auto, full, full, auto; a fresh delta
    before every run of a delta case), with the host's phases of each."""
    empty = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype)
    c = empty.copy()
    rng = np.random.default_rng(20261022)
    set_config(incremental="auto")
    port_inc.reset()
    _reset_counts()
    # the first product's key has C's empty pattern, the second's the
    # product's: its repeat, the third, installs
    for _ in range(3):
        mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    counts = _counts()
    _require((_k1(counts) if kernel == "smm_stack" else counts[kernel]) > 0
             and counts["plain"] == 0, f"incremental {name}: {counts}")
    launches = counts[kernel]
    _require(port_inc.cache_snapshot()["entries"] == 1, f"incremental {name}: nothing cached")
    row0 = int(a.keys[0] // a.nblkcols)
    cases = {"zero": lambda: 0, "row": lambda: _rows_delta(a, [row0], rng),
             "blocks_0.1pct": lambda: _blocks_delta(a, 0.001, rng),
             "blocks_1pct": lambda: _blocks_delta(a, 0.01, rng),
             "blocks_5pct": lambda: _blocks_delta(a, 0.05, rng)}
    out = {"c_bytes": port_inc.cache_snapshot()["bytes"],
           "max_recompute_fraction": port_inc._MAX_RECOMPUTE_FRACTION, "cases": {}}
    for case, delta in cases.items():
        walls = {"auto": [], "full": []}
        phases = {"auto": [], "full": []}
        info, outcomes = {}, []
        for mode in ("auto", "full", "full", "auto"):
            dirty = delta()
            set_config(incremental=mode)
            metrics.reset()
            _reset_counts()
            before = port_inc.stats_snapshot()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mm.multiply("N", "N", 1.0, a, b, 0.0, c)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            phases[mode].append(dict(c._mm_phase_s))
            if mode == "auto":
                got = _inc_counts()
                wants = (("hit_unchanged",) if case == "zero"
                         else ("hit_splice", "fallback_costly", "fallback_all_dirty"))
                _require(sum(got.values()) == 1 and any(got.get(w) == 1 for w in wants),
                         f"incremental {name} {case}: outcomes {got}")
                outcomes.append(got)
                info = {"dirty_blocks": dirty, "outcomes": outcomes, "launches": _counts(),
                        "phase_s": dict(c._mm_phase_s), "reuse": port_inc.reuse_delta(before)}
                # the "full" rerun into a C of the same pattern: it keys and
                # refreshes the same cache entry (a C of another pattern
                # would install a second 396 MB entry and evict this one)
                set_config(incremental="full")
                ref = c.copy()
                mm.multiply("N", "N", 1.0, a, b, 0.0, ref)
                torch.cuda.synchronize()
                _require(_same_bits(c, ref),
                         f"incremental {name} {case}: the reuse is not bit for bit the full C")
                del ref
        info["s_per_multiply"] = walls
        info["host_phase_s"] = phases
        info["median_ratio_auto_to_full"] = float(np.median(walls["auto"])
                                                  / np.median(walls["full"]))
        out["cases"][case] = info
    set_config(incremental="off")
    out["totals"] = port_inc.stats_snapshot()
    out["launches"] = launches
    return out


def _models_under_default() -> dict:
    """The three DFT loops at 2208^2 through the planner under the
    default ``incremental="auto"`` against "off", in turns (off, auto,
    auto, off; the result cache emptied before each run): every run bit
    for bit the first, the reuse outcomes of the "auto" runs counted,
    seconds each."""
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED)
    _, loops = _model_loops(p0, SIGN_STEPS, SIGN_EPS)
    out = {}
    for name, loop in loops.items():
        walls = {"off": [], "auto": []}
        row = {"outcomes": {}, "reuse": {}}
        ref = None
        for mode in ("off", "auto", "auto", "off"):
            set_config(incremental=mode)
            port_inc.reset()
            metrics.reset()
            (x, hist, *_), info = _drive("auto", loop)
            walls[mode].append(info["wall_s"])
            if ref is None:
                ref = (x, hist)
            else:
                _require(hist == ref[1] and _same_bits(x, ref[0]),
                         f"models {name} under incremental={mode}: not bit for bit the off run")
            if mode == "auto":
                row["outcomes"] = _inc_counts()
                row["reuse"] = port_inc.stats_snapshot()
        set_config(incremental="off")
        row["wall_s"] = walls
        row["median_ratio_auto_to_off"] = float(np.median(walls["auto"])
                                                / np.median(walls["off"]))
        out[name] = row
        del ref, x
    return out


def phase_incremental() -> dict:
    """The delta-aware incremental multiply on the card: the f32 north star
    on K3 and a 2208^2 f64 product on K1 (`_incremental_leg`); at 2208^2
    also the full-product probe under ``abft="verify"`` and an
    ``incremental:flip`` fault, caught, counted and recomputed in full;
    and the f64 north star, whose C (792 MB) is over the 512 MB cache
    budget and is never cached; then the models' loops under the default
    ``incremental="auto"`` against "off" (`_models_under_default`).
    Returns K1's and K3's launches."""
    out = {"phase": "incremental", "cache_max_bytes": port_inc.cache_snapshot()["max_bytes"]}
    try:
        cfg = _northstar_cfg(1, data_type=1)
        res = run_perf(cfg, verbose=False)
        a, b, _ = _operands(res, cfg)
        del res
        out["northstar_f32"] = _incremental_leg("northstar_f32", a, b, "smm_crosspack")
        k3 = out["northstar_f32"]["launches"]
        del a, b
        a, b = _resilience_operands(torch.float64, seed=20261023)[:2]
        out["h2o_f64"] = _incremental_leg("h2o_f64", a, b, "smm_stack")
        k1 = out["h2o_f64"]["launches"]
        # the full-product probe, clean and under a flip
        set_config(incremental="auto", abft="verify")
        c = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype)
        rng = np.random.default_rng(20261024)
        for _ in range(3):
            mm.multiply("N", "N", 1.0, a, b, 0.0, c)
        # the probe cases need their splices to run: forget the leg's
        # verdicts on what a splice of this product costs
        port_inc._lost_at.clear()
        _rows_delta(a, [1], rng)
        metrics.reset()
        mm.multiply("N", "N", 1.0, a, b, 0.0, c)
        clean = {"outcomes": _inc_counts(),
                 "checks": _ctr("dbcsr_tpu_abft_checks_total", driver="incremental")}
        _require(clean["outcomes"].get("hit_splice") == 1 and clean["checks"] == 1
                 and not _ctr("dbcsr_tpu_abft_mismatches_total"),
                 f"incremental probe: {clean}")
        port_inc._lost_at.clear()
        _rows_delta(a, [2], rng)
        metrics.reset()
        with faults.inject_faults("incremental:flip,times=1") as sp:
            mm.multiply("N", "N", 1.0, a, b, 0.0, c)
        set_config(incremental="full")
        ref = BlockSparseMatrix("R", a.row_blk_sizes, b.col_blk_sizes, a.dtype)
        mm.multiply("N", "N", 1.0, a, b, 0.0, ref)
        torch.cuda.synchronize()
        flip = {"fired": sp[0].fired, "outcomes": _inc_counts(),
                "mismatches": _ctr("dbcsr_tpu_abft_mismatches_total", driver="incremental"),
                "recoveries": _ctr("dbcsr_tpu_abft_recoveries_total", driver="incremental")}
        _require(sp[0].fired == 1 and flip["outcomes"].get("fallback_abft") == 1
                 and flip["mismatches"] == 1 and flip["recoveries"] == 1
                 and _same_bits(c, ref), f"incremental flip: {flip}")
        _require(not _ctr("dbcsr_tpu_driver_failures_total")
                 and not _ctr("dbcsr_tpu_driver_fallback_total"),
                 "incremental flip: a stack driver failed")
        out["h2o_f64"]["probe"] = {"clean": clean, "flip": flip}
        del a, b, c, ref
        # the f64 north star: never cached
        set_config(incremental="auto", abft="off")
        port_inc.reset()
        cfg = _northstar_cfg(1)
        res = run_perf(cfg, verbose=False)
        a, b, c_out = _operands(res, cfg)
        c_bytes = sum(x.data.numel() * x.data.element_size() for x in c_out.bins)
        del res, c_out
        metrics.reset()
        for _ in range(3):
            c = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype)
            mm.multiply("N", "N", 1.0, a, b, 0.0, c)
            del c
        snap = port_inc.cache_snapshot()
        _require(snap["entries"] == 0 and c_bytes > snap["max_bytes"]
                 and port_inc.stats_snapshot()["products"] == 0,
                 f"f64 north star: {snap}, C {c_bytes} B")
        out["northstar_f64"] = {"c_bytes": c_bytes, "cache": snap, "outcomes": _inc_counts(),
                                "note": "C exceeds the cache budget: never cached, "
                                        "every repeat recomputes"}
        del a, b
        out["models_default"] = _models_under_default()
    finally:
        faults.clear()
        breaker.reset_board()
        mm.clear_plan_cache()
        port_inc.reset()
        set_config(incremental="off", abft="off")
    _emit(out)
    return {"smm_stack": k1, "smm_crosspack": k3}


# ------------------------------------------------- the acc layer and the API
ACC_BENCH_NREP = 5
ACC_BENCH_DTYPES = (3, 1, 9)  # f64, f32, bf16
TUNE_SHAPES = ((23, 23, 23, 3), (23, 23, 23, 1), (5, 13, 23, 3))
TUNED_PAIRS = 3
TUNED_NREP = 3


def _add_counts(total: dict, counts: dict) -> dict:
    for key, n in counts.items():
        total[key] = total.get(key, 0) + n
    return total


def phase_acc_bench() -> dict:
    """`bench_smm` at 23^3 in f64, f32 and bf16 at 30000 entries and at
    the north star's span size, and `bench_trans` at 23^2 f64: times,
    rates, both byte conventions and the share of the least time, from
    the table in force (the committed one)."""
    _reset_counts()
    rows = []
    for dt in ACC_BENCH_DTYPES:
        for size in (30000, NORTHSTAR_SPAN):
            r = bench_smm(nrep=ACC_BENCH_NREP, stack_size=size, m=23, n=23, k=23,
                          dtype_enum=dt, out=lambda *_: None)
            _require(r["errors"] == 0, f"acc_bench {r['dtype']} {size}: max rel err "
                                       f"{r['max_rel_err']:.3e}")
            bound_s, by = stack_bound_s(r["dtype"], 23, 23, 23, r["entries"], r["n_a"],
                                        r["n_b"], r["nruns"])
            rows.append({k: r[k] for k in ("kernel", "dtype", "stack_size", "device_kind", "ms",
                                           "gflops", "gbs", "bytes", "min_bytes", "min_gbs",
                                           "max_rel_err", "errors", "timed", "driver",
                                           "variant", "launched", "pack", "nruns")}
                        | {"bound_ms": bound_s * 1e3, "bound_by": by,
                           "share_of_bound": bound_s * 1e3 / r["ms"]})
    tr = bench_trans(nrep=ACC_BENCH_NREP, stack_size=30000, m=23, n=23, dtype_enum=3,
                     out=lambda *_: None)
    _require(tr["errors"] == 0, "acc_bench: the block transpose disagrees")
    tr["bound_ms"] = tr["bytes"] / H100_BYTES_PER_S * 1e3
    tr["share_of_bound"] = tr["bound_ms"] / tr["ms"]
    counts = _counts()
    _require(counts["plain"] == 0, f"acc_bench: the plain versions ran: {counts}")
    _emit({"phase": "acc_bench", "nrep": ACC_BENCH_NREP, "smm": rows, "trans": tr,
           "launches": counts})
    return counts


def phase_tune() -> dict:
    """`tune_smm` on `TUNE_SHAPES` into a temporary table: every
    candidate a hand-written kernel, each checked against its plain
    version, none failing."""
    prev = os.environ.get("DBCSR_TPU_TORCH_PARAMS_DIR")
    shapes = []
    _reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        _use_table(tmp)
        try:
            for m, n, k, dt in TUNE_SHAPES:
                cands, lines = [], []
                t0 = time.perf_counter()
                entry = tune_smm(m, n, k, dt, 30000, 3, out=lines.append,
                                 candidates_out=cands)
                _require(entry["errors"] == 0,
                         f"tune {m}x{n}x{k} {entry['dtype']}: {entry['failures']}")
                _require(cands and all(c["driver"] == "pallas" for c in cands),
                         f"tune {m}x{n}x{k}: a candidate on the card is no kernel: {cands}")
                shapes.append({"shape": [m, n, k], "dtype": entry["dtype"],
                               "stack_size": 30000, "seconds": time.perf_counter() - t0,
                               "winner": {key: entry.get(key) for key in
                                          ("kernel", "driver", "variant", "grouping",
                                           "pack_p", "precision", "gflops", "env")},
                               "candidates": [{key: c.get(key) for key in
                                               ("candidate", "kernel", "gflops", "max_rel_err",
                                                "tol")} for c in cands],
                               "refused": entry["refused"]})
            with open(params.params_path()) as f:
                written = json.load(f)
            _require(len(written) == len(TUNE_SHAPES),
                     f"tune: {len(written)} rows written for {len(TUNE_SHAPES)} shapes")
        finally:
            if prev is None:
                os.environ.pop("DBCSR_TPU_TORCH_PARAMS_DIR", None)
            else:
                os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = prev
            params.invalidate()
    counts = _counts()
    _emit({"phase": "tune", "table": "temporary", "shapes": shapes, "launches": counts})
    return counts


def _converted(m, dtype):
    """``m`` with its values rounded to ``dtype`` (the perf driver draws
    float64 values and rounds them to the input's dtype, so this is the
    operand `run_perf` draws at that dtype)."""
    out = BlockSparseMatrix(m.name, m.row_blk_sizes, m.col_blk_sizes, dtype, m.dist,
                            m.matrix_type, device=m.device)
    out.set_structure_from_device(m.keys.copy(), [_Bin(b.shape, b.data.to(dtype), b.count)
                                                  for b in m.bins],
                                  binning=(m.ent_bin.copy(), m.ent_slot.copy(),
                                           [b.shape for b in m.bins]))
    return out


def _span_rows(spans, dtype) -> list:
    """Each span with the kernel of the table's exact row for it (None:
    no row, so a donor or the untuned rules steer it) and that row's
    stack size."""
    out = []
    for m, n, k, entries, kernel, _ in spans:
        row = params.lookup(m, n, k, dtype, entries)
        out.append({"shape": [m, n, k], "entries": entries, "kernel": kernel,
                    "row_kernel": row.get("kernel") if row else None,
                    "row_stack_size": row.get("stack_size") if row else None})
    return out


def _tuned_run(name: str, a, b, dtype_name: str) -> dict:
    """``TUNED_NREP`` products C = A B (beta 0) under the table in force:
    s per multiply (median of the repeats after the first, which
    validates new kernel shapes and misses the plan cache), launches per
    kernel, dispatches by mode, the spans and C's checksum."""
    disp0 = _dispatches()
    _reset_counts()
    times = []
    for _ in range(TUNED_NREP):
        c = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype, device=a.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mm.multiply("N", "N", 1.0, a, b, 0.0, c)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = _counts()
    disp = {k: v - disp0[k] for k, v in _dispatches().items()}
    _require(counts["plain"] == 0, f"tuned {name}: the plain versions ran: {counts}")
    return {"s_per_multiply": float(np.median(times[1:])), "times_s": times,
            "host_phase_s": dict(c._mm_phase_s), "launches": counts, "dispatches": disp,
            "spans": _span_rows(c._mm_spans, dtype_name), "checksum": checksum(c),
            "plan_cache": c._mm_plan_cache}


def phase_tuned(ns_a, ns_b) -> dict:
    """The workloads from the committed table and from none, in turns
    (`TUNED_PAIRS` pairs, alternating which runs first): the north star
    at f64 and f32, `mixed_blocks` at f64, `test_H2O` at f32 and the
    sign loop at 2208^2.  Each run against the
    untuned one (checksums 1e-9, 1e-6 at f32; the sign loop's iterate
    10 * filter_eps); every span of the table's runs has an exact row;
    every kernel the table names launches in this phase (a row's own
    bench where no workload reaches it)."""
    committed = os.path.join(TABLE_DIR, os.path.basename(params.params_path()))
    _require(os.path.exists(committed), f"tuned: no committed table {committed}")
    with open(committed) as f:
        table_rows = json.load(f)
    none_dir = os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"]
    # the operands: the north star's at f64 and f32, mixed_blocks' and
    # test_H2O's as `run_perf` draws them (the checksum gate runs there)
    mixed = run_perf(_mixed_cfg(3, 1), verbose=False)
    h2o_cfg = parse_perf_file(os.path.join(INPUTS, "test_H2O.perf"))
    h2o_cfg.data_type, h2o_cfg.nrep, h2o_cfg.check = 1, 1, False
    h2o = run_perf(h2o_cfg, verbose=False)
    products = {"northstar_f64": (ns_a, ns_b, "float64", 1e-9),
                "northstar_f32": (_converted(ns_a, torch.float32),
                                  _converted(ns_b, torch.float32), "float32", 1e-6),
                "mixed_blocks_f64": (*_operands(mixed, _mixed_cfg(3, 1))[:2], "float64", 1e-9),
                "test_H2O_f32": (*_operands(h2o, h2o_cfg)[:2], "float32", 1e-6)}
    del mixed, h2o
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED)
    _, loops = _model_loops(p0, SIGN_STEPS, SIGN_EPS)
    runs = {name: {"table": [], "none": []} for name in [*products, "sign"]}
    table_launches: dict = {}
    try:
        for pair in range(TUNED_PAIRS):
            for which in (("table", "none") if pair % 2 == 0 else ("none", "table")):
                _use_table(TABLE_DIR if which == "table" else none_dir)
                for name, (a, b, dtn, _) in products.items():
                    run = _tuned_run(name, a, b, dtn)
                    runs[name][which].append(run)
                    if which == "table":
                        _add_counts(table_launches, run["launches"])
                disp0 = _dispatches()
                (x, hist), info = _drive("auto", loops["sign"])
                runs["sign"][which].append({
                    "s_per_loop": info["wall_s"], "host_phase_s": info["host_phase_s"],
                    "launches": info["launches"],
                    "dispatches": {k: v - disp0[k] for k, v in _dispatches().items()},
                    "history": hist, "x": x})
                if which == "table":
                    _add_counts(table_launches, info["launches"])
    finally:
        _use_table(none_dir)
    out = {}
    for name, (_, _, dtn, tol) in products.items():
        ref = runs[name]["none"][0]["checksum"]
        for which in ("table", "none"):
            for run in runs[name][which]:
                run["checksum_rel"] = abs(run["checksum"] - ref) / max(abs(ref), 1.0)
                _require(run["checksum_rel"] <= tol,
                         f"tuned {name} ({which}): checksum {run['checksum']!r} against "
                         f"{ref!r} (rel {run['checksum_rel']:.3e} > {tol:.0e})")
        for run in runs[name]["table"]:
            missing = [sp for sp in run["spans"] if sp["row_kernel"] is None]
            _require(not missing, f"tuned {name}: spans without a row: {missing}")
        for which in ("table", "none"):  # the spans of the first run of each
            for run in runs[name][which][1:]:
                del run["spans"]
        out[name] = {"tol": tol, **{which: runs[name][which] for which in ("table", "none")},
                     "median_s": {which: float(np.median([r["s_per_multiply"]
                                                          for r in runs[name][which]]))
                                  for which in ("table", "none")}}
    x_ref = runs["sign"]["none"][0]["x"]
    for which in ("table", "none"):
        for run in runs["sign"][which]:
            run["iterate_rel"] = _iterate_diff(run.pop("x"), x_ref)
            _require(run["iterate_rel"] <= 10 * SIGN_EPS,
                     f"tuned sign ({which}): iterate {run['iterate_rel']:.3e} from the "
                     f"untuned loop's")
    out["sign"] = {**runs["sign"], "median_s": {
        which: float(np.median([r["s_per_loop"] for r in runs["sign"][which]]))
        for which in ("table", "none")}}
    # every kernel the table names launches: from the workloads, or from a
    # bench at one of its rows (K4: at a row that selects it, whose
    # synthetic operands the persisting-L2 window admits)
    named = sorted({r["kernel"] for r in table_rows})
    benched = {}
    _use_table(TABLE_DIR)
    try:
        for kernel in named:
            workload_launches = (_k1(table_launches) if kernel == "smm_stack"
                                 else table_launches.get(kernel, 0))
            if workload_launches and kernel != "smm_crosspack_resident":
                continue
            row = next(r for r in table_rows if r["kernel"] == kernel)
            _reset_counts()
            r = bench_smm(nrep=1, stack_size=row["stack_size"], m=row["m"], n=row["n"],
                          k=row["k"], dtype_enum=dtype_of(row["dtype"]), out=lambda *_: None)
            counts = _counts()
            _require(r["errors"] == 0 and r["launched"] == kernel and counts[kernel] > 0,
                     f"tuned: the row {row} did not launch {kernel}: {r['launched']}, "
                     f"{counts}")
            _add_counts(table_launches, counts)
            benched[kernel] = {"row": {k: row[k] for k in ("m", "n", "k", "dtype",
                                                           "stack_size")},
                               "ms": r["ms"], "launches": counts[kernel]}
    finally:
        _use_table(none_dir)
    winners: dict = {}
    for r in table_rows:
        winners[r["kernel"]] = winners.get(r["kernel"], 0) + 1
    _emit({"phase": "tuned", "table": "committed and none, in turns", "pairs": TUNED_PAIRS,
           "nrep": TUNED_NREP, "table_rows": len(table_rows), "winners": winners,
           "northstar_span": NORTHSTAR_SPAN, "benched_rows": benched,
           "table_launches": table_launches, **out})
    ns_span = [sp["entries"] for sp in out["northstar_f64"]["table"][0]["spans"]
               if sp["shape"] == [23, 23, 23]]
    _require(ns_span == [NORTHSTAR_SPAN],
             f"tuned: the north star's 23^3 span has {ns_span} entries, the table's "
             f"row {NORTHSTAR_SPAN}")
    return table_launches


def _same_matrix(x, y) -> bool:
    """Index and bins bit for bit alike."""
    return (np.array_equal(x.keys, y.keys) and np.array_equal(x.ent_bin, y.ent_bin)
            and np.array_equal(x.ent_slot, y.ent_slot) and len(x.bins) == len(y.bins)
            and all(bx.shape == by.shape and torch.equal(bx.data, by.data)
                    for bx, by in zip(x.bins, y.bins)))


def _on_cpu(m):
    return matrix_from_numpy_state(matrix_to_numpy_state(m), "cpu", name=m.name)


def _bins_rel(x, y) -> float:
    """max |x - y| over max |y|, bin by bin (same index)."""
    _require(np.array_equal(x.keys, y.keys), "the patterns differ")
    diff = max((float((bx.data.cpu().double() - by.data.cpu().double()).abs().max())
                for bx, by in zip(x.bins, y.bins)), default=0.0)
    scale = max((float(by.data.abs().max()) for by in y.bins), default=0.0)
    return diff / max(scale, 1.0)


def phase_api(a, b) -> dict:
    """The public surface on the card (with no table, so f64 takes K1
    and f32 K3): `run_tests` with ``TEST_MM`` at f64 and f32 and with
    ``TEST_BINARY_IO``; the north star's A through `binary_write` and
    `binary_read` bit for bit, and through `csr_from_matrix` and
    `matrix_from_csr` (native COO fill) bit for bit; `hadamard_product`
    of A and B and `function_of_elements` (tanh) of A against their
    values on the CPU."""
    _reset_counts()
    lines = []
    t0 = time.perf_counter()
    cs = {dt: run_tests((240, 180, 260), sparsities=(0.4, 0.4, 0.4), alpha=1.5, beta=0.5,
                        data_type=dt, test_type=TEST_MM, n_loops=2, io=lines.append)
          for dt in (3, 1)}
    counts = _counts()
    _require(_k1(counts) > 0 and counts["smm_crosspack"] > 0 and counts["plain"] == 0,
             f"api: run_tests(TEST_MM) did not run K1 and K3: {counts}")
    io_cs = run_tests((300, 300, 300), test_type=TEST_BINARY_IO, n_loops=2, io=lines.append)
    out = {"phase": "api", "run_tests_s": time.perf_counter() - t0,
           "test_mm_checksums": {name_of(dtype_of(dt)): v for dt, v in cs.items()},
           "binary_io_checksums": io_cs, "report": lines, "launches": counts}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.dbcsr")
        t0 = time.perf_counter()
        binary_write(a, path)
        out["binary_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = binary_read(path, device=a.device)
        out["binary_read_s"] = time.perf_counter() - t0
        out["file_bytes"] = os.path.getsize(path)
    _require(back.device == a.device and _same_matrix(back, a),
             "api: binary_read did not give A back bit for bit")
    del back
    mm.reset_totals()
    t0 = time.perf_counter()
    indptr, indices, data = csr_from_matrix(a)
    out["csr_from_matrix_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = matrix_from_csr("A", indptr, indices, data, a.row_blk_sizes, a.col_blk_sizes,
                           device=a.device)
    out["matrix_from_csr_s"] = time.perf_counter() - t0
    out["csr_nze"] = int(len(data))
    fills = mm.read_totals()["index_engine"]["coo_fill"]
    _require(fills == {"native": 1, "numpy": 0}, f"api: the COO fill ran {fills}")
    _require(_same_matrix(back, a), "api: the CSR round trip changed A")
    del back, indptr, indices, data
    a_cpu, b_cpu = _on_cpu(a), _on_cpu(b)
    had = _bins_rel(_on_cpu(hadamard_product(a, b)), hadamard_product(a_cpu, b_cpu))
    x = a.copy()
    function_of_elements(x, FUNC_TANH, a0=0.1, a1=0.5)
    x_cpu = a_cpu.copy()
    function_of_elements(x_cpu, FUNC_TANH, a0=0.1, a1=0.5)
    tanh = _bins_rel(_on_cpu(x), x_cpu)
    _require(had == 0.0, f"api: hadamard_product on the card differs from the CPU by {had}")
    _require(tanh <= 1e-14, f"api: tanh on the card differs from the CPU by {tanh:.3e}")
    out.update(hadamard_rel=had, function_of_elements_rel=tanh)
    _emit(out)
    return counts


# ------------------------------------------------------------ the grid
# the grids of the mesh phase, each a single process with every image on
# the card; the north star on each, from no table and from the committed
# table in turns
MESH_GRIDS = ((1, 2, 2), (2, 2, 2), (1, 2, 4))
MESH_NREP = 3
WORLD_RANKS = 4
WORLD_TIMEOUT_S = 420
# `dbcsr_tpu_watchdog_outcomes_total{name="mp_world_join"}` of mesh_world
_WORLD_WATCHDOG: dict = {}


def _card_grid(shape) -> Grid:
    """A one-process grid of ``shape`` with every image on the card."""
    kl, pr, pc = shape
    return Grid(shape, [(0, resolve_device())] * (kl * pr * pc))


PROFILE_ATTEMPTS = 3


def _profiled_kernels(fn) -> dict:
    """One call of ``fn`` under `torch.profiler`: the device ms of the
    stack kernels (every kernel named smm_*), by name and in all, and
    the card's busy and idle shares of the traced window.  The call must
    launch a stack kernel (the wrappers' counts); a trace that holds
    none of those launches lost them, and the call is profiled again, up
    to ``PROFILE_ATTEMPTS`` times in all (``profile_attempts``).  These
    launches are no part of the leg's counts."""
    misses = []
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        _reset_counts()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
                # the window closes well after the last kernel has ended
                time.sleep(0.05)
            launched = _counts()
            _reset_counts()
            _require(sum(v for k, v in launched.items() if k != "plain") > 0,
                     f"mesh: the profiled call launched no stack kernel: {launched}")
            prof.export_chrome_trace(path)
            with open(path) as f:
                evs = json.load(f)["traceEvents"]
            by_name, others = {}, {}
            for e in evs:
                if e.get("cat") != "kernel" or e.get("ph") != "X":
                    continue
                name = re.search(r"smm_\w+", e.get("name", ""))
                into, key = (by_name, name.group(0)) if name else (others, e.get("name", "")[:60])
                into[key] = into.get(key, 0.0) + float(e["dur"]) / 1e3
            if by_name:
                return {"stack_device_ms": sum(by_name.values()), "stack_ms_by_kernel": by_name,
                        "profile_attempts": attempt, **_busy_share(path)}
        top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
        misses.append({"launched": launched, "trace_events": len(evs), "top_kernels_ms": top})
    raise RuntimeError(f"mesh: the profiler saw no stack kernel in {PROFILE_ATTEMPTS} "
                       f"profiled calls that launched them: {misses}")


def _mesh_bound_ms(mesh_info: dict, dtype: str, block: int) -> tuple:
    """The least time of one multiply's tick stacks (`stack_bound_s` of
    each stack, summed) and what bounds most of it."""
    total, by = 0.0, {"bytes": 0.0, "operations": 0.0}
    for entries, n_a, n_b, nruns in mesh_info["stack_sizes"].values():
        t, what = stack_bound_s(dtype, block, block, block, entries, n_a, n_b, nruns)
        total += t
        by[what] += t
    return total * 1e3, max(by, key=by.get)


def _mesh_leg(shape, table_dir: str, data_type: int, single: dict) -> dict:
    """The north star on a one-process grid: ``MESH_NREP`` repeats in the
    mode "auto" picks (double_buffer), one in serial order (the same
    bits), one under the profiler; checksums against the `.perf` gate
    (`run_perf` raises) and the single-device multiply."""
    _use_table(table_dir)
    sparse_dist.clear_mesh_plans()
    grid = _card_grid(shape)
    dtype = "float64" if data_type == 3 else "float32"
    _reset_counts()
    res = run_perf(_northstar_cfg(MESH_NREP, data_type), verbose=False, grid=grid)
    counts = _counts()
    info = res["mesh"]
    _require(counts["plain"] == 0, f"mesh {grid.label()}: the plain versions ran")
    kernels = sorted(set(info["kernels"].values()))
    _require(all(counts[k] > 0 for k in kernels),
             f"mesh {grid.label()}: a planned kernel never launched: {counts}")
    # one launch per tick stack and repeat, plus each kernel's first-use
    # validation where this leg is the first to launch it at 23^3
    validations = sum(counts[k] for k in kernels) - MESH_NREP * len(info["stacks"])
    _require(0 <= validations <= len(kernels),
             f"mesh {grid.label()}: {counts} for {len(info['stacks'])} stacks a multiply")
    _require(res["plan_cache"][1:] == ["hit"] * (MESH_NREP - 1),
             f"mesh {grid.label()}: repeats did not hit the plan cache: {res['plan_cache']}")
    _require(info["mode"] == "double_buffer" or grid.pr == 1,
             f"mesh {grid.label()}: ran {info['mode']}")
    set_config(cannon_overlap="serial")
    try:
        ser = run_perf(_northstar_cfg(1, data_type), verbose=False, grid=grid)
    finally:
        set_config(cannon_overlap="auto")
    same = _same_bits(res["matrices"]["c_out"], ser["matrices"]["c_out"])
    _require(same, f"mesh {grid.label()}: serial and double_buffer differ")
    rel = {k: abs(res[k] - single[k]) / abs(single[k]) for k in ("checksum", "checksum_pos")}
    tol = 1e-9 if data_type == 3 else 1e-6
    _require(max(rel.values()) <= tol, f"mesh {grid.label()}: checksums {rel} > {tol}")
    prof = _profiled_kernels(lambda: run_perf(_northstar_cfg(1, data_type), verbose=False,
                                              grid=grid))
    bound_ms, bound_by = _mesh_bound_ms(info, dtype, 23)
    nstacks = len(info["stacks"])
    out = {"grid": grid.label(), "table": _table_label(), "dtype": dtype,
           "engine": info["engine"], "mode": info["mode"], "nticks": info["nticks"],
           "times_s": res["times_s"], "first_s": res["times_s"][0],
           "later_s": res["times_s"][1:], "host_phase_s": res["host_phase_s"],
           "serial_times_s": ser["times_s"], "serial_bit_identical": same,
           "stacks_per_multiply": nstacks, "launches": counts, "validations": validations,
           "launches_per_stack": {k: (counts[k] - (validations if len(kernels) == 1 else 0))
                                  / (MESH_NREP * nstacks) for k in kernels},
           "stack_entries": sum(info["stacks"].values()),
           "padded_flops": info["padded_flops"], "true_flops": info["true_flops"],
           "caps": info["caps"], "checksum": res["checksum"],
           "checksum_pos": res["checksum_pos"], "rel_vs_single_device": rel,
           "stack_bound_ms": bound_ms, "bound_by": bound_by, **prof,
           "digest": digests.matrix_value_digest(res["matrices"]["c_out"]).hex()}
    return out


def _mesh_gates() -> tuple:
    """The `.perf` gates (`PERF_GATES`, one repeat each, no table) on a
    2x2x2 and a 1x2x3 grid on the card: `run_perf` raises on a
    checksum outside the input's threshold; a stack product must launch
    a kernel and no plain version (a full operand pair takes the dense
    Cannon, `torch.matmul`).  Returns the rows and the launches."""
    rows, total = [], dict.fromkeys(_counts(), 0)
    for shape in ((2, 2, 2), (1, 2, 3)):
        grid = _card_grid(shape)
        for name, _ in PERF_GATES:
            cfg = parse_perf_file(os.path.join(INPUTS, f"{name}.perf"))
            cfg.nrep = 1
            _reset_counts()
            res = run_perf(cfg, verbose=False, grid=grid)  # raises on a mismatch (no retry)
            counts = _counts()
            launched = _k1(counts) + counts["smm_crosspack"] + counts["smm_crosspack_resident"]
            _require(counts["plain"] == 0 and (launched > 0 or res["algorithm"] == "dense"),
                     f"mesh gates {grid.label()} {name}: launches {counts}")
            total = {k: total[k] + counts[k] for k in total}
            rows.append({"grid": grid.label(), "input": name, "checksum": res["checksum"],
                         "refs": list(cfg.check_refs), "threshold": cfg.check_threshold,
                         "algorithm": res["algorithm"],
                         "engine": (res["mesh"] or {}).get("engine"),
                         "launches": {k: v for k, v in counts.items() if v},
                         "times_s": res["times_s"]})
    sparse_dist.clear_mesh_plans()
    return rows, total


def phase_mesh(none_dir: str, single_f64: dict) -> dict:
    """The north star, f64 at full width, on one-process grids of 1x2x2,
    2x2x2 (2.5D: two layers) and 1x2x4 (the all-gather engine) with every
    image on the card, from no table and from the committed table in
    turns; then f32 on 1x2x2 (K3) against a single-device f32 repeat.
    Returns K1's and K3's launches and the 1x2x2 legs (the world's
    reference bits)."""
    legs, k1, k3 = [], 0, 0
    order = ((none_dir, TABLE_DIR), (TABLE_DIR, none_dir), (none_dir, TABLE_DIR))
    ref = {}
    for shape, tables in zip(MESH_GRIDS, order):
        for table in tables:
            leg = _mesh_leg(shape, table, 3, single_f64)
            k1 += leg["launches"]["smm_stack"]
            k3 += leg["launches"]["smm_crosspack"]
            if shape == (1, 2, 2):
                ref[leg["table"]] = leg
            _emit({"phase": "mesh", **leg})
            legs.append(leg)
    _use_table(none_dir)
    gates, launched = _mesh_gates()
    _emit({"phase": "mesh_gates", "passed": len(gates), "inputs": gates})
    k1 += launched["smm_stack"]
    k3 += launched["smm_crosspack"]
    single32 = run_perf(_northstar_cfg(1, 1), verbose=False)
    leg = _mesh_leg((1, 2, 2), none_dir, 1, single32)
    _require(leg["launches"]["smm_crosspack"] > 0, "mesh f32: K3 never launched")
    k3 += leg["launches"]["smm_crosspack"]
    _emit({"phase": "mesh", **leg})
    sparse_dist.clear_mesh_plans()
    return {"smm_stack": k1, "smm_crosspack": k3, "ref_1x2x2": ref}


def _world_summary(agg: dict, wall: float) -> dict:
    ranks = agg["per_rank"]
    return {"ranks": len(ranks), "wall_s": wall, "grid": ranks[0]["grid"],
            "checksums": [r["checksum"] for r in ranks],
            "checksums_equal": len({r["checksum"] for r in ranks}) == 1,
            "digests_equal": len({r["digest"] for r in ranks}) == 1,
            "times_s": [r["times_s"] for r in ranks],
            "staged": [r["staged"] for r in ranks],
            "gflops_world": agg["gflops_world"], "gflops_mean_ranks": agg["gflops_mean_ranks"],
            "launches": {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}}


def phase_mesh_world(ref_1x2x2: dict) -> dict:
    """Four ranks on the one card over gloo, one image each (a 2x2 grid),
    panels host-staged between them: the north star (f64, 2 repeats),
    then `test_square_sparse_rma.perf`, both through
    `run_perf_multiproc`.  Every rank's C must be bit for bit the others'
    and the one-process 2x2 grid's under the same table."""
    out = {"phase": "mesh_world"}
    t0 = time.perf_counter()
    agg = run_perf_multiproc(_northstar_cfg(2), WORLD_RANKS, timeout=WORLD_TIMEOUT_S,
                             verbose=False)
    ns = _world_summary(agg, time.perf_counter() - t0)
    want = ref_1x2x2[_table_label()]
    _require(ns["digests_equal"] and ns["checksums_equal"], f"mesh_world: ranks differ {ns}")
    _require(agg["per_rank"][0]["digest"] == want["digest"],
             "mesh_world: the world's C is not bit for bit the one-process 2x2 grid's")
    _require(ns["launches"]["plain"] == 0 and ns["launches"]["smm_stack"] > 0,
             f"mesh_world: launches {ns['launches']}")
    out["northstar"] = {**ns, "bit_identical_to_one_process": True}
    path = os.path.join(INPUTS, "test_square_sparse_rma.perf")
    cfg = parse_perf_file(path)
    one = run_perf(cfg, verbose=False, grid=_card_grid((1, 2, 2)))
    t0 = time.perf_counter()
    agg = run_perf_multiproc(path, WORLD_RANKS, timeout=WORLD_TIMEOUT_S, verbose=False)
    rma = _world_summary(agg, time.perf_counter() - t0)
    _require(rma["digests_equal"] and agg["per_rank"][0]["digest"]
             == digests.matrix_value_digest(one["matrices"]["c_out"]).hex(),
             "mesh_world: rma ranks differ from the one-process grid")
    out["rma"] = {**rma, "one_process_checksum": one["checksum"],
                  "bit_identical_to_one_process": True}
    # both worlds joined through the `mp_world_join` watchdog
    _WORLD_WATCHDOG.update({lab["outcome"]: v for lab, v in metrics.counter_items(
        "dbcsr_tpu_watchdog_outcomes_total") if lab.get("name") == "mp_world_join"})
    _require(_WORLD_WATCHDOG.get("OK", 0) + _WORLD_WATCHDOG.get("SLOW", 0) == 2,
             f"mesh_world: watchdog outcomes {_WORLD_WATCHDOG}")
    out["watchdog_mp_world_join"] = dict(_WORLD_WATCHDOG)
    _emit(out)
    return {k: ns["launches"][k] + rma["launches"][k] for k in ns["launches"]}


def phase_mesh_models() -> dict:
    """The models' grid branches on 1x2x2: one sparse McWeeny step at
    2208^2 against the single-device step (1e-10), and the RI
    contraction's mesh branch at 32 molecules against the single-device
    contraction (1e-10)."""
    grid = _card_grid((1, 2, 2))
    out = {"phase": "mesh_models"}
    p = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, seed=MODEL_SEED)
    _reset_counts()
    t0 = time.perf_counter()
    got = mcweeny_step_sparse_distributed(p, grid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    want = mcweeny_step(p.copy())
    _require(np.array_equal(got.keys, want.keys), "mesh_models: purify patterns differ")
    gd, wd = _to_dense_device(got), _to_dense_device(want)
    rel = float((gd - wd).abs().max()) / float(wd.abs().max())
    _require(rel <= 1e-10 and counts["plain"] == 0 and _k1(counts) > 0,
             f"mesh_models: purify step rel {rel:.3e}, launches {counts}")
    out["purify_step"] = {"grid": grid.label(), "rel_vs_single_device": rel, "wall_s": wall,
                          "launches": counts}
    launched = dict(counts)
    n = TENSOR_LEGS["remap"]
    t, m, _, empty_c = _ri_operands(n)
    c_grid, c_one = empty_c("Cg"), empty_c("C1")
    _reset_counts()
    t0 = time.perf_counter()
    contract(1.0, t, m, 0.0, c_grid, **RI_KW, mesh=grid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    contract(1.0, t, m, 0.0, c_one, **RI_KW)
    cmp = _blocks_rel(c_grid, c_one)
    _require(cmp["rel_elementwise"] <= 1e-10 and counts["plain"] == 0 and _k1(counts) > 0,
             f"mesh_models: RI contraction rel {cmp['rel_elementwise']:.3e}, {counts}")
    out["ri_contraction"] = {"grid": grid.label(), "molecules": n, "wall_s": wall,
                             "launches": counts, **cmp}
    _emit(out)
    return {k: launched[k] + counts[k] for k in counts}


# ------------------------------------------------- telemetry and autotune
TELEMETRY_STEPS = 10      # north-star multiplies on each side of the step
TELEMETRY_PAIRS = 3       # on/off pairs of turns of the hooks' cost
WARM_MAX = 160            # mixed_blocks repeats at most, until the verdict is OK
TUNE_TRIAL_BUDGET_S = 20  # the trials' wall budget here (the default is 120 s)
COMMITTED_TABLE = os.path.join(TABLE_DIR, "parameters_NVIDIA_H100_80GB_HBM3.json")
_PLANE_ENV = {"DBCSR_TPU_TORCH_SYNC_TIMING": "1", "DBCSR_TPU_TORCH_TS_INTERVAL_S": "0",
              "DBCSR_TPU_TORCH_INCIDENT_INTERVAL_S": "0", "DBCSR_TPU_TORCH_CP_REF_N": "8",
              "DBCSR_TPU_TORCH_TUNE_BUDGET_S": str(TUNE_TRIAL_BUDGET_S)}


@contextlib.contextmanager
def _environ(values: dict):
    """Set environment variables for the block, restoring them after."""
    prev = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fresh_plane() -> None:
    """A fresh telemetry plane: metrics and statistics (with the
    attribution ledger, incident budget, profile, change-points and change
    ledger), the health windows and detector states with the SLOs, the
    store, the events ring, breakers and the tuner service."""
    metrics.reset()
    health.reset()
    obs_ts.reset()
    events.clear()
    breaker.reset_board()
    tune_service.stop_service()


def _anomalies() -> list:
    return [{k: e.get(k) for k in ("kind", "rate_per_multiply", "dur_ms", "driver",
                                   "threshold", "window")}
            for e in events.records(kind="anomaly")]


def _hooks_ms(a, b) -> dict:
    """The north star with the event bus (the health windows) and the
    store sampling at every product on against both off, in pairs of
    turns (on, off), (off, on), ..."""
    times: dict = {"on": [], "off": []}
    _northstar_multiply(a, b)  # the plan cache warm
    for i in range(TELEMETRY_PAIRS):
        for leg in (("on", "off") if i % 2 == 0 else ("off", "on")):
            events.set_enabled(leg == "on")
            obs_ts.set_enabled(leg == "on")
            try:
                times[leg].append(_northstar_multiply(a, b))
            finally:
                events.set_enabled(True)
                obs_ts.set_enabled(True)
    return {"times_s": times, "mean_on_s": float(np.mean(times["on"])),
            "mean_off_s": float(np.mean(times["off"])),
            "on_minus_off_ms": 1e3 * float(np.mean(times["on"]) - np.mean(times["off"]))}


def phase_telemetry() -> dict:
    """The telemetry, health and diagnosis plane on the card (module
    docstring, phase 30).  Returns the phase's launches."""
    out = {"phase": "telemetry", "env": dict(_PLANE_ENV)}
    res = run_perf(_northstar_cfg(1), verbose=False)
    a, b = res["matrices"]["a"], res["matrices"]["b"]
    del res
    launched: dict = {}

    def tally():
        for k, v in _counts().items():
            launched[k] = launched.get(k, 0) + v
        _reset_counts()

    with tempfile.TemporaryDirectory() as inc_dir, \
            _environ(dict(_PLANE_ENV, DBCSR_TPU_TORCH_INCIDENTS=inc_dir)):
        _fresh_plane()
        _reset_counts()
        # the step: forced dense, then the stack format
        set_config(mm_format="dense")
        dense_s = [_northstar_multiply(a, b) for _ in range(TELEMETRY_STEPS)]
        warm = health.verdict()
        warm_fired = _anomalies()
        _require(warm["status"] == "OK",
                 f"telemetry: verdict {warm['status']} before the step: "
                 f"{ {n: c['reasons'] for n, c in warm['components'].items() if c['reasons']} }")
        t_step = time.time()
        set_config(mm_format="stack")
        stack_s = [_northstar_multiply(a, b) for _ in range(TELEMETRY_STEPS)]
        set_config(mm_format="auto")
        counts = _counts()
        _require(_k1(counts) > 0 and counts["plain"] == 0,
                 f"telemetry: the stack side's launches {counts}")
        tally()
        cps = changepoint.changepoints(series="multiply_latency_ms")
        reg = [c for c in cps if c["regression"]]
        _require(reg and reg[0]["direction"] == "up",
                 f"telemetry: no regressing change-point on multiply_latency_ms: {cps}")
        cp = reg[0]
        reports = [r for r in rca.reports()
                   if (r["changepoint"] or {}).get("series") == "multiply_latency_ms"]
        _require(reports and reports[0]["top_cause"] == "knob_change"
                 and reports[0]["causes"][0].get("knob") == "mm_format",
                 f"telemetry: RCA's top cause {[r['causes'][:2] for r in reports]}")
        bundles = sorted(os.listdir(inc_dir))
        _require(any(f.startswith("incident-rca_multiply_latency_ms-") for f in bundles),
                 f"telemetry: no rca:multiply_latency_ms bundle among {bundles}")
        out["step"] = {
            "dense_s": dense_s, "stack_s": stack_s,
            "verdict_before_step": warm["status"], "anomalies_before_step": warm_fired,
            "changepoint": {k: cp[k] for k in ("series", "direction", "baseline", "level",
                                               "magnitude", "sigma", "n")},
            "shift_after_step_s": cp["t_shift"] - t_step,
            "detected_after_step_s": cp["t"] - t_step,
            "changepoints_all": [{k: c[k] for k in ("series", "labels", "direction",
                                                    "magnitude", "regression")} for c in cps],
            "rca_causes": [{k: c.get(k) for k in ("rank", "kind", "knob", "value", "prev",
                                                  "score")} for c in reports[0]["causes"]],
            "incident_bundles": bundles,
            "anomalies_after_step": _anomalies(),
            "slo": {n: {k: r[k] for k in ("status", "burn")}
                    for n, r in slo.evaluate().items()},
            "verdict_after_step": health.verdict()["status"],
        }
        out["cells"] = [{**ser["labels"], "flops": ser["value"]} for ser in
                        obs_ts.query("dbcsr_tpu_cell_flops_total", agg="last")]
        out["rates"] = {ser["metric"] + "|" + ser["labels"]["driver"]: ser["value"]
                        for m in ("dbcsr_tpu_achieved_gflops", "dbcsr_tpu_roofline_fraction")
                        for ser in obs_ts.query(m, agg="last")}
        out["watchdog_mp_world_join"] = dict(_WORLD_WATCHDOG)
        # one pallas fault on one shape (the models' density: every block
        # 23^3) until its breaker opens; K3 serves the shape meanwhile
        _fresh_plane()
        p = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, seed=MODEL_SEED)
        key = (MODEL_BLOCK, MODEL_BLOCK, MODEL_BLOCK, "float64")
        set_config(mm_format="stack")
        products = 0
        try:
            with faults.inject_faults("pallas:raise") as specs:
                while breaker.get_board().state("pallas", key) != breaker.OPEN \
                        and products < 8:
                    mm.clear_plan_cache()  # a cached plan heals onto K3
                    c = BlockSparseMatrix("C", p.row_blk_sizes, p.col_blk_sizes, p.dtype,
                                          device=p.device)
                    mm.multiply("N", "N", 1.0, p, p, 0.0, c)
                    products += 1
            torch.cuda.synchronize()
            fired = specs[0].fired
            comp = health.verdict()["components"]["drivers"]
            shape = "x".join(str(x) for x in key)
            _require(comp["status"] == "DEGRADED"
                     and comp["reasons"] == [f"breaker open: pallas|{shape} (runtime)"],
                     f"telemetry: drivers {comp}")
            out["breaker"] = {"products": products, "faults_fired": fired,
                              "drivers": comp, "chain": port_smm.breaker_chain(f"pallas|{shape}"),
                              "launches": _counts()}
        finally:
            faults.clear()
            set_config(mm_format="auto")
            _reset_counts()
            _fresh_plane()
            port_smm._cross_disabled.clear()
        after = health.verdict()
        _require(after["status"] == "OK", f"telemetry: verdict {after['status']} after reset")
        out["breaker"]["verdict_after_reset"] = after["status"]
        set_config(mm_format="stack")
        _reset_counts()
        out["hooks"] = _hooks_ms(a, b)
        set_config(mm_format="auto")
        tally()
        _fresh_plane()
    out["launches"] = dict(launched)
    _emit(out)
    _TELEMETRY_TIMES.update(dense_s=dense_s, stack_s=stack_s)
    return launched


_TELEMETRY_TIMES: dict = {}
_KERNEL_COUNT = {"smm_stack": _k1, "smm_crosspack": lambda c: c["smm_crosspack"],
                 "smm_crosspack_resident": lambda c: c["smm_crosspack_resident"]}


def _cycle_row(svc, label: str, cells, **kw) -> dict:
    """One `TuneService.cycle` with what it mined, trialed and promoted."""
    gen0 = params.generation()
    svc.last_trial = None
    t0 = time.perf_counter()
    got = svc.cycle(cells=cells, **kw)
    row = {"cycle": label, "outcome": got["outcome"], "seconds": time.perf_counter() - t0,
           "generation_before": gen0, "generation_after": params.generation(),
           "cell": got.get("cell"), "promoted": got.get("promoted"), "error": got.get("error"),
           "mined": [{k: c.get(k) for k in ("m", "n", "k", "dtype", "driver", "stack_size",
                                            "observed_gflops", "target_gflops",
                                            "wasted_flop_seconds", "reason")}
                     for c in (cells or [])[:5]]}
    trial = svc.last_trial
    if trial is not None:
        row["trial"] = {"outcome": trial.outcome, "stack_size": trial.stack_size,
                        "elapsed_s": trial.elapsed_s, "budget_hit": trial.budget_hit,
                        "candidates": [{k: c.get(k) for k in (
                            "candidate", "kernel", "variant", "pack_p", "precision",
                            "format", "seconds", "gflops", "max_rel_err", "tol")}
                            for c in trial.candidates]}
        if trial.candidates and "format" not in trial.candidates[0]:
            cell = got["cell"]
            win = tune_trials.select_winner(trial.candidates, cell["m"], cell["n"], cell["k"],
                                            cell["dtype"])
            row["winner"] = {k: win.get(k) for k in ("candidate", "kernel", "gflops")}
            _require(all(c["max_rel_err"] <= c["tol"] for c in trial.candidates),
                     f"autotune: a candidate disagrees with its plain version {row['trial']}")
    return row


def _not_ok(verdict: dict) -> dict:
    return {n: c["reasons"] for n, c in verdict["components"].items() if c["status"] != "OK"}


def _warm(a, b, admission: bool = False) -> dict:
    """North-star repeats until the health verdict is OK (a first-use
    validation storm ages out of the window, the JAX package's
    semantics), or with ``admission`` until the verdict the tuner's gate
    reads is (an advisory SLO burn stays for its windows)."""
    def ok():
        return (health.admission_status() if admission
                else health.verdict()["status"]) == "OK"

    n = 0
    while not ok() and n < WARM_MAX:
        _northstar_multiply(a, b)
        n += 1
    verdict = health.verdict()
    _require(ok(), f"autotune: not OK after {n} warm repeats: {_not_ok(verdict)}")
    return {"repeats": n, "verdict": verdict["status"], "not_ok": _not_ok(verdict)}


def phase_autotune(none_dir: str) -> dict:
    """The online tuner on the card from an empty temporary table (module
    docstring, phase 31).  Returns the phase's launches."""
    with open(COMMITTED_TABLE, "rb") as f:
        committed = hashlib.sha256(f.read()).hexdigest()
    out = {"phase": "autotune", "table": "temporary", "env": dict(_PLANE_ENV)}
    launched: dict = {}

    def tally():
        for k, v in _counts().items():
            launched[k] = launched.get(k, 0) + v
        _reset_counts()

    with tempfile.TemporaryDirectory() as tmp, _environ(_PLANE_ENV):
        _use_table(tmp)
        try:
            _fresh_plane()
            _reset_counts()
            ns = run_perf(_northstar_cfg(2), verbose=False)
            a, b = ns["matrices"]["a"], ns["matrices"]["b"]
            pre = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype,
                                    device=a.device)
            mm.multiply("N", "N", 1.0, a, b, 0.0, pre)
            torch.cuda.synchronize()
            pre_cache, pre_sum = pre._mm_plan_cache, checksum(pre)
            del pre
            del run_perf(_mixed_cfg(3, 3), verbose=False)["matrices"]
            warm_fired = _anomalies()
            warm = _warm(a, b)
            tally()
            out["warmup"] = {"northstar_times_s": ns["times_s"], "plan_cache": pre_cache,
                             "anomalies": warm_fired, "warm": warm}
            # the purify loop's dense product (the models' density forced
            # dense): its measured rate against the planner's model goes
            # to the regret ring the format axis mines
            p = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, seed=MODEL_SEED)
            set_config(mm_format="dense")
            _northstar_multiply(p, p)
            set_config(mm_format="auto")
            del p
            regrets = format_planner.regret_records()
            out["format_regret"] = regrets[-1] if regrets else None
            out["mis_crossovers"] = len(format_planner.mis_crossovers())
            _warm(a, b, admission=True)
            svc = tune_service.TuneService(interval_s=3600)
            # an idle cycle first: the format axis (a format row it
            # promotes at the north star's cell is replaced by the kernel
            # row the mined cycle promotes at the same key)
            idle = _cycle_row(svc, "idle (format axis)", [])
            if idle.get("trial") is None:
                occ = 832484 / 435.0 ** 3  # the north star's products over its block triples
                cell = {"m": 23, "n": 23, "k": 23, "dtype": "float64", "occ": occ,
                        "grid": [435, 435, 435], "stack_size": 30000}
                trial = tune_trials.run_format_trial(cell)
                idle["trial"] = {"outcome": trial.outcome, "cell": cell,
                                 "grid_run": [max(2, min(g, 16)) for g in cell["grid"]],
                                 "elapsed_s": trial.elapsed_s,
                                 "candidates": trial.candidates, "entry": trial.entry,
                                 "run_by": "trials.run_format_trial (nothing mined)"}
                _require(trial.ok and trial.candidates, f"autotune: format trial {trial!r}")
            idle["northstar_dense_s"] = _TELEMETRY_TIMES.get("dense_s")
            idle["northstar_stack_s"] = _TELEMETRY_TIMES.get("stack_s")
            # the format trial's small products feed the health windows
            # too (a "pallas" roofline collapse on the CPU rehearsal)
            idle["anomalies_after"] = _anomalies()
            idle["rewarm"] = _warm(a, b, admission=True)
            tally()
            cells = tune_miner.mine()
            _require(cells, "autotune: the miner found no cell")
            cycles = [idle, _cycle_row(svc, "mined", cells)]
            if cycles[-1]["outcome"] != "promoted":
                svc.margin = -1.0  # any winner beats the bar: the generation check needs one
                cycles.append(_cycle_row(svc, "mined, margin -1", cells))
            _require(cycles[-1]["outcome"] == "promoted", f"autotune: no promotion {cycles}")
            row = params.lookup(cells[0]["m"], cells[0]["n"], cells[0]["k"], cells[0]["dtype"],
                                stack_size=cells[0]["stack_size"])
            with faults.inject_faults("tune_trial:raise,times=1") as specs:
                faulted = _cycle_row(svc, "tune_trial fault", cells)
            _require(specs[0].fired == 1 and faulted["outcome"] == "trial_faulted"
                     and faulted["generation_after"] == faulted["generation_before"],
                     f"autotune: the faulted cycle {faulted}")
            cycles.append(faulted)
            tally()
            # the next multiply after the promotion: a plan-cache miss on
            # the promoted row's kernel, the checksum of the unpromoted run
            post = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype,
                                     device=a.device)
            mm.multiply("N", "N", 1.0, a, b, 0.0, post)
            torch.cuda.synchronize()
            counts = _counts()
            post_sum = checksum(post)
            rel = abs(post_sum - pre_sum) / abs(pre_sum)
            kernel = row.get("kernel")
            _require(post._mm_plan_cache == "miss" and kernel in _KERNEL_COUNT
                     and _KERNEL_COUNT[kernel](counts) > 0 and rel <= 1e-9,
                     f"autotune: after the promotion plan cache {post._mm_plan_cache}, "
                     f"row kernel {kernel}, launches {counts}, checksum rel {rel:.3e}")
            tally()
            # a second repeat hits the new plan
            again = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype,
                                      device=a.device)
            mm.multiply("N", "N", 1.0, a, b, 0.0, again)
            torch.cuda.synchronize()
            out["after_promotion"] = {"row": {k: row.get(k) for k in (
                "m", "n", "k", "dtype", "stack_size", "kernel", "variant", "pack_p",
                "precision", "gflops", "tuned_by", "promoted_gen")},
                "plan_cache_before": pre_cache, "plan_cache": post._mm_plan_cache,
                "launches": counts, "checksum": post_sum, "checksum_unpromoted": pre_sum,
                "rel_checksum": rel, "repeat_plan_cache": again._mm_plan_cache,
                "repeat_rel_checksum": abs(checksum(again) - pre_sum) / abs(pre_sum),
                "verdict": health.verdict()["status"], "anomalies": _anomalies()}
            del post, again
            tally()
            out["cycles"] = cycles
        finally:
            faults.clear()
            _use_table(none_dir)
            set_config(mm_format="auto")
            _fresh_plane()
    with open(COMMITTED_TABLE, "rb") as f:
        _require(hashlib.sha256(f.read()).hexdigest() == committed,
                 "autotune: the committed table changed")
    out["committed_table_unchanged"] = True
    out["launches"] = dict(launched)
    _emit(out)
    return launched


# ------------------------------------------------------------ serving plane
SERVE_TENANTS = 4
SERVE_PAIRS = 3          # coalesced/serialized pairs of legs, in turns
SERVE_PATTERN_SEED = 20261019
# The JAX defaults shed a north-star request (A + B + C is about 950 MB
# against serve_tenant_bytes = 256 MB) and never bank its 792 MB C
# (serve_product_cache_bytes = 128 MB): the smoke sets room for both.
# A group closes when its 4 tenants are in (serve_coalesce_max), not at
# the end of the window.
SERVE_CFG = {"serve_window_ms": 50.0, "serve_coalesce_max": SERVE_TENANTS,
             "serve_tenant_bytes": 64 << 30, "serve_product_cache_bytes": 8 << 30,
             "serve_product_cache_entries": 32, "serve_queue_max": 256,
             "serve_tenant_inflight": 8}
SERVE_WARM_MAX = 40      # north-star groups at most, until admission is OK


def _northstar_sizes() -> list:
    cfg = _northstar_cfg(1)
    return [int(x) for x in expand_block_sizes(cfg.m, cfg.m_sizes)]


def _revalued(m, seed: int, name: str):
    """A copy of ``m`` (same pattern) with standard-normal values drawn on
    the card from ``seed``."""
    out = m.copy(name)
    gen = torch.Generator(device=m.device)
    gen.manual_seed(seed)
    out.map_bin_data(lambda d: torch.randn(d.shape, generator=gen, dtype=d.dtype,
                                           device=d.device))
    return out


def _dispatch_total() -> float:
    return sum(v for _, v in metrics.counter_items("dbcsr_tpu_dispatches_total"))


def _serve_leg(eng, sessions, cname: str, coalesce_on: bool) -> dict:
    """Every tenant submits C = A B into a fresh ``cname`` inside one
    batching window; returns the tickets, wall seconds, launches and
    dispatches of the leg (the serve path's launches: the caller tallies
    them)."""
    set_config(serve_coalesce=coalesce_on)
    rows = _northstar_sizes()
    for s in sessions:
        if cname in s.matrices():
            s.drop(cname)
        s.create(cname, rows, rows)
    torch.cuda.synchronize()
    d0 = _dispatch_total()
    verdicts, reqs = [], []
    not_ok = _not_ok(health.verdict())
    t0 = time.perf_counter()
    for s in sessions:
        verdicts.append(health.admission_status())
        reqs.append(eng.submit(s, a="A", b="B", c=cname))
    for r in reqs:
        _require(r.wait(600) and r.state == "done", f"serve: request {r.info()}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    _require(counts["plain"] == 0, f"serve: a stack reached a plain version {counts}")
    return {"mode": "coalesced" if coalesce_on else "serialized", "wall_s": wall,
            "requests_per_s": len(reqs) / wall,
            "latency_ms": [r.info()["latency_ms"] for r in reqs],
            "phases_ms": [(r.info().get("attribution") or {}).get("phases_ms") for r in reqs],
            "coalesced": [r.result.get("coalesced") for r in reqs],
            "verdicts_at_submit": verdicts, "not_ok_before": not_ok, "launches": counts,
            "dispatches": _dispatch_total() - d0, "tickets": reqs}


def _drop_tickets(leg: dict) -> dict:
    return {k: v for k, v in leg.items() if k != "tickets"}


def _latency_by_tenant(legs: list) -> dict:
    """{tenant: the count, median and largest of its latencies (ms) over
    the tickets of ``legs``}: a leg gives each tenant one latency, too
    few for a tail quantile."""
    by: dict = {}
    for leg in legs:
        for r in leg["tickets"]:
            by.setdefault(r.tenant, []).append((r.t_done - r.t_submit) * 1e3)
    return {t: {"n": len(xs), "median_ms": statistics.median(xs), "max_ms": max(xs)}
            for t, xs in by.items()}


def phase_serve(none_dir: str) -> dict:
    """The serving plane on the card (module docstring, phase 32).
    Returns the phase's launches by kernel."""
    out = {"phase": "serve", "tenants": SERVE_TENANTS, "shape": [10000, 10000, 10000],
           "block": 23, "occupancy": 0.1, "dtype": "float64", "config": dict(SERVE_CFG),
           "config_by_leg": {"serve_product_cache": "off but in the product-cache leg",
                             "abft": "off but 'verify' in the integrity leg",
                             "serve_coalesce": "per leg", "mm_driver": "auto ('torch' for "
                             "the one reference product)", "incremental": "off"}}
    launched: dict = {}

    def tally(counts=None):
        _add_counts(launched, counts if counts is not None else _counts())
        _reset_counts()

    def drop_counts():  # comparison work: counted nowhere
        stack_kernel.reset_counts()
        crosspack_kernel.reset_counts()

    t_phase = time.perf_counter()
    set_config(**SERVE_CFG, serve_product_cache=False, abft="off")
    eng = ServeEngine(device="cuda")
    rows = _northstar_sizes()
    sessions = []
    try:
        t0 = time.perf_counter()
        a0 = make_random_matrix("A", rows, rows, occupation=0.1,
                                rng=np.random.default_rng(SERVE_PATTERN_SEED), device="cuda")
        b0 = make_random_matrix("B", rows, rows, occupation=0.1,
                                rng=np.random.default_rng(SERVE_PATTERN_SEED + 1),
                                device="cuda")
        for t in range(SERVE_TENANTS):
            s = eng.open_session(f"tenant{t}")
            s.put("A", _revalued(a0, 2 * t + 1, f"A{t}"))
            s.put("B", _revalued(b0, 2 * t + 2, f"B{t}"))
            sessions.append(s)
        del a0, b0
        torch.cuda.synchronize()
        out["operands_s"] = time.perf_counter() - t0
        # warm: first-use plans of the composite and its validations,
        # until admission reads OK (a first-use storm ages out)
        n = 0
        while n < SERVE_WARM_MAX and (n < 2 or health.admission_status() != "OK"):
            _serve_leg(eng, sessions, "Cw", coalesce_on=(n % 2 == 0))
            n += 1
        drop_counts()
        _require(health.admission_status() == "OK",
                 f"serve: admission not OK after {n} warm legs: {_not_ok(health.verdict())}")
        out["warm_legs"] = n
        for s in sessions:
            s.drop("Cw")
        # 1. bits and launches, no table (K1 fused) and committed (K3)
        bits = {}
        for table, tdir in (("none", none_dir), ("committed", TABLE_DIR)):
            _use_table(tdir)
            _serve_leg(eng, sessions, "Cwarm", coalesce_on=True)  # this table's plans
            drop_counts()
            for s in sessions:
                s.drop("Cwarm")
            ser = _serve_leg(eng, sessions, "Cs", coalesce_on=False)
            tally(ser["launches"])
            co = _serve_leg(eng, sessions, "Cc", coalesce_on=True)
            tally(co["launches"])
            _require(all(x == SERVE_TENANTS for x in co["coalesced"]),
                     f"serve: the group did not coalesce {co['coalesced']}")
            same = [_same_matrix(s.get("Cs"), s.get("Cc")) for s in sessions]
            _require(all(same), f"serve ({table}): coalesced C differs from standalone {same}")
            if table == "none":
                _require(co["launches"]["smm_superstack"] > 0 and
                         co["launches"]["smm_crosspack"] == 0,
                         f"serve: no table, the composite's launches {co['launches']}")
            else:
                _require(co["launches"]["smm_crosspack"] > 0,
                         f"serve: committed table, no K3 launch {co['launches']}")
            # one plain-version product, the comparison leg
            set_config(mm_driver="torch")
            try:
                ref = BlockSparseMatrix("Cref", rows, rows, torch.float64, device="cuda")
                mm.multiply("N", "N", 1.0, sessions[0].get("A"), sessions[0].get("B"), 0.0,
                            ref)
                torch.cuda.synchronize()
            finally:
                set_config(mm_driver="auto")
            drop_counts()
            rel = _bins_rel(sessions[0].get("Cc"), ref)
            _require(rel <= 1e-10, f"serve ({table}): against the torch driver rel {rel:.3e}")
            del ref
            bits[table] = {"bit_for_bit_standalone": same, "rel_torch_driver": rel,
                           "serialized": _drop_tickets(ser), "coalesced": _drop_tickets(co),
                           "composite_phases_ms": co["phases_ms"][0]}
        out["bits"] = bits
        # 2. coalesced against serialized, committed table, in turns
        legs = {"coalesced": [], "serialized": []}
        busy = None
        for i in range(SERVE_PAIRS):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                if on and busy is None:
                    with tempfile.TemporaryDirectory() as tmp:
                        path = os.path.join(tmp, "serve.json")
                        with torch.profiler.profile(activities=[
                                torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA]) as prof:
                            leg = _serve_leg(eng, sessions, "Ct", coalesce_on=True)
                        prof.export_chrome_trace(path)
                        busy = _busy_share(path)
                else:
                    leg = _serve_leg(eng, sessions, "Ct", coalesce_on=on)
                tally(leg["launches"])
                leg["composite_phases_ms"] = leg["phases_ms"][0] if on else None
                legs["coalesced" if on else "serialized"].append(leg)
        out["in_turns"] = {
            mode: {"requests_per_s": [x["requests_per_s"] for x in ls],
                   "wall_s": [x["wall_s"] for x in ls],
                   "dispatches": [x["dispatches"] for x in ls],
                   "launches": [x["launches"] for x in ls],
                   "composite_phases_ms": [x["composite_phases_ms"] for x in ls],
                   "latency_ms": _latency_by_tenant(ls)}
            for mode, ls in legs.items()}
        out["in_turns"]["busy_share_coalesced_leg"] = busy
        out["latency_quantiles_engine"] = eng.latency_quantiles()
        took = {k: v for k, v in _integrity_counts().items() if v}
        _require(not took, f"serve: the clean legs took the integrity plane: {took}")
        # 3. the product cache: an identical request hits with no launch;
        # A changed in place misses and gives the new product's bits
        set_config(serve_product_cache=True)
        s0 = sessions[0]
        for name in ("Cp0", "Cp1", "Cp2", "Cp3"):
            s0.create(name, rows, rows)
        miss = eng.submit(s0, a="A", b="B", c="Cp0")
        _require(miss.wait(600) and miss.state == "done", f"serve: {miss.info()}")
        torch.cuda.synchronize()
        tally()
        hit = eng.submit(s0, a="A", b="B", c="Cp1")
        _require(hit.wait(600) and hit.state == "done", f"serve: {hit.info()}")
        torch.cuda.synchronize()
        hit_counts = _counts()
        _require(hit.result.get("cached") == 1 and sum(
            v for k, v in hit_counts.items()) == 0,
            f"serve: the repeat did not hit without launches {hit.result} {hit_counts}")
        _require(_same_matrix(s0.get("Cp0"), s0.get("Cp1")), "serve: the hit's C differs")
        scale(s0.get("A"), 1.5)  # in place
        mut = eng.submit(s0, a="A", b="B", c="Cp2")
        _require(mut.wait(600) and mut.state == "done", f"serve: {mut.info()}")
        torch.cuda.synchronize()
        mut_counts = _counts()
        tally()
        _require(not mut.result.get("cached") and _k1(mut_counts) > 0,
                 f"serve: the mutated operand hit the cache {mut.result} {mut_counts}")
        mm.multiply("N", "N", 1.0, s0.get("A"), s0.get("B"), 0.0, s0.get("Cp3"))
        torch.cuda.synchronize()
        drop_counts()
        _require(_same_matrix(s0.get("Cp2"), s0.get("Cp3")),
                 "serve: the miss after the mutation is not the new product's bits")
        out["product_cache"] = {
            "miss_latency_ms": miss.info()["latency_ms"],
            "hit_latency_ms": hit.info()["latency_ms"], "hit_launches": hit_counts,
            "saved_flops": hit.result.get("saved_flops"),
            "saved_seconds": hit.result.get("saved_seconds"),
            "after_in_place_mutation": {"cached": bool(mut.result.get("cached")),
                                        "launches": mut_counts,
                                        "latency_ms": mut.info()["latency_ms"]},
            "snapshot": product_cache.snapshot()}
        set_config(serve_product_cache=False)
        product_cache.clear()
        for name in ("Cp0", "Cp1", "Cp2", "Cp3"):
            s0.drop(name)
        # 4. integrity: a served NaN, caught by the per-request probe,
        # restored and re-executed once, bit for bit the clean C
        set_config(abft="verify")
        for name in ("Ci0", "Ci1"):
            s0.create(name, rows, rows)
        clean = eng.submit(s0, a="A", b="B", c="Ci0")
        _require(clean.wait(600) and clean.state == "done", f"serve: {clean.info()}")
        rec0 = _ctr("dbcsr_tpu_abft_recoveries_total", driver="serve")
        with faults.inject_faults("serve_execute:nan,times=1") as specs:
            bad = eng.submit(s0, a="A", b="B", c="Ci1")
            _require(bad.wait(600) and bad.state == "done", f"serve: {bad.info()}")
        torch.cuda.synchronize()
        tally()
        recovered = _ctr("dbcsr_tpu_abft_recoveries_total", driver="serve") - rec0
        _require(specs[0].fired == 1 and recovered == 1 and bad.result.get("verified") == 1
                 and _same_matrix(s0.get("Ci0"), s0.get("Ci1")),
                 f"serve: the probe did not recover the served NaN ({specs[0].fired} fired, "
                 f"{recovered} recovered, {bad.result})")
        out["integrity"] = {"fault": "serve_execute:nan,times=1", "fired": specs[0].fired,
                            "recoveries": recovered, "result": bad.result,
                            "bit_for_bit_clean": True,
                            "mismatches": _ctr("dbcsr_tpu_abft_mismatches_total")}
        set_config(abft="off")
        # 5. shedding: a serve_admit fault sheds with the structured reason
        with faults.inject_faults("serve_admit:raise,times=1"):
            shed = eng.submit(s0, a="A", b="B", c="Ci1")
        _require(shed.state == "shed" and shed.error.startswith("shed: fault"),
                 f"serve: the admit fault did not shed {shed.info()}")
        out["shed"] = {"state": shed.state, "outcome": shed.outcome, "error": shed.error,
                       "shed_total": {lab["reason"]: v for lab, v in
                                      metrics.counter_items("dbcsr_tpu_serve_shed_total")}}
    finally:
        faults.clear()
        breaker.reset_board()
        _use_table(none_dir)
        set_config(abft="off", serve_product_cache=True, serve_coalesce=True)
        eng.shutdown()
        for s in sessions:
            s.close()
        product_cache.clear()
        # the served NaN's mismatch must not degrade the later phases'
        # verdicts: a fresh plane, as telemetry and autotune leave it
        _fresh_plane()
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = dict(launched)
    _emit(out)
    return launched


def _http(url: str, route: str, body=None, timeout: float = 600.0):
    """(status, payload) of one call to the obs endpoint."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + route, data=data, headers=(
        {"Content-Type": "application/json"} if data else {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw, code = resp.read().decode(), resp.status
    except urllib.error.HTTPError as exc:
        raw, code = exc.read().decode(), exc.code
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw


def phase_serve_http() -> dict:
    """The HTTP endpoint in this process over the card's engine (module
    docstring, phase 33).  Returns the phase's launches."""
    t_phase = time.perf_counter()
    set_config(**SERVE_CFG, serve_product_cache=False)
    rows = _northstar_sizes()
    eng = serve_engine.get_engine(device="cuda")
    obs_server.start(0)
    url = obs_server.url()
    out = {"phase": "serve_http", "url_port": obs_server.get().port,
           "config": dict(SERVE_CFG), "routes": {}}
    try:
        def call(route, body=None, want=200):
            t0 = time.perf_counter()
            code, payload = _http(url, route, body)
            _require(code == want, f"serve_http: {route} answered {code}: {str(payload)[:300]}")
            out["routes"].setdefault(route.split("?")[0], []).append(
                {"status": code, "ms": 1e3 * (time.perf_counter() - t0)})
            return payload

        sid = call("/serve/session/open", {"tenant": "http", "session_id": "http-1"})[
            "session_id"]
        for name, seed in (("a", 1), ("b", 2)):
            call("/serve/matrix", {"session": sid, "name": name, "row_blk": rows,
                                   "occupation": 0.1, "seed": seed})
        call("/serve/matrix", {"session": sid, "name": "c", "row_blk": rows,
                               "kind": "create"})
        sess = serve_session.get_session(sid)
        _require(sess.get("a").device.type == "cuda", "serve_http: operands off the card")
        torch.cuda.synchronize()
        _reset_counts()
        info = call("/serve/submit", {"session": sid, "a": "a", "b": "b", "c": "c",
                                      "wait": True, "timeout_s": 600})
        torch.cuda.synchronize()
        launched = _counts()
        _reset_counts()
        _require(info["state"] == "done" and _k1(launched) > 0 and launched["plain"] == 0,
                 f"serve_http: submit {info} launches {launched}")
        status = call("/serve/status")
        tenants = call("/serve/tenants")
        ck = call(f"/serve/checksum?session={sid}&name=c")
        local = float(checksum(sess.get("c")))
        _require(ck["checksum"] == local,
                 f"serve_http: /serve/checksum {ck['checksum']} != in-process {local}")
        health_v = call("/healthz")
        code, prom = _http(url, "/metrics")
        _require(code == 200 and "dbcsr_tpu_serve_requests_total" in prom,
                 "serve_http: /metrics lacks the serve counters")
        usage = call("/usage")
        with faults.inject_faults("serve_admit:raise,times=1"):
            shed = call("/serve/submit", {"session": sid, "a": "a", "b": "b", "c": "c"},
                        want=429)
        _require(shed["state"] == "shed" and "fault" in shed["error"],
                 f"serve_http: the shed {shed}")
        out.update({"request": {k: info.get(k) for k in ("request_id", "state", "outcome",
                                                          "latency_ms", "result")},
                    "status": status, "tenants": tenants, "checksum": ck["checksum"],
                    "checksum_in_process": local, "healthz": health_v["status"],
                    "usage_tenants": sorted((usage.get("tenants") or {})),
                    "shed": {k: shed.get(k) for k in ("state", "outcome", "error")},
                    "launches": launched})
    finally:
        faults.clear()
        obs_server.stop()
        serve_engine.shutdown()
        for s in serve_session.sessions().values():
            s.close()
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    _emit(out)
    return launched


FLEET_REQUESTS = 3       # north-star requests a tenant submits before the kill
# the peer tier's wait for one peer: the default 0.3 s is too short for
# an entry of the models' size to travel as base64 JSON
FLEET_ENV = {"DBCSR_TPU_TORCH_FLEET_CACHE_TIMEOUT_S": "60"}
# the workers' quota: the default 256 MB of queued operands a tenant
# sheds a second queued north-star request (A and B are 160 MB)
FLEET_CONFIG = {"serve_tenant_bytes": 64 << 30}


def _worker_launches(url: str) -> dict:
    """A worker's kernel wrappers' own counts, by kernel, from its
    /metrics (`obs.server.kernel_counts_text`): each wrapper's launches,
    and "plain", the calls of the plain versions."""
    code, text = _http(url, "/metrics", timeout=30)
    _require(code == 200, f"fleet: {url}/metrics answered {code}")
    out: dict = {"plain": 0}
    for line in text.splitlines():
        m = re.match(r'^dbcsr_tpu_kernel_(launches|plain_calls)_total\{kernel="([^"]+)"\} (\S+)$',
                     line)
        if m:
            key = m.group(2) if m.group(1) == "launches" else "plain"
            out[key] = out.get(key, 0) + int(float(m.group(3)))
    _require(len(out) == 5, f"fleet: {url}/metrics lacks the kernel counts: {out}")
    return out


def _since(now: dict, base: dict) -> dict:
    return {k: n - base.get(k, 0) for k, n in now.items()}


def _worker_dispatches(url: str) -> float:
    code, text = _http(url, "/metrics", timeout=30)
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith("dbcsr_tpu_dispatches_total"))


def phase_fleet() -> dict:
    """Two worker processes on the one card behind the router (module
    docstring, phase 34).  Returns the workers' launches by kernel."""
    t_phase = time.perf_counter()
    rows = _northstar_sizes()
    dens = [MODEL_BLOCK] * MODEL_BLOCKS
    out = {"phase": "fleet", "workers": 2, "device": "cuda", "coalesce": "off",
           "table_dir_inherited": os.environ.get("DBCSR_TPU_TORCH_PARAMS_DIR"),
           "env": dict(FLEET_ENV), "config": dict(FLEET_CONFIG)}
    launched: dict = {}
    with tempfile.TemporaryDirectory() as wd:
        fl = Fleet(n=2, device="cuda", workdir=wd, env=FLEET_ENV, config=FLEET_CONFIG)
        t0 = time.perf_counter()
        with fl:
            out["start_s"] = dict(fl.start_s)
            out["fleet_start_s"] = time.perf_counter() - t0
            r = fl.router()
            _require(r.check() == {"w0": "up", "w1": "up"}, "fleet: a worker is not up")
            urls = {n: s["url"] for n, s in fl.specs.items()}
            # each worker's counts are read as differences from its start
            base = {n: _worker_launches(u) for n, u in urls.items()}
            sids = {}
            for t, seed in (("alpha", 11), ("beta", 21)):
                sid = r.open_session(t, session_id=f"{t}-s")
                r.matrix(sid, name="a", row_blk=rows, occupation=0.1, seed=seed)
                r.matrix(sid, name="b", row_blk=rows, occupation=0.1, seed=seed + 1)
                for i in range(FLEET_REQUESTS + 1):
                    r.matrix(sid, name=f"c{i}", row_blk=rows, kind="create")
                sids[t] = sid
            placed = {t: r.sessions[sid]["worker"] for t, sid in sids.items()}
            _require(len(set(placed.values())) == 2, f"fleet: placement {placed}")
            # one request each, waited: the workers' plans and first uses
            for t, sid in sids.items():
                info = r.submit(sid, request_id=f"{t}-0", op="multiply", a="a", b="b",
                                c="c0", wait=True, timeout_s=600)
                _require(info["state"] == "done", f"fleet: {info}")
            owner = placed["alpha"]
            peer = placed["beta"]
            # the doomed worker's tenant submits and is killed in flight
            # (a north-star request takes tens of ms on the host alone,
            # so the kill lands before the first of them is done); what
            # it launched for them dies with it, uncounted
            before_kill = _since(_worker_launches(urls[owner]), base[owner])
            subs = [r.submit(sids["alpha"], request_id=f"alpha-{i}", op="multiply", a="a",
                             b="b", c=f"c{i}") for i in range(1, FLEET_REQUESTS + 1)]
            rids = [x["request_id"] for x in subs]
            t_kill = time.perf_counter()
            fl.kill(owner)
            r.mark_down(owner)
            moved = r.failover(owner)
            r.settle_replayed(moved["replayed"], moved["target"], timeout=600.0)
            failover_s = time.perf_counter() - t_kill
            for i in range(1, FLEET_REQUESTS + 1):
                info = r.submit(sids["beta"], request_id=f"beta-{i}", op="multiply", a="a",
                                b="b", c=f"c{i}", wait=True, timeout_s=600)
                _require(info["state"] == "done", f"fleet: {info}")
            audit = r.audit()
            _require(all(x["state"] not in ("shed", "failed") for x in subs),
                     f"fleet: in-flight submissions {[x['state'] for x in subs]}")
            _require(audit["duplicated"] == [] and audit["unresolved"] == []
                     and moved["target"] == peer and moved["replayed"],
                     f"fleet: audit {audit['duplicated']} {audit['unresolved']}, "
                     f"moved {moved}")
            # a clean in-process run of the same specs, coalescing off
            set_config(serve_coalesce=False)
            clean = {}
            for t, seed in (("alpha", 11), ("beta", 21)):
                s = Session(f"clean-{t}", register=False, device="cuda")
                a = s.random("a", rows, rows, occupation=0.1, seed=seed)
                b = s.random("b", rows, rows, occupation=0.1, seed=seed + 1)
                c = s.create("c", rows, rows)
                mm.multiply("N", "N", 1.0, a, b, 0.0, c)
                torch.cuda.synchronize()
                clean[t] = float(checksum(c))
                s.close()
            stack_kernel.reset_counts()
            crosspack_kernel.reset_counts()
            set_config(serve_coalesce=True)
            got = {}
            for rid in moved["replayed"]:
                i = int(rid.rsplit("-", 1)[1])
                got[rid] = _fleet_checksum(urls[peer], sids["alpha"], f"c{i}")
            for i in range(FLEET_REQUESTS + 1):
                got[f"beta-{i}"] = _fleet_checksum(urls[peer], sids["beta"], f"c{i}")
            for rid, ck in got.items():
                want = clean[rid.split("-")[0]]
                _require(ck == want, f"fleet: {rid} checksum {ck} != clean {want}")
            # the peer tier of the product cache on the models' operands
            # (2208^2: a north-star C is 792 MB, too large for base64)
            fl.respawn(owner)
            r.rejoin(owner)
            out["respawn_start_s"] = fl.start_s[owner]
            base[owner] = _worker_launches(urls[owner])
            sid_p = r.open_session("beta", session_id="beta-s")  # on the peer
            for name, seed in (("pa", 0),):
                r.matrix(sid_p, name=name, row_blk=dens, kind="density", occupation=0.2,
                         seed=seed)
            r.matrix(sid_p, name="pc", row_blk=dens, kind="create")
            first = r.submit(sid_p, request_id="dens-0", op="multiply", a="pa", b="pa",
                             c="pc", wait=True, timeout_s=600)
            r.affinity["gamma"] = owner
            sid_g = r.open_session("gamma", session_id="gamma-s")
            r.matrix(sid_g, name="pa", row_blk=dens, kind="density", occupation=0.2, seed=0)
            r.matrix(sid_g, name="pc", row_blk=dens, kind="create")
            n0, d0 = _worker_launches(urls[owner]), _worker_dispatches(urls[owner])
            hit = r.submit(sid_g, request_id="dens-1", op="multiply", a="pa", b="pa", c="pc",
                           wait=True, timeout_s=600)
            n1, d1 = _worker_launches(urls[owner]), _worker_dispatches(urls[owner])
            cache_lines = [ln for ln in _http(urls[owner], "/metrics", timeout=30)[1].splitlines()
                           if ln.startswith("dbcsr_tpu_product_cache_total")]
            p = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=0, device="cuda")
            pc = BlockSparseMatrix("pc", dens, dens, torch.float64, device="cuda")
            mm.multiply("N", "N", 1.0, p, p, 0.0, pc)
            torch.cuda.synchronize()
            stack_kernel.reset_counts()
            crosspack_kernel.reset_counts()
            want = float(checksum(pc))
            del p, pc
            ck_hit = _fleet_checksum(urls[owner], sid_g, "pc")
            _require(first["state"] == "done" and hit["state"] == "done"
                     and hit["result"].get("cached") == 1 and n1 == n0 and d1 == d0
                     and ck_hit == want,
                     f"fleet: the peer-tier hit {hit}, launches {n0} -> {n1}, "
                     f"dispatches {d0} -> {d1}, checksum {ck_hit} vs {want}, cache {cache_lines}")
            after = {n: _since(_worker_launches(u), base[n]) for n, u in urls.items()}
            for src in (before_kill, after[peer], after[owner]):
                _require(src.pop("plain") == 0,
                         f"fleet: a worker's stack ran a plain version {src}")
                _add_counts(launched, src)
            out.update({
                "placed": placed, "killed": owner, "in_flight": rids,
                "in_flight_states_at_submit": [x["state"] for x in subs],
                "failover": {k: moved[k] for k in ("target", "pending", "skipped",
                                                   "replayed", "repinned")},
                "failover_s": failover_s,
                "audit": {"requests": len(audit["requests"]),
                          "duplicated": audit["duplicated"],
                          "unresolved": audit["unresolved"]},
                "checksums": got, "clean_checksums": clean,
                "peer_tier": {"size": "2208^2 (make_test_density(96, 23, occ=0.2, seed=0))",
                              "result": hit["result"], "latency_ms": hit.get("latency_ms"),
                              "launches_on_second_worker": {"before": n0, "after": n1},
                              "dispatches_on_second_worker": {"before": d0, "after": d1},
                              "checksum": ck_hit, "clean_checksum": want,
                              "cache_counters": cache_lines,
                              "first_latency_ms": first.get("latency_ms")},
                "worker_launches": {"killed_before_kill": before_kill, **after},
                "health_fleet": health.verdict()["components"].get("fleet")})
        out["workers_exit"] = {n: p.returncode for n, p in fl.procs.items()}
        _require(all(p.poll() is not None for p in fl.procs.values()),
                 "fleet: a worker is still running")
    counts = {"smm_stack": launched.get("smm_stack", 0),
              "smm_superstack": launched.get("smm_superstack", 0),
              "smm_crosspack": launched.get("smm_crosspack", 0),
              "smm_crosspack_resident": launched.get("smm_crosspack_resident", 0)}
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = counts
    _emit(out)
    return counts


def _fleet_checksum(url: str, sid: str, name: str) -> float:
    code, payload = _http(url, f"/serve/checksum?session={sid}&name={name}", timeout=120)
    _require(code == 200, f"fleet: checksum of {sid}/{name} answered {code}: {payload}")
    return payload["checksum"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; "
              "this script runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    # every `.perf` gate raises on a checksum mismatch at once, in this
    # process and in the ranks and workers it spawns: no repeat on the
    # safe driver may turn a wrong kernel result into a pass
    os.environ["DBCSR_TPU_TORCH_CHECKSUM_RETRY"] = "0"
    # the phases of the earlier slices run on the untuned rules, as they
    # did before the committed table: an empty table directory ("table":
    # "none" on their lines); the new phases name their table
    with tempfile.TemporaryDirectory() as none_dir:
        _use_table(none_dir)
        return _run_phases(none_dir)


def _run_phases(none_dir: str) -> int:
    # the engine's phases time the engine: the incremental multiply is
    # off but in its own phase, as in the perf driver's repeats
    set_config(mm_driver="auto", validate_kernels=True, incremental="off")
    # every phase but resilience, integrity and incremental injects
    # nothing, so each must end without a failover, a fallback, an ABFT
    # mismatch or a rollback (`_clean`)
    _clean("build", phase_build)
    _clean("kernel_vs_plain", phase_kernel_vs_plain)
    _clean("crosspack_vs_plain", phase_crosspack_vs_plain)
    _clean("perf_gates", phase_perf_gates, "auto")
    _clean("perf_gates_crosspack", phase_perf_gates, "pallas_cross")
    k1s = _clean("superstack", phase_superstack)
    ns = _clean("northstar", phase_northstar)
    ns_a, ns_b = ns["a"], ns["b"]
    _clean("native_index", phase_native_index, ns["a"], ns["b"], ns["c"])
    _clean("obs", phase_obs, ns["a"], ns["b"])
    ns_timing = _clean("northstar_stacks", _stacks_phase, "northstar_stacks", ns.pop("a"),
                       ns.pop("b"), ns.pop("c"))
    k1 = _kernel_row("smm_stack", ns.pop("launches"), ns_timing)
    k3 = _clean("northstar_f32", phase_northstar_f32)
    k4 = _clean("resident_f32", phase_resident_f32)
    k1["launches_by_path"] = {"northstar": k1["launches"],
                              "formats": _clean("formats", phase_formats),
                              "limits": _clean("limits", phase_limits),
                              "models": _clean("models", phase_models)}
    k3["launches_by_path"] = {"northstar_f32": k3["launches"],
                              "models_f32": _clean("models_f32", phase_models_f32)}
    # the legs first: they validate K1 at (529, 23, 23) for f64 and f32,
    # so the full-width run's stack times hold no first-use check
    legs = _clean("tensor_legs", phase_tensor_legs)
    k1["launches_by_path"]["tensor_legs"] = legs["launches"]
    tensor = _clean("tensor", phase_tensor)
    k1["launches_by_path"]["tensor"] = tensor.pop("launches")
    k1["launches_by_path"]["tensor_adaptive"] = tensor.pop("adaptive_launches")
    adaptive_row = tensor.pop("form_row")
    k1["by_path"] = {"tensor": {**tensor, "library_ms": None}}
    # K1's complex and demoted forms, each beside its launches on its
    # phase's main path; the tiled forms' rows from the contraction legs
    cx = _clean("complex", phase_complex, ns_timing["ms"][0])
    pr = _clean("precision", phase_precision, ns_timing["ms"][0])
    k1["launches_by_path"]["complex"] = cx["launches"]
    k1["launches_by_path"]["precision"] = pr["launches"]
    k1["forms"] = cx["forms"] + pr["forms"] + [
        _leg_form_row(legs["c128"], torch.complex128, None, tensor["ms"]), adaptive_row]
    for phase, fn in (("resilience", phase_resilience), ("integrity", phase_integrity),
                      ("incremental", phase_incremental)):
        _PHASE_NOW[0] = phase
        launched = fn()
        _reset_counts()
        k1["launches_by_path"][phase] = launched["smm_stack"]
        k3["launches_by_path"][phase] = launched["smm_crosspack"]
    k4["launches_by_path"] = {"resident_f32": k4["launches"]}
    # the acc layer alone from the committed table, the tuner into a
    # temporary one, the workloads from the committed table and from none
    # in turns, and the public surface with no table
    set_config(incremental="off", abft="off")
    _use_table(TABLE_DIR)
    by_phase = {"acc_bench": _clean("acc_bench", phase_acc_bench)}
    _use_table(none_dir)
    by_phase["tune"] = _clean("tune", phase_tune)
    by_phase["tuned"] = _clean("tuned", phase_tuned, ns_a, ns_b)
    by_phase["api"] = _clean("api", phase_api, ns_a, ns_b)
    del ns_a, ns_b
    # the distributed engine: one-process grids on the card (tables in
    # turns), the four-rank world over gloo, the models' grid branches
    mesh = _clean("mesh", phase_mesh, none_dir,
                  {"checksum": ns["checksum"], "checksum_pos": ns["checksum_pos"]})
    _use_table(none_dir)
    by_phase["mesh"] = {k: mesh[k] for k in ("smm_stack", "smm_crosspack")}
    by_phase["mesh_world"] = _clean("mesh_world", phase_mesh_world, mesh["ref_1x2x2"])
    by_phase["mesh_models"] = _clean("mesh_models", phase_mesh_models)
    # the telemetry plane and the online tuner: both inject a fault, so
    # neither runs under `_clean`; each resets the plane it used
    for phase, fn, args in (("telemetry", phase_telemetry, ()),
                            ("autotune", phase_autotune, (none_dir,))):
        _PHASE_NOW[0] = phase
        metrics.reset()
        _reset_counts()
        by_phase[phase] = fn(*args)
        _reset_counts()
    # the serving plane: the in-process engine on the card (it injects
    # faults, so it checks its clean legs itself), the HTTP endpoint, and
    # a two-worker fleet (the workers' wrapper counts come from their /metrics)
    _PHASE_NOW[0] = "serve"
    metrics.reset()
    _reset_counts()
    by_phase["serve"] = phase_serve(none_dir)
    _reset_counts()
    by_phase["serve_http"] = _clean("serve_http", phase_serve_http)
    by_phase["fleet"] = _clean("fleet", phase_fleet)
    _SUPERSTACK_BY_PATH["fleet"] = by_phase["fleet"]["smm_superstack"]
    for row in (k1, k3, k4):
        for phase, counts in by_phase.items():
            row["launches_by_path"][phase] = counts.get(row["name"], 0)
    k1s["launches_by_path"] = dict(_SUPERSTACK_BY_PATH)
    print(json.dumps({"kernels": [k1, k3, k4, k1s]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
