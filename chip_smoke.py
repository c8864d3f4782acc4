#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--requests 1000000] [--requests2 N]
                          [--requests3 N]

1. prints the card's name and power limit (nvidia-smi) and turns TF32 off;
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel);
3. the AKPC replay with the device clique generation, for each of
   ``netflix-table2`` (the paper's Table-II trace, 60 items x 600 servers)
   and ``catalog-10k`` (10,000 items x 600 servers): ``akpc`` through
   ``run_policy`` on the card, every kernel of the path launched, again
   with the plain versions, equal partitions, E/anchor and costs at 1e-9,
   and a head of the trace on the CPU equal to the card; the kernels'
   inputs are captured from the card run;
4. holds the three kernels of the device clique generation against their
   plain PyTorch versions, bitwise, on the captured inputs, on synthetic
   ones at the same shapes and on ragged ones, and ``crm_update`` and
   ``clique_pair_edges`` on the inputs their sparse designs could get
   wrong (``kernel_bench.worst_cases``: dense, empty and strided rows, S 1,
   h 1); ``merge_density`` unmasked and masked at every act count edge
   case and on the captured merge in both modes; every kernel is called
   twice on each input and must give the same bits both times; times kernel,
   plain version and library call on the captured and the worst-case
   inputs (``merge_density`` also beside the mask chain its masked mode
   replaces) and works out each kernel's bound from the work these
   inputs need; the device-CGM replay must launch ``merge_density`` once
   a window;
5. the host-schedule replay: ``hetero-table2`` (the Table-II trace with
   lognormal item sizes under the heterogeneous cost model, per-server
   dt) with ``akpc``, ``no_packing``, ``ttl``, ``packcache`` and
   ``dp_greedy``; ``hetero-catalog-10k`` with ``akpc``; and ``no_packing``
   under table1 on ``netflix-table2`` (uniform dt: the scan kernels must
   stay idle).  Each run: kernels on the card, every expected kernel
   launched (under per-server dt one ``seg_scan_step`` a live step and no
   standalone scan), at most one item -> clique lookup a partition stretch
   (windows + 1), plain versions on the card (no launch), equal state and
   costs, a CPU head equal to the card's;
6. ``kernels_bench``: the kernel benchmark (``python -m
   repro_torch.bench.kernel_bench``), the only path of ``unpacked_lookup``:
   every row bitwise against the plain version, the two lookups against
   each other on the same bytes, ``merge_density`` in both modes up to
   the full merge's S 20,000 (k 10,000, drawn on the card; its record
   stands beside the captured merge's in the kernels' line), plus ragged
   lookups (d 1, 3, 255, 256; int32, float32, float64; R 1), every path
   of the lookups' copy engine
   (``kernel_bench.lookup_cases``: narrow, vector, sliced, ragged;
   R 1, 3, 64, 65,537; int32, float32, float16), each twice, and an id
   out of range that must raise; then ``crm_update``'s mid path
   (``kernel_bench.mid_crm_cases``: h 33-64 at 1, 3 and 17 lanes, row
   strides h and h + 1) and the lookups' stream path
   (``kernel_bench.stream_lookup_cases``: rows of 6 MB + 16 B, 7.9 MB and
   24 MB at R 1, 2 and 18 in bf16, f32 and int16), each taking its path
   and held bitwise twice;
7. ``sweep_fig6``: the fig6 (64 alphas x 4 rhos) AKPC grid over
   ``netflix-table2`` as one ``SweepEngine`` call (one host schedule per
   rho, 64 scenario lanes each, one scan: the schedules are one cohort),
   8 points of it against serial card runs
   (the device clique generation) and all 256 on a 10,000-request head
   against serial CPU runs: costs at 1e-9, equal partitions and state;
8. ``sweep_fig10``: fig10's grid (2 size distributions x 3 price sigmas x
   no_packing / packcache / akpc, heterogeneous prices, 150 servers) at
   1M requests as one sweep: per-server dt, so the lane-batched scans
   launch (one ``seg_scan_step`` a live step a cohort: one scan a cohort
   of the reference's key); every point against a serial card run;
8b. ``sweep_fig7``: fig7's grid (6 thetas, 6 gammas, 5 omegas; ``akpc``
   and ``akpc_base``) over ``netflix-table2`` and the Table-II
   ``spotify`` trace at ``--requests`` as one sweep: 4 device-CGM
   super-groups of 17 lanes, each one laned device clique generation (one
   schedule a group, no host clique generation, ``crm_update`` once a
   window a group, ``clique_pair_edges`` and ``merge_density`` once a
   window an ``akpc`` group, no scan or lookup); the first and last lane
   of each group against serial card runs, the netflix ``akpc`` group on
   a 20,000-request head against serial CPU runs and a 3-lane
   ``catalog-10k`` theta group (top_frac 0.1: h 1024) on a 25,000-request
   head against serial card runs (state, costs at 1e-9, windows and size
   history); then the laned kernels against their laned plain versions,
   bitwise and twice, on the inputs captured from these runs and on
   ``kernel_bench.lane_cases`` (1, 2, 17 and 3 lanes with their own hot
   counts, omega, gamma and act counts), timed on the card alone beside a
   per-lane loop of the unlaned kernel;
9. holds the scan and gather kernels (and the CGM kernels at the host
   clique generation's shapes) against their plain versions on inputs
   captured from those replays (the scans also in the sweep's lane form;
   ``seg_scan_step``, the replay step's one launch for both scans, on the
   captured step and on ragged and lane cases) and on ragged ones, and
   times them, every captured input also on the card alone (``device_ms``
   and ``library_device_ms``, from a CUDA graph of calls; the CGM
   kernels' captured inputs too);
10. the serve phase: ``serve_netflix`` streams ``netflix-table2`` in
    128-request slices through a ``LiveServingEngine`` (``akpc``, the
    device clique generation; chunks of 65,536, a ring of 6) and
    ``serve_hetero`` streams ``hetero-table2`` the same way for ``akpc``
    and ``no_packing`` (the host schedule, per-server dt) under torch's
    sync debug mode, every host sync classified; each stream's totals
    equal the ``slice`` / ``slice2`` line's at 1e-9 (integer counters
    exact), the path's kernels launch (``crm_update`` and
    ``merge_density`` once a window), a 200,000-request head again with
    the plain versions equals the kernel run bit for bit, and a snapshot
    taken mid-flight restores into a fresh card engine and a CPU session
    that both finish the head bit for bit alike; then
    ``python -m repro_torch.bench.serve_bench --smoke`` in a process of
    its own (session, live cold and live warm req/s, printed, not gated
    here);
11. ``learned``: the learned keep-or-not policy on fig11's regime-shift
    stress trace (60 items x 12 servers, rho 4), ``--requests4`` requests:
    ``train_policy`` on the card with no host sync inside its step loop
    and on the CPU from the same inputs (weights within 1e-5 of each
    leaf's magnitude), the card-trained scorer served through
    ``run_policy`` on the card under table1 and heterogeneous pricing
    (one ``seg_scan_step`` a step under per-server dt; on a
    200,000-request head the kernel run == the plain run == the CPU's,
    bit for bit), its total against
    ``no_packing``, ``ttl``, ``packcache`` and ``dp_greedy`` (it must beat
    ``no_packing``), and the heterogeneous run streamed through a
    ``LiveServingEngine`` in 128-request slices (totals == offline);
12. ``pipeline``: ``PackedDataPipeline`` at ``ShardStore``'s defaults, 64
    rows of 2,048 tokens, 1,000 steps on the ``session`` and ``live``
    backends in lockstep: equal token batches, equal costs after
    ``drain()``, the live device clique generation's kernels once a window;
    the live engine's request stream replayed with the plain versions (no
    launch) and on the CPU: the same state bit for bit, costs at 1e-9;
13. ``expert_cache``: ``ExpertCacheManager`` at DeepSeek-V2's routing
    shape (160 experts, top-6, 4 hosts, 256 tokens a step, 5,000 steps):
    equal ``stats()`` on both backends, the live engine's stream replayed
    with the plain versions and on the CPU as for the pipeline, a live
    snapshot at step 2,500
    finishing in a ``session`` manager with equal totals; then the packed
    table of Granite-MoE-width expert rows (40 x 3 x 1536 x 512 f16)
    gathered a step's cliques at a time by ``packed_lookup`` (== its plain
    version), timed on the card alone against ``index_select``;
13b. ``sweep_shards``: fig11's eval-seed shard axis (regime_shift, shards
    at seeds 101 / 102 / 103 of 200,000 requests each, cut from fig11's
    run size; both pricing models; all eight policies, ``learned`` with
    the weights the ``learned`` phase trained) as one sweep: each point's
    shard group is one scan of 3 lanes over its 3 schedules (per-lane
    event rows in ``seg_scan_step``, one launch a live step under
    per-server dt), every point equal to the ``serial`` backend's at 1e-9
    with equal ``shard_stats``; the widest captured shard-group step held
    bitwise against ``seg_scan_step_plain`` and against the loop of
    per-shard launches, and timed beside that loop and its bound;
13c. ``competitive``: the Thm-2 adversary replayed on the card realises
    ``competitive_bound_corrected`` at 1e-12 for the five (S, omega) of
    ``tests/test_competitive.py``; ``per_request_ratio_check`` and
    ``generalized_per_request_ratio_check`` on a 1,500-request netflix
    trace under table1 and heterogeneous pricing stay <= 1 and equal a CPU
    run of the port;
13d. ``figures``: the figure drivers of ``repro_torch.bench`` on the
    card: ``fig8 --smoke`` (the mixed (n, m) grid under the bucketed
    layout: at most one scan a bucket cohort, every point equal to its
    serial card run at 1e-9); fig8's servers and items axes as a bucketed
    grid under heterogeneous prices (per-server dt, 20,000 requests a
    trace, ``akpc`` and ``no_packing``): one scan a cohort, one
    ``seg_scan_step`` launch a live step a scan, every point equal to its
    serial card run (state and costs), and the widest captured step (its
    ``dt`` padded past the servers, per-lane rows) held bitwise against
    the plain scan, twice, and timed beside its bound; the ``--smoke``
    gates of ``fig9``, ``fig10``, ``sweep_bench`` (at 20,000 requests)
    and ``replay_bench`` (a 10,000-request batch-1 head); ``table1``; and
    the fig5 and fig6 grids on a 20,000-request head swept on the card and
    equal to serial CPU runs at 1e-9;
13e. ``mesh``: the ``row_sharded`` state layout on logical meshes of
    cuda:0 (``make_sweep_mesh(devices=["cuda:0"] * 4)``): a
    200,000-request head of ``hetero-catalog-10k`` with ``akpc`` (the host
    schedule: per-server dt, so ``seg_scan_step`` once a live step and the
    host clique generation's kernels) over 4 row blocks, bit for bit the
    dense card run (state and costs) and its 5,000-request head equal to a
    CPU run on a logical CPU mesh at 1e-9; ``no_packing`` under table1 on
    a synthetic ``spotify`` catalog of 1,000,000 items x 600 servers
    (1,000,000 requests; a 4.8 GB dense ``E``, 1.2 GB a block) over 4 row
    blocks, bit for bit the dense card run, with the per-device state
    bytes, the peak device memory and walls of both runs and the routed
    block accesses a step; and fig10's grid on a 100,000-request head
    swept on a 2 x 2 ("scenario", "state_row") mesh, every point equal to
    the mesh-less sweep (state float for float, costs at 1e-9);
13f. ``serve_model``: the model zoo's decoder family and the
    continuous-batching ``BatchedServer``: granite-moe-3b-a800m at its
    full config (32 layers, d 1536, 40 experts top-8 padded to 48, vocab
    49,155, bf16, weights from a seeded generator) serves 16 requests of
    4-12 prompt tokens and 16 new tokens each (batch 8, cache 256) while
    the AKPC ``ExpertCacheManager`` (2 hosts, T_CG 24, on the card) watches
    layer 0's routing; decode ms a step (CUDA events, median of the steady
    steps), tokens/s, parameter bytes, peak memory and the expert cache's
    totals; every kernel of the path launched, the manager's CGM kernels
    and the ``packed_lookup`` gather of a step's cliques of layer 0's
    ``wi`` (7.9 MB clique rows, ``stream``) bitwise against their plain
    versions; staggered == solo on the card; and the six decoder-family
    configs at full width cut to 2 layers, the card's ``decode_step``
    logits and cache rows within ``CROSS_TOL`` of the port's CPU run on
    the same weights over 4 steps at staggered positions;
13g. ``serve_families``: the remaining model families.  zamba2-1.2b at
    its full config (38 layers: 6 groups of 6 mamba-2 layers under one
    shared attention block, then 2; d 2048, d_state 64, bf16, seeded
    weights) serves serve_model's 16 requests (batch 8, cache 256), with
    decode ms a step against the step's byte bound (weights, the f32 SSM
    state read and written, the shared block's K/V); deepseek-v2 at full
    width cut to its dense prefix layer and one MoE layer (MLA, 160
    routed experts top-6 and 2 shared, vocab 102,400) serves the same
    requests with the AKPC ``ExpertCacheManager`` (160 experts, 2 hosts,
    T_CG 24) on the MoE layer's routing, then gathers the last step's
    cliques of that layer's ``wi`` (78.6 MB clique rows, ``stream``): every
    kernel of the path launched, held bitwise against its plain version
    on the captured inputs and timed; xlstm-125m and whisper-tiny at
    their full configs, zamba2 at full width cut to 8 layers and the
    2-layer deepseek-v2, ``prefill`` then 4 ``decode_step``s at staggered
    positions on the card within ``CROSS_TOL`` of the port's CPU run on
    the same weights (logits and every cache or state leaf); staggered ==
    solo on the card for zamba2, xlstm and whisper;
13h. ``train``: the training path.  qwen2.5-3b at its full config (36
    layers, d 2048, vocab 151,936, bf16, seeded weights) trains on
    4,096-position batches of 2 microbatches of 1 row, every layer
    rematerialised: 3 AdamW steps and one more under ``torch.profiler``
    (kernels a step, device-busy time, idle share), then 2 steps of 8-bit
    AdamW with error-feedback compression; step seconds, tokens/s, peak
    memory, the model-FLOP share of the bf16 peak, finite losses and grad
    norms.  Then, for qwen2.5-3b at full width cut to 2 layers (512
    positions at a 256-position attention chunk: the chunked
    attention and its backward), granite-moe at
    full width cut to 2 layers and the f32 smoke configs of deepseek-v2,
    zamba2, xlstm, whisper and phi-3-vision: the train step's mean loss
    and gradient over both microbatches on the card against the CPU
    (``TRAIN_F32_TOL`` / CROSS_TOL of each leaf's largest; granite's in
    f32, its bf16 gap printed beside the CPU's own bf16-against-f32 gap),
    each train step twice on the card from one state (equal bits), each
    whole step's loss and grad norm against the CPU's whole step, and each
    optimizer update of the mean gradient on the card against the CPU
    (parameters and state at the same tolerances, 8-bit codes at most one
    unit apart).  Last, ``python -m
    repro_torch.examples.train_lm`` at its defaults on the card, without
    and with a failure at step 60: equal final parameters bit for bit,
    one restart, the loss falling, the shard cache's ``crm_update``,
    ``clique_pair_edges`` and ``merge_density`` once a window;
13i. ``prod_mesh``: the production mesh's expert-parallel branches on
    the card, full-width granite-moe-3b-a800m under a logical (data 2,
    model 4) mesh of one card.  The dry run's ``decode_32k`` cell cut to 8
    rows x 4,096 cached positions (``launch.specs.build_cell`` /
    ``instantiate_cell``; the weight-stationary branch in every layer), 4
    steps meshed and unmeshed: ms a step both ways in bf16, the logits
    held in f32 at ``TRAIN_F32_TOL`` (bf16 gaps printed).  A 2-layer f32
    cut trained on 2 microbatches of 4 x 512 positions (the token-sharded
    branch): ``make_train_step(mesh=)`` and the mean gradient on the card
    against the CPU under a CPU mesh of the same shape, the meshed loss
    beside the unmeshed one;
13j. ``dryrun``: ``launch.dryrun.run_cell`` for qwen2.5-3b x
    ``decode_32k`` and deepseek-v2-236b x ``train_4k`` on both production
    meshes (meta tensors; each record printed, each ``ok``); the decode
    cell above on a (1, 1) mesh made real on the card, its allocation
    within 1% of the dry run's argument bytes, one step's peak printed
    beside the dry run's;
13k. ``examples``: ``python -m repro_torch.examples.quickstart`` at 20,000
    requests on the card and on the CPU: every run's costs equal at 1e-9,
    the streamed total equal to the offline one, rows 1-3 and 6 launched;
14. prints the kernels' JSON line and, last, the result line.

Exits non-zero without CUDA, and on any failed check or exception.
Writes the kernel build log (and ``--profile`` tables) under ``--out``
(default ``smoke_out/``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time
import traceback
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.bench import (  # noqa: E402
    common as bench_common,
    fig5,
    fig6,
    fig7,
    fig8,
    fig9,
    fig10,
    fig11,
    kernel_bench,
    replay_bench,
    sweep_bench,
    table1,
)
from repro_torch.bench.common import (  # noqa: E402
    PEAK_BF16,
    PEAK_BYTES,
    PEAK_FP32,
    PEAK_TF32,
    bound,
    cuda_graph_time,
    cuda_time,
    product_ops,
    t_cg_for,
)
from repro_torch.bench.sweep_bench import (  # noqa: E402
    assert_parity,
    build_grid,
    env_for,
    fig10_points,
    same_costs,
)
from repro_torch.core import (  # noqa: E402
    CacheEnvironment,
    CacheSession,
    CacheState,
    CliquePartition,
    CostParams,
    SweepEngine,
    SweepPoint,
    adversarial_trace,
    competitive_bound_corrected,
    generalized_per_request_ratio_check,
    get_cost_model,
    get_policy,
    per_request_ratio_check,
    replay_adversary,
    run_policy,
)
from repro_torch.core import cliques as port_cliques  # noqa: E402
from repro_torch.core.cgm_schedule import (  # noqa: E402
    build_cgm_schedule,
    policy_hot_dims,
)
from repro_torch.core.replay import (  # noqa: E402
    TorchReplayEngine,
    cost_spec,
    run_policy_torch,
    run_schedule,
    state_to_device,
)
from repro_torch.core.state_layout import StateLayout  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_sweep_mesh,
    make_test_mesh,
)
from repro_torch.kernels.merge_step import (  # noqa: E402
    merge_density_lanes_plain,
)
from repro_torch.kernels import (  # noqa: E402
    KERNELS,
    _build,
    capture,
    clique_pair_edges,
    clique_pair_edges_plain,
    crm_update,
    crm_update_plain,
    merge_density,
    merge_density_plain,
    packed_lookup,
    packed_lookup_plain,
    seg_running_argmax,
    seg_running_argmax_plain,
    seg_running_max,
    seg_running_max_plain,
    seg_scan_step,
    seg_scan_step_plain,
    unpacked_lookup,
    unpacked_lookup_plain,
)
from repro_torch.data import PackedDataPipeline, ShardStore  # noqa: E402
from repro_torch.learned import hindsight_windows, train_policy  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    quickstart,
    serve_moe_expert_cache as moe_example,
    train_lm,
)
from repro_torch.launch.dryrun import run_cell  # noqa: E402
from repro_torch.launch.specs import (  # noqa: E402
    arg_bytes,
    build_cell,
    instantiate_cell,
    trace_cell,
)
from repro_torch.launch.train import (  # noqa: E402
    accumulate_gradients,
    apply_gradients,
    make_eval_step,
    make_train_step,
)
from repro_torch.models.shard_ctx import recording_collectives  # noqa: E402
from repro_torch.models import build_model, value_and_grad  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, ef_init  # noqa: E402
from repro_torch.optim.adamw8bit import adamw8bit_init  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.common import tree_leaves as param_leaves  # noqa: E402,E501
from repro_torch.serving import (  # noqa: E402
    BatchedServer,
    ExpertCacheManager,
    LiveServingEngine,
    Request,
)
from repro_torch.traces import SynthConfig, paper_trace, synth_trace  # noqa: E402

#: (omega, gamma) cases of the merge_density check: the path's default
#: and two that let other pair sizes and every density through
MERGE_CASES = ((5, 0.85), (3, 0.0), (4, 0.6))
SOURCES = {
    "crm_update": ("src/repro_torch/csrc/crm_update.cu",
                   "src/repro/kernels/crm_update.py:45"),
    "clique_pair_edges": ("src/repro_torch/csrc/clique_density.cu",
                          "src/repro/kernels/clique_density.py:41"),
    "merge_density": ("src/repro_torch/csrc/merge_step.cu",
                      "src/repro/kernels/merge_step.py:53"),
    "seg_running_argmax": ("src/repro_torch/csrc/segment_reduce.cu",
                           "src/repro/kernels/segment_reduce.py:108"),
    "seg_running_max": ("src/repro_torch/csrc/segment_reduce.cu",
                        "src/repro/kernels/segment_reduce.py:95"),
    "packed_lookup": ("src/repro_torch/csrc/packed_lookup.cu",
                      "src/repro/kernels/packed_lookup.py:61"),
    "unpacked_lookup": ("src/repro_torch/csrc/packed_lookup.cu",
                        "src/repro/kernels/packed_lookup.py:79"),
}
#: the kernels of the AKPC replay with the device clique generation
CGM_KERNELS = ("crm_update", "clique_pair_edges", "merge_density")
#: timed calls of a kernel (and of its plain version and library call) on
#: a captured input: at 10-50 us a call, fewer would sit inside the host's
#: jitter
REPS = 100
#: the standalone scan kernels, and the one launch of both that the
#: host-schedule replay makes a step under per-server dt
SEG_KERNELS = ("seg_running_argmax", "seg_running_max")
STEP = "seg_scan_step"
#: servers of the ragged and lane step checks' dt (hetero-table2's m)
STEP_SERVERS = 600
#: requests of each configuration's head that also run on the CPU
HEAD = {"netflix-table2": 20_000, "catalog-10k": 5_000,
        "hetero-table2": 20_000, "hetero-catalog-10k": 5_000}
#: fig10's server-price skew (lognormal sigma of lam_j / mu_j)
PRICE_SIGMA = 1.0
#: ragged scan lengths (the replay's step width is about 8192)
RAGGED_L = (1, 7, 8191, 8193, 100_000)
#: lane-form scan checks: (lanes S, length L)
LANE_CASES = ((1, 9), (3, 7), (8, 8193), (64, 1000))
#: fig6's sweep grid (sweep_bench's defaults) and the points of it held
#: against serial card runs: every rho at the two end alphas
FIG6_ALPHAS, FIG6_RHOS = 64, 4
#: requests of the fig6 head whose 256 points also run serially on the CPU
FIG6_CPU_HEAD = 10_000
#: ragged unpacked lookups: row widths, element types, requests
RAGGED_D = (1, 3, 255, 256)
RAGGED_DTYPES = (torch.int32, torch.float32, torch.float64)
#: the lookups' copy paths every check run must reach
LOOKUP_PATHS = ("narrow", "vector", "sliced", "ragged")
#: the program's named profiler spans (``repro_torch.spans``)
SPANS = ("cgm.", "replay.", "host.", "host_cgm.", "live.")
#: the serve phase: requests an arrival slice, a dispatched chunk, the
#: ring's depth (the reference serving bench's), the head streamed again
#: with the plain versions, and the mid-flight snapshot's cut in that head
#: (two chunks dispatched, 77 requests buffered)
SERVE_SLICE, SERVE_CHUNK, SERVE_RING = 128, 65_536, 6
SERVE_HEAD, SERVE_CUT = 200_000, 2 * 65_536 + 77
#: the port's functions a host sync of the live host-schedule path may
#: come from, by kind (``SyncCounter``); any other sync is "other"
SYNC_KINDS = {"gather": "lookup", "crm_matmul": "host_cgm",
              "pair_edges": "host_cgm", "_sync_costs": "costs",
              "_sync_state": "state"}


#: the fig7 phase: the CPU head of the 17-lane netflix akpc group, and a
#: 3-lane theta group on catalog-10k (top_frac 0.1: the hot space h 1024)
#: over a head of its trace, each lane against a serial card run.  The
#: catalog group's time follows its windows (a head of 100,000 requests,
#: 20 windows, was half of the phase): cut twice, to 25,000, to keep the
#: script well inside its limit beside the train phase
FIG7_CPU_HEAD = 20_000
FIG7_CATALOG_THETAS, FIG7_CATALOG_TOP_FRAC = (0.15, 0.2, 0.3), 0.1
FIG7_CATALOG_HEAD = 25_000


#: the learned phase: fig11's regime-shift stress trace, trained on the
#: training seed, evaluated on seed 101 under both pricing models; the
#: head also replayed with the plain versions and on the CPU; the trainer's bar on the card against
#: the CPU (tests/test_torch_learned.py's TRAIN_LEAF_RTOL); the rivals
#: ranked beside ``learned``
LEARNED_EVAL_SEED = 101
LEARNED_HEAD = 200_000
TRAIN_LEAF_RTOL = 1e-5
LEARNED_RIVALS = ("no_packing", "ttl", "packcache", "dp_greedy")
#: the sweep_shards phase: fig11's eval-seed shard axis, each shard cut
#: from fig11's run size to this many requests (the phase's time limit)
SHARD_REQUESTS = 200_000
#: the competitive phase: the adversary's (S, omega) of
#: tests/test_competitive.py, the per-request checks' trace, the
#: partition they start from (twelve cliques of five items) and the
#: tolerance of the card against the CPU (sums taken in another order)
ADVERSARY_CASES = ((1, 5), (2, 5), (5, 5), (3, 8), (1, 2))
RATIO_REQUESTS = 1500
RATIO_RTOL = 1e-12
#: the pipeline phase: ShardStore's defaults (256 shards x 4,096 tokens,
#: vocab 32,000, 8 domains), 64 rows of 2,048 tokens a step, T_CG 64
PIPE_ROWS, PIPE_SEQ, PIPE_TCG, PIPE_STEPS = 64, 2048, 64.0, 1000
#: the expert-cache phase: DeepSeek-V2's routing (160 routed experts,
#: top-6; ``src/repro/configs/deepseek_v2_236b.py``), 4 hosts, T_CG 32,
#: 256 tokens a step; experts co-activate in fixed groups of 8, one hot;
#: a live snapshot at EXPERT_CUT restored into a session manager
EXPERTS, EXPERT_TOP_K, EXPERT_GROUP = 160, 6, 8
EXPERT_HOSTS, EXPERT_TCG, EXPERT_TOKENS = 4, 32.0, 256
EXPERT_STEPS, EXPERT_CUT, EXPERT_HOT = 5000, 2500, 0.7
#: the packed-table gather at Granite-MoE's expert width (40 experts,
#: top-8, wi / wg / wo of 1536 x 512 f16 each; ``src/repro/configs/
#: granite_moe_3b_a800m.py``)
GATHER_EXPERTS, GATHER_TOP_K, GATHER_ROW = 40, 8, (3, 1536, 512)
#: the figures phase: requests of each trace of the bucketed
#: heterogeneous grid and of the fig5 / fig6 heads, and the cuts of the
#: sweep and replay benchmarks' smoke runs (printed when they run)
FIG_HETERO_REQUESTS = 20_000
FIG_HEAD = 20_000
FIG_SWEEP_BENCH_REQUESTS = 20_000
FIG_REPLAY_CAP = 10_000
GATHER_STEPS = 400
#: CUDA-graph calls of the expert gather (each copies tens of MB)
GATHER_CALLS = 10
#: the mesh phase: row blocks of the logical mesh, the hetero-catalog-10k
#: head, the 10^6-item catalog (items, servers, requests) and the fig10
#: head swept on a (devices, state_rows) = (4, 2) mesh: 2 x 2
MESH_SHARDS = 4
MESH_HEAD = 200_000
MESH_BIG = (1_000_000, 600, 1_000_000)
MESH_FIG10_REQUESTS = 100_000
MESH_SWEEP = (4, 2)


def make_trace(config: str, n_requests: int, seed: int):
    """The configuration's trace.  ``hetero-*`` take the same request
    stream as their table1 twin with fig10's lognormal item sizes."""
    if config == "netflix-table2":
        return paper_trace("netflix", n_requests, seed)
    if config == "hetero-table2":
        # paper_trace's Table-II SynthConfig with size_dist="lognormal"
        return synth_trace(SynthConfig(
            kind="netflix", n_items=60, n_servers=600, n_requests=n_requests,
            t_max=6.0 * n_requests / 100_000.0, bundle_cover=1.0,
            bundle_zipf=0.7, server_affinity=2, mean_session_len=6.0,
            seed=seed, size_dist="lognormal"))
    return synth_trace(SynthConfig(
        kind="spotify", n_items=10_000, n_servers=600, n_requests=n_requests,
        t_max=60.0 * n_requests / 1_000_000, bundle_cover=1.0,
        bundle_zipf=0.7, seed=seed,
        size_dist="lognormal" if config.startswith("hetero") else "unit"))


def akpc(t_cg: float):
    return get_policy("akpc", params=CostParams(), t_cg=t_cg, top_frac=0.1)


def host_policy(name: str, t_cg: float, env, cost_model: str):
    """fig5's method set (``benchmarks/common.py::method_policies``) at
    top_frac 0.1, priced by ``cost_model`` in ``env``."""
    kw = {"no_packing": {}, "ttl": dict(t_cg=t_cg),
          "dp_greedy": dict(top_frac=0.1),
          "packcache": dict(t_cg=t_cg, top_frac=0.1),
          "akpc": dict(t_cg=t_cg, top_frac=0.1)}[name]
    return get_policy(name, params=CostParams(), env=env,
                      cost_model=cost_model, **kw)


def path_inputs(rng, h: int, wcap: int, dev):
    """Inputs at the main path's shapes: a (wcap, h) incidence with <= 5
    hot slots a request row (taken from a (wcap, h+1) buffer as the path
    does), a (2h, h) membership and an (h, h) symmetric binary CRM."""
    Hbuf = torch.zeros((wcap, h + 1), dtype=torch.float32)
    cols = torch.from_numpy(rng.integers(0, h + 1, size=(wcap, 5)))
    Hbuf[torch.arange(wcap)[:, None].expand(wcap, 5), cols] = 1.0
    S = 2 * h
    M = torch.zeros((S, h), dtype=torch.float32)
    grp = torch.from_numpy(rng.integers(0, h, size=h))
    M[grp, torch.arange(h)] = 1.0
    A = torch.from_numpy(rng.random((h, h)) < 0.05)
    A = (torch.triu(A, 1) | torch.triu(A, 1).T).to(torch.float32)
    return Hbuf.to(dev)[:, :h], M.to(dev), A.to(dev)


def dense_inputs(rng, h: int, dev):
    """A (2h, h) membership with the h slots in h // 2 groups and an
    (h, h) CRM at edge density 0.9: pair densities spread across gamma,
    so merge_density's arithmetic decides which entries pass."""
    S = 2 * h
    M = torch.zeros((S, h), dtype=torch.float32)
    grp = torch.from_numpy(rng.integers(0, max(2, h // 2), size=h))
    M[grp, torch.arange(h)] = 1.0
    A = torch.from_numpy(rng.random((h, h)) < 0.9)
    A = (torch.triu(A, 1) | torch.triu(A, 1).T).to(torch.float32)
    return M.to(dev), A.to(dev)


def _equal(got, want) -> tuple[bool, float]:
    """Bitwise equality and max abs error of a tensor or a tuple of them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    eq = all(torch.equal(a, b) for a, b in zip(got, want))
    err = 0.0
    for a, b in zip(got, want):
        if a.numel():
            d = (a.to(torch.float64) - b.to(torch.float64)).abs()
            d = torch.nan_to_num(d, nan=0.0)   # -inf - -inf at equal bits
            err = max(err, float(d.max()))
    return eq, err


def held_equal(report: list, name, label, kern, plain) -> float:
    """Run a kernel twice and its plain version once; fail unless the two
    kernel runs give the same bits (the order of its atomics must not
    matter) and agree with the plain version bit for bit.  Appends the
    check to ``report``; returns the max abs error."""
    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    if not _equal(got, again)[0]:
        raise AssertionError(f"{name} gave other bits on a second call on "
                             f"{label}")
    eq, err = _equal(got, want)
    report.append({"kernel": name, "inputs": label, "equal": eq})
    if not eq:
        raise AssertionError(f"{name} differs from its plain version on "
                             f"{label}: max abs err {err}")
    return err


def pair_bound(name: str, args: tuple) -> dict:
    """The bound of ``crm_update`` (H) or ``clique_pair_edges`` (M, A) at
    these inputs: each input read once, the output written once, the 0/1
    products' multiply-adds at the TF32 peak."""
    if name == "crm_update":
        (H,) = args
        rows, h = H.shape
        return bound(product_ops(H.T, H), PEAK_TF32, 4.0 * (rows * h + h * h))
    M, A = args
    S, h = M.shape
    return bound(product_ops(M, A) + product_ops(M @ A, M.T), PEAK_TF32,
                 4.0 * (S * h + h * h + S * S))


def worst_phase(report: list, seed: int, dev) -> dict:
    """``crm_update`` and ``clique_pair_edges`` on the inputs their sparse
    designs could get wrong (``kernel_bench.worst_cases``): twice, bitwise
    against the plain version, and timed.  Returns records by kernel and
    label."""
    calls = {"crm_update": (crm_update, crm_update_plain, lambda H: H.T @ H),
             "clique_pair_edges": (clique_pair_edges, clique_pair_edges_plain,
                                   lambda M, A: M @ A @ M.T)}
    records: dict = {}
    for name, label, args in kernel_bench.worst_cases(dev, seed):
        kern, plain, lib = (lambda f=f, a=args: f(*a) for f in calls[name])
        err = held_equal(report, name, f"worst {label}", kern, plain)
        records.setdefault(name, {})[label] = {
            "shape": [list(a.shape) for a in args], "max_abs_err": err,
            "ms": cuda_time(kern, 3), "plain_ms": cuda_time(plain, 3),
            "library_ms": cuda_time(lib, 3), **pair_bound(name, args)}
    return records


def cgm_cases(cap: dict) -> dict:
    """The device CGM's kernels on the inputs ``cap`` captured from a run,
    by name: (kernel call, plain call, library call or None, bound)."""
    (H,) = cap["crm_update"]
    M, A = cap["clique_pair_edges"]
    X, sizes, omega, g32, k0 = cap["merge_density"]
    return {
        "crm_update": (lambda: crm_update(H), lambda: crm_update_plain(H),
                       lambda: H.T @ H, pair_bound("crm_update", (H,))),
        "clique_pair_edges": (
            lambda: clique_pair_edges(M, A),
            lambda: clique_pair_edges_plain(M, A),
            lambda: M @ A @ M.T,
            pair_bound("clique_pair_edges", (M, A))),
        # the main path's call: D with the act mask of its k0 groups
        "merge_density": (
            lambda: merge_density(X, sizes, omega, g32, n_act=k0),
            lambda: merge_density_plain(X, sizes, omega, g32, n_act=k0),
            None, kernel_bench.merge_bound(sizes, omega, k0)),
    }


def kernel_phase(shapes: dict, captured: dict, seed: int, dev
                 ) -> tuple[dict, dict]:
    """The device clique generation's kernels: bitwise against their plain
    versions on synthetic inputs at each configuration's shapes and at
    ragged ones, on the worst cases of the sparse designs, and on the
    inputs captured from each configuration's replay, on which they are
    timed (``merge_density`` in both modes, beside the mask chain its
    masked mode replaces).  Returns per-kernel timing records by
    configuration, the worst cases' records and the synthetic merges'
    records."""
    rng = np.random.default_rng(seed)
    records: dict = {}
    merges: dict = {}
    ragged = {"ragged": (37, 1001), "ragged-wide": (1000, 3333)}
    report: list = []

    def held(*a):
        return held_equal(report, *a)

    for label, (h, wcap) in {**shapes, **ragged}.items():
        H, M, A = path_inputs(rng, h, wcap, dev)
        Md, Ad = dense_inputs(rng, h, dev)
        X = clique_pair_edges_plain(Md, Ad)
        sizes = Md.sum(dim=1).to(torch.int32)
        for omega, g in MERGE_CASES:
            g32 = float(np.float32(g))
            want = merge_density_plain(X, sizes, omega, g32)
            if not ((want >= 0).any() and (want < 0).any()):
                raise AssertionError(
                    f"merge_density check at {label} (omega={omega}, "
                    f"gamma={g}) has no pair on one side of the gate")
            held("merge_density", f"synthetic {label} omega={omega} "
                 f"gamma={g} ({int((want >= 0).sum())} passing pairs)",
                 lambda: merge_density(X, sizes, omega, g32),
                 lambda: want)
            if label in shapes:
                merges[f"synthetic {label} unmasked omega={omega} "
                       f"gamma={g}"] = {
                    "shape": {"S": X.shape[0], "n_act": None},
                    "device_ms": cuda_graph_time(
                        lambda: merge_density(X, sizes, omega, g32), REPS),
                    **kernel_bench.merge_bound(sizes, omega)}
            S = X.shape[0]
            for k in (0, 1, 2, S // 3, S - 1, S):
                held("merge_density", f"synthetic {label} omega={omega} "
                     f"gamma={g} n_act={k}",
                     lambda: merge_density(X, sizes, omega, g32, n_act=k),
                     lambda: merge_density_plain(X, sizes, omega, g32,
                                                 n_act=k))
        held("clique_pair_edges", f"synthetic {label} (dense A)",
             lambda: clique_pair_edges(Md, Ad), lambda: X)
        gamma = float(np.float32(0.85))
        held("crm_update", f"synthetic {label}", lambda: crm_update(H),
             lambda: crm_update_plain(H))
        held("clique_pair_edges", f"synthetic {label}",
             lambda: clique_pair_edges(M, A),
             lambda: clique_pair_edges_plain(M, A))
        held("merge_density", f"synthetic {label}",
             lambda: merge_density(X, sizes, 5, gamma),
             lambda: merge_density_plain(X, sizes, 5, gamma))

    for label in shapes:
        cap = captured[label]
        (H,) = cap["crm_update"]
        M, A = cap["clique_pair_edges"]
        X, sizes, omega, g32, k0 = cap["merge_density"]
        wcap, h = H.shape
        S = M.shape[0]
        for name, (kern, plain, lib, bnd) in cgm_cases(cap).items():
            err = held(name, f"captured {label}", kern, plain)
            records.setdefault(label, {})[name] = {
                "shape": {"h": h, "wcap": wcap, "S": S,
                          "captured_size": cap["sizes"][name]},
                "inputs": "captured",
                "max_abs_err": err,
                "ms": cuda_time(kern, REPS),
                "plain_ms": cuda_time(plain, REPS),
                "library_ms": cuda_time(lib, REPS) if lib else None,
                **kernel_bench.device_times(kern, lib, REPS),
                **bnd,
            }
        records[label]["merge_density"].update(
            merge_extras(report, X, sizes, omega, g32, k0))
    worst = worst_phase(report, seed, dev)
    print("kernels " + json.dumps(report), flush=True)
    print("kernels_worst " + json.dumps(worst), flush=True)
    print("kernels_merge " + json.dumps(
        {**{c: r["merge_density"] for c, r in records.items()}, **merges}),
        flush=True)
    return records, worst, merges


def mask_chain(D, act):
    """The act mask as the merge applied it after the kernel until the
    masked mode took it over: eye, act pairs, where."""
    eyeS = torch.eye(D.shape[0], dtype=torch.bool, device=D.device)
    actp = act[:, None] & act[None, :] & ~eyeS
    return torch.where(actp, D, -2.0)


def merge_extras(report: list, X, sizes, omega, g32, k0) -> dict:
    """The captured merge input's other numbers: the act count, the
    unmasked mode (the TPU kernel's function) held and timed, and the mask
    chain that the masked mode replaces, on the card alone."""
    unmasked = lambda: merge_density(X, sizes, omega, g32)      # noqa: E731
    plain = lambda: merge_density_plain(X, sizes, omega, g32)   # noqa: E731
    err = held_equal(report, "merge_density", "captured unmasked", unmasked,
                     plain)
    D0 = unmasked()
    act = torch.arange(X.shape[0], device=X.device) < k0
    want = merge_density_plain(X, sizes, omega, g32, n_act=k0)
    if not torch.equal(mask_chain(D0, act), want):
        raise AssertionError("the mask chain differs from the masked mode")
    return {
        "n_act": k0,
        "mask_chain_device_ms": cuda_graph_time(
            lambda: mask_chain(D0, act), REPS),
        "unmasked": {"max_abs_err": err, "ms": cuda_time(unmasked, REPS),
                     "plain_ms": cuda_time(plain, REPS),
                     "device_ms": cuda_graph_time(unmasked, REPS),
                     **kernel_bench.merge_bound(sizes, omega)},
    }


def full_merge(bench_recs: list) -> dict:
    """The kernel bench's record of ``merge_density`` at the full merge's
    S 20,000 (``catalog-10k``'s 2n), masked at k 10,000."""
    S = kernel_bench.BIG_SLOTS
    for r in bench_recs:
        if (r["name"] == "merge_density" and r["shape"]["S"] == S
                and r["shape"]["n_act"] == S // 2):
            return {**r, "inputs": "synthetic (kernel bench)"}
    raise AssertionError(f"the kernel bench has no merge_density row at "
                         f"S {S}")


def same_state(a, b) -> None:
    if not np.array_equal(a.partition.clique_of, b.partition.clique_of):
        raise AssertionError("final partitions differ")
    if not (np.array_equal(a.E, b.E) and np.array_equal(a.anchor, b.anchor)):
        raise AssertionError("final E/anchor differ")


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def slice_phase(config: str, trace, t_cg: float) -> tuple[dict, dict]:
    """The main path on the card, its plain-version twin and a CPU head.
    Returns the ``slice`` record and the kernels' inputs captured from the
    card run."""
    head = trace.slice(0, min(HEAD[config], trace.n_requests))
    t_head = t_cg_for(head)
    gpu_head = run_policy(akpc(t_head), head)
    cpu_head = run_policy(akpc(t_head), head, device="cpu")
    if gpu_head.n_windows < 2:
        raise AssertionError(f"{config}: the CPU check's head has "
                             f"{gpu_head.n_windows} windows")
    same_state(gpu_head.state, cpu_head.state)
    same_costs(gpu_head, cpu_head, f"{config} CPU head")

    reset_launches()
    capture.INPUTS = {}
    torch.cuda.synchronize()
    res = run_policy(akpc(t_cg), trace)
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    captured = {k: v[1] for k, v in capture.INPUTS.items()}
    captured["sizes"] = {k: v[0] for k, v in capture.INPUTS.items()}
    capture.INPUTS = None
    for name in CGM_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{config}: kernel {name} never launched")
    if launches["merge_density"] != res.n_windows:
        raise AssertionError(
            f"{config}: {launches['merge_density']} merge_density launches "
            f"for {res.n_windows} windows (one merge a window)")
    plain = run_policy_torch(akpc(t_cg), trace, use_kernels=False)
    if any(fn.launches != launches[name] for name, fn in KERNELS.items()):
        raise AssertionError("the plain run launched a kernel")
    same_state(res.state, plain.state)
    same_costs(res, plain, f"{config} plain")
    total = res.total
    if not (np.isfinite(total) and total > 0.0):
        raise AssertionError(f"total cost {total} is not a positive number")
    if res.costs.n_requests != trace.n_requests or res.n_windows < 2:
        raise AssertionError("the replay did not cover the trace's windows")
    sizes = res.clique_sizes
    out = {
        "config": config, "n": trace.n, "m": trace.m,
        "requests": trace.n_requests, "t_cg": t_cg,
        "windows": res.n_windows, "total_cost": total,
        "transfer": res.transfer, "caching": res.caching,
        "cliques": int(sizes.size), "max_clique": int(sizes.max()),
        "wall_s": res.wall_seconds,
        "requests_per_s": trace.n_requests / res.wall_seconds,
        "plain_wall_s": plain.wall_seconds,
        "loop_stats": res.loop_stats, "launches": launches,
        "cpu_head_requests": head.n_requests,
        "cpu_head_windows": cpu_head.n_windows,
        "costs": res.costs.as_dict(),
    }
    print("slice " + json.dumps(out), flush=True)
    return out, captured


def sync_check(pol, trace) -> int:
    """Replay ``trace`` once through the engine to get its schedule, then
    run the scan alone again under ``torch.cuda.set_sync_debug_mode
    ("error")``: any host sync in the loop raises.  Returns its steps."""
    env = CacheEnvironment.resolve(pol.env, trace, pol.params)
    pol.bind(trace.n, trace.m)
    eng = TorchReplayEngine(trace.n, trace.m, pol.params, env=env,
                            cost_model=pol.cost_model,
                            caching_charge=pol.caching_charge)
    part0 = pol.initial_partition(trace)
    if part0 is not None:
        eng.install_partition(part0, now=0.0)
    eng.replay(trace, clique_generator=pol.on_window if pol.t_cg else None,
               t_cg=pol.t_cg)
    E0, a0 = state_to_device(CacheState.fresh(
        eng.last_schedule.partition0, trace.m), trace.n, eng.device)
    stats: dict = {}
    run_schedule(eng.last_schedule, eng._spec, eng._statics, E0, a0,
                 charge=eng.engine.caching_charge, stats=stats,
                 check_syncs=True)
    torch.cuda.synchronize()
    return stats["steps"]


def slice2_phase(config: str, trace, names, cost_model: str,
                 capture_name: str | None = None) -> tuple[dict, dict]:
    """The host-schedule replay of each policy: a CPU head equal to the
    card's, the card run (expected kernels launched), the plain-version
    run on the card (no launch, equal state and costs).  Returns the
    ``slice2`` records by policy and the inputs captured from the run of
    ``capture_name``."""
    params = CostParams()

    def env_of(tr):
        if cost_model == "heterogeneous":
            return env_for(tr, params, PRICE_SIGMA)
        return CacheEnvironment.from_trace(tr, params)

    env = env_of(trace)
    dt = np.asarray(get_cost_model(cost_model, env).dt(), np.float64)
    per_server = bool((dt != dt[0]).any())
    t_cg = t_cg_for(trace, params, env=env, cost_model=cost_model)
    head = trace.slice(0, min(HEAD[config], trace.n_requests))
    env_h = env_of(head)
    t_head = t_cg_for(head, params, env=env_h, cost_model=cost_model)
    out, captured = {}, {}
    for name in names:
        t0 = time.perf_counter()
        gpu_head = run_policy(host_policy(name, t_head, env_h, cost_model),
                              head)
        cpu_head = run_policy(host_policy(name, t_head, env_h, cost_model),
                              head, device="cpu")
        pol = host_policy(name, t_head, env_h, cost_model)
        if pol.t_cg is not None and gpu_head.n_windows < 2:
            raise AssertionError(f"{config}/{name}: the CPU check's head "
                                 f"has {gpu_head.n_windows} windows")
        same_state(gpu_head.state, cpu_head.state)
        same_costs(gpu_head, cpu_head, f"{config}/{name} CPU head")
        sync_steps = sync_check(pol, head)

        reset_launches()
        if name == capture_name:
            capture.INPUTS = {}
        torch.cuda.synchronize()
        res = run_policy(host_policy(name, t_cg, env, cost_model), trace)
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        if name == capture_name:
            captured = {k: v[1] for k, v in capture.INPUTS.items()}
            capture.INPUTS = None
        expect = ["packed_lookup"]
        if name == "akpc":
            expect += ["crm_update", "clique_pair_edges"]
        for k in expect:
            if launches[k] <= 0:
                raise AssertionError(f"{config}/{name}: kernel {k} never "
                                     "launched")
        st = res.loop_stats
        if st.get("path") != "host_schedule":
            raise AssertionError(f"{config}/{name} did not take the "
                                 "host-schedule replay")
        want_scans = st["steps"] if per_server else 0
        if launches[STEP] != want_scans or any(launches[k]
                                               for k in SEG_KERNELS):
            raise AssertionError(
                f"{config}/{name}: {launches[STEP]} seg_scan_step launches "
                f"for {st['steps']} steps (per-server dt {per_server}), "
                f"standalone {[launches[k] for k in SEG_KERNELS]}")
        plain = run_policy_torch(host_policy(name, t_cg, env, cost_model),
                                 trace, use_kernels=False)
        if any(fn.launches != launches[k] for k, fn in KERNELS.items()):
            raise AssertionError("the plain run launched a kernel")
        same_state(res.state, plain.state)
        same_costs(res, plain, f"{config}/{name} plain")
        total = res.total
        if not (np.isfinite(total) and total > 0.0):
            raise AssertionError(f"total cost {total} is not positive")
        if res.costs.n_requests != trace.n_requests:
            raise AssertionError("the replay did not cover the trace")
        if st["lookup_calls"] > res.n_windows + 1:
            raise AssertionError(
                f"{config}/{name}: {st['lookup_calls']} lookups for "
                f"{res.n_windows} windows (one a partition stretch)")
        sizes = res.clique_sizes
        line = {
            "config": config, "policy": name, "cost_model": cost_model,
            "per_server_dt": per_server, "n": trace.n, "m": trace.m,
            "requests": trace.n_requests, "t_cg": t_cg,
            "windows": res.n_windows, "total_cost": total,
            "transfer": res.transfer, "caching": res.caching,
            "cliques": int(sizes.size), "max_clique": int(sizes.max()),
            "wall_s": res.wall_seconds,
            "requests_per_s": trace.n_requests / res.wall_seconds,
            "schedule_s": st["schedule_s"], "cg_seconds": st["cg_s"],
            "lookup_s": st["lookup_s"], "lookup_calls": st["lookup_calls"],
            "lookup_bytes_up": st["lookup_bytes_up"],
            "lookup_table_uploads": st["lookup_table_uploads"],
            "lookup_table_bytes_up": st["lookup_table_bytes_up"],
            "schedule_rest_s": st["schedule_rest_s"],
            "scan_s": st["scan_s"], "steps": st["steps"],
            "installs": st["installs"], "nb": st["nb"], "ne": st["ne"],
            "sync_scan": st["sync_scan"], "sync_final": st["sync_final"],
            "sync_checked_steps": sync_steps,
            "seg_scan_launches": launches[STEP],
            "launches": launches, "plain_wall_s": plain.wall_seconds,
            "cpu_head_requests": head.n_requests,
            "cpu_head_windows": cpu_head.n_windows,
            "phase_s": time.perf_counter() - t0,
            "costs": res.costs.as_dict(),
        }
        print("slice2 " + json.dumps(line), flush=True)
        out[name] = line
    return out, captured


def scan_inputs(rng, L: int, starts: str, dev):
    """Ragged scan inputs: values from a few integers (ties everywhere)
    with -inf entries; starts all, first only, or random at p."""
    v = rng.integers(0, 4, size=L).astype(np.float64)
    v[rng.random(L) < 0.1] = -np.inf
    if starts == "all":
        s = np.ones(L, bool)
    elif starts == "first":
        s = np.zeros(L, bool)
        s[0] = True
    else:
        s = rng.random(L) < float(starts)
    return (torch.from_numpy(v).to(dev), torch.from_numpy(s).to(dev))


def step_operands(args):
    """Both scans' (S, L) operands of ``seg_scan_step``'s arguments, in
    the shared form or with per-lane rows, stacked (the yardstick's
    input)."""
    dt = args[6]
    if len(args) == 7:
        return torch.stack([args[0] + dt[:, args[1]],
                            args[3] + dt[:, args[4]]])
    rows = args[7]
    return torch.stack([args[0][rows] + dt.gather(1, args[1][rows]),
                        args[3][rows] + dt.gather(1, args[4][rows])])


def rows_step_record(report: list, args: tuple, label: str) -> dict:
    """``seg_scan_step`` on a captured step with per-lane event rows:
    bitwise against its plain version and against the loop of one
    shared-form launch a lane (each lane's row, its dt), both twice;
    timed, also on the card alone beside that loop (the yardstick) and
    its bound."""
    dt, rows = args[6], args[7]
    G, L = (int(d) for d in args[0].shape)
    S, m = (int(d) for d in dt.shape)
    per_lane = [tuple(a[r] for a in args[:6]) + (dt[s:s + 1],)
                for s, r in enumerate(rows.tolist())]

    def kern():
        return seg_scan_step(*args)

    def loop():
        return [seg_scan_step(*a) for a in per_lane]

    def stacked():
        outs = loop()
        return tuple(torch.cat([o[k] for o in outs]) for k in range(3))

    both = step_operands(args)
    err = held_equal(report, STEP, label,
                     kern, lambda: seg_scan_step_plain(*args))
    held_equal(report, STEP, f"{label} against the per-lane loop", kern,
               stacked)
    return {"shape": {"G": G, "S": S, "L": L, "m": m,
                      "segments": [int(args[2].sum()), int(args[5].sum())]},
            "max_abs_err": err, "ms": cuda_time(kern, REPS),
            "plain_ms": cuda_time(lambda: seg_scan_step_plain(*args), REPS),
            "library_ms": cuda_time(lambda: torch.cummax(both, dim=-1),
                                    REPS),
            **kernel_bench.device_times(
                kern, lambda: torch.cummax(both, dim=-1), REPS),
            "lane_loop_device_ms": cuda_graph_time(loop, REPS),
            "library_call": kernel_bench.SCAN_YARDSTICK,
            **kernel_bench.scan_bound(STEP, S, L, m, G)}


def kernel_phase2(captured: dict, seed: int, dev) -> dict:
    """The scan and gather kernels, and the CGM kernels at the host clique
    generation's shapes: bitwise against their plain versions on inputs
    captured from the replays and on ragged ones; timed on the captured
    inputs, also on the card alone.  Returns timing records by kernel and
    configuration."""
    rng = np.random.default_rng(seed)
    report: list = []
    records: dict = {}

    def held(*a):
        return held_equal(report, *a)

    for L in RAGGED_L:
        for starts in ("all", "first", "0.01", "0.5"):
            v, s = scan_inputs(rng, L, starts, dev)
            label = f"ragged L={L} starts={starts}"
            held("seg_running_argmax", label,
                 lambda: seg_running_argmax(v, s),
                 lambda: seg_running_argmax_plain(v, s))
            held("seg_running_max", label, lambda: seg_running_max(v, s),
                 lambda: seg_running_max_plain(v, s))
            args = kernel_bench.scan_step_inputs(rng, 1, L, starts,
                                                 STEP_SERVERS, dev)
            held(STEP, label, lambda: seg_scan_step(*args),
                 lambda: seg_scan_step_plain(*args))
    # the sweep's lane form: (S, L) values over one shared (L,) start vector,
    # against the plain version and against the one-lane kernel per lane
    for S, L in LANE_CASES:
        v = torch.stack([scan_inputs(rng, L, "first", dev)[0]
                         for _ in range(S)])
        s = scan_inputs(rng, L, "0.01", dev)[1]
        label = f"lanes S={S} L={L}"
        held("seg_running_argmax", label,
             lambda: seg_running_argmax(v, s),
             lambda: seg_running_argmax_plain(v, s))
        held("seg_running_max", label, lambda: seg_running_max(v, s),
             lambda: seg_running_max_plain(v, s))
        held("seg_running_max", label + " per lane",
             lambda: seg_running_max(v, s),
             lambda: torch.stack([seg_running_max(v[i].contiguous(), s)
                                  for i in range(S)]))
        args = kernel_bench.scan_step_inputs(rng, S, L, "0.01", STEP_SERVERS,
                                             dev)
        held(STEP, label, lambda: seg_scan_step(*args),
             lambda: seg_scan_step_plain(*args))
    for (C, om, d, R, dtype) in ((4096, 5, 128, 4096, torch.float32),
                                 (4096, 5, 128, 777, torch.float64),
                                 (61, 1, 1, 9999, torch.int32),
                                 (7, 3, 5, 1, torch.int32)):
        table = torch.from_numpy(rng.standard_normal((C, om, d)) * 100).to(
            dtype).to(dev)
        ids = torch.from_numpy(rng.integers(0, C, size=R).astype(
            np.int32)).to(dev)
        held("packed_lookup", f"ragged ({C}, {om}, {d}) {dtype} R={R}",
             lambda: packed_lookup(table, ids),
             lambda: packed_lookup_plain(table, ids))

    for cfg, cap in captured.items():
        cases = {}
        # the scans: the step's one launch, and each standalone kernel on
        # its (S, L) operand (S = 1 outside a sweep); torch.cummax is their
        # unsegmented yardstick
        for name, kern, plain in (
                ("seg_running_argmax", seg_running_argmax,
                 seg_running_argmax_plain),
                ("seg_running_max", seg_running_max, seg_running_max_plain)):
            if name in cap:
                v, s = cap[name]
                S, L = v.shape
                cases[name] = (
                    lambda k=kern, v=v, s=s: k(v, s),
                    lambda p=plain, v=v, s=s: p(v, s),
                    lambda v=v: torch.cummax(v, dim=-1),
                    kernel_bench.scan_bound(name, S, L,
                                            lane_starts=s.dim() == 2),
                    {"S": S, "L": L, "segments": int(s.sum()),
                     "lane_starts": s.dim() == 2})
        if STEP in cap:
            # the shared form, or (a cohort of schedules) per-lane rows
            args = cap[STEP]
            S, m = args[6].shape
            L = int(args[0].shape[-1])
            G = int(args[0].shape[0]) if len(args) > 7 else 1
            cases[STEP] = (
                lambda a=args: seg_scan_step(*a),
                lambda a=args: seg_scan_step_plain(*a),
                lambda b=step_operands(args): torch.cummax(b, dim=-1),
                kernel_bench.scan_bound(STEP, S, L, m, G),
                {"S": S, "L": L, "m": int(m), "G": G,
                 "segments": [int(args[2].sum()), int(args[5].sum())]})
        if "packed_lookup" in cap:
            clique_of, items = cap["packed_lookup"]
            table = torch.from_numpy(clique_of.astype(np.int32)).reshape(
                -1, 1, 1).to(dev)
            ids = torch.from_numpy(np.maximum(items, 0).reshape(-1).astype(
                np.int32)).to(dev)
            R = int(ids.shape[0])
            cases["packed_lookup"] = (
                lambda t=table, i=ids: packed_lookup(t, i, ids_checked=True),
                lambda t=table, i=ids: packed_lookup_plain(t, i),
                lambda t=table, i=ids: t.index_select(0, i),
                # the ids, each table entry they touch, the output
                bound(0.0, PEAK_FP32,
                      4.0 * R + 4.0 * int(torch.unique(ids).numel())
                      + 4.0 * R),
                {"C": int(table.shape[0]), "R": R})
        if "crm_update" in cap:
            (H,) = cap["crm_update"]
            Hd = torch.as_tensor(H).to(dev)
            rows, h = Hd.shape
            cases["crm_update"] = (
                lambda H=Hd: crm_update(H), lambda H=Hd: crm_update_plain(H),
                lambda H=Hd: H.T @ H, pair_bound("crm_update", (Hd,)),
                {"rows": int(rows), "h": int(h)})
        if "clique_pair_edges" in cap:
            M, A = cap["clique_pair_edges"]
            Md, Ad = torch.as_tensor(M).to(dev), torch.as_tensor(A).to(dev)
            S, h = Md.shape
            cases["clique_pair_edges"] = (
                lambda M=Md, A=Ad: clique_pair_edges(M, A),
                lambda M=Md, A=Ad: clique_pair_edges_plain(M, A),
                lambda M=Md, A=Ad: M @ A @ M.T,
                pair_bound("clique_pair_edges", (Md, Ad)),
                {"S": int(S), "h": int(h)})
        for name, (kern, plain, lib, bnd, shape) in cases.items():
            err = held(name, f"captured {cfg}", kern, plain)
            if name == "packed_lookup":
                # the path the kernel took on its own buffers just now
                shape = {**shape, "path": packed_lookup.last_path}
            rec = records.setdefault(name, {})[cfg] = {
                "shape": shape, "max_abs_err": err,
                "ms": cuda_time(kern, REPS),
                "plain_ms": cuda_time(plain, REPS),
                "library_ms": cuda_time(lib, REPS) if lib else None,
                **bnd,
            }
            rec.update(kernel_bench.device_times(kern, lib, REPS))
            if name in SEG_KERNELS or name == STEP:
                rec["library_call"] = kernel_bench.SCAN_YARDSTICK
    print("kernels2 " + json.dumps(report), flush=True)
    return records


def profile_phase(config: str, trace, make_policy, out_dir) -> dict:
    """Where the time goes: one unprofiled replay (wall clock), then the
    same replay under ``torch.profiler`` (device time by kernel, host time
    by span).  The idle share is 1 - device busy time / unprofiled wall.
    ``make_policy()`` gives a fresh policy for each replay."""
    from torch.profiler import ProfilerActivity, profile

    plain_wall = run_policy(make_policy(), trace).wall_seconds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_policy(make_policy(), trace)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    device: dict = {}         # kernels and copies on the device
    span_device: dict = {}    # device-side extent of each named span
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        into = span_device if e.name.startswith(SPANS) else device
        into[e.name] = into.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(device.values()) / 1e3
    spans: dict = {}          # host time inside each named span
    for e in evs:
        if e.key.startswith(SPANS):
            spans[e.key] = spans.get(e.key, 0.0) + e.cpu_time_total / 1e3
    top = sorted(device.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "config": config, "requests": trace.n_requests,
        "wall_ms": plain_wall * 1e3,
        "profiled_wall_ms": res.wall_seconds * 1e3,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (plain_wall * 1e3),
        "span_host_ms": spans,
        "span_device_ms": {k: v / 1e3 for k, v in span_device.items()},
        "launches_total": sum(e.count for e in evs
                              if e.key == "cudaLaunchKernel"),
        "device_kernels": len(device),
        "top_device_ms": {k[:60]: v / 1e3 for k, v in top},
        "loop_stats": res.loop_stats,
    }
    (out_dir / f"profile_{config.replace('/', '_')}.txt").write_text(
        evs.table(sort_by="self_cpu_time_total", row_limit=60))
    print("profile " + json.dumps(out), flush=True)
    return out


def new_path_checks(report: list, dev) -> None:
    """``crm_update``'s mid path on ``kernel_bench.mid_crm_cases`` and both
    lookups' stream path on ``kernel_bench.stream_lookup_cases`` (the
    unpacked one on the same bytes as one item a row): each must take its
    path and hold bitwise, twice, against its plain version."""
    def held(name, label, kern, plain, fn, path):
        held_equal(report, name, f"{path} {label}", kern, plain)
        if fn.last_path != path:
            raise AssertionError(f"{name} took the {fn.last_path} path at "
                                 f"{label}, not {path}")

    for label, H in kernel_bench.mid_crm_cases(dev):
        held("crm_update", label, lambda: crm_update(H),
             lambda: crm_update_plain(H), crm_update, "mid")
    for label, table, ids in kernel_bench.stream_lookup_cases(dev):
        items, iids = table.view(table.shape[0], -1), ids.view(-1, 1)
        held("packed_lookup", label, lambda: packed_lookup(table, ids),
             lambda: packed_lookup_plain(table, ids), packed_lookup,
             "stream")
        held("unpacked_lookup", label, lambda: unpacked_lookup(items, iids),
             lambda: unpacked_lookup_plain(items, iids), unpacked_lookup,
             "stream")


def kernels_bench_phase(dev) -> tuple[list, dict]:
    """The kernel benchmark, the only path of ``unpacked_lookup``, with the
    launch counts of its run; then ragged lookups held bitwise against
    the plain versions (and the packed gather of the same bytes), and ids
    out of range, which must raise."""
    reset_launches()
    torch.cuda.synchronize()
    recs = kernel_bench.run(dev)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    if launches["unpacked_lookup"] <= 0 or launches["packed_lookup"] <= 0:
        raise AssertionError("the kernel benchmark launched no lookup kernel")
    rng = np.random.default_rng(7)
    report = []
    C, omega = 101, 5
    for d in RAGGED_D:
        for dtype in RAGGED_DTYPES:
            for R in (1, 777):
                table = torch.from_numpy(
                    rng.standard_normal((C, omega, d)) * 100).to(dtype).to(dev)
                items = table.reshape(C * omega, d)
                cids = torch.from_numpy(
                    rng.integers(0, C, R).astype(np.int32)).to(dev)
                iids = (cids[:, None] * omega + torch.arange(
                    omega, dtype=torch.int32, device=dev)).to(torch.int32)
                rids = torch.from_numpy(rng.integers(
                    0, C * omega, (R, 3)).astype(np.int32)).to(dev)
                got = unpacked_lookup(items, iids)
                got_r = unpacked_lookup(items, rids)
                eq = (torch.equal(got, unpacked_lookup_plain(items, iids))
                      and torch.equal(got, packed_lookup(table, cids))
                      and torch.equal(got_r, unpacked_lookup_plain(items,
                                                                   rids)))
                torch.cuda.synchronize()
                label = f"d={d} {dtype} R={R}"
                report.append({"kernel": "unpacked_lookup", "inputs": label,
                               "equal": eq})
                if not eq:
                    raise AssertionError(f"unpacked_lookup differs from its "
                                         f"plain version at {label}")
    # every path of the lookups' copy engine, at R 1, 3, 64 and 65,537 in
    # int32, float32 and float16
    covered = set()
    for case in kernel_bench.lookup_cases(dev):
        for entry in kernel_bench.check_lookup_case(case):
            report.append(entry)
            covered.add((entry["kernel"], entry["path"]))
    missed = {(k, p) for k in ("packed_lookup", "unpacked_lookup")
              for p in LOOKUP_PATHS} - covered
    if missed:
        raise AssertionError(f"lookup paths never checked: {sorted(missed)}")
    new_path_checks(report, dev)
    items = torch.zeros((10, 4), dtype=torch.float32, device=dev)
    for bad in (-1, 10):
        ids = torch.tensor([[0, bad]], dtype=torch.int32, device=dev)
        try:
            unpacked_lookup(items, ids)
        except IndexError:
            report.append({"kernel": "unpacked_lookup",
                           "inputs": f"id {bad} of 10", "raised": True})
            continue
        raise AssertionError(f"unpacked_lookup took id {bad} of 10")
    print("kernels_bench_ragged " + json.dumps(report), flush=True)
    print("kernels_bench " + json.dumps(recs), flush=True)
    return recs, launches


def same_point(a, b, tag) -> None:
    """Equal final partition, E and anchor of two runs of one point."""
    try:
        same_state(a.state, b.state)
    except AssertionError as e:
        raise AssertionError(f"{tag}: {e}") from None


def cohort_count(pts, layout=None) -> int:
    """The scans the reference's sweep makes for unsharded points outside
    device-CGM super-groups: one a cohort key (state rows and columns
    under ``layout``, const_dt, uses_sizes, step-tensor set, statics,
    caching charge), the step-tensor set being fixed by const_dt,
    uses_sizes and whether the policy has a keep-or-not hook
    (``src/repro/core/sweep.py:462-477``)."""
    from repro_torch.core.state_layout import StateLayout

    lay = StateLayout.resolve(layout)
    keys = set()
    for p in pts:
        pol = get_policy(p.policy, **p.policy_kwargs)
        pol.bind(p.trace.n, p.trace.m)
        env = CacheEnvironment.resolve(getattr(pol, "env", None), p.trace,
                                       pol.params)
        model = get_cost_model(getattr(pol, "cost_model", "table1"), env)
        statics = cost_spec(model, env)[1]
        dt = np.asarray(model.dt())
        keys.add((*lay.state_dims(p.trace.n, p.trace.m),
                  bool((dt == dt[0]).all()),
                  bool(model.uses_sizes), hasattr(pol, "item_keep"),
                  statics, getattr(pol, "caching_charge", "requested")))
    return len(keys)


def scan_lines(groups) -> dict:
    """What a sweep's scan calls were: lanes, member groups and schedules
    of each, and their seconds."""
    return {"scans": len(groups),
            "lanes": [g["lanes"] for g in groups],
            "members": [g["members"] for g in groups],
            "scan_schedules": [g["schedules"] for g in groups],
            "step_tensor_bytes": [g["xs_bytes"] for g in groups],
            "scan_s": [g["scan_s"] for g in groups]}


def sweep_fig6_phase(trace) -> dict:
    """fig6's grid as one sweep on the card, 8 points of it against serial
    card runs and the whole grid on a head against serial CPU runs."""
    pts = build_grid(trace, FIG6_ALPHAS, FIG6_RHOS)
    # rho enters the clique generation only through t_cg: one schedule per
    # distinct t_cg (rhos whose t_cg clips to the same value share one)
    want_schedules = len({p.policy_kwargs["t_cg"] for p in pts})
    reset_launches()
    torch.cuda.synchronize()
    eng = SweepEngine()
    swept = eng.run(pts)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    for k in ("packed_lookup", "crm_update", "clique_pair_edges"):
        if launches[k] <= 0:
            raise AssertionError(f"sweep fig6: kernel {k} never launched")
    want_scans = cohort_count(pts)
    if len(eng.last_stats["groups"]) != want_scans:
        raise AssertionError(
            f"sweep fig6: {len(eng.last_stats['groups'])} scans for "
            f"{want_scans} cohorts")
    if any(launches[k] for k in (*SEG_KERNELS, STEP)):
        raise AssertionError("sweep fig6: a scan kernel launched at a "
                             "uniform dt")
    if eng.last_n_schedules != want_schedules:
        raise AssertionError(f"sweep fig6 built {eng.last_n_schedules} "
                             f"schedules, not {want_schedules}")
    for p, r in zip(pts, swept):
        if not (np.isfinite(r.total) and r.total > 0.0
                and r.costs.n_requests == trace.n_requests):
            raise AssertionError(f"sweep fig6 {p.tag}: total {r.total}")
    idx = [k * FIG6_ALPHAS + a for k in range(FIG6_RHOS)
           for a in (0, FIG6_ALPHAS - 1)]
    sub = [pts[i] for i in idx]
    md0 = KERNELS["merge_density"].launches
    ser = SweepEngine(backend="serial")
    serial = ser.run(sub)
    if KERNELS["merge_density"].launches == md0:
        raise AssertionError("the serial fig6 runs did not take the device "
                             "clique generation")
    assert_parity(sub, serial, [swept[i] for i in idx])
    for i, r in zip(idx, serial):
        same_point(r, swept[i], pts[i].tag)

    head = trace.slice(0, min(FIG6_CPU_HEAD, trace.n_requests))
    pts_h = build_grid(head, FIG6_ALPHAS, FIG6_RHOS)
    swept_h = SweepEngine().run(pts_h)
    ser_cpu = SweepEngine(backend="serial", device="cpu")
    cpu = ser_cpu.run(pts_h)
    assert_parity(pts_h, cpu, swept_h)
    for p, a, b in zip(pts_h, cpu, swept_h):
        same_point(a, b, f"head {p.tag}")
    groups = eng.last_stats["groups"]
    line = {
        "config": "netflix-table2", "requests": trace.n_requests,
        "points": len(pts), "alphas": FIG6_ALPHAS, "rhos": FIG6_RHOS,
        "schedules": eng.last_n_schedules,
        "expected_schedules": want_schedules,
        "expected_scans": want_scans, **scan_lines(groups),
        "sweep_wall_s": eng.last_wall,
        "sweep_per_point_s": eng.last_wall / len(pts),
        "schedule_s": [b["schedule_s"] for b in eng.last_stats["builds"]],
        "cg_s": [b["cg_s"] for b in eng.last_stats["builds"]],
        "lookup_s": [b["lookup_s"] for b in eng.last_stats["builds"]],
        "lookup_calls": [b["lookup_calls"]
                         for b in eng.last_stats["builds"]],
        "lookup_table_bytes_up": [b["lookup_table_bytes_up"]
                                  for b in eng.last_stats["builds"]],
        "serial_points": len(sub), "serial_wall_s": ser.last_wall,
        "serial_per_point_s": ser.last_wall / len(sub),
        "launches": launches,
        "cpu_head_requests": head.n_requests,
        "cpu_head_points": len(pts_h),
        "cpu_serial_per_point_s": ser_cpu.last_wall / len(pts_h),
    }
    print("sweep_fig6 " + json.dumps(line), flush=True)
    return line


def sweep_fig10_phase(n_requests: int) -> tuple[dict, dict]:
    """fig10's grid as one sweep on the card (per-server dt: the lane
    scans run), every point against a serial card run.  Returns the
    ``sweep_fig10`` record and the widest lane scan's inputs."""
    pts = fig10_points(n_requests)
    reset_launches()
    capture.INPUTS = {}
    torch.cuda.synchronize()
    eng = SweepEngine()
    swept = eng.run(pts)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    captured = {k: v[1] for k, v in capture.INPUTS.items()
                if k in (*SEG_KERNELS, STEP)}
    capture.INPUTS = None
    groups = eng.last_stats["groups"]
    lanes = [g["lanes"] for g in groups if not g["const_dt"]]
    for k in (STEP, "packed_lookup"):
        if launches[k] <= 0:
            raise AssertionError(f"sweep fig10: kernel {k} never launched")
    want_scans = cohort_count(pts)
    if len(groups) != want_scans:
        raise AssertionError(f"sweep fig10: {len(groups)} scans for "
                             f"{want_scans} cohorts")
    # one launch a live step a cohort (a scan), however many schedules
    live = sum(g["steps"] for g in groups if not g["const_dt"])
    if launches[STEP] != live or any(launches[k] for k in SEG_KERNELS):
        raise AssertionError(
            f"sweep fig10: {launches[STEP]} seg_scan_step launches for {live} "
            f"per-server-dt steps, standalone "
            f"{[launches[k] for k in SEG_KERNELS]}")
    if not lanes or max(lanes) < 2:
        raise AssertionError("sweep fig10 ran no per-server-dt group with "
                             "more than one lane")
    ser = SweepEngine(backend="serial")
    serial = ser.run(pts)
    assert_parity(pts, serial, swept)
    for p, a, b in zip(pts, serial, swept):
        same_point(a, b, p.tag)
        if not (np.isfinite(b.total) and b.total > 0.0):
            raise AssertionError(f"sweep fig10 {p.tag}: total {b.total}")
    line = {
        "requests": n_requests, "points": len(pts),
        "schedules": eng.last_n_schedules,
        "expected_scans": want_scans, **scan_lines(groups),
        "per_server_dt_lanes": lanes,
        "sweep_wall_s": eng.last_wall,
        "sweep_per_point_s": eng.last_wall / len(pts),
        "schedule_s": [b["schedule_s"] for b in eng.last_stats["builds"]],
        "cg_s": [b["cg_s"] for b in eng.last_stats["builds"]],
        "lookup_s": [b["lookup_s"] for b in eng.last_stats["builds"]],
        "lookup_calls": [b["lookup_calls"]
                         for b in eng.last_stats["builds"]],
        "lookup_table_bytes_up": [b["lookup_table_bytes_up"]
                                  for b in eng.last_stats["builds"]],
        "serial_wall_s": ser.last_wall,
        "serial_per_point_s": ser.last_wall / len(pts),
        "seg_scan_launches": launches[STEP],
        "launches": launches,
        "totals": {p.tag: r.total for p, r in zip(pts, swept)},
    }
    print("sweep_fig10 " + json.dumps(line), flush=True)
    return line, captured


class SyncCounter:
    """Counts the host syncs that ``torch.cuda.set_sync_debug_mode("warn")``
    reports inside the block, by the port's function that made each
    (``SYNC_KINDS``; "other" for any other place).  Waits on a CUDA event
    (the live engine's ring) are not syncs to that mode; the engine counts
    them itself."""

    def __init__(self, kinds: dict | None = None):
        self.kinds = SYNC_KINDS if kinds is None else kinds

    def __enter__(self):
        self.counts = dict.fromkeys(
            (*sorted(set(self.kinds.values())), "other"), 0)
        self.other: list = []
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self._record
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _record(self, message, category, filename, lineno, file=None,
                line=None):
        if "synchronizing CUDA operation" not in str(message):
            self._show(message, category, filename, lineno, file, line)
            return
        stack = traceback.extract_stack()[:-1]
        kind = next((self.kinds[f.name] for f in reversed(stack)
                     if f.name in self.kinds), "other")
        self.counts[kind] += 1
        if kind == "other" and len(self.other) < 3:
            self.other.append("".join(traceback.format_list(stack[-4:])))

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        return False


def lane_bound(name: str, args: tuple) -> dict:
    """The bound of a laned CGM kernel at these inputs: every lane's bytes
    and operations, as :func:`pair_bound` and ``merge_bound`` count one
    lane's, summed."""
    if name == "merge_density":
        X, sizes, om, gm, acts, _ = args
        ks = None if acts is None else acts.tolist()
        recs = [kernel_bench.merge_bound(
            sizes[lane], int(om[lane]), None if ks is None else ks[lane])
            for lane in range(X.shape[0])]
        return bound(sum(r["ops"] for r in recs), PEAK_FP32,
                     sum(r["bytes"] for r in recs))
    recs = [pair_bound(name, tuple(a[lane] for a in args))
            for lane in range(args[0].shape[0])]
    return bound(sum(r["ops"] for r in recs), PEAK_TF32,
                 sum(r["bytes"] for r in recs))


def lane_calls(name: str, args: tuple):
    """(kernel, plain version, per-lane loop of the unlaned kernel, library
    call) of one laned CGM kernel's inputs."""
    L = args[0].shape[0]
    if name == "crm_update":
        (H,) = args
        return (lambda: crm_update(H), lambda: crm_update_plain(H),
                lambda: [crm_update(H[lane]) for lane in range(L)],
                lambda: torch.bmm(H.transpose(1, 2), H))
    if name == "clique_pair_edges":
        M, A = args
        return (lambda: clique_pair_edges(M, A),
                lambda: clique_pair_edges_plain(M, A),
                lambda: [clique_pair_edges(M[lane], A[lane])
                         for lane in range(L)],
                lambda: torch.bmm(torch.bmm(M, A), M.transpose(1, 2)))
    X, sizes, om, gm, acts, act_max = args
    oms, gms = om.tolist(), gm.tolist()
    ks = [None] * L if acts is None else acts.tolist()
    return (lambda: merge_density(X, sizes, om, gm, n_act=acts,
                                  act_max=act_max),
            lambda: merge_density_lanes_plain(X, sizes, om, gm, acts),
            lambda: [merge_density(X[lane], sizes[lane], oms[lane],
                                   gms[lane], ks[lane])
                     for lane in range(L)],
            None)


def lane_kernel_phase(report: list, captured: dict) -> dict:
    """The laned CGM kernels against their laned plain versions, bitwise
    and twice, on the laned inputs captured from the fig7 runs and on
    ``kernel_bench.lane_cases``; each timed on the card alone beside a
    per-lane loop of the unlaned kernel (the yardstick) and its bound."""
    cases = [(name, f"ragged {label}", args) for name, label, args
             in kernel_bench.lane_cases(torch.device("cuda"))]
    for run, cap in captured.items():
        (H,) = cap["crm_update_lanes"][1]
        cases.append(("crm_update", f"captured {run}", (H,)))
        if "clique_pair_edges_lanes" in cap:
            cases.append(("clique_pair_edges", f"captured {run}",
                          cap["clique_pair_edges_lanes"][1]))
            cases.append(("merge_density", f"captured {run}",
                          cap["merge_density_lanes"][1]))
    records: dict = {}
    for name, label, args in cases:
        kern, plain, loop, lib = lane_calls(name, args)
        err = held_equal(report, name, f"laned {label}", kern, plain)
        if (name == "crm_update" and label == "captured fig7 grid"
                and crm_update.last_path != "mid"):
            raise AssertionError(f"fig7's laned crm_update took the "
                                 f"{crm_update.last_path} path, not mid")
        if not label.startswith("captured") and args[0].shape[0] != 17:
            continue
        records.setdefault(name, {})[label] = {
            **({"path": crm_update.last_path} if name == "crm_update"
               else {}),
            "shape": [list(a.shape) for a in args
                      if isinstance(a, torch.Tensor)],
            "lanes": int(args[0].shape[0]), "max_abs_err": err,
            "ms": cuda_time(kern, REPS), "plain_ms": cuda_time(plain, REPS),
            "library_ms": cuda_time(lib, REPS) if lib else None,
            **kernel_bench.device_times(kern, lib, REPS),
            "lane_loop_device_ms": cuda_graph_time(loop, REPS),
            **lane_bound(name, args)}
    return records


def fig7_groups(pts) -> dict:
    """Point indices of each (trace, method) super-group of fig7's grid."""
    groups: dict = {}
    for i, p in enumerate(pts):
        groups.setdefault((id(p.trace), p.policy), []).append(i)
    return groups


def same_lane(a, b, tag) -> None:
    """A laned point against its serial run: state, costs at 1e-9,
    windows and size history."""
    same_point(a, b, tag)
    same_costs(a, b, tag)
    if a.n_windows != b.n_windows or len(a.size_history) != len(
            b.size_history) or not all(np.array_equal(x, y) for x, y in zip(
                a.size_history, b.size_history)):
        raise AssertionError(f"{tag}: windows or size history differ")


def sweep_fig7_phase(traces: dict, catalog) -> tuple[dict, dict]:
    """fig7's grid (both Table-II traces, theta / gamma / omega, akpc and
    akpc_base) as one sweep on the card: 4 device-CGM super-groups, each
    one laned clique generation.  The first and last lane of each group
    against serial card runs, the netflix akpc group on a head against
    serial CPU runs, and a 3-lane catalog-10k theta group (h 1024) on a
    head against serial card runs.  Returns the ``sweep_fig7`` record and
    the laned kernels' records."""
    pts, _ = fig7.grid_points(traces)
    groups = fig7_groups(pts)
    captured: dict = {}
    reset_launches()
    capture.INPUTS = {}
    calls0 = port_cliques.CGM_CALLS
    torch.cuda.synchronize()
    eng = SweepEngine()
    swept = eng.run(pts)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    captured["fig7 grid"] = dict(capture.INPUTS)
    capture.INPUTS = None
    recs = eng.last_stats["cgm_groups"]
    if port_cliques.CGM_CALLS != calls0:
        raise AssertionError("sweep fig7 made host clique-generation calls")
    if (eng.last_n_schedules != len(groups) or len(recs) != len(groups)
            or [r["lanes"] for r in recs] != [len(v) for v in
                                              groups.values()]):
        raise AssertionError(
            f"sweep fig7: {eng.last_n_schedules} schedules, lanes "
            f"{[r['lanes'] for r in recs]}, not {len(groups)} groups of "
            f"{[len(v) for v in groups.values()]}")
    windows = sum(r["windows"] for r in recs)
    merge_windows = sum(r["windows"] for (_, pol), r in zip(groups, recs)
                        if pol == "akpc")
    want = {"crm_update": windows, "clique_pair_edges": merge_windows,
            "merge_density": merge_windows}
    for k, n_l in want.items():
        if launches[k] != n_l:
            raise AssertionError(f"sweep fig7: {launches[k]} {k} launches "
                                 f"for {n_l} super-group windows")
    if any(launches[k] for k in (*SEG_KERNELS, STEP, "packed_lookup",
                                 "unpacked_lookup")):
        raise AssertionError("sweep fig7: a scan or lookup kernel launched")
    for p, r in zip(pts, swept):
        if not (np.isfinite(r.total) and r.total > 0.0
                and r.costs.n_requests == p.trace.n_requests
                and r.n_windows >= 2):
            raise AssertionError(f"sweep fig7 {p.policy}: total {r.total}")

    idx = [i for v in groups.values() for i in (v[0], v[-1])]
    ser = SweepEngine(backend="serial")
    serial = ser.run([pts[i] for i in idx])
    for i, r in zip(idx, serial):
        same_lane(swept[i], r, f"fig7 point {i}")

    head = traces["netflix"].slice(0, FIG7_CPU_HEAD)
    pts_h = [p for p in fig7.grid_points({"netflix": head})[0]
             if p.policy == "akpc"]
    eng_h = SweepEngine()
    swept_h = eng_h.run(pts_h)
    ser_cpu = SweepEngine(backend="serial", device="cpu")
    for k, (a, b) in enumerate(zip(swept_h, ser_cpu.run(pts_h))):
        same_lane(a, b, f"fig7 CPU head point {k}")

    cat = catalog.slice(0, min(FIG7_CATALOG_HEAD, catalog.n_requests))
    t_cat = t_cg_for(cat)
    pts_c = [SweepPoint("akpc", cat, dict(
        params=CostParams(theta=th), t_cg=t_cat,
        top_frac=FIG7_CATALOG_TOP_FRAC)) for th in FIG7_CATALOG_THETAS]
    capture.INPUTS = {}
    eng_c = SweepEngine()
    swept_c = eng_c.run(pts_c)
    captured["catalog-10k theta group"] = dict(capture.INPUTS)
    capture.INPUTS = None
    ser_c = SweepEngine(backend="serial")
    for k, (a, b) in enumerate(zip(swept_c, ser_c.run(pts_c))):
        same_lane(a, b, f"fig7 catalog-10k point {k}")
    (rec_c,) = eng_c.last_stats["cgm_groups"]

    def per_window(rec, prefix):
        return {k: rec[k] / rec["windows"] for k in rec
                if k.startswith(prefix)}

    line = {
        "configs": {k: [tr.n, tr.m, tr.n_requests] for k, tr in
                    traces.items()},
        "points": len(pts), "schedules": eng.last_n_schedules,
        "groups": [{"policy": pol, "lanes": r["lanes"],
                    "windows": r["windows"], "h": r["h"], "gcap": r["gcap"],
                    "full_merge": r["full_merge"], "seconds": r["seconds"],
                    "seconds_per_point": r["seconds"] / r["lanes"],
                    "syncs": {k: r[k] for k in r if k.startswith("sync_")},
                    "syncs_per_window": per_window(r, "sync_"),
                    "iterations": {k: r.get(k, 0) for k in (
                        "iters_removed", "iters_added", "split_iters",
                        "merge_iters")},
                    "edges_removed": r.get("edges_removed", 0),
                    "edges_added": r.get("edges_added", 0),
                    "merges": r.get("merges", 0)}
                   for (_, pol), r in zip(groups, recs)],
        "sweep_wall_s": eng.last_wall,
        "sweep_per_point_s": eng.last_wall / len(pts),
        "serial_points": len(idx), "serial_wall_s": ser.last_wall,
        "serial_per_point_s": ser.last_wall / len(idx),
        "serial_walls_s": [r.wall_seconds for r in serial],
        "launches": launches, "host_cgm_calls": 0,
        "cpu_head_requests": head.n_requests, "cpu_head_lanes": len(pts_h),
        "cpu_head_sweep_s": eng_h.last_wall,
        "cpu_serial_per_point_s": ser_cpu.last_wall / len(pts_h),
        "catalog": {"requests": cat.n_requests, "lanes": len(pts_c),
                    "h": rec_c["h"], "windows": rec_c["windows"],
                    "sweep_s": eng_c.last_wall,
                    "serial_per_point_s": ser_c.last_wall / len(pts_c),
                    "sweep_per_point_s": eng_c.last_wall / len(pts_c),
                    "syncs_per_window": per_window(rec_c, "sync_")},
    }
    print("sweep_fig7 " + json.dumps(line), flush=True)
    report: list = []
    lane_recs = lane_kernel_phase(report, captured)
    print("kernels_lanes " + json.dumps(report), flush=True)
    print("kernels_lanes_timed " + json.dumps(lane_recs), flush=True)
    return line, lane_recs


def submit_slices(eng, trace, lo: int, hi: int) -> None:
    """Submit [lo, hi) of the trace in ``SERVE_SLICE`` arrival slices;
    fails if the ring ever holds more than ``ring`` chunks."""
    for s in range(lo, hi, SERVE_SLICE):
        e = min(s + SERVE_SLICE, hi)
        eng.submit(trace.items[s:e], trace.servers[s:e], trace.times[s:e])
        if eng.in_flight > eng.ring:
            raise AssertionError(f"{eng.in_flight} chunks in flight on a "
                                 f"ring of {eng.ring}")


def stream_live(eng, trace, lo: int = 0) -> float:
    """Stream [lo, end) and drain; seconds, ending in a device sync."""
    t0 = time.perf_counter()
    submit_slices(eng, trace, lo, trace.n_requests)
    eng.drain()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def held_costs(want: dict, got: dict, tag: str) -> dict:
    """``got`` against ``want`` (``CostBreakdown.as_dict``): integer
    counters exact, floats at 1e-9; returns which fields are equal to the
    last digit."""
    for f in ("n_requests", "n_item_requests", "n_misses", "n_hits",
              "items_transferred"):
        if want[f] != got[f]:
            raise AssertionError(f"{tag} {f}: {got[f]} != {want[f]}")
    for f in ("transfer", "caching", "keepalive_rent", "total"):
        if not np.isclose(got[f], want[f], rtol=1e-9, atol=0.0):
            raise AssertionError(f"{tag} {f}: {got[f]} != {want[f]} at 1e-9")
    return {f: got[f] == want[f] for f in want if f != "model"}


def serve_phase(tag: str, config: str, trace, make_policy, env,
                offline: dict, expect: tuple, per_window: tuple = (),
                count_syncs: bool = False) -> dict:
    """One configuration through the live engine on the card: the whole
    trace in arrival slices (chunks of ``SERVE_CHUNK`` on a ring of
    ``SERVE_RING``), held to the offline replay's totals (``offline``, the
    ``slice`` / ``slice2`` line's costs), ``expect``'s kernels launched
    (``per_window``'s once a window); with ``count_syncs`` every host sync
    classified (``SyncCounter``: nothing but the lookups, the host clique
    generation, the cost reads and the final state read).  Then a head of
    ``SERVE_HEAD`` requests with the kernels and with their plain versions
    (the same state bit for bit, no launch in the plain run), and a
    snapshot taken mid-flight in that head restored into a fresh card
    engine and into a CPU session that both finish the head: the same
    state bit for bit as each other and as the uninterrupted run, costs at
    1e-9."""
    t_all = time.perf_counter()

    def engine(**kw):
        return LiveServingEngine(make_policy(), trace.n, trace.m, env=env,
                                 chunk_size=SERVE_CHUNK, ring=SERVE_RING,
                                 cgm="auto", **kw)

    reset_launches()
    torch.cuda.synchronize()
    eng = engine()
    with (SyncCounter() if count_syncs else contextlib.nullcontext()) as sc:
        wall = stream_live(eng, trace)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    got = eng.costs.as_dict()
    last_digit = held_costs(offline, got, f"{tag} {config}")
    for k in expect:
        if launches[k] <= 0:
            raise AssertionError(f"{tag} {config}: kernel {k} never launched")
    windows = eng.policy.n_windows
    for k in per_window:
        if launches[k] != windows:
            raise AssertionError(f"{tag} {config}: {launches[k]} {k} launches "
                                 f"for {windows} windows")
    syncs = None
    if count_syncs:
        syncs = dict(sc.counts)
        if syncs["other"] or syncs["costs"] != eng.cost_reads:
            raise AssertionError(
                f"{tag} {config}: host syncs {syncs} ({eng.cost_reads} cost "
                f"reads); unexpected ones at:\n" + "\n".join(sc.other))

    head = trace.slice(0, min(SERVE_HEAD, trace.n_requests))
    reset_launches()
    kern = engine()
    stream_live(kern, head)
    head_launches = {k: fn.launches for k, fn in KERNELS.items()}
    plain = engine(use_kernels=False)
    t0 = time.perf_counter()
    stream_live(plain, head)
    plain_s = time.perf_counter() - t0
    if {k: fn.launches for k, fn in KERNELS.items()} != head_launches:
        raise AssertionError(f"{tag} {config}: the plain run launched a "
                             "kernel")
    same_state(kern.session.engine.state, plain.session.engine.state)
    held_costs(kern.costs.as_dict(), plain.costs.as_dict(), f"{tag} plain")

    cut = min(SERVE_CUT, head.n_requests - 1)
    first = engine()
    submit_slices(first, head, 0, cut)
    pending = first.pending
    snap = first.snapshot()
    card = engine().restore(snap)
    stream_live(card, head, lo=cut)
    cpu = CacheSession(make_policy(), trace.n, trace.m, env=env,
                       device="cpu").restore(snap)
    live = snap["live"]
    cpu.feed(live["pend_items"], live["pend_servers"], live["pend_times"])
    cpu.feed(head.items[cut:], head.servers[cut:], head.times[cut:])
    same_state(card.session.engine.state, cpu.engine.state)
    same_state(card.session.engine.state, kern.session.engine.state)
    held_costs(cpu.costs.as_dict(), card.costs.as_dict(), f"{tag} snapshot")
    held_costs(kern.costs.as_dict(), card.costs.as_dict(), f"{tag} resumed")
    line = {
        "config": config, "policy": eng.policy.name, "n": trace.n,
        "m": trace.m, "requests": trace.n_requests, "slice": SERVE_SLICE,
        "chunk": SERVE_CHUNK, "ring": SERVE_RING,
        "path": "device_cgm" if eng._cgm else "host_schedule",
        "windows": windows, "costs": got,
        "equal_to_offline_last_digit": last_digit,
        "wall_s": wall, "requests_per_s": trace.n_requests / wall,
        "chunks": eng.chunks, "ratchets": eng.compiles,
        "ring_waits": eng.ring_waits, "cost_reads": eng.cost_reads,
        "state_reads": eng.state_reads, "host_syncs": syncs,
        "loop_stats": eng.loop_stats,
        "syncs_per_chunk": (sum(v for k, v in eng.loop_stats.items()
                                if k.startswith("sync_")) / eng.chunks),
        "launches": launches,
        "head_requests": head.n_requests, "head_launches": head_launches,
        "head_kernel_equals_plain": True, "plain_head_s": plain_s,
        "snapshot_cut": cut, "snapshot_pending": pending,
        "snapshot_card_equals_cpu": True,
        "phase_s": time.perf_counter() - t_all,
    }
    print(f"{tag} " + json.dumps(line), flush=True)
    return line


def serve_bench_phase() -> dict:
    """``python -m repro_torch.bench.serve_bench --smoke`` in a process of
    its own, so its cold engine is the first of a process (the kernels
    are built already); returns its result line."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.serve_bench", "--smoke"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"serve_bench --smoke failed "
                             f"({proc.returncode}):\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("serve_bench "))
    out = json.loads(line[len("serve_bench "):])
    sc = out["scenarios"][0]
    print("serve_bench " + json.dumps({
        "profile": sc["profile"], "requests": sc["n_requests"],
        "slice": sc["slice"], "device_cgm": sc["device_cgm"],
        "session_req_per_s": sc["req_per_s_session"],
        "live_cold_req_per_s": sc["req_per_s_live_cold"],
        "live_warm_req_per_s": sc["req_per_s_live_warm"],
        "s_per_session_feed": sc["s_per_session_feed"],
        "device": out["device"]}), flush=True)
    return out


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def launch_delta(before: dict) -> dict:
    return {k: fn.launches - before[k] for k, fn in KERNELS.items()}


def learned_phase(n_requests: int) -> dict:
    """The learned keep-or-not policy at full size (fig11's regime-shift
    trace): ``train_policy`` on the card (no host sync inside its step
    loop, ``SyncCounter``) and on the CPU from the same inputs, weights
    within the CPU test's bar; the card-trained scorer served through
    ``run_policy`` on the card under table1 and heterogeneous pricing
    (one ``seg_scan_step`` a step under per-server dt; on a head, the
    kernel run == the plain run == the CPU's, bit for bit), ranked against
    ``no_packing`` / ``ttl`` / ``packcache`` / ``dp_greedy`` (fails unless
    it beats ``no_packing``), and the heterogeneous run streamed through a
    ``LiveServingEngine`` in arrival slices (totals == offline at 1e-9).
    Returns the ``learned`` lines and the card-trained policies, by
    pricing model."""
    params = CostParams(rho=4.0)
    train_tr = fig11.stress_trace("regime_shift", fig11.TRAIN_SEED,
                                  n_requests)
    ev = fig11.stress_trace("regime_shift", LEARNED_EVAL_SEED, n_requests)
    head = ev.slice(0, min(LEARNED_HEAD, ev.n_requests))
    out, trained = {}, {}
    for cm in fig11.MODELS:
        t_all = time.perf_counter()
        env = fig11.env_for(cm, params)
        t_cg = t_cg_for(train_tr, params, env=env, cost_model=cm)
        # the labels alone, so the step loop's share of a training is the
        # rest of its wall time
        t0 = time.perf_counter()
        X, _, _ = hindsight_windows(train_tr, env, t_cg, params=params,
                                    cost_model=cm)
        labels_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SyncCounter({"train_steps": "train_loop"}) as sc:
            lp = train_policy(train_tr, env=env, t_cg=t_cg, params=params,
                              cost_model=cm)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        if sc.counts["train_loop"]:
            raise AssertionError(
                f"learned {cm}: {sc.counts['train_loop']} host syncs inside "
                "the training step loop")
        t0 = time.perf_counter()
        lp_cpu = train_policy(train_tr, env=env, t_cg=t_cg, params=params,
                              cost_model=cm, device="cpu")
        train_cpu_s = time.perf_counter() - t0
        worst = 0.0
        for (path, a), (_, b) in zip(tree_leaves(lp_cpu.w),
                                     tree_leaves(lp.w)):
            rel = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))
            worst = max(worst, rel)
            if rel > TRAIN_LEAF_RTOL:
                raise AssertionError(
                    f"learned {cm}: trained leaf {path} differs card vs CPU "
                    f"by {rel:.3g} of its magnitude (bar {TRAIN_LEAF_RTOL})")

        def pol(name):
            return get_policy(name, params=params, env=env, cost_model=cm,
                              **fig11.policy_kwargs(name, t_cg, lp))

        reset_launches()
        torch.cuda.synchronize()
        res = run_policy(pol("learned"), ev)
        launches = launch_counts()
        st = res.loop_stats
        dt = np.asarray(get_cost_model(cm, CacheEnvironment.resolve(
            env, ev, params)).dt())
        per_server = bool((dt != dt[0]).any())
        if st.get("path") != "host_schedule" or launches["packed_lookup"] <= 0:
            raise AssertionError(f"learned {cm}: not the host schedule with "
                                 f"its lookups ({st.get('path')}, "
                                 f"{launches['packed_lookup']})")
        want = st["steps"] if per_server else 0
        if launches[STEP] != want or any(launches[k] for k in SEG_KERNELS):
            raise AssertionError(
                f"learned {cm}: {launches[STEP]} seg_scan_step launches for "
                f"{st['steps']} steps (per-server dt {per_server})")
        card_head = run_policy(pol("learned"), head)
        before = launch_counts()
        plain = run_policy_torch(pol("learned"), head, use_kernels=False)
        if launch_counts() != before:
            raise AssertionError("the plain run launched a kernel")
        same_state(card_head.state, plain.state)
        same_costs(card_head, plain, f"learned {cm} plain head")
        cpu_head = run_policy(pol("learned"), head, device="cpu")
        same_state(card_head.state, cpu_head.state)
        same_costs(card_head, cpu_head, f"learned {cm} CPU head")
        totals = {"learned": res.total}
        for name in LEARNED_RIVALS:
            totals[name] = run_policy(pol(name), ev).total
        if not totals["learned"] < totals["no_packing"]:
            raise AssertionError(
                f"learned {cm}: {totals['learned']} does not beat "
                f"no_packing's {totals['no_packing']}")
        line = {
            "config": "fig11 regime_shift", "cost_model": cm,
            "n": ev.n, "m": ev.m, "requests": ev.n_requests, "t_cg": t_cg,
            "train_seed": fig11.TRAIN_SEED, "eval_seed": LEARNED_EVAL_SEED,
            "train": {"examples": int(X.shape[0]), "labels_s": labels_s,
                      "wall_s": train_s, "rest_s": train_s - labels_s,
                      "syncs": sc.counts},
            "train_cpu": {"wall_s": train_cpu_s,
                          "rest_s": train_cpu_s - labels_s},
            "train_card_vs_cpu_worst_rel": worst,
            "windows": res.n_windows, "per_server_dt": per_server,
            "wall_s": res.wall_seconds,
            "serve_requests_per_s": ev.n_requests / res.wall_seconds,
            "head_wall_s": card_head.wall_seconds,
            "plain_head_wall_s": plain.wall_seconds, "steps": st["steps"],
            "schedule_s": st["schedule_s"], "scan_s": st["scan_s"],
            "launches": launches, "totals": totals,
            "ranking": sorted(totals, key=totals.get),
            "costs": res.costs.as_dict(),
            "head_requests": head.n_requests,
        }
        if cm == "heterogeneous":
            eng = LiveServingEngine(pol("learned"), ev.n, ev.m, env=env,
                                    chunk_size=SERVE_CHUNK, ring=SERVE_RING)
            reset_launches()
            wall = stream_live(eng, ev)
            held_costs(res.costs.as_dict(), eng.costs.as_dict(),
                       f"learned {cm} live")
            line["live"] = {"wall_s": wall,
                            "requests_per_s": ev.n_requests / wall,
                            "slice": SERVE_SLICE, "chunk": SERVE_CHUNK,
                            "chunks": eng.chunks,
                            "ring_waits": eng.ring_waits,
                            "launches": launch_counts()}
        line["phase_s"] = time.perf_counter() - t_all
        print("learned " + json.dumps(line), flush=True)
        out[cm] = line
        trained[cm] = lp
    return out, trained


def sweep_shards_phase(trained: dict) -> tuple[dict, dict]:
    """fig11's eval-seed shard axis as one sweep on the card (regime_shift,
    three shards a point, both pricing models, all eight policies;
    ``learned`` with ``trained``, the ``learned`` phase's weights): each
    point's shard group one scan of 3 lanes over 3 schedules, one
    ``seg_scan_step`` launch a live step under per-server dt; every point
    against the serial backend.  Returns the ``sweep_shards`` line and the
    widest shard-group step's scan inputs."""
    params = CostParams(rho=4.0)
    pts = []
    for cm in fig11.MODELS:
        env = fig11.env_for(cm, params)
        train_tr = fig11.stress_trace("regime_shift", fig11.TRAIN_SEED,
                                      SHARD_REQUESTS)
        t_cg = t_cg_for(train_tr, params, env=env, cost_model=cm)
        shards = tuple(fig11.stress_trace("regime_shift", seed,
                                          SHARD_REQUESTS)
                       for seed in fig11.EVAL_SEEDS)
        for name in fig11.POLICIES:
            pts.append(SweepPoint(name, shards, dict(
                params=params, env=env, cost_model=cm,
                **fig11.policy_kwargs(name, t_cg, trained[cm])),
                tag=f"regime_shift/{cm}/{name}"))
    n_sh = len(fig11.EVAL_SEEDS)
    reset_launches()
    capture.INPUTS = {}
    torch.cuda.synchronize()
    eng = SweepEngine()
    swept = eng.run(pts)
    launches = launch_counts()
    captured = {k: v[1] for k, v in capture.INPUTS.items()
                if k in (*SEG_KERNELS, STEP)}
    capture.INPUTS = None
    groups = eng.last_stats["groups"]
    for k in ("packed_lookup", "crm_update", "clique_pair_edges"):
        if launches[k] <= 0:
            raise AssertionError(f"sweep shards: kernel {k} never launched")
    if len(groups) != len(pts) or any(
            (g["lanes"], g["schedules"]) != (n_sh, n_sh) for g in groups):
        raise AssertionError(
            "sweep shards: not one scan of a lane a shard per shard group: "
            f"{[(g['lanes'], g['schedules']) for g in groups]}")
    live = sum(g["steps"] for g in groups if not g["const_dt"])
    if not live or launches[STEP] != live or any(
            launches[k] for k in SEG_KERNELS):
        raise AssertionError(
            f"sweep shards: {launches[STEP]} seg_scan_step launches for "
            f"{live} per-server-dt steps")
    if eng.last_n_schedules != n_sh * len(pts):
        raise AssertionError(f"sweep shards built {eng.last_n_schedules} "
                             f"schedules, not {n_sh * len(pts)}")
    ser = SweepEngine(backend="serial")
    serial = ser.run(pts)
    for p, a, b in zip(pts, serial, swept):
        same_costs(a, b, f"sweep shards {p.tag}")
        same_point(a, b, f"sweep shards {p.tag}")
        sa, sb = a.shard_stats, b.shard_stats
        if sb["n"] != n_sh or not all(np.allclose(
                sa[k], sb[k], rtol=1e-9, atol=0.0)
                for k in ("totals", "mean", "std", "ci95")):
            raise AssertionError(f"sweep shards {p.tag}: shard_stats {sb} "
                                 f"!= serial {sa}")
        if not (np.isfinite(b.total) and b.total > 0.0):
            raise AssertionError(f"sweep shards {p.tag}: total {b.total}")
    line = {
        "config": "fig11 regime_shift", "eval_seeds": list(fig11.EVAL_SEEDS),
        "requests_a_shard": SHARD_REQUESTS,
        "cut": f"shards of {SHARD_REQUESTS} requests (fig11's run size "
               "cut to keep the phase within the script's limit)",
        "points": len(pts), "schedules": eng.last_n_schedules,
        **scan_lines(groups),
        "steps": [g["steps"] for g in groups],
        "per_server_dt_steps": live,
        "sweep_wall_s": eng.last_wall, "serial_wall_s": ser.last_wall,
        "sweep_per_point_s": eng.last_wall / len(pts),
        "serial_per_point_s": ser.last_wall / len(pts),
        "schedule_s": sum(b["schedule_s"]
                          for b in eng.last_stats["builds"]),
        "seg_scan_launches": launches[STEP], "launches": launches,
        "totals": {p.tag: r.total for p, r in zip(pts, swept)},
        "ci95": {p.tag: r.shard_stats["ci95"] for p, r in zip(pts, swept)},
    }
    print("sweep_shards " + json.dumps(line), flush=True)
    return line, captured


def competitive_phase() -> dict:
    """Thm 2 and Thm 1 on the card: the adversary's ratio equals the
    corrected bound; the per-request checks (a one-request-a-step replay
    with the per-step record) stay <= 1 and equal a CPU run."""
    t0 = time.perf_counter()
    adversary = []
    for S, omega in ADVERSARY_CASES:
        params = CostParams(omega=omega)
        setup = adversarial_trace(S=S, omega=omega, n_phases=7,
                                  params=params)
        akpc, opt, _ = replay_adversary(setup, params)
        want = competitive_bound_corrected(S, omega, params.alpha)
        if not np.isclose(akpc / opt, want, rtol=1e-12, atol=0.0):
            raise AssertionError(f"adversary S={S} omega={omega}: ratio "
                                 f"{akpc / opt} != bound {want}")
        adversary.append({"S": S, "omega": omega, "ratio": akpc / opt,
                          "bound": want})
    adversary_s = time.perf_counter() - t0
    tr = paper_trace("netflix", RATIO_REQUESTS)
    part = CliquePartition.from_cliques(
        tr.n, [tuple(range(i, i + 5)) for i in range(0, tr.n, 5)])
    params = CostParams()
    checks = {}
    for cm in ("table1", "heterogeneous"):
        env = (None if cm == "table1" else CacheEnvironment.skewed(
            tr.n, tr.m, params, price_sigma=0.6, size_sigma=0.3, seed=1))
        runs = [("generalized", lambda dev, env=env, cm=cm:
                 generalized_per_request_ratio_check(
                     tr, part, params, env=env, cost_model=cm, device=dev))]
        if cm == "table1":
            runs.append(("thm1", lambda dev: per_request_ratio_check(
                tr, part, params, device=dev)))
        for label, fn in runs:
            reset_launches()
            t1 = time.perf_counter()
            card = fn(None)
            card_s = time.perf_counter() - t1
            launches = launch_counts()
            t1 = time.perf_counter()
            cpu = fn("cpu")
            cpu_s = time.perf_counter() - t1
            if not (0.0 < card <= 1.0 + 1e-9
                    and np.isclose(card, cpu, rtol=RATIO_RTOL, atol=0.0)):
                raise AssertionError(f"competitive {cm} {label}: card "
                                     f"{card}, CPU {cpu}")
            if (launches[STEP] > 0) != (cm == "heterogeneous"):
                raise AssertionError(f"competitive {cm} {label}: "
                                     f"{launches[STEP]} scan launches")
            checks[f"{cm} {label}"] = {
                "worst": card, "cpu_worst": cpu, "card_s": card_s,
                "cpu_s": cpu_s, "launches": launches}
    line = {"adversary": adversary, "adversary_s": adversary_s,
            "requests": tr.n_requests, "checks": checks,
            "seconds": time.perf_counter() - t0}
    print("competitive " + json.dumps(line), flush=True)
    return line


def record_feeds(cache) -> list:
    """Keep every ``(items, servers, times)`` fed to ``cache`` from now
    on, so the same request stream can be replayed elsewhere."""
    fed: list = []
    feed = cache.feed

    def recorded(items, servers, times):
        fed.append((items, servers, times))
        return feed(items, servers, times)

    cache.feed = recorded
    return fed


def replay_plain_and_cpu(tag: str, live, make_policy, env, fed) -> dict:
    """The request stream ``fed`` that a drained card engine ``live``
    served, replayed through a card engine that runs the kernels' plain
    versions (no launch) and through a CPU session: both leave ``live``'s
    state bit for bit, costs at 1e-9.  Returns their seconds."""
    items, servers, times = (np.concatenate(c) for c in zip(*fed))
    before = launch_counts()
    t0 = time.perf_counter()
    plain = LiveServingEngine(make_policy(), live.n, live.m, env=env,
                              device=live.device, use_kernels=False)
    plain.feed(items, servers, times)
    plain.drain()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if launch_counts() != before:
        raise AssertionError(f"{tag}: the plain run launched a kernel")
    t0 = time.perf_counter()
    cpu = CacheSession(make_policy(), live.n, live.m, env=env, device="cpu")
    cpu.feed(items, servers, times)
    cpu_s = time.perf_counter() - t0
    for other in (plain.session, cpu):
        same_state(live.session.engine.state, other.engine.state)
    held_costs(live.costs.as_dict(), plain.costs.as_dict(), f"{tag} plain")
    held_costs(cpu.costs.as_dict(), live.costs.as_dict(), f"{tag} CPU")
    return {"requests": int(len(times)), "plain_s": plain_s, "cpu_s": cpu_s,
            "kernel_equals_plain": True, "card_equals_cpu": True}


def pipeline_phase() -> dict:
    """``PackedDataPipeline`` at ShardStore's defaults on the ``session``
    and the ``live`` backend in lockstep: the same token batches bit for
    bit, costs at 1e-9 after ``drain()``, and the live engine's device
    clique generation launching ``crm_update``, ``clique_pair_edges`` and
    ``merge_density`` once a window.  The live engine's request stream is
    then replayed with the plain versions and on the CPU
    (``replay_plain_and_cpu``).  Returns the ``pipeline`` line."""
    pipes = {b: PackedDataPipeline(ShardStore(), batch_rows=PIPE_ROWS,
                                   seq_len=PIPE_SEQ, t_cg=PIPE_TCG,
                                   backend=b)
             for b in ("session", "live")}
    secs = dict.fromkeys(pipes, 0.0)
    launches = {b: dict.fromkeys(KERNELS, 0) for b in pipes}
    fed = record_feeds(pipes["live"].cache)

    def timed(b, fn):
        before = launch_counts()
        t0 = time.perf_counter()
        r = fn()
        secs[b] += time.perf_counter() - t0
        for k, v in launch_delta(before).items():
            launches[b][k] += v
        return r

    torch.cuda.synchronize()
    for step in range(PIPE_STEPS):
        a = timed("session", lambda: next(pipes["session"]))
        b = timed("live", lambda: next(pipes["live"]))
        if not np.array_equal(a, b):
            raise AssertionError(f"pipeline: token batches differ at step "
                                 f"{step}")
    live = pipes["live"].cache
    t0 = time.perf_counter()
    timed("live", lambda: (live.drain(), torch.cuda.synchronize()))
    drain_s = time.perf_counter() - t0
    ses = pipes["session"].cache
    got = held_costs(ses.costs.as_dict(), live.costs.as_dict(),
                     "pipeline live")
    windows = live.policy.n_windows
    for k in CGM_KERNELS:
        if launches["live"][k] != windows:
            raise AssertionError(f"pipeline live: {launches['live'][k]} {k} "
                                 f"launches for {windows} windows")
    same_state(ses.engine.state, live.session.engine.state)
    p = pipes["live"]
    checks = replay_plain_and_cpu(
        "pipeline", live,
        lambda: get_policy("akpc", params=p.params, t_cg=PIPE_TCG,
                           top_frac=1.0, cost_model=p.cost_model),
        p.env, fed)
    tel = p.telemetry
    line = {
        "store": {"shards": 256, "shard_tokens": 4096, "vocab": 32000,
                  "domains": 8},
        "rows": PIPE_ROWS, "seq_len": PIPE_SEQ, "t_cg": PIPE_TCG,
        "steps": PIPE_STEPS, "windows": windows,
        "shards_fetched": tel.shards_fetched,
        "requests": ses.costs.n_requests,
        "path": "device_cgm" if live._cgm else "host_schedule",
        "s_per_step": {b: secs[b] / PIPE_STEPS for b in pipes},
        "live_drain_s": drain_s, "live_chunks": live.chunks,
        "launches": launches, "costs": ses.costs.as_dict(),
        "equal_last_digit": got, "replays": checks,
    }
    print("pipeline " + json.dumps(line), flush=True)
    return line


def expert_observations(rng, n_experts: int, top_k: int, steps: int):
    """One step's routing outcome a step: ``EXPERT_TOKENS`` tokens drawn
    from one group of ``EXPERT_GROUP`` co-activated experts (the hot group
    0 with probability ``EXPERT_HOT``), and the serving host."""
    groups = n_experts // EXPERT_GROUP
    obs = []
    for _ in range(steps):
        g = 0 if rng.random() < EXPERT_HOT else int(rng.integers(0, groups))
        members = np.arange(g * EXPERT_GROUP, (g + 1) * EXPERT_GROUP)
        obs.append((rng.choice(members, size=(EXPERT_TOKENS, top_k)),
                    int(rng.integers(0, EXPERT_HOSTS))))
    return obs


def expert_cache_phase(seed: int, dev) -> tuple[dict, dict]:
    """``ExpertCacheManager`` at DeepSeek-V2's routing shape on the card:
    the ``session`` and ``live`` backends give equal ``stats()``; the live
    engine's request stream replayed with the plain versions and on the
    CPU leaves its state bit for bit (``replay_plain_and_cpu``); a live
    snapshot taken mid-stream restored into a ``session`` manager keeps
    equal totals to the end.  Then the packed expert table at
    Granite-MoE's width, one step's activated cliques gathered with
    ``packed_lookup`` (== its plain version and the host table, bit for
    bit), timed on the card alone against ``index_select``.  Returns the
    ``expert_cache`` line and the gather's kernel record."""
    rng = np.random.default_rng(seed)
    obs = expert_observations(rng, EXPERTS, EXPERT_TOP_K, EXPERT_STEPS)

    def manager(backend):
        return ExpertCacheManager(EXPERTS, EXPERT_HOSTS, t_cg=EXPERT_TCG,
                                  backend=backend)

    secs, launches = {}, {}
    live, ses = manager("live"), manager("session")
    fed = record_feeds(live.session)
    for name, mgr in (("live", live), ("session", ses)):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, (topk, host) in enumerate(obs):
            if name == "live" and i == EXPERT_CUT:
                snap = live.snapshot()
            mgr.observe(topk, host=host)
        mgr._settle()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches[name] = launch_delta(before)
    sl, ss = live.stats(), ses.stats()
    if not np.isclose(sl.akpc_total, ss.akpc_total, rtol=1e-9, atol=0.0):
        raise AssertionError(f"expert_cache: live {sl.akpc_total} != "
                             f"session {ss.akpc_total}")
    if sl.nopack_total != ss.nopack_total or sl.cliques != ss.cliques:
        raise AssertionError("expert_cache: no_packing totals or cliques "
                             "differ between the backends")
    checks = replay_plain_and_cpu(
        "expert_cache", live.session,
        lambda: get_policy("akpc", params=live.params, t_cg=EXPERT_TCG,
                           top_frac=1.0, cost_model=live.cost_model),
        live.env, fed)
    standby = manager("session")
    standby.restore(snap)
    for topk, host in obs[EXPERT_CUT:]:
        standby.observe(topk, host=host)
    sb = standby.stats()
    if not np.isclose(sb.akpc_total, sl.akpc_total, rtol=1e-9, atol=0.0):
        raise AssertionError(f"expert_cache: the restored standby's "
                             f"{sb.akpc_total} != live {sl.akpc_total}")
    if sb.nopack_total != sl.nopack_total:
        raise AssertionError("expert_cache: the standby's no_packing total "
                             "differs")
    line = {
        "config": "deepseek_v2_236b routing", "experts": EXPERTS,
        "top_k": EXPERT_TOP_K, "hosts": EXPERT_HOSTS, "t_cg": EXPERT_TCG,
        "tokens_per_step": EXPERT_TOKENS, "steps": EXPERT_STEPS,
        "snapshot_step": EXPERT_CUT, "windows": live.session.policy.n_windows,
        "path": "device_cgm" if live.session._cgm else "host_schedule",
        "akpc_total": sl.akpc_total, "nopack_total": sl.nopack_total,
        "saving_pct": sl.saving_pct, "cliques": len(sl.cliques),
        "s_per_step": {k: v / EXPERT_STEPS for k, v in secs.items()},
        "launches": launches, "replays": checks,
    }

    # the packed table gather at Granite-MoE's expert width
    g_obs = expert_observations(rng, GATHER_EXPERTS, GATHER_TOP_K,
                                GATHER_STEPS)
    mgr = ExpertCacheManager(GATHER_EXPERTS, EXPERT_HOSTS, t_cg=EXPERT_TCG,
                             backend="live")
    for topk, host in g_obs:
        mgr.observe(topk, host=host)
    weights = rng.standard_normal((GATHER_EXPERTS, *GATHER_ROW),
                                  dtype=np.float32).astype(np.float16)
    table, where = mgr.packed_tables(weights)
    step_experts = np.unique(g_obs[-1][0])
    ids_h = np.unique(where[step_experts, 0]).astype(np.int32)
    C, omega = table.shape[:2]
    table_d = torch.from_numpy(table).reshape(C, omega, -1).to(dev)
    ids = torch.from_numpy(ids_h).to(dev)
    reset_launches()
    got = packed_lookup(table_d, ids)
    path = packed_lookup.last_path
    gather_launches = packed_lookup.launches
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), torch.from_numpy(
            table[ids_h].reshape(len(ids_h), omega, -1))):
        raise AssertionError("expert gather differs from the host table")
    report: list = []
    err = held_equal(report, "packed_lookup", "expert table",
                     lambda: packed_lookup(table_d, ids, ids_checked=True),
                     lambda: packed_lookup_plain(table_d, ids))
    R = int(ids.numel())
    row_bytes = omega * table_d.shape[2] * table_d.element_size()

    def kern():
        return packed_lookup(table_d, ids, ids_checked=True)

    def lib():
        return table_d.index_select(0, ids.to(torch.int64))

    rec = {
        "shape": {"C": C, "omega": omega, "row": list(GATHER_ROW),
                  "dtype": "float16", "R": R, "row_bytes": row_bytes,
                  "table_bytes": int(table_d.numel() * 2), "path": path},
        "max_abs_err": err,
        "ms": cuda_time(kern, GATHER_CALLS),
        "plain_ms": cuda_time(lambda: packed_lookup_plain(table_d, ids),
                              GATHER_CALLS),
        "library_ms": cuda_time(lib, GATHER_CALLS),
        "device_ms": cuda_graph_time(kern, GATHER_CALLS),
        "library_device_ms": cuda_graph_time(lib, GATHER_CALLS),
        # the ids, each gathered row read once, the output written once
        **bound(0.0, PEAK_FP32, 4.0 * R + 2.0 * R * row_bytes),
        "launches": gather_launches, "cliques": len(mgr.cliques()),
    }
    line["gather"] = rec
    print("expert_cache " + json.dumps(line), flush=True)
    return line, rec


def same_entries(want: dict, got: dict, tag: str) -> None:
    """Two runs' figure payload entries (``{method: {total, transfer,
    caching, ...}}``): the same methods, floats at 1e-9, equal clique-size
    histograms."""
    if set(want) != set(got):
        raise AssertionError(f"{tag}: methods {set(want) ^ set(got)}")
    for m, w in want.items():
        for f in ("total", "transfer", "caching"):
            if not np.isclose(w[f], got[m][f], rtol=1e-9, atol=1e-9):
                raise AssertionError(f"{tag} {m} {f}: {w[f]} != "
                                     f"{got[m][f]}")
        if w.get("clique_sizes") != got[m].get("clique_sizes"):
            raise AssertionError(f"{tag} {m}: clique sizes differ")


def fig8_hetero_points(n_requests: int) -> list:
    """fig8's servers and items axes under heterogeneous pricing (fig10's
    ``env_for`` at price sigma 1.0: per-server dt) and lognormal item
    sizes, ``akpc`` and ``no_packing`` at each point."""
    params = CostParams()
    traces = ([(60, m) for m in fig8.SERVERS]
              + [(n, 600) for n in fig8.ITEMS])
    pts = []
    for n, m in traces:
        tr = synth_trace(SynthConfig(
            kind="netflix", n_items=n, n_servers=m, n_requests=n_requests,
            t_max=6.0 * n_requests / 100_000.0, bundle_cover=1.0,
            bundle_zipf=0.7, server_affinity=2, seed=0,
            size_dist="lognormal"))
        env = CacheEnvironment.resolve(env_for(tr, params, PRICE_SIGMA), tr,
                                       params)
        t_cg = t_cg_for(tr, params, env=env, cost_model="heterogeneous")
        for name in ("akpc", "no_packing"):
            kw = dict(t_cg=t_cg, top_frac=1.0) if name == "akpc" else {}
            pts.append(SweepPoint(name, tr, dict(
                params=params, env=env, cost_model="heterogeneous", **kw),
                tag=f"n={n}/m={m}/{name}"))
    return pts


def figures_phase(out_dir) -> tuple[dict, dict]:
    """The figure drivers on the card (``repro_torch.bench``): fig8's
    smoke gate under the bucketed layout, fig8's axes as a bucketed
    heterogeneous grid (the scan step with padded columns), the smoke
    gates of fig9, fig10, the sweep and the replay benchmarks, table1,
    and fig5 / fig6 on a head against serial CPU runs.  Returns the
    ``figures`` record and the bucketed step's kernel record."""
    report: list = []
    line: dict = {"launches": {}}
    bench_common.RESULTS_DIR = str(out_dir / "results")

    def counts() -> dict:
        return {k: fn.launches for k, fn in KERNELS.items()}

    # -- fig8 --smoke: one scan a bucket cohort, every point == serial ------
    grid, labels = fig8.build_grid(smoke=True)
    reset_launches()
    torch.cuda.synchronize()
    res, stats = fig8.run(grid)
    launches = counts()
    scans = len(stats["groups"])
    for k in ("packed_lookup", "crm_update", "clique_pair_edges"):
        if launches[k] <= 0:
            raise AssertionError(f"figures fig8: kernel {k} never launched")
    if any(launches[k] for k in (*SEG_KERNELS, STEP)):
        raise AssertionError("figures fig8: a scan kernel launched at a "
                             "uniform dt")
    fails = fig8.smoke_gate(grid, labels, res, scans)
    if fails:
        raise AssertionError("figures fig8 --smoke: " + "; ".join(fails))
    line["fig8_smoke"] = {
        "points": len(grid), "cohorts": fig8.n_cohorts(grid),
        "scans": scans, "lanes": [g["lanes"] for g in stats["groups"]],
        "scan_s": [g["scan_s"] for g in stats["groups"]],
        "sweep_wall_s": stats["wall"]}
    line["launches"]["fig8 smoke"] = launches

    # -- fig8's axes, bucketed, per-server dt -------------------------------
    pts = fig8_hetero_points(FIG_HETERO_REQUESTS)
    print(f"cut: figures fig8-bucketed-hetero at {FIG_HETERO_REQUESTS} "
          "requests a trace (fig8's axes; n and m unchanged)", flush=True)
    want_scans = cohort_count(pts, fig8.LAYOUT)
    reset_launches()
    capture.INPUTS = {}
    torch.cuda.synchronize()
    eng = SweepEngine(layout=fig8.LAYOUT)
    swept = eng.run(pts)
    launches = counts()
    captured = capture.INPUTS[STEP][1]
    capture.INPUTS = None
    groups = eng.last_stats["groups"]
    if len(groups) != want_scans:
        raise AssertionError(f"figures hetero: {len(groups)} scans for "
                             f"{want_scans} cohorts")
    live = sum(g["steps"] for g in groups)
    if launches[STEP] != live or any(launches[k] for k in SEG_KERNELS):
        raise AssertionError(
            f"figures hetero: {launches[STEP]} seg_scan_step launches for "
            f"{live} live steps")
    for k in ("packed_lookup", "crm_update", "clique_pair_edges"):
        if launches[k] <= 0:
            raise AssertionError(f"figures hetero: kernel {k} never "
                                 "launched")
    ser = SweepEngine(backend="serial")
    serial = ser.run(pts)
    assert_parity(pts, serial, swept)
    for p, a, b in zip(pts, serial, swept):
        same_point(a, b, p.tag)
        if not (np.isfinite(b.total) and b.total > 0.0):
            raise AssertionError(f"figures hetero {p.tag}: {b.total}")
    m_max = max(p.trace.m for p in pts
                if fig8.LAYOUT.state_cols(p.trace.m) == captured[6].shape[1])
    if captured[6].shape[1] <= m_max:
        raise AssertionError("figures hetero: the captured step's dt has "
                             "no padded column")
    step_rec = rows_step_record(
        report, captured, "captured fig8-bucketed-hetero step (padded "
        "columns)") if len(captured) == 8 else None
    if step_rec is None:
        raise AssertionError("figures hetero: the widest step has no "
                             "per-lane rows")
    step_rec["shape"]["servers"] = m_max
    line["fig8_bucketed_hetero"] = {
        "requests": FIG_HETERO_REQUESTS, "points": len(pts),
        "expected_scans": want_scans, **scan_lines(groups),
        "live_steps": live, "seg_scan_launches": launches[STEP],
        "sweep_wall_s": eng.last_wall, "serial_wall_s": ser.last_wall,
        "state_dims": sorted({fig8.LAYOUT.state_dims(p.trace.n, p.trace.m)
                              for p in pts})}
    line["launches"]["fig8-bucketed-hetero"] = launches

    # -- the drivers' smoke gates -------------------------------------------
    env_cut = {"REPRO_SWEEP_BENCH_REQUESTS": str(FIG_SWEEP_BENCH_REQUESTS),
               "REPRO_REPLAY_SCALAR_CAP": str(FIG_REPLAY_CAP)}
    print(f"cut: figures sweep_bench --smoke at {FIG_SWEEP_BENCH_REQUESTS} "
          f"requests (60,000 in the driver); replay_bench --smoke with a "
          f"{FIG_REPLAY_CAP}-request batch-1 head (20,000)", flush=True)
    saved = {k: os.environ.get(k) for k in env_cut}
    os.environ.update(env_cut)
    try:
        for name, mod in (("fig9", fig9), ("fig10", fig10),
                          ("sweep_bench", sweep_bench),
                          ("replay_bench", replay_bench)):
            reset_launches()
            t0 = time.perf_counter()
            rc = mod.main(["--smoke"])
            line.setdefault("smoke_s", {})[name] = time.perf_counter() - t0
            line["launches"][f"{name} smoke"] = counts()
            if rc != 0:
                raise AssertionError(f"figures: {name} --smoke exited {rc}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if line["launches"]["fig10 smoke"][STEP] <= 0:
        raise AssertionError("figures: fig10 --smoke launched no scan step")
    if table1.main([]) != 0:
        raise AssertionError("figures: table1 failed")

    # -- fig5 / fig6 on a head, the card's sweep == serial CPU runs ---------
    for name, mod in (("fig5", fig5), ("fig6", fig6)):
        g = mod.grid(FIG_HEAD)
        if name == "fig6":
            g, keys = g
        reset_launches()
        torch.cuda.synchronize()
        st: dict = {}
        got = bench_common.run_method_grid(g, stats=st)
        line["launches"][f"{name} head"] = counts()
        t0 = time.perf_counter()
        want = bench_common.run_method_grid(g, backend="serial",
                                            device="cpu")
        cpu_s = time.perf_counter() - t0
        for i, (w, r) in enumerate(zip(want, got)):
            same_entries(w, r, f"figures {name} entry {i}")
        payload = (mod.payload_rows(got)[0] if name == "fig5"
                   else mod.payload_rows(keys, got)[0])
        rec = {"requests": FIG_HEAD, "entries": len(g),
               "schedules": st["schedules"], "scans": len(st["groups"]),
               "sweep_wall_s": st["wall"], "cpu_serial_s": cpu_s}
        if name == "fig5":
            rec["relative"] = {k: payload[k]["relative"] for k in fig5.KINDS}
            rec["akpc_vs_packcache_saving"] = {
                k: 1 - got[i]["akpc"]["total"] / got[i]["packcache"]["total"]
                for i, k in enumerate(fig5.KINDS)}
        line[f"{name}_head"] = rec
    print("kernels_figures " + json.dumps(report), flush=True)
    print("figures " + json.dumps(line), flush=True)
    return line, step_rec


def logical_mesh(n_dev: int, state_rows: int, device: str = "cuda:0"):
    """A mesh of ``n_dev`` logical shards of one device."""
    return make_sweep_mesh(n_dev, state_rows, devices=[device] * n_dev)


def same_bits(a, b, tag: str) -> None:
    """Equal state and bit-for-bit equal costs of two runs."""
    same_point(a, b, tag)
    if a.costs.as_dict() != b.costs.as_dict():
        raise AssertionError(f"{tag}: costs differ: {a.costs.as_dict()} "
                             f"!= {b.costs.as_dict()}")


def sharded_record(res, lay, trace) -> dict:
    st = res.loop_stats
    if (st.get("path") != "host_schedule"
            or st.get("shards") != lay.row_shards):
        raise AssertionError(f"the row-sharded run took {st.get('path')} "
                             f"over {st.get('shards')} block(s)")
    return {"n": trace.n, "m": trace.m, "requests": trace.n_requests,
            "shards": st["shards"], "steps": st["steps"],
            "state_rows": lay.state_rows(trace.n),
            "state_bytes_per_device": lay.state_bytes_per_device(
                trace.n, trace.m),
            "dense_state_bytes": StateLayout().state_bytes(trace.n, trace.m),
            "block_ops": st["block_ops"],
            "block_ops_per_step": st["block_ops"] / max(1, st["steps"]),
            "device_copies_per_step":
                st["device_copies"] / max(1, st["steps"]),
            "scan_s": st["scan_s"], "schedule_s": st["schedule_s"],
            "total_cost": res.total}


def mesh_phase(catalog, seed: int) -> dict:
    """The row-sharded layout and the sweep mesh on logical meshes of
    cuda:0: the hetero-catalog-10k head (host schedule, per-server dt),
    the 10^6-item catalog, fig10's grid on a 2 x 2 mesh.  Each run is held
    against the dense (or mesh-less) card run."""
    params = CostParams()
    mesh = logical_mesh(MESH_SHARDS, MESH_SHARDS)
    lay = StateLayout(kind="row_sharded", mesh=mesh)
    line: dict = {"mesh": mesh.shape, "physical_devices":
                  mesh.physical_devices, "launches": {}}

    def counts() -> dict:
        return {k: fn.launches for k, fn in KERNELS.items()}

    # -- hetero-catalog-10k akpc on a head: 4 row blocks == dense ---------
    head = catalog.slice(0, min(MESH_HEAD, catalog.n_requests))
    env = env_for(head, params, PRICE_SIGMA)
    t_cg = t_cg_for(head, params, env=env, cost_model="heterogeneous")
    reset_launches()
    torch.cuda.synchronize()
    res = run_policy(host_policy("akpc", t_cg, env, "heterogeneous"), head,
                     layout=lay)
    launches = counts()
    rec = sharded_record(res, lay, head)
    for k in ("packed_lookup", "crm_update", "clique_pair_edges", STEP):
        if launches[k] <= 0:
            raise AssertionError(f"mesh hetero-catalog-10k: kernel {k} "
                                 "never launched")
    if launches[STEP] != rec["steps"] or any(launches[k]
                                             for k in SEG_KERNELS):
        raise AssertionError(
            f"mesh hetero-catalog-10k: {launches[STEP]} seg_scan_step "
            f"launches for {rec['steps']} steps")
    line["launches"]["hetero-catalog-10k row_sharded"] = launches
    dense = run_policy(host_policy("akpc", t_cg, env, "heterogeneous"),
                       head)
    same_bits(dense, res, "mesh hetero-catalog-10k dense")
    cpu_head = head.slice(0, min(HEAD["hetero-catalog-10k"],
                                 head.n_requests))
    env_c = env_for(cpu_head, params, PRICE_SIGMA)
    t_c = t_cg_for(cpu_head, params, env=env_c, cost_model="heterogeneous")
    card = run_policy(host_policy("akpc", t_c, env_c, "heterogeneous"),
                      cpu_head, layout=lay)
    cpu_lay = StateLayout(kind="row_sharded",
                          mesh=logical_mesh(MESH_SHARDS, MESH_SHARDS, "cpu"))
    cpu = run_policy(host_policy("akpc", t_c, env_c, "heterogeneous"),
                     cpu_head, device="cpu", layout=cpu_lay)
    same_point(card, cpu, "mesh hetero-catalog-10k CPU head")
    same_costs(card, cpu, "mesh hetero-catalog-10k CPU head")
    line["hetero-catalog-10k"] = {
        **rec, "policy": "akpc", "windows": res.n_windows,
        "wall_s": res.wall_seconds, "dense_wall_s": dense.wall_seconds,
        "dense_scan_s": dense.loop_stats["scan_s"],
        "bitwise_dense": True, "cpu_head_requests": cpu_head.n_requests,
        "cpu_head_windows": cpu.n_windows}

    # -- 10^6 items x 600 servers: 4.8 GB of E, 1.2 GB a block ------------
    n_items, n_srv, n_req = MESH_BIG
    t0 = time.perf_counter()
    big = synth_trace(SynthConfig(
        kind="spotify", n_items=n_items, n_servers=n_srv, n_requests=n_req,
        t_max=60.0 * n_req / 1_000_000, bundle_cover=1.0, bundle_zipf=0.7,
        seed=seed))
    trace_s = time.perf_counter() - t0
    runs, peaks = {}, {}
    for key, layout in (("row_sharded", lay), ("dense", None)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        runs[key] = run_policy(get_policy("no_packing", params=params), big,
                               layout=layout)
        peaks[key] = torch.cuda.max_memory_allocated()
        line["launches"][f"catalog-1m {key}"] = counts()
    sh, dense = runs["row_sharded"], runs["dense"]
    if line["launches"]["catalog-1m row_sharded"]["packed_lookup"] <= 0:
        raise AssertionError("mesh catalog-1m: packed_lookup never launched")
    same_bits(dense, sh, "mesh catalog-1m dense")
    if not (np.isfinite(sh.total) and sh.total > 0.0
            and sh.costs.n_requests == n_req):
        raise AssertionError(f"mesh catalog-1m: total {sh.total}")
    line["catalog-1m"] = {
        **sharded_record(sh, lay, big), "policy": "no_packing",
        "cost_model": "table1", "trace_s": trace_s,
        "wall_s": sh.wall_seconds, "dense_wall_s": dense.wall_seconds,
        "dense_scan_s": dense.loop_stats["scan_s"],
        "max_memory_allocated": peaks["row_sharded"],
        "dense_max_memory_allocated": peaks["dense"],
        "bitwise_dense": True}
    del runs, sh, dense, big

    # -- fig10's grid on a head, a 2 x 2 mesh == the mesh-less sweep -------
    pts = fig10_points(MESH_FIG10_REQUESTS)
    base_eng = SweepEngine()
    base = base_eng.run(pts)
    mesh2 = logical_mesh(*MESH_SWEEP)
    eng = SweepEngine(mesh=mesh2, layout=StateLayout(kind="row_sharded"))
    reset_launches()
    torch.cuda.synchronize()
    got = eng.run(pts)
    launches = counts()
    line["launches"]["sweep-fig10 2x2"] = launches
    groups = eng.last_stats["groups"]
    live = sum(g["steps"] for g in groups if not g["const_dt"])
    if launches[STEP] != live or launches["packed_lookup"] <= 0:
        raise AssertionError(f"mesh sweep-fig10: {launches[STEP]} "
                             f"seg_scan_step launches for {live} steps")
    if {g["block"] for g in groups} != {0, 1}:
        raise AssertionError("mesh sweep-fig10: the lanes did not split "
                             "over the scenario axis")
    assert_parity(pts, base, got)
    for p, a, b in zip(pts, base, got):
        same_point(a, b, f"mesh sweep-fig10 {p.tag}")
    line["sweep-fig10"] = {
        "requests": MESH_FIG10_REQUESTS, "points": len(pts),
        "mesh": mesh2.shape, **scan_lines(groups),
        "blocks": [g["block"] for g in groups],
        "block_ops": [g["block_ops"] for g in groups],
        "sweep_wall_s": eng.last_wall, "meshless_wall_s": base_eng.last_wall,
        "seg_scan_launches": launches[STEP]}
    print("mesh " + json.dumps(line), flush=True)
    return line


#: the serve_model phase: granite-moe-3b-a800m at its full config served
#: through ``BatchedServer`` (requests, prompt tokens lo..hi-1, new tokens,
#: batch, cache length) with the AKPC expert cache on its routing (hosts,
#: T_CG); decode steps left out of the median as warm-up
SERVE_ARCH = "granite_moe_3b_a800m"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_MAX_NEW = 16, (4, 13), 16
SERVE_BATCH, SERVE_CACHE = 8, 256
SERVE_HOSTS, SERVE_TCG = 2, 24.0
SERVE_WARMUP = 2
#: the card against the CPU at full width: the decoder-family configs cut
#: to CROSS_LAYERS layers, CROSS_ROWS rows at staggered positions over a
#: seeded cache of CROSS_CACHE positions (h2o-danube's 4096-slot ring
#: wraps), CROSS_STEPS decode steps
CROSS_ARCHS = ("qwen2_5_3b", "codeqwen1_5_7b", "h2o_danube_1_8b",
               "command_r_35b", "granite_moe_3b_a800m", "phi_3_vision_4_2b")
CROSS_LAYERS, CROSS_ROWS, CROSS_CACHE, CROSS_STEPS = 2, 2, 4096, 4
#: largest gap of the card's bf16 logits and cache rows from the CPU's, as
#: a share of the CPU's largest magnitude: bf16 keeps 8 bits, cuBLAS and
#: the CPU's GEMMs sum in other orders, and a value on a rounding boundary
#: rounds the other way (the CPU tests hold the port to the JAX package at
#: 6e-2 for the same reason); int8 KV codes at most one unit apart
CROSS_TOL = 0.06
#: calls of a timed kernel on the serve_model path's captured inputs
SERVE_REPS = 20


def tree_bytes(tree) -> int:
    return int(sum(a.numel() * a.element_size() for a in param_leaves(tree)))


def timed_decode(model, events: list, finite: list):
    """``model`` whose ``decode_step`` records a pair of CUDA events a call
    and folds ``isfinite(logits).all()`` into ``finite[0]`` on the card."""
    inner = model.decode_step

    def step(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = inner(*args, **kw)
        stop.record()
        events.append((start, stop))
        finite[0] = finite[0] & torch.isfinite(logits).all()
        return logits, cache

    return dataclasses.replace(model, decode_step=step)


def cgm_records(report: list, captured: dict, label: str) -> dict:
    """The device CGM's kernels on the inputs captured from the expert
    cache's run: twice, bitwise against the plain versions, timed beside
    the plain versions, the library calls and the bounds."""
    (H,) = captured["crm_update"]
    M = captured["clique_pair_edges"][0]
    k0 = captured["merge_density"][4]
    out = {}
    for name, (kern, plain, lib, bnd) in cgm_cases(captured).items():
        err = held_equal(report, name, f"captured {label}", kern, plain)
        out[name] = {
            "shape": {"h": H.shape[1], "wcap": H.shape[0], "S": M.shape[0],
                      "n_act": k0},
            "inputs": "captured", "max_abs_err": err,
            "ms": cuda_time(kern, SERVE_REPS),
            "plain_ms": cuda_time(plain, SERVE_REPS),
            "library_ms": cuda_time(lib, SERVE_REPS) if lib else None,
            **kernel_bench.device_times(kern, lib, SERVE_REPS), **bnd}
    return out


def gather_record(report: list, g: dict, label: str) -> dict:
    """The expert gather (``packed_lookup`` of a step's cliques of the first
    MoE layer's ``wi`` rows): twice, bitwise against the plain version, timed beside
    ``index_select`` and the bound."""
    table, ids = g["table"], g["ids"]

    def kern():
        return packed_lookup(table, ids, ids_checked=True)

    def plain():
        return packed_lookup_plain(table, ids)

    def lib():
        return table.index_select(0, ids.to(torch.int64))

    err = held_equal(report, "packed_lookup", label, kern, plain)
    C, omega, d = table.shape
    R = int(ids.numel())
    row_bytes = omega * d * table.element_size()
    return {
        "shape": {"C": C, "omega": omega, "row": d, "dtype": str(table.dtype),
                  "R": R, "row_bytes": row_bytes,
                  "table_bytes": tree_bytes(table),
                  "path": packed_lookup.last_path},
        "max_abs_err": err, "ms": cuda_time(kern, SERVE_REPS),
        "plain_ms": cuda_time(plain, SERVE_REPS),
        "library_ms": cuda_time(lib, SERVE_REPS),
        **kernel_bench.device_times(kern, lib, GATHER_CALLS),
        # the ids, each gathered row read once, the output written once
        **bound(0.0, PEAK_FP32, 4.0 * R + 2.0 * R * row_bytes)}


def step_bytes(cfg, params) -> float:
    """Bytes a decode step must read: the parameters, less the padded
    experts' rows of ``wi`` / ``wg`` / ``wo`` (the router never sends a
    token to experts ``n_experts`` .. ``n_experts_padded - 1``)."""
    mo = cfg.moe
    mlp = params["layers"]["mlp"]
    pad = sum(tree_bytes(mlp[w]) for w in ("wi", "wg", "wo")) * (
        mo.n_experts_padded - mo.n_experts) / mo.n_experts_padded
    return tree_bytes(params) - pad


def serve_requests(model, params, seed: int, tag: str, **kw):
    """SERVE_REQUESTS requests of SERVE_PROMPT prompt tokens and
    SERVE_MAX_NEW new tokens through ``BatchedServer`` (batch SERVE_BATCH,
    cache SERVE_CACHE), or, given the expert cache's ``n_hosts`` and
    ``t_cg``, through the example's server with the cache on its routing
    tap; a decode step timed by CUDA events.  Gates: every request in full,
    finite logits, tokens in the vocabulary.  Returns (line, server, the
    manager and per-step top-k or None)."""
    cfg = model.cfg
    requests = moe_example.make_requests(
        np.random.default_rng(seed), SERVE_REQUESTS, cfg.vocab,
        *SERVE_PROMPT, SERVE_MAX_NEW)
    events: list = []
    finite = [torch.ones((), dtype=torch.bool, device=model.device)]
    timed = timed_decode(model, events, finite)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kw:
        srv, mgr, done, topks = moe_example.serve_with_expert_cache(
            timed, params, requests, batch_size=SERVE_BATCH,
            cache_len=SERVE_CACHE, **kw)
        extra = (mgr, topks)
    else:
        srv = BatchedServer(timed, params, batch_size=SERVE_BATCH,
                            cache_len=SERVE_CACHE)
        for r in requests:
            srv.submit(r)
        done, extra = srv.run(), None
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if len(done) != SERVE_REQUESTS or any(
            len(r.out) != SERVE_MAX_NEW for r in done):
        raise AssertionError(f"{tag}: {len(done)} of {SERVE_REQUESTS} "
                             "requests served in full")
    if not bool(finite[0]):
        raise AssertionError(f"{tag}: non-finite logits")
    if not all(0 <= t < cfg.vocab for r in done for t in r.out):
        raise AssertionError(f"{tag}: a token outside the vocabulary")
    step_ms = [a.elapsed_time(b) for a, b in events]
    generated = sum(len(r.out) for r in done)
    processed = sum(len(r.prompt) - 1 + len(r.out) for r in done)
    line = {
        "config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads], "vocab": cfg.vocab,
        "dtype": cfg.param_dtype, "requests": SERVE_REQUESTS,
        "prompt_tokens": list(SERVE_PROMPT), "max_new": SERVE_MAX_NEW,
        "batch_size": SERVE_BATCH, "cache_len": SERVE_CACHE,
        "steps": srv.steps, "tokens_generated": generated,
        "tokens_processed": processed, "serve_s": serve_s,
        "decode_ms_median": float(np.median(step_ms[SERVE_WARMUP:])),
        "decode_ms_min": float(np.min(step_ms[SERVE_WARMUP:])),
        "decode_ms_first": step_ms[:SERVE_WARMUP],
        "tokens_per_s": generated / serve_s,
        "processed_tokens_per_s": processed / serve_s,
        "params": sum(a.numel() for a in param_leaves(params)),
        "param_bytes": tree_bytes(params), "cache_bytes": tree_bytes(srv.cache),
    }
    return line, srv, extra


def built(cfg, seed: int, dev):
    """``cfg``'s model on ``dev`` with seeded weights, the peak memory
    counter reset first; returns (model, params, seconds)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(seed)
    torch.cuda.synchronize()
    return model, params, time.perf_counter() - t0


def serve_moe(cfg, seed: int, dev, report: list,
              tag: str) -> tuple[dict, dict, tuple]:
    """An MoE config served through ``BatchedServer`` with the AKPC expert
    cache on its first MoE layer's routing tap, then the expert gather of
    the last step's cliques; the path's kernels launched, held against
    their plain versions on the captured inputs and timed."""
    model, params, init_s = built(cfg, seed, dev)
    reset_launches()
    capture.INPUTS = {}
    line, srv, (mgr, topks) = serve_requests(
        model, params, seed, tag, n_hosts=SERVE_HOSTS, t_cg=SERVE_TCG)
    stats = mgr.stats()
    g = moe_example.expert_gather(mgr, params, topks[-1])
    torch.cuda.synchronize()
    launches = launch_counts()
    captured = {k: v[1] for k, v in capture.INPUTS.items()}
    capture.INPUTS = None
    for name in CGM_KERNELS + ("packed_lookup",):
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} never launched")
    if g["rows"].shape != (g["ids"].numel(), mgr.params.omega,
                           cfg.d_model * cfg.moe.d_ff_expert):
        raise AssertionError(f"{tag}: gathered {tuple(g['rows'].shape)}")
    if packed_lookup.last_path != "stream":
        raise AssertionError(f"{tag}: the gather took the "
                             f"{packed_lookup.last_path} path, not stream")
    if not (np.isfinite(stats.akpc_total) and stats.akpc_total > 0):
        raise AssertionError(f"{tag}: AKPC total {stats.akpc_total}")
    line.update({
        "init_s": init_s,
        "experts": [cfg.moe.n_experts, cfg.moe.n_experts_padded,
                    cfg.moe.top_k, cfg.moe.n_shared],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        # the least a decode step reads: every weight once (attention,
        # the router, the tied embedding for the logits) and the real
        # experts only (the padded ones never receive a token), the cache
        "step_bound_ms": (step_bytes(cfg, params) + tree_bytes(srv.cache))
        / PEAK_BYTES * 1e3,
        "expert_cache": {
            "hosts": SERVE_HOSTS, "t_cg": SERVE_TCG,
            "observations": stats.n_observations,
            "windows": mgr.session.policy.n_windows,
            "cliques": len(stats.cliques),
            "clique_list": [list(map(int, c)) for c in stats.cliques],
            "akpc_total": stats.akpc_total,
            "nopack_total": stats.nopack_total,
            "saving_pct": stats.saving_pct},
        "gather_cliques": int(g["ids"].numel()),
        "gather_table_bytes": tree_bytes(g["table"]),
        "launches": launches,
    })
    recs = {"gather": gather_record(report, g, f"{tag} expert gather"),
            **cgm_records(report, captured, f"{tag} expert cache")}
    del g, captured, srv
    torch.cuda.empty_cache()
    return line, recs, (model, params)


def cross_check(arch: str, seed: int, dev) -> dict:
    """(b): ``arch`` at full width cut to CROSS_LAYERS layers: the card's
    ``decode_step`` logits and written cache rows against the port's CPU
    run on the same weights over CROSS_STEPS steps, staggered positions."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=CROSS_LAYERS)
    gm, cm = build_model(cfg, device=dev), build_model(cfg, device="cpu")
    gp = gm.init(seed)
    cp = tree_map(lambda a: a.cpu(), gp)
    kv = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    cc = gm.init_cache(CROSS_ROWS, CROSS_CACHE, kv)
    cc = tree_map(lambda a: (torch.randint(-127, 128, a.shape, generator=gen,
                                           dtype=torch.int8) if kv ==
                             torch.int8 else torch.randn(
                                 a.shape, generator=gen).to(kv)), cc)
    gc = tree_map(lambda a: a.to(dev), cc)
    S = cc["layers"]["k"].shape[2]
    # row 1 ends the cache; a sliding window's ring wraps under it
    start = [7, S - 2 if cfg.swa_window else S - 1 - CROSS_STEPS]
    pos = torch.tensor(start, dtype=torch.int32)
    worst = {"logits": 0.0, "cache": 0.0, "int8_codes": 0}
    agree = 0
    for step in range(CROSS_STEPS):
        tok = torch.randint(0, cfg.vocab, (CROSS_ROWS, 1), generator=gen,
                            dtype=torch.int32)
        gl, gc = gm.decode_step(gp, gc, tok.to(dev), pos.to(dev))
        cl, cc = cm.decode_step(cp, cc, tok, pos)
        gl = gl.cpu()
        if not bool(torch.isfinite(gl).all()):
            raise AssertionError(f"{arch}: non-finite logits on the card")
        gap = float((gl.float() - cl.float()).abs().max()
                    / cl.float().abs().max())
        worst["logits"] = max(worst["logits"], gap)
        agree += int((gl.argmax(-1) == cl.argmax(-1)).sum())
        slot = pos % S if cfg.swa_window > 0 else pos
        for name in ("k", "v"):
            rows = torch.arange(CROSS_ROWS)
            g_rows = gc["layers"][name].cpu()[:, rows, slot.long()].float()
            c_rows = cc["layers"][name][:, rows, slot.long()].float()
            if kv == torch.int8:
                worst["int8_codes"] = max(worst["int8_codes"], int(
                    (g_rows - c_rows).abs().max()))
            else:
                worst["cache"] = max(worst["cache"], float(
                    (g_rows - c_rows).abs().max() / c_rows.abs().max()))
        pos = pos + 1
    if worst["logits"] > CROSS_TOL or worst["cache"] > CROSS_TOL \
            or worst["int8_codes"] > 1:
        raise AssertionError(f"{arch}: the card differs from the CPU: "
                             f"{worst} (tolerance {CROSS_TOL}, int8 1)")
    out = {"layers": f"{CROSS_LAYERS} of {full.n_layers} (cut)",
           "d_model": cfg.d_model, "vocab": cfg.vocab, "kv_cache": str(kv),
           "swa_window": cfg.swa_window, "qkv_bias": cfg.qkv_bias,
           "norm": cfg.norm, "params": sum(a.numel()
                                            for a in param_leaves(gp)),
           "positions_start": start, "cache_len": S,
           "max_gap": worst, "argmax_agree": f"{agree} of "
           f"{CROSS_STEPS * CROSS_ROWS}"}
    del gm, gp, gc
    torch.cuda.empty_cache()
    return out


def staggered_check(model, params, tag: str = "serve_model") -> dict:
    """A staggered request's tokens on the card equal its solo run on the
    card (``tests/test_server_staggered.py``'s contract)."""
    def solo(prompt):
        srv = BatchedServer(model, params, batch_size=2, cache_len=64)
        srv.submit(Request(rid=0, prompt=list(prompt), max_new=6))
        (r,) = srv.run(max_steps=200)
        return r.out

    p0, p1 = [1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7]
    want0, want1 = solo(p0), solo(p1)
    srv = BatchedServer(model, params, batch_size=2, cache_len=64)
    srv.submit(Request(rid=0, prompt=list(p0), max_new=6))
    for _ in range(4):
        srv.step()
    srv.submit(Request(rid=1, prompt=list(p1), max_new=6))
    done = {r.rid: r.out for r in srv.run(max_steps=200)}
    if done != {0: want0, 1: want1}:
        raise AssertionError(f"{tag}: staggered {done} != solo "
                             f"{want0} / {want1}")
    return {"solo": [want0, want1], "staggered_equal": True}


def serve_model_phase(seed: int, dev) -> tuple[dict, dict]:
    """The model zoo's decoder family and ``BatchedServer`` on the card:
    (a) full-width granite-moe-3b-a800m serving with the AKPC expert
    cache, (b) the six decoder-family configs at full width, cut to
    CROSS_LAYERS layers, card against CPU, (c) staggered == solo on the
    card, (d) the path's kernels (the expert cache's CGM kernels and the
    expert gather) bitwise against their plain versions.
    Returns the ``serve_model`` line and the kernels' records."""
    report: list = []
    line, recs, (model, params) = serve_moe(get_config(SERVE_ARCH), seed,
                                            dev, report, "serve_model")
    line["staggered"] = staggered_check(model, params)
    del model, params
    torch.cuda.empty_cache()
    line["card_vs_cpu"] = {a: cross_check(a, seed, dev) for a in CROSS_ARCHS}
    line["card_vs_cpu_tolerance"] = CROSS_TOL
    line["checks"] = report
    print("serve_model " + json.dumps(line), flush=True)
    return line, recs


#: the serve_families phase: zamba2-1.2b at its full config served as
#: serve_model serves granite (the same requests, batch and cache); the
#: MLA config at full width cut to MLA_LAYERS layers (its dense prefix
#: layer and one MoE layer) served with the expert cache on that MoE
#: layer's routing
HYBRID_ARCH, MLA_ARCH, MLA_LAYERS = "zamba2_1_2b", "deepseek_v2_236b", 2
#: card against CPU on the same weights: each family's layers (None: the
#: full config; zamba2 cut to one shared-attention group and its 2
#: trailing mamba layers), CROSS_ROWS rows, a prefill of one chunk of
#: tokens (the recurrent archs' chunk; FAMILY_PROMPT tokens for MLA,
#: FAMILY_FRAMES seeded frames for whisper), then CROSS_STEPS decode
#: steps at staggered positions over a seeded cache of CROSS_CACHE
#: positions (whisper: its prefill's cross K/V)
FAMILY_CROSS = {"xlstm_125m": None, "whisper_tiny": None,
                "zamba2_1_2b": 8, "deepseek_v2_236b": MLA_LAYERS}
FAMILY_PROMPT, FAMILY_FRAMES = 16, 256
#: staggered == solo on the card: the reference's server test's archs
STAGGER_ARCHS = ("zamba2_1_2b", "xlstm_125m", "whisper_tiny")
#: archs whose bf16 prefill over one chunk is chaotic: xlstm-125m's 12
#: recurrent layers over 256 tokens turn one bf16 rounding into a logit
#: gap of several per cent (on the CPU, rounding one GEMM of the first
#: layer exactly instead of after an f32 sum moved the last logits by 4-9%
#: of the largest; bf16 against f32 8.2%; the card against the CPU 8.1%).
#: Such a gap says nothing of the port, so their prefill is held at
#: CROSS_TOL in f32 (the same code at the full config's shapes) and the
#: bf16 gap is printed beside the CPU's own bf16-against-f32 gap
F32_PREFILL = ("xlstm_125m",)


def serve_hybrid(seed: int, dev) -> tuple[dict, tuple]:
    """(a) + (d): zamba2-1.2b at its full config served through
    ``BatchedServer``; staggered == solo on the card."""
    cfg = get_config(HYBRID_ARCH)
    model, params, init_s = built(cfg, seed, dev)
    line, srv, _ = serve_requests(model, params, seed, "serve_families")
    cache = srv.cache
    state = tree_bytes({k: cache[k] for k in ("ssm", "conv")})
    line.update({
        "init_s": init_s, "ssm": dataclasses.asdict(cfg.ssm),
        "state_bytes": state,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        # the least a decode step moves: every weight read once (the tied
        # embedding for the logits), the recurrent state (f32 SSM state
        # and conv window) read and written, the shared block's K/V read
        "step_bytes": tree_bytes(params) + 2 * state + tree_bytes(
            cache["attn"]),
    })
    line["step_bound_ms"] = line["step_bytes"] / PEAK_BYTES * 1e3
    line["staggered"] = staggered_check(model, params, "serve_families")
    return line, (model, params)


def serve_mla(seed: int, dev, report: list) -> tuple[dict, dict, tuple]:
    """(b): deepseek-v2 at full width cut to MLA_LAYERS layers served as
    ``serve_moe`` serves (the expert cache at 160 experts)."""
    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    line, recs, (model, params) = serve_moe(cfg, seed, dev, report,
                                            "serve_families")
    m = cfg.mla
    line.update({
        "layers": f"{MLA_LAYERS} of {get_config(MLA_ARCH).n_layers} (cut: "
        "the dense prefix layer and one MoE layer)",
        "mla": dataclasses.asdict(m),
        # BatchedServer's cache is bf16
        "latent_cache_bytes_a_token_a_layer":
            (m.kv_lora_rank + m.rope_head_dim) * torch.bfloat16.itemsize})
    return line, recs, (model, params)


def family_cross(arch: str, model, params, seed: int) -> dict:
    """(c): the card's ``prefill`` and CROSS_STEPS ``decode_step``s against
    the port's CPU run on the same weights: logits and every cache or
    state leaf within CROSS_TOL of the CPU's largest magnitude."""
    cfg = model.cfg
    dev = model.device
    cm = build_model(cfg, device="cpu")
    cp = tree_map(lambda a: a.cpu(), params)
    gen = torch.Generator().manual_seed(seed)
    rec = (cfg.ssm or cfg.xlstm)
    S = rec.chunk if rec else FAMILY_PROMPT
    toks = torch.randint(0, cfg.vocab, (CROSS_ROWS, S), generator=gen)
    batch, kw = {"tokens": toks, "labels": toks}, {}
    if cfg.family == "encdec":
        batch = {"frames": torch.randn((CROSS_ROWS, FAMILY_FRAMES,
                                        cfg.d_model), generator=gen)}
        kw["cache_len"] = CROSS_CACHE
    worst = {"logits": 0.0, "cache": 0.0}

    def gap(g, c) -> float:
        c = c.float()
        return float((g.cpu().float() - c).abs().max()
                     / c.abs().max().clamp_min(1e-30))

    gl, gpre = model.prefill(params, {k: v.to(dev) for k, v in
                                      batch.items()}, **kw)
    cl, cpre = cm.prefill(cp, batch, **kw)
    worst["prefill_logits"] = gap(gl, cl)
    noise = {}
    if arch in F32_PREFILL:
        fcfg = dataclasses.replace(cfg, param_dtype="float32",
                                   compute_dtype="float32")
        fl = {}
        for where, ps in ((dev, params), ("cpu", cp)):
            fl[where] = build_model(fcfg, device=where).prefill(
                tree_map(lambda a: a.float(), ps),
                {k: v.to(where) for k, v in batch.items()}, **kw)[0]
        noise = {"prefill_logits_bf16": worst.pop("prefill_logits"),
                 "cpu_bf16_against_f32": gap(cl, fl["cpu"])}
        worst["prefill_logits_f32"] = gap(fl[dev], fl["cpu"])
    worst["prefill_cache"] = max(
        [gap(g, c) for g, c in zip(param_leaves(gpre), param_leaves(cpre))
         if bool(c.any())], default=0.0)
    cc = tree_map(lambda a: (torch.randn(a.shape, generator=gen) * 0.5).to(
        a.dtype), cm.init_cache(CROSS_ROWS, CROSS_CACHE, torch.bfloat16))
    if cfg.family == "encdec":
        cc["cross"] = cpre["cross"]
    del gpre, cpre
    gc = tree_map(lambda a: a.to(dev), cc)
    pos = torch.tensor([7, CROSS_CACHE - 1 - CROSS_STEPS], dtype=torch.int32)
    agree = 0
    for _ in range(CROSS_STEPS):
        tok = torch.randint(0, cfg.vocab, (CROSS_ROWS, 1), generator=gen)
        gl, gc = model.decode_step(params, gc, tok.to(dev), pos.to(dev))
        cl, cc = cm.decode_step(cp, cc, tok, pos)
        if not bool(torch.isfinite(gl).all()):
            raise AssertionError(f"{arch}: non-finite logits on the card")
        worst["logits"] = max(worst["logits"], gap(gl, cl))
        agree += int((gl.cpu().argmax(-1) == cl.argmax(-1)).sum())
        worst["cache"] = max(worst["cache"], max(
            gap(g, c) for g, c in zip(param_leaves(gc), param_leaves(cc))))
        pos = pos + 1
    if max(worst.values()) > CROSS_TOL:
        raise AssertionError(f"{arch}: the card differs from the CPU: "
                             f"{worst} (tolerance {CROSS_TOL})")
    full = get_config(arch)
    del gc, cp, cm
    return {"layers": (f"{cfg.n_layers} of {full.n_layers} (cut)"
                       if cfg.n_layers != full.n_layers else cfg.n_layers),
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "params": sum(a.numel() for a in param_leaves(params)),
            "prefill": {"rows": CROSS_ROWS, **(
                {"frames": FAMILY_FRAMES} if cfg.family == "encdec"
                else {"tokens": S})},
            "positions_start": [7, CROSS_CACHE - 1 - CROSS_STEPS],
            "cache_len": CROSS_CACHE, "steps": CROSS_STEPS,
            "max_gap": worst, **({"bf16_prefill": noise} if noise else {}),
            "argmax_agree": f"{agree} of {CROSS_STEPS * CROSS_ROWS}"}


def serve_families_phase(seed: int, dev) -> tuple[dict, dict]:
    """The remaining model families on the card: (a) full zamba2-1.2b
    served, (b) deepseek-v2 at full width, 2 layers, served with the AKPC
    expert cache at 160 experts and its kernels held bitwise, (c) the four
    families card against CPU, (d) staggered == solo for the reference's
    server-test archs.  Returns the ``serve_families`` line and the
    kernels' records."""
    report: list = []
    cross: dict = {}
    stagger: dict = {}
    line: dict = {}
    times: dict = {}
    t0 = time.perf_counter()
    line["serve-deepseek-v2-2l"], recs, (model, params) = serve_mla(
        seed, dev, report)
    cross[MLA_ARCH] = family_cross(MLA_ARCH, model, params, seed)
    del model, params
    torch.cuda.empty_cache()
    times["deepseek"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["serve-zamba2"], (model, params) = serve_hybrid(seed, dev)
    stagger[HYBRID_ARCH] = line["serve-zamba2"].pop("staggered")
    del model, params
    torch.cuda.empty_cache()
    times["zamba2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch in ("zamba2_1_2b", "xlstm_125m", "whisper_tiny"):
        cfg = get_config(arch)
        if FAMILY_CROSS[arch]:
            cfg = dataclasses.replace(cfg, n_layers=FAMILY_CROSS[arch])
        model = build_model(cfg, device=dev)
        params = model.init(seed)
        cross[arch] = family_cross(arch, model, params, seed)
        if arch in STAGGER_ARCHS and arch not in stagger:
            stagger[arch] = staggered_check(model, params, "serve_families")
        del model, params
        torch.cuda.empty_cache()
    times["card_vs_cpu"] = time.perf_counter() - t0
    line["card_vs_cpu"] = cross
    line["card_vs_cpu_tolerance"] = CROSS_TOL
    line["staggered"] = stagger
    line["part_s"] = times
    line["checks"] = report
    print("serve_families " + json.dumps(line), flush=True)
    return line, recs


# ---------------------------------------------------------------------------
# train: gradients, the train step, the optimisers, checkpoints and the
# fault-tolerant loop
# ---------------------------------------------------------------------------
#: (a) full-width, full-depth qwen2.5-3b at the train_4k sequence: batches
#: of TRAIN_ACCUM microbatches of TRAIN_MB rows, every layer rematerialised;
#: TRAIN_STEPS AdamW steps (f32 moments) and one more under the profiler,
#: then TRAIN_STEPS_8BIT steps of 8-bit AdamW with error-feedback
#: compression; the first step of each run is left out of the median
TRAIN_ARCH = "qwen2_5_3b"
TRAIN_SEQ, TRAIN_ACCUM, TRAIN_MB = 4096, 2, 1
TRAIN_STEPS, TRAIN_STEPS_8BIT = 3, 2
#: (b) one train step on the card against the CPU from the same
#: parameters, two microbatches: arch -> (layers, sequence, microbatch
#: rows, modes); layers None: the smoke config in f32 (sequence None: two
#: of its recurrent chunks, else TRAIN_CROSS_SMOKE_SEQ positions).  qwen's
#: 512 positions pass its attn_chunk, cut to TRAIN_CROSS_CHUNK: two
#: chunks, the chunked attention and its backward run (2,048 positions at
#: the config's 1,024 made qwen's CPU side, bf16 GEMMs on the chip host's
#: CPU, most of the part's 193 s); granite-moe runs the MoE dispatch
#: backward and the aux loss
TRAIN_CROSS = {
    "qwen2_5_3b": (2, 512, 1, ("adamw", "compress_8bit")),
    "granite_moe_3b_a800m": (2, 256, 1, ("adamw",)),
    "deepseek_v2_236b": (None, None, 2, ("adamw",)),
    "zamba2_1_2b": (None, None, 2, ("adamw",)),
    "xlstm_125m": (None, None, 2, ("adamw",)),
    "whisper_tiny": (None, None, 2, ("adamw",)),
    "phi_3_vision_4_2b": (None, None, 2, ("adamw",)),
}
TRAIN_CROSS_SMOKE_SEQ = 24
TRAIN_CROSS_CHUNK = {"qwen2_5_3b": 256}
#: ``tests/test_torch_models.py``'s tolerances, of each leaf's largest
#: magnitude: f32 sums in other orders (2e-5), bf16's 8 bits (CROSS_TOL)
TRAIN_F32_TOL = 2e-5
#: archs whose bf16 gradients are chaotic at these shapes: granite-moe's
#: router picks its top 8 of 40 experts from bf16 activations, and a
#: rounding that reorders two experts moves whole tokens between experts,
#: so the CPU's own bf16 gradients stand further from its f32 ones than
#: CROSS_TOL (PERF.md, §7).  Their gradients, whole-step stats and
#: updates are held in f32 on the same weights (the same code at the same
#: shapes), and the bf16 gaps printed beside the CPU's own
#: bf16-against-f32 gap
F32_TRAIN = ("granite_moe_3b_a800m",)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=1000)
#: (c) the example at its defaults, once uninterrupted and once with a
#: failure injected at this step
TRAIN_LM_FAILURE = 60


def opt_state(params, mode: str) -> dict:
    """The optimizer state of ``mode`` ("adamw" or "compress_8bit")."""
    if mode == "adamw":
        return adamw_init(params)
    return {**adamw8bit_init(params), "ef": ef_init(params)}


def train_step_for(model, mode: str, opt_cfg: AdamWConfig):
    return make_train_step(model, opt_cfg, compress=mode != "adamw",
                           opt_8bit=mode != "adamw")


def lm_batch(rng, cfg, accum: int, mb: int, seq: int) -> dict:
    """(accum, mb, seq) next-token batches from a seeded numpy generator,
    with a VLM's patches or an encoder-decoder's frames."""
    toks = rng.integers(0, cfg.vocab, (accum, mb, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.vlm is not None:
        batch["patches"] = rng.standard_normal(
            (accum, mb, cfg.vlm.n_patches, cfg.vlm.d_patch)).astype(
                np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (accum, mb, seq, cfg.d_model)).astype(np.float32)
    return batch


#: kinds of device kernels in a profile, by a part of their names (the
#: first that matches): cuBLAS's GEMMs, copies and casts, reductions
#: (sums, softmax, norms), the rest of PyTorch's elementwise kernels
KERNEL_KINDS = (("gemm", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
                ("copy_cast", ("copy_kernel", "Memcpy", "Memset")),
                ("reduce", ("reduce_kernel", "softmax", "Softmax", "norm")),
                ("elementwise", ("elementwise_kernel",)))


def profiled(fn) -> tuple[float, dict]:
    """``fn()`` once under ``torch.profiler`` (device activity only): the
    wall, kernels launched, device-busy ms (the union of the device
    events), the idle share, device ms by kind of kernel and the ten
    costliest kernels (by the first 80 characters of the name).  The
    profiler's raw events are read: building its per-op event tree for a
    step of ~10^5 kernels takes a minute."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = sorted((e.start_ns(), e.end_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA)
    if not ev:
        return wall, {"device_busy_ms": "not measured (no device events)"}
    busy, end = 0, -1
    by_name: dict = {}
    by_kind: dict = {}
    for s, e, name in ev:
        busy += max(0, e - max(s, end))
        end = max(end, e)
        by_name[name[:80]] = by_name.get(name[:80], 0) + (e - s)
        kind = next((k for k, keys in KERNEL_KINDS if any(
            key in name for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    launches = sum(1 for *_, n in ev if not n.startswith(("Memcpy", "Memset")))
    return wall, {"device_events": len(ev), "kernel_launches": launches,
                  "device_busy_ms": busy / 1e6,
                  "idle_share": 1.0 - busy / 1e9 / wall,
                  "by_kind_ms": {k: t / 1e6 for k, t in by_kind.items()},
                  "top_kernels_ms": {n: t / 1e6 for n, t in top}}


def train_full_run(model, seed: int, mode: str, steps: int,
                   profile_last: bool = False) -> dict:
    """``steps`` train steps of ``mode`` from seeded parameters: step
    seconds (host clock over a synchronised step), losses and grad norms
    (finite), the peak device memory; with ``profile_last`` one more step
    under the profiler."""
    cfg = model.cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed)
    opt = opt_state(params, mode)
    step = train_step_for(model, mode, AdamWConfig())
    rng = np.random.default_rng(seed)
    secs, losses, gnorms = [], [], []

    def one():
        nonlocal params, opt
        batch = lm_batch(rng, cfg, TRAIN_ACCUM, TRAIN_MB, TRAIN_SEQ)
        params, opt, stats = step(params, opt, batch)
        losses.append(float(stats["loss"]))
        gnorms.append(float(stats["grad_norm"]))

    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    prof = None
    if profile_last:
        t0 = time.perf_counter()
        wall, prof = profiled(one)
        prof["wall_s"] = wall
        prof["with_trace_processing_s"] = time.perf_counter() - t0
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"train_full {mode}: non-finite losses "
                             f"{losses} or grad norms {gnorms}")
    n = sum(a.numel() for a in param_leaves(params))
    tokens = TRAIN_ACCUM * TRAIN_MB * TRAIN_SEQ
    step_s = float(np.median(secs[1:]))
    out = {
        "mode": mode, "steps": steps, "tokens_a_step": tokens,
        "step_s": step_s, "step_s_all": secs,
        "tokens_per_s": tokens / step_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "losses": losses, "grad_norms": gnorms,
        "model_flops_a_step": 6.0 * n * tokens,
        "model_flop_share": 6.0 * n * tokens / (step_s * PEAK_BF16),
        "state_bytes": tree_bytes(opt),
    }
    if prof is not None:
        out["profiled_step"] = prof
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def train_full(seed: int, dev) -> dict:
    """(a): full qwen2.5-3b, AdamW then 8-bit AdamW with compression."""
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    line = {"config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "dtype": cfg.param_dtype,
            "attn": [cfg.attn_impl, cfg.attn_chunk],
            "params": cfg.param_count(), "seq": TRAIN_SEQ,
            "accum": TRAIN_ACCUM, "microbatch": TRAIN_MB, "remat": "every layer",
            "peak_bf16_flops": PEAK_BF16,
            "peak_used": "989 TFLOP/s dense bf16, H100 SXM data sheet"}
    line["adamw"] = train_full_run(model, seed, "adamw", TRAIN_STEPS,
                                   profile_last=True)
    line["compress_8bit"] = train_full_run(model, seed, "compress_8bit",
                                           TRAIN_STEPS_8BIT)
    return line


def tree_gap(got, want, floats_only: bool = False) -> float:
    """The largest leaf gap of two trees of one structure, each as a share
    of the ``want`` leaf's largest magnitude (``floats_only``: integer
    leaves, the 8-bit codes, left out)."""
    worst = 0.0
    for g, w in zip(param_leaves(got), param_leaves(want)):
        if floats_only and not w.is_floating_point():
            continue
        w = w.float()
        worst = max(worst, float((g.cpu().float() - w).abs().max()
                                 / w.abs().max().clamp_min(1e-30)))
    return worst


def same_tree_bits(a, b, tag: str) -> None:
    for x, y in zip(param_leaves(a), param_leaves(b)):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{tag}: the card's step gave other bits "
                                 "the second time")


def clone_tree(tree):
    return tree_map(lambda a: a.clone(), tree)


def code_flips(got, want) -> dict:
    """8-bit moment codes of the card against the CPU's: share that differ
    and the largest difference."""
    n = diff = worst = 0
    for g, w in zip(param_leaves(got["mv"]), param_leaves(want["mv"])):
        if w.dtype != torch.int8:
            continue
        d = (g.cpu().int() - w.int()).abs()
        n += d.numel()
        diff += int((d > 0).sum())
        worst = max(worst, int(d.max()))
    return {"share": diff / max(n, 1), "max": worst}


def f32_variant(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def rel_gap(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def cpu_mean_gradients(cfg, params, batch: dict):
    """The train step's mean loss and gradient on the CPU, written out
    plainly: each microbatch's ``value_and_grad`` without remat (the same
    bits as with it, less time), summed in f32 and divided by their
    count."""
    model = build_model(cfg, device="cpu")
    accum = batch["tokens"].shape[0]
    lsum, g = torch.zeros(()), None
    for i in range(accum):
        loss, grads = value_and_grad(
            model, params, {k: torch.from_numpy(v[i]) for k, v in
                            batch.items()}, remat=False)
        grads = tree_map(lambda a: a.float(), grads)
        g = grads if g is None else tree_map(torch.add, g, grads)
        lsum = lsum + loss
        del grads
    n = torch.full((), float(accum))
    return lsum / n, tree_map(lambda a: a / n, g)


def grads_gap(cfg, params, batch: dict, dev, cpu_run=None):
    """The train step's mean loss and gradient over both microbatches
    (``accumulate_gradients``) on the card against the CPU's from the same
    parameters: the gaps, the card's ``(loss, g)`` and the CPU's."""
    card = accumulate_gradients(build_model(cfg, device=dev), params, batch)
    if cpu_run is None:
        cpu_run = cpu_mean_gradients(
            cfg, tree_map(lambda a: a.cpu(), params), batch)
    return ({"loss": rel_gap(card[0], cpu_run[0]),
             "grads": tree_gap(card[1], cpu_run[1])}, card, cpu_run)


def train_cross_case(arch: str, seed: int, dev) -> dict:
    """(b): from one set of seeded parameters and one batch of two
    microbatches, (1) the train step's mean loss and gradient on the card
    (``accumulate_gradients``: both microbatches, their sum and the divide)
    against the CPU, (2) each mode's train step on the card twice, from
    clones of one state: equal bits, (3) each mode's whole step's
    ``stats`` loss and grad norm against the CPU's whole step, (4) the
    update half of that CPU step (``apply_gradients`` of the CPU's mean
    gradient) run on the card against the CPU: the stepped parameters and
    optimizer state.  The whole step's parameters are printed but not
    held: AdamW divides each gradient by its own magnitude, so a
    near-zero gradient whose sign the summation order decides moves its
    parameter by a whole step (phi-3-vision in f32: 3.38e-5 of a leaf's
    largest against the 2e-5 tolerance).  For F32_TRAIN archs (1), (3)
    and (4) are held in f32 on the same weights and (2) runs in bf16."""
    layers, seq, mb, modes = TRAIN_CROSS[arch]
    if layers is None:
        cfg = f32_variant(get_smoke_config(arch))
        rec = cfg.ssm or cfg.xlstm
        seq = 2 * rec.chunk if rec else TRAIN_CROSS_SMOKE_SEQ
    else:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        if arch in TRAIN_CROSS_CHUNK:
            cfg = dataclasses.replace(cfg, attn_chunk=TRAIN_CROSS_CHUNK[arch])
    f32 = cfg.param_dtype == "float32"
    tol = TRAIN_F32_TOL if f32 else CROSS_TOL
    gm = build_model(cfg, device=dev)
    gp = gm.init(seed)
    cp = tree_map(lambda a: a.cpu(), gp)
    batch = lm_batch(np.random.default_rng(seed), cfg, 2, mb, seq)
    out = {"layers": (f"{cfg.n_layers} of {get_config(arch).n_layers} (cut)"
                      if layers else f"smoke config, {cfg.n_layers}"),
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "dtype": cfg.param_dtype, "seq": seq, "accum": 2,
           "microbatch": mb,
           "params": sum(a.numel() for a in param_leaves(gp)),
           "attn": [cfg.attn_impl, cfg.attn_chunk], "modes": {}}
    hcfg, hp, hcp = cfg, gp, cp          # the config the checks hold
    gaps, card, cpu_run = grads_gap(cfg, gp, batch, dev)
    if not f32 and (arch in F32_TRAIN or max(gaps.values()) > tol):
        f32_cp = tree_map(lambda a: a.float(), cp)
        noise = cpu_mean_gradients(f32_variant(cfg), f32_cp, batch)
        out["cpu_bf16_against_f32"] = {
            "loss": rel_gap(cpu_run[0], noise[0]),
            "grads": tree_gap(cpu_run[1], noise[1])}
        if arch in F32_TRAIN:
            # held in f32 on the same (bf16-valued) weights; bf16 printed
            hcfg, hcp = f32_variant(cfg), f32_cp
            hp = tree_map(lambda a: a.float(), gp)
            out["bf16_gaps"] = gaps
            del card, cpu_run
            gaps, card, cpu_run = grads_gap(hcfg, hp, batch, dev,
                                            cpu_run=noise)
            out["held_in"] = "float32"
        del noise, f32_cp
    out["max_gap"] = gaps
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    cg = cpu_run[1]
    del card
    for mode in modes:
        flags = (mode != "adamw", mode != "adamw")
        step = train_step_for(gm, mode, opt_cfg)
        runs = [step(clone_tree(gp), opt_state(gp, mode), batch)
                for _ in range(2)]
        for i in range(3):
            same_tree_bits(runs[0][i], runs[1][i], f"train_cross {arch} {mode}")
        gs = runs[0][2]
        rec = {"loss": float(gs["loss"]), "grad_norm": float(gs["grad_norm"]),
               "card_twice": "equal bits"}
        whole = runs[0][0]
        del runs
        if hcfg is not cfg:
            step = train_step_for(build_model(hcfg, device=dev), mode, opt_cfg)
            whole, _, gs = step(clone_tree(hp), opt_state(hp, mode), batch)
        # the CPU's whole step (its own mean gradient), and the same
        # update of that gradient on the card
        cu = apply_gradients(opt_cfg, clone_tree(cg), clone_tree(hcp),
                             opt_state(hcp, mode), *flags)
        gu = apply_gradients(opt_cfg, tree_map(lambda a: a.to(dev), cg),
                             clone_tree(hp), opt_state(hp, mode), *flags)
        rec["whole_step"] = {
            "loss": rel_gap(gs["loss"], cpu_run[0]),
            "grad_norm": rel_gap(gs["grad_norm"], cu[2]["grad_norm"]),
            "params_not_held": tree_gap(whole, cu[0])}
        del whole
        rec["update_on_one_gradient"] = {
            "params": tree_gap(gu[0], cu[0]),
            "state": tree_gap(gu[1], cu[1], floats_only=True),
            "grad_norm": rel_gap(gu[2]["grad_norm"], cu[2]["grad_norm"])}
        if mode != "adamw":
            rec["update_on_one_gradient"]["codes"] = code_flips(gu[1], cu[1])
        out["modes"][mode] = rec
        del gu, cu
    held = [gaps["loss"], gaps["grads"]] + [
        r[part][k] for r in out["modes"].values()
        for part, keys in (("whole_step", ("loss", "grad_norm")),
                           ("update_on_one_gradient",
                            ("params", "state", "grad_norm")))
        for k in keys]
    codes = [r["update_on_one_gradient"].get("codes", {"max": 0})["max"]
             for r in out["modes"].values()]
    if max(held) > tol or max(codes) > 1:
        raise AssertionError(f"train_cross {arch}: the card differs from the "
                             f"CPU: {out} (tolerance {tol}, codes 1)")
    del gm, gp, cp, hp, hcp, cg, cpu_run
    torch.cuda.empty_cache()
    return out


def train_lm_runs(out_dir) -> dict:
    """(c): ``python -m repro_torch.examples.train_lm`` at its defaults on
    the card, uninterrupted and with a failure at TRAIN_LM_FAILURE: equal
    final parameters bit for bit, one restart, the loss falling, and the
    shard cache's device clique generation launching each of its three
    kernels once a window of every cache session."""
    runs = {}
    for tag, extra in (("clean", []), ("failure", [
            "--inject-failure", str(TRAIN_LM_FAILURE)])):
        ckpt = out_dir / f"train_lm_{tag}"
        if ckpt.exists():
            shutil.rmtree(ckpt)
        reset_launches()
        t0 = time.perf_counter()
        res = train_lm.main(["--ckpt-dir", str(ckpt)] + extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        shutil.rmtree(ckpt)
        launches = launch_counts()
        pipe, ctl, losses = res["pipeline"], res["controller"], res["losses"]
        windows = pipe.windows
        for k in CGM_KERNELS:
            if launches[k] != windows or windows < 1:
                raise AssertionError(f"train_lm {tag}: {launches[k]} {k} "
                                     f"launches for {windows} windows")
        k = max(1, len(losses) // 10)
        runs[tag] = {"s": secs, "restarts": ctl.restarts,
                     "steps_run": len(losses), "windows": windows,
                     "loss_first_tenth": sum(losses[:k]) / k,
                     "loss_last_tenth": sum(losses[-k:]) / k,
                     "launches": launches,
                     "akpc_total": pipe.telemetry.akpc_total,
                     "params": res["params"]}
    same_tree_bits(runs["clean"].pop("params"), runs["failure"].pop("params"),
                   "train_lm: the run with a failure")
    if runs["failure"]["restarts"] != 1 or runs["clean"]["restarts"] != 0:
        raise AssertionError(f"train_lm: restarts {runs}")
    runs["final_params"] = "bitwise equal"
    return runs


def train_phase(seed: int, dev, out_dir) -> tuple[dict, dict]:
    """The training path on the card: (a) full qwen2.5-3b training steps,
    (b) card against CPU for one train step of every family, (c) the
    example with an injected failure.  Returns the ``train`` line and the
    launches of (c)'s failure run."""
    line: dict = {"live_bytes_before": torch.cuda.memory_allocated()}
    times: dict = {}
    t0 = time.perf_counter()
    line["train_full"] = train_full(seed, dev)
    times["train_full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["train_cross"] = {a: train_cross_case(a, seed, dev)
                           for a in TRAIN_CROSS}
    line["train_cross_tolerance"] = {"bfloat16": CROSS_TOL,
                                     "float32": TRAIN_F32_TOL}
    times["train_cross"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["train_lm"] = train_lm_runs(out_dir)
    times["train_lm"] = time.perf_counter() - t0
    line["part_s"] = times
    print("train " + json.dumps(line), flush=True)
    return line, line["train_lm"]["failure"]["launches"]


#: ``prod_mesh``: full granite-moe-3b-a800m on a logical (data 2, model 4)
#: mesh of one card.  The decode cell is ``decode_32k`` cut to 8 rows x
#: 4,096 cached positions (the full 128 x 32,768 cache alone is ~0.5 TB):
#: 8 tokens a step send it down the weight-stationary branch
PROD_ARCH = "granite_moe_3b_a800m"
PROD_SHARDS = 8
PROD_DECODE = (8, 4096)
PROD_DECODE_STEPS = 4
#: the train cell: 2 layers at full width in f32, microbatches of 4 rows x
#: 512 positions (T 2,048, above the weight-stationary branch's 1,024: the
#: token-sharded branch), two of them
PROD_TRAIN = (2, 4, 512, 2)
#: the dry run's cells, each on both production meshes
DRYRUN_CELLS = (("qwen2_5_3b", "decode_32k"), ("deepseek_v2_236b", "train_4k"))
DRYRUN_ARG_RTOL = 0.01
#: the examples phase: the quickstart's runs at this many requests
EXAMPLE_REQUESTS = 20_000
EXAMPLE_RTOL = 1e-9


def moe_branches(log) -> dict:
    """How many MoE layers took each expert-parallel branch."""
    out: dict = {}
    for r in log:
        out[r.what] = out.get(r.what, 0) + 1
    return out


def decode_runs(model, params, cache0, toks, pos, mesh) -> tuple:
    """``len(toks)`` decode steps from ``cache0``: the logits, ms a step
    (CUDA events) and the MoE branches taken."""
    cache, logits, times = cache0, [], []
    with recording_collectives() as log:
        for i, tok in enumerate(toks):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            lg, cache = model.decode_step(params, cache, tok, pos + i,
                                          mesh=mesh)
            stop.record()
            logits.append(lg)
            times.append((start, stop))
    torch.cuda.synchronize()
    for lg in logits:
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("prod_mesh decode: non-finite logits")
    return logits, [a.elapsed_time(b) for a, b in times], moe_branches(log)


def logits_gap(got: list, want: list) -> float:
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max()) for g, w in zip(got, want))


def prod_decode(seed: int, dev, mesh) -> dict:
    """The decode cell meshed against unmeshed on the card, 4 steps from
    one seeded cache on the same tokens: ms a step both ways in bf16, and
    the logits held in f32 (the same weights and cache widened) at
    TRAIN_F32_TOL of the unmeshed largest.  The bf16 gap is printed, not
    held, beside the card's own bf16-against-f32 gap: granite's router
    picks 8 of 40 experts from bf16 activations, and the weight-stationary
    branch rounds each shard's partial to bf16, so over 32 layers a
    reordered pair of experts moves whole tokens (as ``train_cross``'s
    granite gradients, ROADMAP queue 3)."""
    B, S = PROD_DECODE
    cell = build_cell(PROD_ARCH, "decode_32k", mesh, global_batch=B,
                      seq_len=S)
    real = instantiate_cell(cell, dev, seed)
    params, cache0, tokens, pos = real.args
    rng = np.random.default_rng(seed)
    toks = [tokens] + [torch.from_numpy(rng.integers(
        0, cell.cfg.vocab, (B, 1), dtype=np.int64)).to(dev)
        for _ in range(PROD_DECODE_STEPS - 1)]
    L = cell.cfg.n_layers
    want = {"moe_weight_stationary": L * PROD_DECODE_STEPS}
    bf16, f32, ms = {}, {}, {}
    for tag, m in (("meshed", mesh), ("unmeshed", None)):
        bf16[tag], ms[tag], branches = decode_runs(real.model, params,
                                                   cache0, toks, pos, m)
        if m is not None and branches != want:
            raise AssertionError(f"prod_mesh decode: branches {branches}")
    model32 = build_model(f32_variant(cell.cfg), device=dev)
    params = tree_map(lambda a: a.float(), params)
    cache0 = tree_map(lambda a: a.float(), cache0)
    torch.cuda.empty_cache()
    for tag, m in (("meshed", mesh), ("unmeshed", None)):
        f32[tag] = decode_runs(model32, params, cache0, toks, pos, m)[0]
    gaps = {"float32": logits_gap(f32["meshed"], f32["unmeshed"]),
            "bfloat16_not_held": logits_gap(bf16["meshed"], bf16["unmeshed"]),
            "bfloat16_against_float32_unmeshed": logits_gap(
                bf16["unmeshed"], f32["unmeshed"])}
    if gaps["float32"] > TRAIN_F32_TOL:
        raise AssertionError(f"prod_mesh decode: meshed logits {gaps} of "
                             f"the unmeshed largest, tolerance "
                             f"{TRAIN_F32_TOL}")
    del real, params, cache0, bf16, f32, model32
    torch.cuda.empty_cache()
    return {"config": cell.cfg.name, "layers": L, "d_model": cell.cfg.d_model,
            "experts": [cell.cfg.moe.n_experts, cell.cfg.moe.top_k],
            "dtype": cell.cfg.param_dtype,
            "cut": f"batch {B} of 128, cache {S} of 32,768",
            "steps": PROD_DECODE_STEPS, "branches": want,
            "gaps": gaps, "tolerance": TRAIN_F32_TOL,
            "ms_meshed": ms["meshed"], "ms_unmeshed": ms["unmeshed"]}


def prod_train(seed: int, dev, mesh) -> dict:
    """One train step of the cut granite under the logical mesh on the card
    (``make_train_step(mesh=)``, and ``accumulate_gradients`` for its mean
    gradient) against the same step's halves on the CPU under a CPU mesh
    of the same shape: mean gradient, loss and grad norm at 2e-5; the
    meshed loss printed beside the unmeshed one."""
    layers, rows, seq, accum = PROD_TRAIN
    cfg = f32_variant(dataclasses.replace(get_config(PROD_ARCH),
                                          n_layers=layers))
    cpu_mesh = make_test_mesh(devices=["cpu"] * PROD_SHARDS)
    gm = build_model(cfg, device=dev)
    gp = gm.init(seed)
    cp = tree_map(lambda a: a.cpu(), gp)
    batch = lm_batch(np.random.default_rng(seed), cfg, accum, rows, seq)
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    with recording_collectives() as log:
        g_loss, g_grad = accumulate_gradients(gm, gp, batch, mesh=mesh)
    branches = moe_branches(log)
    t0 = time.perf_counter()
    _, _, gstats = make_train_step(gm, opt_cfg, mesh=mesh)(
        clone_tree(gp), adamw_init(gp), batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    unmeshed = make_eval_step(gm)
    plain_loss = sum(float(unmeshed(gp, {k: v[i] for k, v in batch.items()}))
                     for i in range(accum)) / accum
    cm = build_model(cfg, device="cpu")
    c_loss, c_grad = accumulate_gradients(cm, cp, batch, mesh=cpu_mesh)
    _, _, cstats = apply_gradients(opt_cfg, clone_tree(c_grad), cp,
                                   adamw_init(cp))
    gaps = {"grads": tree_gap(g_grad, c_grad),
            "loss": rel_gap(g_loss, c_loss),
            "step_loss": rel_gap(gstats["loss"], c_loss),
            "grad_norm": rel_gap(gstats["grad_norm"], cstats["grad_norm"])}
    want = {"moe_token_sharded": layers * accum}
    if branches != want:
        raise AssertionError(f"prod_mesh train: branches {branches}, "
                             f"expected {want}")
    if max(gaps.values()) > TRAIN_F32_TOL:
        raise AssertionError(f"prod_mesh train: the card differs from the "
                             f"CPU: {gaps} (tolerance {TRAIN_F32_TOL})")
    del gm, gp, cp, g_grad, c_grad
    torch.cuda.empty_cache()
    return {"config": cfg.name,
            "layers": f"{layers} of {get_config(PROD_ARCH).n_layers} (cut)",
            "dtype": "float32", "rows": rows, "seq": seq, "accum": accum,
            "tokens_a_microbatch": rows * seq, "branches": branches,
            "gaps": gaps, "tolerance": TRAIN_F32_TOL,
            "loss_meshed": float(g_loss), "loss_unmeshed": plain_loss,
            "step_s": step_s}


def prod_mesh_phase(seed: int, dev) -> dict:
    """The production mesh's branches on the card: the decode and train
    cells of full-width granite-moe-3b-a800m under a logical (2, 4) mesh."""
    mesh = make_test_mesh(devices=[str(dev)] * PROD_SHARDS)
    line = {"mesh": mesh.shape, "logical_shards_of": str(dev)}
    t0 = time.perf_counter()
    line["decode"] = prod_decode(seed, dev, mesh)
    line["decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["train"] = prod_train(seed, dev, mesh)
    line["train_s"] = time.perf_counter() - t0
    print("prod_mesh " + json.dumps(line), flush=True)
    return line


def dryrun_phase(seed: int, dev) -> dict:
    """``run_cell`` for DRYRUN_CELLS on both production meshes (every record
    printed, each must be ``ok``), then the decode cell of ``prod_mesh`` on a
    (1, 1) mesh instantiated on the card: the allocation it takes against
    the dry run's argument bytes (held within DRYRUN_ARG_RTOL) and one
    step's peak against the dry run's (printed)."""
    line: dict = {"records": []}
    for arch, shape in DRYRUN_CELLS:
        for mesh_kind in ("single", "multi"):
            t0 = time.perf_counter()
            rec = run_cell(arch, shape, mesh_kind)
            rec["wall_s"] = time.perf_counter() - t0
            print("dryrun_record " + json.dumps(rec), flush=True)
            if rec["status"] != "ok":
                raise AssertionError(f"dryrun {arch} {shape} {mesh_kind}: "
                                     f"{rec}")
            line["records"].append({k: rec[k] for k in (
                "arch", "shape", "mesh", "wall_s", "live_bytes_per_dev",
                "fits_hbm", "dominant", "roofline_fraction")})
    B, S = PROD_DECODE
    cell = build_cell(PROD_ARCH, "decode_32k",
                      make_test_mesh(devices=[str(dev)]), global_batch=B,
                      seq_len=S)
    predicted = arg_bytes(cell)
    cost = trace_cell(cell)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    real = instantiate_cell(cell, dev, seed)
    torch.cuda.synchronize()
    got = torch.cuda.memory_allocated() - base
    gap = abs(got - predicted) / predicted
    torch.cuda.reset_peak_memory_stats()
    out = real.step_fn(*real.args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, real
    torch.cuda.empty_cache()
    line["arg_bytes"] = {"cell": f"{PROD_ARCH} decode_32k cut to {B} x {S}, "
                                 "(1, 1) mesh", "dry_run": predicted,
                         "memory_allocated": got, "gap": gap,
                         "tolerance": DRYRUN_ARG_RTOL}
    line["peak_bytes"] = {"dry_run_arg_plus_temp": predicted + cost.peak_bytes,
                          "max_memory_allocated": peak,
                          "held": False}
    print("dryrun " + json.dumps(line), flush=True)
    if gap > DRYRUN_ARG_RTOL:
        raise AssertionError(f"dryrun: the card allocated {got} bytes for the "
                             f"cell's arguments, the dry run says "
                             f"{predicted}")
    return line


def examples_phase() -> dict:
    """``python -m repro_torch.examples.quickstart`` at EXAMPLE_REQUESTS on
    the card and on the CPU: every run's costs equal at EXAMPLE_RTOL, the
    streamed total equal to the offline AKPC (the example holds it) and to
    the CPU's; the device CGM's three kernels and the host schedule's
    lookup launched."""
    argv = ["--requests", str(EXAMPLE_REQUESTS)]
    reset_launches()
    t0 = time.perf_counter()
    card = quickstart.main(argv)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = launch_counts()
    t0 = time.perf_counter()
    cpu = quickstart.main(argv + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    gaps = {}
    for label, want in cpu["rows"].items():
        got = card["rows"][label]
        gaps[label] = max(abs(getattr(got, f) - getattr(want, f))
                          / max(abs(getattr(want, f)), 1e-30)
                          for f in ("transfer", "caching", "total"))
    gaps["stream"] = rel_gap(card["stream_total"], cpu["stream_total"])
    line = {"requests": EXAMPLE_REQUESTS, "card_s": card_s, "cpu_s": cpu_s,
            "totals": {k: v.total for k, v in card["rows"].items()},
            "stream_total": card["stream_total"], "gaps": gaps,
            "rtol": EXAMPLE_RTOL, "launches": launches}
    print("examples " + json.dumps(line), flush=True)
    if max(gaps.values()) > EXAMPLE_RTOL:
        raise AssertionError(f"examples: the card's quickstart differs from "
                             f"the CPU's: {gaps}")
    for k in CGM_KERNELS + ("packed_lookup",):
        if launches[k] < 1:
            raise AssertionError(f"examples: {k} never launched")
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=1_000_000,
                    help="requests of each AKPC device-CGM configuration "
                    "(cut only this)")
    ap.add_argument("--requests2", type=int, default=1_000_000,
                    help="requests of each host-schedule configuration "
                    "(and of the fig6 sweep's trace)")
    ap.add_argument("--requests3", type=int, default=1_000_000,
                    help="requests of each trace of the fig10 sweep")
    ap.add_argument("--requests4", type=int, default=1_000_000,
                    help="requests of the learned phase's training and "
                    "evaluation traces")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="also profile the akpc replay of each device-CGM "
                    "configuration's first N requests (tables under --out)")
    ap.add_argument("--profile2", type=int, default=0, metavar="N",
                    help="the same for the host-schedule akpc replay of "
                    "each hetero configuration")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the build log and profile tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul allow_tf32=False cudnn allow_tf32=False", flush=True)
    for flag, n in (("requests", args.requests),
                    ("requests2", args.requests2),
                    ("requests3", args.requests3),
                    ("requests4", args.requests4)):
        if n != 1_000_000:
            print(f"cut: --{flag} {n} per configuration (n and m "
                  "unchanged)", flush=True)
    dev = torch.device("cuda")
    phases: dict = {}

    def phase(name, t0):
        phases[name] = time.perf_counter() - t0
        print(f"phase {name}: {phases[name]:.3f} s", flush=True)

    t0 = time.perf_counter()
    configs = {}
    for config in ("netflix-table2", "catalog-10k"):
        trace = make_trace(config, args.requests, args.seed)
        t_cg = t_cg_for(trace)
        pol = akpc(t_cg)
        sched = build_cgm_schedule(trace, t_cg, uses_sizes=False,
                                   hot_dims=policy_hot_dims(pol))
        configs[config] = (trace, t_cg, sched.h, sched.wcap)
        print(f"config {config}: n={trace.n} m={trace.m} "
              f"requests={trace.n_requests} t_cg={t_cg} h={sched.h} "
              f"wcap={sched.wcap} windows={sched.boundary_steps.size}",
              flush=True)
    traces2 = {c: make_trace(c, args.requests2, args.seed)
               for c in ("hetero-table2", "hetero-catalog-10k")}
    traces2["netflix-table2"] = (
        configs["netflix-table2"][0] if args.requests2 == args.requests
        else make_trace("netflix-table2", args.requests2, args.seed))
    phase("traces", t0)

    t0 = time.perf_counter()
    info = _build.build_all()
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in info["logs"].items()))
    print(f"build: {time.perf_counter() - t0:.2f} s for {info['built']} "
          "(nvcc, sm_90a, in parallel)", flush=True)
    phase("build", t0)

    results, captured_cgm = {}, {}
    for c, v in configs.items():
        t0 = time.perf_counter()
        results[c], captured_cgm[c] = slice_phase(c, v[0], v[1])
        phase(f"slice1 {c}", t0)
    t0 = time.perf_counter()
    records, worst, merges = kernel_phase(
        {c: (v[2], v[3]) for c, v in configs.items()}, captured_cgm,
        args.seed, dev)
    del captured_cgm
    phase("kernels_cgm", t0)

    results2, captured = {}, {}
    plan = (("hetero-table2", ("akpc", "no_packing", "ttl", "packcache",
                               "dp_greedy"), "heterogeneous"),
            ("hetero-catalog-10k", ("akpc",), "heterogeneous"),
            ("netflix-table2", ("no_packing",), "table1"))
    for c, names, cost_model in plan:
        t0 = time.perf_counter()
        key = c if cost_model == "heterogeneous" else f"{c}/table1"
        results2[key], cap = slice2_phase(
            c, traces2[c], names, cost_model, capture_name=names[0])
        if cost_model == "heterogeneous":
            captured[c] = cap
        phase(f"slice2 {key}", t0)

    t0 = time.perf_counter()
    bench_recs, bench_launches = kernels_bench_phase(dev)
    merges["synthetic full merge"] = full_merge(bench_recs)
    phase("kernels_bench", t0)
    t0 = time.perf_counter()
    fig6 = sweep_fig6_phase(traces2["netflix-table2"])
    phase("sweep_fig6", t0)
    t0 = time.perf_counter()
    fig10, captured["sweep-fig10"] = sweep_fig10_phase(args.requests3)
    phase("sweep_fig10", t0)
    t0 = time.perf_counter()
    fig7_traces = {"netflix": configs["netflix-table2"][0],
                   "spotify": paper_trace("spotify", args.requests,
                                          args.seed)}
    fig7_line, lane_recs = sweep_fig7_phase(fig7_traces,
                                            configs["catalog-10k"][0])
    phase("sweep_fig7", t0)

    t0 = time.perf_counter()
    records2 = kernel_phase2(captured, args.seed, dev)
    del captured
    phase("kernels_host_path", t0)

    serve = {}
    t0 = time.perf_counter()
    net, net_tcg = configs["netflix-table2"][0], configs["netflix-table2"][1]
    serve["serve_netflix"] = serve_phase(
        "serve_netflix", "netflix-table2", net, lambda: akpc(net_tcg), None,
        results["netflix-table2"]["costs"], expect=CGM_KERNELS,
        per_window=("crm_update", "merge_density"))
    phase("serve_netflix", t0)
    t0 = time.perf_counter()
    het = traces2["hetero-table2"]
    het_env = env_for(het, CostParams(), PRICE_SIGMA)
    het_tcg = results2["hetero-table2"]["akpc"]["t_cg"]
    for name in ("akpc", "no_packing"):
        expect = (STEP, "packed_lookup") + (
            ("crm_update", "clique_pair_edges") if name == "akpc" else ())
        serve[f"serve_hetero {name}"] = serve_phase(
            "serve_hetero", "hetero-table2", het,
            lambda name=name: host_policy(name, het_tcg, het_env,
                                          "heterogeneous"),
            het_env, results2["hetero-table2"][name]["costs"], expect,
            count_syncs=True)
    phase("serve_hetero", t0)
    t0 = time.perf_counter()
    serve_bench_phase()
    phase("serve_bench", t0)
    t0 = time.perf_counter()
    learned, trained = learned_phase(args.requests4)
    phase("learned", t0)
    t0 = time.perf_counter()
    shards_line, captured_shards = sweep_shards_phase(trained)
    del trained
    report_rows: list = []
    rows_rec = rows_step_record(report_rows, captured_shards[STEP],
                                "captured sweep-shards step (per-lane rows)")
    del captured_shards
    print("kernels_rows " + json.dumps({"checks": report_rows,
                                        "record": rows_rec}), flush=True)
    phase("sweep_shards", t0)
    t0 = time.perf_counter()
    comp = competitive_phase()
    phase("competitive", t0)
    t0 = time.perf_counter()
    pipe = pipeline_phase()
    phase("pipeline", t0)
    t0 = time.perf_counter()
    expert, gather_rec = expert_cache_phase(args.seed, dev)
    phase("expert_cache", t0)
    t0 = time.perf_counter()
    figures, fig_step_rec = figures_phase(out_dir)
    phase("figures", t0)
    t0 = time.perf_counter()
    mesh = mesh_phase(traces2["hetero-catalog-10k"], args.seed)
    phase("mesh", t0)
    t0 = time.perf_counter()
    serve_model, serve_model_recs = serve_model_phase(args.seed, dev)
    phase("serve_model", t0)
    t0 = time.perf_counter()
    families, families_recs = serve_families_phase(args.seed, dev)
    phase("serve_families", t0)
    t0 = time.perf_counter()
    _, train_launches = train_phase(args.seed, dev, out_dir)
    phase("train", t0)
    t0 = time.perf_counter()
    prod_mesh_phase(args.seed, dev)
    phase("prod_mesh", t0)
    t0 = time.perf_counter()
    dryrun_phase(args.seed, dev)
    phase("dryrun", t0)
    t0 = time.perf_counter()
    examples = examples_phase()
    phase("examples", t0)
    served_mla = families["serve-deepseek-v2-2l"]["launches"]
    consumers = {
        **{f"learned {cm}": line["launches"] for cm, line in learned.items()},
        "learned heterogeneous live":
            learned["heterogeneous"]["live"]["launches"],
        **{f"pipeline {b}": v for b, v in pipe["launches"].items()},
        **{f"expert_cache {b}": v for b, v in expert["launches"].items()},
        "train train_lm (shard cache, injected failure)": train_launches,
        "examples quickstart": examples["launches"],
    }
    t0 = time.perf_counter()
    if args.profile:
        for c, v in configs.items():
            head = v[0].slice(0, min(args.profile, v[0].n_requests))
            t_head = t_cg_for(head)
            profile_phase(c, head, lambda: akpc(t_head), out_dir)
    if args.profile2:
        for c in ("hetero-table2", "hetero-catalog-10k"):
            tr = traces2[c]
            head = tr.slice(0, min(args.profile2, tr.n_requests))
            env = env_for(head, CostParams(), PRICE_SIGMA)
            t_head = t_cg_for(head, CostParams(), env=env,
                              cost_model="heterogeneous")
            profile_phase(c, head, lambda: host_policy(
                "akpc", t_head, env, "heterogeneous"), out_dir)
    if args.profile or args.profile2:
        phase("profile", t0)

    main_cfg, main_cfg2 = "catalog-10k", "hetero-table2"
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        extra: dict = {}
        if name in CGM_KERNELS:
            rec = dict(records[main_cfg][name])
            launches = results[main_cfg]["launches"][name]
            by_config = {c: {**records[c][name],
                             "launches": results[c]["launches"][name]}
                         for c in records}
            for c, rec2 in records2.get(name, {}).items():
                by_config[f"{c} host CGM"] = {
                    **rec2, "launches": results2[c]["akpc"]["launches"][name]}
            for label, rec2 in worst.get(name, {}).items():
                by_config[f"worst {label}"] = rec2
            if name == "merge_density":
                by_config.update(merges)
            for label, rec2 in lane_recs.get(name, {}).items():
                by_config[f"sweep_fig7 laned {label}"] = {
                    **rec2, **({"launches": fig7_line["launches"][name]}
                               if label == "captured fig7 grid" else {})}
        elif name == "unpacked_lookup":
            brecs = [r for r in bench_recs if r["name"] == name]
            rec = dict(brecs[-1])
            launches = bench_launches[name]
            by_config = {f"kernel_bench {r['shape']['config']}":
                         {**r, "launches": launches} for r in brecs}
        else:
            # the replay launches both scans' device code as seg_scan_step,
            # one launch a step: its count and its record stand beside each
            # standalone scan's
            counter = STEP if name in SEG_KERNELS else name
            rec = dict(records2[name][main_cfg2])
            launches = results2[main_cfg2]["akpc"]["launches"][counter]
            by_config = {}
            for c, r in records2[name].items():
                runs = results2.get(c)
                n_l = (runs["akpc"]["launches"][counter] if runs
                       else fig10["launches"][counter])
                by_config[c] = {**r, "launches": n_l}
                if counter == STEP:
                    by_config[c][STEP] = records2[STEP][c]
            for key, runs in results2.items():
                for pol, line in runs.items():
                    by_config.setdefault(f"{key} {pol}", {})["launches"] = \
                        line["launches"][counter]
            by_config.setdefault("sweep-fig6", {})["launches"] = \
                fig6["launches"][counter]
            by_config.setdefault("sweep-fig10", {})["launches"] = \
                fig10["launches"][counter]
            by_config["sweep-shards per-lane rows, captured"] = {
                **rows_rec, "launches": shards_line["launches"][counter]}
            for label, rec2 in comp["checks"].items():
                if rec2["launches"][counter]:
                    by_config[f"competitive {label}"] = {
                        "launches": rec2["launches"][counter]}
            for r in bench_recs:
                if r["name"] in (name, counter):
                    sh = r["shape"]
                    tag = (sh["config"] if "config" in sh else
                           f"{r['name']} S={sh['S']} L={sh['L']} "
                           f"starts={sh['starts']}")
                    by_config[f"kernel_bench {tag}"] = {
                        **r, "launches": bench_launches[r["name"]]}
            if counter == STEP:
                extra = {"launched_as": STEP,
                         "standalone_launches": bench_launches[name],
                         STEP: records2[STEP][main_cfg2]}
        counter = STEP if name in SEG_KERNELS else name
        for key, line in serve.items():
            if line["launches"][counter]:
                by_config.setdefault(key, {})["launches"] = \
                    line["launches"][counter]
        for key, counts in consumers.items():
            if counts[counter]:
                by_config.setdefault(key, {})["launches"] = counts[counter]
        for key, counts in figures["launches"].items():
            if counts[counter]:
                by_config.setdefault(f"figures {key}", {})["launches"] = \
                    counts[counter]
        for key, counts in mesh["launches"].items():
            if counts[counter]:
                by_config.setdefault(f"mesh {key}", {})["launches"] = \
                    counts[counter]
        if name in SEG_KERNELS:
            by_config["figures fig8-bucketed-hetero step, captured"] = {
                **fig_step_rec, "launches":
                    figures["launches"]["fig8-bucketed-hetero"][STEP]}
        if name == "packed_lookup":
            by_config["expert_cache gather (granite-moe expert rows)"] = \
                gather_rec
        if serve_model["launches"][counter]:
            by_config["serve_model (granite-moe-3b-a800m served)"] = {
                "launches": serve_model["launches"][counter]}
        key = "gather" if name == "packed_lookup" else name
        if key in serve_model_recs:
            by_config[f"serve_model {key}, captured"] = {
                **serve_model_recs[key],
                "launches": serve_model["launches"][name]}
        if served_mla[counter]:
            by_config["serve_families (deepseek-v2, 2 layers, served)"] = {
                "launches": served_mla[counter]}
        if key in families_recs:
            by_config[f"serve_families {key}, captured"] = {
                **families_recs[key], "launches": served_mla[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, **rec, **extra,
            "by_config": by_config,
        })
    print(f"phase total: {time.perf_counter() - t_all:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
