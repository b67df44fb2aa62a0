#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spcbpt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero:
  1. environment: torch, CUDA, nvcc release, card name and power limit;
  2. build: the CUDA kernels of csrc/ (one nvcc per source, all started
     together) and the native host library (g++), through the package's
     own loaders;
  3. kernels vs plain: the row-walk kernels K1 (closest hit) and K2 (any
     hit), which compute their rows' cluster entries themselves, against
     their plain torch versions on the card, on the 32,576-triangle
     interior, for a 512x512 camera wavefront and a 2^17-ray incoherent
     bounce wavefront with a quarter of its lanes dead, and against brute
     force on a 4096-ray subset; the kernels' entry phase alone
     (`ray_walk_entries`) against the plain `row_entries` table; each
     kernel alone and each call;
  4. K3 vs plain: the brute-force kernel (closest and any hit) against its
     plain torch version on the 32-triangle Cornell box, for a 512x512
     camera wavefront, a 2^17-ray bounce wavefront with a quarter of its
     lanes dead and a 3 x 2^16-ray connection-shaped segment wavefront with
     masked lanes, and on the interior's 512x512 camera rays against the
     512 triangles that hold most of their closest hits, both cull
     settings, each wavefront with at least MIN_HIT_SHARE of its lanes
     hit and of its any-hit lanes occluded; each kernel alone (its launches
     captured in a CUDA graph and replayed, with torch.profiler's kernel
     times beside it) and each call through its binding; what the pairs
     meet (the shares failing at det, at u and at v) and the live work,
     stage by stage, that bounds them; one torch.profiler window showing
     that a brute-mode trace_closest / trace_any call issues exactly one
     device kernel;
  5. main path, PT on the interior: `render_cli --scene interior --alg pt
     --dim 1024x1024 --spp 4` through K1/K2, with no call of the plain
     route's `row_entries` pass;
  6. main path, Cornell through K3: a synthetic trained subspace state
     saved with the port's checkpoint, then `render_cli --scene cornell`
     at 512x512, 4 spp with `--alg spcbpt --resume`, `--alg bdpt` (100,000
     light paths per frame, light and eye depth 16, 3 connections) and
     `--alg pt`; the BDPT and SPCBPT means within MEAN_VS_PT of PT's;
  7. SPCBPT on interior_cove at 256x256, 1 spp, through K1/K2 (the walk
     under the masked connection wavefront);
  8. CPU vs card: the same 64x64 render on both, PT (2 spp, interior) and
     SPCBPT (1 spp, Cornell, 10,000 light paths, the saved state);
  9. tile kernels vs plain: the interior in `tile` mode (1,370 clusters of
     at most 32 triangles): K4's round walk (tile_closest on the card: one
     launch per trace, no host sync, each tile's rounds summing to the
     plain host loop's visits), K4's single round, and the fused walk K5
     (closest and any hit) against their plain versions on the camera,
     bounce and connection wavefronts, both cull settings, the bounce
     wavefront with at least MIN_HIT_SHARE of its lanes hit; against
     brute force on a subset and against the walk mode; each kernel alone
     and each call; K5 closest and the single round beside their first
     forms (FIRST_FORMS, built from tile_walk_variants.py), which must equal
     them;
 10. list-walk kernels vs plain: the four forms of K6 (closest and any
     hit, resident and streamed) on both cluster sets of one BVH (the tile
     mode's K=32, the walk mode's K=128) for the camera, bounce and
     connection wavefronts, both cull settings, tiles of 256 (and 128 for
     the resident closest form and both any forms), prune=False once;
     against brute force on a subset; times per call (every form at K=128
     and K=32, the any forms also on the connection wavefront), and the
     rounds and tests each group made against the plain walk's tile visits
     and tests; each form alone and each call;
 11. the list walk's path: the traversal profiler `python -m
     spcbpt_tpu_torch.apps.prof_traversal` at its defaults (2^17 rays,
     both sets, tiles 128 and 256, every form) in a process of its own;
     every K6 entry point must launch there;
 12. tile main path, PT on the interior in `tile` mode at 1024x1024, depth
     30, 2^17 pool lanes, 4 spp, through `load_trace_scene` with mode
     "tile" and `pt_pool.render_pool` (the library boundary: the CLI has no
     mode flag): K4 closest hits (one walk launch and no round-loop host
     sync per trace), K5 any hits, the mean within TILE_MEAN_PT of phase
     5's walk-mode mean on the same seeds;
 13. cove SPCBPT 256x256, 1 spp in `tile` mode from the saved state: the
     connection wavefront through K5's any hit; the mean of the image with
     its pixels capped at COVE_CAP within TILE_MEAN_SPCBPT of phase 7's, the
     plain mean within TILE_MEAN_SPCBPT_TAIL; a walk-mode render of the same
     frame gives the spread, and frames with planted any-hit faults must
     fall outside the bounds;
 14. CPU vs card in `tile` mode: PT 64x64, 2 spp, depth 8 on the scale=1
     interior (the CPU runs JAX's matmul walk, the card K4/K5);
 15. training, Cornell through K3: `render_cli --scene cornell --alg
     spcbpt --checkpoint smoke_out/cornell_trained.npz --spp 4` at 512x512
     and the CLI's training defaults (200,000 pretraced paths on 8,192
     lanes, 500,000 Q paths from 50,000-path light traces of depth 8,
     Gamma 1000x1000 in batches of 20,000, 1 epoch); the launch counters
     over the training alone (K3 closest and any > 0), the stage times and
     counts, the trained Gamma's rows finite and summing to 1, the CMF rows
     monotone and ending at 1, every Adam loss finite; then `--alg spcbpt
     --resume` from that checkpoint, its mean within MEAN_VS_PT of phase
     6's PT mean;
 16. one pretrace launch (Cornell, PRETRACE_LANES lanes, frame 0) on the
     CPU and on the card: at least PRETRACE_AGREE of the lanes agree on
     valid and n_conns; its K3 launches; one launch at the CLI's 8,192
     lanes, its wall against its device activities (torch.profiler);
 17. the relMSE benchmark: `python -m spcbpt_tpu_torch.apps.benchmark
     --scene cornell --dim 256x256 --ref-spp 64 --spp 8 --algs
     pt,bdpt,spcbpt --checkpoint smoke_out/cornell_trained.npz` (in this
     process, its output in smoke_out/benchmark.log): every relMSE finite;
 18. sky-lit Cornell through K3: the bundled Cornell scene under a
     1024x512 Radiance sky the script writes from SKY_SEED (new-RLE
     scanlines; a gradient, noise, a sun texel, env_lum 1) with one
     Direction light shining into the box's open front; K3 closest and any
     equal to their plain versions on its camera, bounce and env NEE
     wavefronts (hit and occluded shares printed); render_cli at 512x512,
     4 spp: PT, PT with the sky's raster zeroed (env_lum 0; the sky-lit
     mean at least SKY_ON_OVER_OFF times it), BDPT, SPCBPT trained from the
     scene at the CLI's defaults (--checkpoint; stage seconds and K3
     launches per stage, pretrace acceptance against phase 15's) and
     rendered from it (--resume); BDPT and SPCBPT within MEAN_VS_PT of PT;
     the LVC vertices of one 100,000-path frame against plain Cornell's;
     PT 64x64 on the CPU and on the card;
 19. sky-lit furnished scene through K1/K2: the interior's furniture
     (scale 4: wood, ornament, lamp, bed, curtain) on one floor quad, no
     room shell, under the same sky and Direction light and one quad
     light; K1 and K2 on its env wavefronts as in phase 18; PT at
     1024x1024, depth 30, 2^17 pool lanes, 4 spp; SPCBPT 256x256, 1 spp
     from a synthetic trained state;
 20. the close-set network, through K3 (run after phase 15): `render_cli
     --scene cornell --alg spcbpt --classifier nn --checkpoint
     smoke_out/cornell_nn.npz` at the CLI's training defaults (the network
     on up to 500,000 paths in 4,096-path batches, 1 epoch); launch
     counters over the training alone, the network's seconds, its step
     losses finite and its objective over those batches lower than the
     initial network's; SPCBPT 4 spp with `--resume` from that checkpoint
     within MEAN_VS_PT of phase 6's PT mean, its ms/spp beside the centroid
     state's of phase 15; one blended first-stage draw of 2^16 lanes on
     the CPU and on the card (RNG states equal, NN_AGREE of the picks);
 21. the mesh path (parallel/tile.py, run after phase 17): this process
     alone as a 1x1 mesh over NCCL (one card: NCCL takes one rank a
     card): sharded PT on Cornell 512x512 (K3) and on the interior
     1024x1024 (K1/K2), each torch.equal to the sequential route; sharded
     BDPT and SPCBPT on Cornell 512x512 from phase 15's state, finite; the
     data-parallel Gamma step on 20,000 paths against one process; then
     `multichip_bench`, which spawns its rank: BASELINE config 5
     (cornell_glossy 2048x2048 SPCBPT, 1 subframe, MESH_SUB_BLOCKS row
     blocks, first and warm run) with its peak memory, and one
     `--equal-time` run at 256x256 against a 64-spp PT reference the phase
     renders itself (key 'img'); their outputs in smoke_out/multichip_*.
Each render phase sets every launch counter to 0 just before it renders and
reads them just after (the profiler's counters start at 0 in its own
process and are read from its last line); the CLI renders' PNG, HDR and
stats go to smoke_out/. The last three lines are the card as nvidia-smi
names it, one JSON object with each kernel's numbers (its bound from the
plain version's visits on the same inputs, see PEAK_F32_FLOPS; the K6
forms and K5 closest, which test fewer pairs than their plain version,
take the bound of their own tests (their groups' optional rounds output)
and K4's single round that of its live lanes, each carrying the plain
version's beside it as plain_bound_ms;
K3's rows bound the live work of their inputs stage by stage and carry
every lane against every triangle as plain_bound_ms, and the shares of
live pairs failing at det, at u and at v; every row gives the kernel alone
as ms (`graph_ms`: its launches captured in a CUDA graph and replayed, no
host time) and the call through its binding as call_ms, and K5 closest's
and the single round's rows their first form alone as first_form_ms), and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BOUNCE_RAYS = 1 << 17
CAMERA_DIM = 512
# Kernel vs plain version on the same prepared rays: equal bit for bit (the
# kernels are built with --fmad=false, so they round like the plain torch
# version). Against brute force, only on a subset and with a bound: an exact
# tie at an edge shared by two clusters goes to the earlier-visited cluster
# in the walk and to the smaller triangle id in brute force.
BRUTE_SUBSET = 4096
TRI_AGREE = 0.999        # share of subset lanes with brute force's triangle
OCC_AGREE = 0.9999       # share of subset lanes with brute force's occlusion
CONN_RAYS = 3 << 16      # connection wavefront: 3 draws x 2^16 pool lanes
# BDPT and SPCBPT are unbiased, like PT: their Cornell means at 512x512,
# 4 spp must lie within 2% of PT's (the JAX package's record is 0.3%).
MEAN_VS_PT = 0.02
# one pretrace launch on the CPU and on the card (phase 16)
PRETRACE_LANES = 1024
PRETRACE_AGREE = 0.99
GAMMA_ROW_SUM = 1e-5     # trained Gamma's rows sum to 1 within this
TRAIN_PATHS = 200_000    # render_cli's --train-samples and --q-samples
Q_PATHS = 500_000
TRAIN_LANES = 8192       # render_cli's pretrace lanes
# the close-set network (phase 20): its training's batches and path cap;
# one blended first-stage draw on the CPU and the card (the pool's 2^16
# lanes), picks equal on NN_AGREE of them and their pmfs within
# NN_PMF_RTOL (a pick sits on a float cumsum)
NN_BATCH = 4096
NN_MAX_PATHS = 500_000
NN_DRAW_LANES = 1 << 16
NN_SEED = 21
NN_AGREE = 0.999
NN_PMF_RTOL = 1e-5
# the mesh path (phase 21): NCCL at world size 1 (one card), PT depth and
# light paths of the sharded renders (multichip_bench's defaults), the
# data-parallel step on the CLI's Gamma batch against one process (the
# gather's backward adds atomically on the card), config 5's row blocks,
# the equal-time run
MESH_TIMEOUT_S = 600
MESH_PT_DIMS = {"cornell": 512, "interior": 1024}
MESH_PT_DEPTH = 8
MESH_LIGHT_PATHS = 8192
DP_PATHS = 20_000
DP_LOSS_RTOL = 1e-6
DP_THETA_ATOL = 1e-6
MESH_SUB_BLOCKS = 4
EQUAL_TIME_DIM = 256
EQUAL_TIME_REF_SPP = 64
EQUAL_TIME_S = 5.0
BENCH_ARGS = ["--scene", "cornell", "--dim", "256x256", "--ref-spp", "64",
              "--spp", "8", "--algs", "pt,bdpt,spcbpt"]
# CPU vs card, SPCBPT 64x64 1 spp: the two devices trace the same seeds,
# but transcendental ulps, atomic sums and label ties let some paths part;
# the mean must agree within 1%.
SPCBPT_CPU_CARD = 0.01
# Tile mode against walk mode on the card, same seeds: both run direct
# Moller-Trumbore, so paths part only where an exact tie at a shared edge
# goes to another cluster. PT means within 0.5%, SPCBPT means within 1%
# (its LVC sums are atomics whose order changes from run to run). The cove
# is lit indirectly only, and at 1 spp a few pixels above 100 carry a tenth
# of its mean: where two renders of the same seeds part in a handful of such
# paths, the plain mean moves by up to 1.3% (walk mode 0.708684 to 0.716390
# between runs, tile mode 0.717581; one H100) and the mean of the pixels
# capped at COVE_CAP by under 0.4%. So the 1% bound holds the capped mean,
# and the plain mean, tail included, gets 2%. Phase 13 shows on every run
# that the bounds can tell: a walk-mode frame whose any-hit traces report
# one lane in 16 unoccluded must fall outside both (read: plain mean off by
# 5.3%, capped mean by 7.9%), and with one lane in 64 outside the capped
# mean's (1.0% and 2.1%).
TILE_MEAN_PT = 0.005
TILE_MEAN_SPCBPT = 0.01
TILE_MEAN_SPCBPT_TAIL = 0.02
COVE_CAP = 20.0          # radiance cap per pixel of the capped mean
COVE_FAULT_STRIDES = (16, 64)    # planted faults: one any-hit lane in N
# CPU (JAX's matmul walk) against card (K4/K5) in tile mode: the two
# formulations part at grazing edges; PT means within 0.5%.
TILE_CPU_CARD = 0.005
# the sky-lit phases: a 1024x512 Radiance sky drawn from SKY_SEED (a
# gradient, noise and a sun texel) and one Direction light shining into the
# Cornell box's open front (baked into the sky's raster)
SKY_W, SKY_H, SKY_SEED = 1024, 512, 0
SKY_DIRECTION = (0.2, -0.35, 1.0)
SKY_SUN = (4.0, 3.6, 3.0)
SKY_ON_OVER_OFF = 1.1    # PT mean with the sky at least this x the mean
                         # with its raster zeroed (env_lum 0)
SKY_CPU_CARD = 0.005
LVC_PATHS = 100_000      # light sub-paths of one LVC frame (render_cli's)
FURNISHED = ("wood", "ornament", "lamp", "bed", "curtain")
KERNEL_SOURCES = ("ray_walk", "brute_trace", "tile_walk", "list_walk")
# The least time of a kernel's work on one H100 SXM (NVIDIA's data sheet, at
# its 700 W limit): the larger of its operations over the f32 rate outside
# the tensor cores and its bytes over the memory rate. Operations: about 45
# f32 operations per ray-triangle test (Moller-Trumbore), counted from the
# plain version's own cluster visits on the same inputs (every lane of the
# visiting row or tile against the cluster's real triangles, not its zero
# slots); for K1/K2, which compute their rows' entries, also the slab tests
# that finding those entries needs on this run's rays (`slab_tests`): 6
# subtractions, 6 products, 5 minima, 5 maxima and 3 comparisons each. Bytes:
# each ray read once, each hit written once, the triangles of the clusters
# visited at least once, and the other inputs the kernel reads. K3's tests
# stop at their first failing stage, as its plain version's rejections
# allow, so its bound charges each stage's cumulative count
# (`FLOPS_STAGES`: pvec and det; then 1/det, tvec and u; then qvec and v;
# then t) to the pairs that stop there.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FLOPS_PER_TEST = 45
FLOPS_STAGES = {"det": 14, "u": 24, "v": 39, "t": FLOPS_PER_TEST}
FLOPS_PER_SLAB_TEST = 25
SLAB_GROUP = 8           # clusters per group box of K1/K2's entry phase
TRI_BYTES = 36           # p0, e1, e2 of one triangle, float32
RAY_BYTES = 32           # origin, direction, tmin, tmax
PROFILER_TIMEOUT = 900
PROFILER_WINDOWS = 3     # tries of a profiler window (device_events)
LAUNCH_PROBE = 5000      # launches timed for the [env] line's host reading
GRAPH_LAUNCHES = 20      # launches captured in one CUDA graph (graph_ms)
GRAPH_ROUNDS = 3         # replays of it, the least taken
BRUTE_WIDE = 512         # triangles of K3's widest wavefront (its limit)
MIN_HIT_SHARE = 0.2      # least share of hit lanes and of occluded lanes
# the first forms timed beside K5 closest and K4's single round: kernel ->
# its form in tile_walk_variants.py
FIRST_FORMS = {"K5 closest": "old_closest", "K4 round": "old_round"}


_T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] [{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_environment() -> str:
    from spcbpt_tpu_torch.kernels import build
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout
    release = re.search(r"release ([\d.]+)", nvcc)
    smi = nvidia_smi_line()
    try:
        import cv2
        cv2_version = cv2.__version__
    except ImportError:
        cv2_version = "missing (scenes with albedoTex textures cannot load)"
    log("env", f"cv2 {cv2_version}")
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}, nvcc "
               f"{release.group(1) if release else 'unknown'}, "
               f"{torch.cuda.device_count()} card(s)")
    log("env", f"nvidia-smi: {smi}")
    # the host, which bounds the render loops: its CPU and what one small
    # launch costs it, so that a slow run can be told from a slow program
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    cpu = ", ".join(f"{k} {info.get(k, 'unknown')}" for k in
                    ("vendor_id", "cpu family", "model", "model name",
                     "cpu MHz"))
    x = torch.zeros(1024, device="cuda")
    for _ in range(200):
        x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAUNCH_PROBE):
        x.add_(1.0)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / LAUNCH_PROBE * 1e6
    log("env", f"host: {cpu}, {os.cpu_count()} cores; {us:.2f} us per launch "
               f"of a 1024-element add ({LAUNCH_PROBE} in a row)")
    return smi


def phase_build() -> dict:
    """Builds the kernels, the native library and the first forms of K5
    closest and K4's single round (tile_walk_variants.py: FIRST_FORMS) in
    parallel; returns the first forms' libraries by name."""
    from spcbpt_tpu_torch.kernels import build
    from spcbpt_tpu_torch.native import loader
    import tile_walk_variants as variants
    t0 = time.perf_counter()
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 3) as pool:
        native = pool.submit(loader.get_lib)
        first = {name: pool.submit(variants.build_variant, name, out_dir)
                 for name in FIRST_FORMS.values()}
        list(pool.map(build.build, KERNEL_SOURCES))
        lib = native.result()
        first = {name: f.result()[0] for name, f in first.items()}
    log("build", f"native host library (BVH construction, OBJ parser): "
                 f"{'built with ' + loader.compiler() if lib else 'no C++ compiler, numpy route'}")
    infos = {name: dict(build.BUILD_LOG[name]) for name in KERNEL_SOURCES}
    for name in KERNEL_SOURCES:
        build.load(name)
        info = infos[name]
        log("build", f"csrc/{name}.cu -> sm_90a in {info['seconds']:.2f} s "
                     f"(cached={info['cached']})")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("build", "ptxas: " + line.strip())
    log("build", f"all kernels ready in {time.perf_counter() - t0:.2f} s "
                 f"(with the first forms {sorted(first)})")
    return first


def visit_log(fn) -> list:
    """Runs a plain walk once with the cluster visit log on; returns the log,
    one (lanes, cluster ids) entry per round."""
    from spcbpt_tpu_torch.ops import clusters
    clusters.VISIT_LOG = log = []
    try:
        fn()
    finally:
        clusters.VISIT_LOG = None
    return log


def visits(fn, sizes) -> tuple:
    """Runs a plain walk once with the cluster visit log on; returns (its
    ray-triangle tests, the triangles of the clusters it visited, its
    visits), with `sizes` the (C,) triangle count of each cluster."""
    return tally(visit_log(fn), sizes)


def tally(log, sizes) -> tuple:
    """(ray-triangle tests, triangles of the clusters visited, visits) of a
    visit log."""
    if not log:
        return 0, 0, 0
    cids = [cid.long() for _, cid in log]
    tests = sum(lanes * int(sizes[cid].sum()) for (lanes, _), cid in
                zip(log, cids))
    seen = torch.unique(torch.cat(cids))
    return tests, int(sizes[seen].sum()), sum(c.numel() for c in cids)


def bound(tests: int, nbytes: int, slab_tests: int = 0,
          flops: int = 0) -> dict:
    """The JSON line's bound keys for `tests` ray-triangle tests, `slab_tests`
    ray-box tests and `flops` further operations moving `nbytes` bytes; no
    single PyTorch call walks a BVH (library_ms)."""
    ops_ms = (tests * FLOPS_PER_TEST + slab_tests * FLOPS_PER_SLAB_TEST
              + flops) / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None)


def slab_tests(row_e, live) -> int:
    """The ray-box tests that the (rows, C) table `row_e` of row entries
    needs, counted from the table itself: every live ray against the box of
    each group of SLAB_GROUP consecutive clusters, and against the clusters
    of the groups in which its row has an entry below 1e30. Lanes with tmax <
    tmin (`live` False: dead or padding) add nothing."""
    rows, c = row_e.shape
    groups = -(-c // SLAB_GROUP)
    reach = torch.nn.functional.pad(row_e < 1e30,
                                    (0, groups * SLAB_GROUP - c))
    reach = reach.view(rows, groups, SLAB_GROUP).any(dim=-1)
    sizes = torch.full((groups,), SLAB_GROUP, device=row_e.device)
    sizes[-1] = c - SLAB_GROUP * (groups - 1)
    per_ray = groups + (reach * sizes).sum(dim=1)
    return int((live.view(rows, -1).sum(dim=1) * per_ray).sum())


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn) -> float:
    """Device milliseconds per call of `fn` with no host time in the
    interval: GRAPH_LAUNCHES calls (each allocating its outputs from the
    graph's pool) captured in one CUDA graph, replayed between CUDA events;
    the least of GRAPH_ROUNDS replays, after a warm-up on a side stream and
    one replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(GRAPH_ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / GRAPH_LAUNCHES)
    del graph
    return best


def device_events(fn, calls: int = 1) -> dict:
    """{name: (count, device ms per call)} of the device activities
    (kernels, copies, fills) that `calls` calls of `fn` issue, from one
    torch.profiler window. A window that comes back with no device activity
    at all is taken again, up to PROFILER_WINDOWS times: on the card a short
    window now and then returns none, though its launch ran (the callers
    count launches beside it); the result of the last window is returned
    either way, so a call that issues nothing still reads as nothing."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILER_WINDOWS):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            count, us = out.get(ev.name, (0, 0.0))
            out[ev.name] = (count + 1,
                            us + ev.time_range.end - ev.time_range.start)
        if out:
            break
        log("profiler", "a window came back with no device activity; "
                        "taken again")
    return {k: (c, us / 1e3 / calls) for k, (c, us) in out.items()}


def camera_wavefront(cam, dev):
    """(name, origins, dirs, tmax) of the 512x512 camera wavefront."""
    from spcbpt_tpu_torch.render.common import camera_rays

    eye, U, V, W = cam.uvw()
    n_cam = CAMERA_DIM * CAMERA_DIM
    o, d, _ = camera_rays(eye, U, V, W, CAMERA_DIM, CAMERA_DIM, 0, block=32,
                          device=dev)
    return ("camera512", o.contiguous(), d, torch.full((n_cam,), 1e16,
                                                       device=dev))


def wavefronts(ts, cam, dev):
    """(name, origins, dirs, tmax) of the camera and bounce wavefronts."""
    from spcbpt_tpu_torch.ops import bsdf
    from spcbpt_tpu_torch.render.common import camera_rays
    from spcbpt_tpu_torch.scene.scene import local_geometry, trace_closest
    from spcbpt_tpu_torch.utils import rng

    eye, U, V, W = cam.uvw()
    camera = camera_wavefront(cam, dev)
    # bounce wavefront: primary hit -> BSDF sample -> fixed permutation
    nb = BOUNCE_RAYS
    o1, d1, _ = camera_rays(eye, U, V, W, CAMERA_DIM, CAMERA_DIM, 0, block=16,
                            device=dev)
    o1, d1 = o1[:nb].contiguous(), d1[:nb].contiguous()
    hit = trace_closest(ts, o1, d1, 1e-3, 1e16, True)
    geom = local_geometry(ts, hit, o1, d1)
    st = rng.seed(torch.arange(nb, device=dev), 7)
    mat = bsdf.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
    nd, _ = bsdf.sample_bsdf(mat, geom["Ns"], -d1, st)
    rs = np.random.RandomState(0)
    perm = torch.from_numpy(rs.permutation(nb)).to(dev)
    tmax = torch.full((nb,), 1e16, device=dev)
    tmax[torch.from_numpy(rs.permutation(nb)[:nb // 4]).to(dev)] = -1.0
    bounce = ("bounce2^17", geom["P"][perm].contiguous(),
              nd[perm].contiguous(), tmax)
    return camera, bounce


def phase_kernels(ts, waves, dev):
    from spcbpt_tpu_torch.kernels import ray_walk as kernels
    from spcbpt_tpu_torch.ops import clusters, intersect, ray_walk

    cs = ts.clusters_walk
    sizes = clusters.cluster_sizes(cs, ts.num_tris)
    results = {}
    for name, o, d, tmax in waves:
        n = o.shape[0]
        tmin = torch.full((n,), 1e-3, device=dev)
        # K1, both cull settings: kernel wrapper vs plain version
        for cull in (True, False):
            got = ray_walk.walk_closest(cs, o, d, tmin, tmax, cull,
                                        sort_rays=True)
            ref = ray_walk.walk_closest_plain(cs, o, d, tmin, tmax, cull,
                                              sort_rays=True)
            torch.cuda.synchronize()
            agree = (got.tri == ref.tri).float().mean().item()
            hits = (ref.tri >= 0).float().mean().item()
            err_t = (got.t - ref.t).abs().max().item()
            err_uv = max((got.u - ref.u).abs().max().item(),
                         (got.v - ref.v).abs().max().item())
            log("kernels", f"K1 {name} cull={cull}: tri agreement "
                           f"{agree:.6f}, hits {hits:.4f}, max |dt| "
                           f"{err_t:.3g}, max |du|,|dv| {err_uv:.3g}")
            for f in ("tri", "t", "u", "v"):
                assert torch.equal(getattr(got, f), getattr(ref, f)), \
                    f"K1 {name} cull={cull}: {f} differs from the plain version"
            assert (got.tri[tmax < tmin] == -1).all(), "dead lane hit"
            # against brute force on a subset
            sub = slice(0, BRUTE_SUBSET)
            bf = intersect.brute_force_closest(
                o[sub], d[sub], ts.tri_p0, ts.tri_e1, ts.tri_e2, tmin[sub],
                tmax[sub], cull)
            bf_agree = (got.tri[sub] == bf.tri).float().mean().item()
            log("kernels", f"K1 {name} cull={cull}: brute-force agreement "
                           f"on {BRUTE_SUBSET} rays {bf_agree:.6f}")
            assert bf_agree >= TRI_AGREE, f"K1 vs brute {bf_agree}"
            if name.startswith("bounce") and not cull:
                results["walk_closest"] = dict(max_abs_err=err_t)
        # K2 with segment tmax (dead lanes stay dead)
        rs = np.random.RandomState(1)
        seg = torch.from_numpy(rs.uniform(0.05, 4.0, n).astype(np.float32))
        tseg = torch.where(tmax < 0, -1.0, seg.to(dev))
        occ_k = ray_walk.walk_any(cs, o, d, tmin, tseg, sort_rays=True)
        occ_p = ray_walk.walk_any_plain(cs, o, d, tmin, tseg, sort_rays=True)
        torch.cuda.synchronize()
        agree = (occ_k == occ_p).float().mean().item()
        assert torch.equal(occ_k, occ_p), \
            f"K2 {name}: occlusion differs from the plain version ({agree})"
        sub = slice(0, BRUTE_SUBSET)
        bf = intersect.brute_force_any(o[sub], d[sub], ts.tri_p0, ts.tri_e1,
                                       ts.tri_e2, tmin[sub], tseg[sub])
        bf_agree = (occ_k[sub] == bf).float().mean().item()
        log("kernels", f"K2 {name}: occlusion agreement {agree:.6f} "
                       f"(occluded {occ_k.float().mean().item():.4f}), "
                       f"brute-force agreement {bf_agree:.6f}")
        assert bf_agree >= OCC_AGREE, f"K2 vs brute {bf_agree}"
        if name.startswith("bounce"):
            results["walk_any"] = dict(
                max_abs_err=(occ_k.int() - occ_p.int()).abs().max().item())

        # the kernels' entry phase alone against the plain table, on the
        # prepared rays of both walks
        po, pd, ptmn, ptmx, _, _ = ray_walk.prepare(cs, o, d, tmin, tmax,
                                                    True)
        pseg = ray_walk.prepare(cs, o, d, tmin, tseg, True)[3]
        boxes = (cs.cmin, cs.cmax)
        slabs = {}
        for tag, tx in (("closest", ptmx), ("any", pseg)):
            got_e = kernels.entries(po, pd, ptmn, tx, *boxes)
            ref_e = ray_walk.row_entries(*boxes, po, pd, ptmn, tx)
            torch.cuda.synchronize()
            reach = (ref_e < 1e30).float().sum(dim=1).mean().item()
            assert torch.equal(got_e, ref_e), \
                f"ray_walk_entries {name} ({tag}): differs from row_entries"
            slabs[tag] = slab_tests(ref_e, tx >= ptmn)
            log("kernels", f"ray_walk_entries {name} ({tag} rays): equals "
                           f"row_entries, {reach:.1f} of {cs.num_clusters} "
                           f"clusters in reach of a row, "
                           f"{slabs[tag] / po.shape[0]:.1f} slab tests a "
                           f"padded ray")

        # times: the row walk alone (kernel vs plain, entries included) on
        # the prepared rays, the entry phase alone, and the whole wrapper
        tris = (cs.tri_count, cs.tri_slots)
        call1 = lambda: kernels.closest(po, pd, ptmn, ptmx, *boxes,
                                        cs.tri_begin, *tris, False)
        call2 = lambda: kernels.any_hit(po, pd, ptmn, pseg, *boxes, *tris)
        k1, k2 = graph_ms(call1), graph_ms(call2)
        c1, c2 = cuda_ms(call1, 20), cuda_ms(call2, 20)
        ke = cuda_ms(lambda: kernels.entries(po, pd, ptmn, ptmx, *boxes), 20)
        p1 = cuda_ms(lambda: ray_walk.closest_rows_plain(
            cs, po, pd, ptmn, ptmx, False), 2)
        p2 = cuda_ms(lambda: ray_walk.any_rows_plain(
            cs, po, pd, ptmn, pseg), 2)
        re_ms = cuda_ms(lambda: ray_walk.row_entries(*boxes, po, pd, ptmn,
                                                     ptmx), 10)
        wrap_ms = cuda_ms(lambda: ray_walk.walk_closest(
            cs, o, d, tmin, tmax, False, sort_rays=True), 10)
        mr = lambda ms: n / ms / 1e3
        log("kernels", f"{name} ({n} rays): K1 {k1:.4f} ms alone "
                       f"({mr(k1):.1f} Mrays/s), call {c1:.4f}, plain "
                       f"{p1:.3f} ms ({mr(p1):.2f} Mrays/s); K2 {k2:.4f} ms "
                       f"alone ({mr(k2):.1f} Mrays/s), call {c2:.4f}, plain "
                       f"{p2:.3f} ms ({mr(p2):.2f} Mrays/s); entry phase "
                       f"alone {ke:.3f} ms (with the table's write), plain "
                       f"row_entries {re_ms:.3f} ms; walk_closest wrapper "
                       f"(sort + K1 + unsort) {wrap_ms:.3f} ms")
        if name.startswith("bounce"):
            # operations: the visits' ray-triangle tests and the entries'
            # slab tests; bytes: rays, boxes, tri_count (K1:
            # tri_begin), the visited clusters' triangles, hits or flags
            npad, c = po.shape[0], cs.num_clusters
            fixed = npad * RAY_BYTES + c * 28
            t1, tri1, _ = visits(lambda: ray_walk.closest_rows_plain(
                cs, po, pd, ptmn, ptmx, False), sizes)
            t2, tri2, _ = visits(lambda: ray_walk.any_rows_plain(
                cs, po, pd, ptmn, pseg), sizes)
            results["walk_closest"].update(ms=k1, call_ms=c1, plain_ms=p1,
                                           **bound(
                t1, fixed + c * 4 + tri1 * TRI_BYTES + npad * 16,
                slabs["closest"]))
            results["walk_any"].update(ms=k2, call_ms=c2, plain_ms=p2,
                                       **bound(
                t2, fixed + tri2 * TRI_BYTES + npad * 4, slabs["any"]))
    return results


def reset_launches() -> None:
    from spcbpt_tpu_torch import kernels
    from spcbpt_tpu_torch.ops import tile_trace
    kernels.reset_launches()
    tile_trace.reset_walk_stats()


def read_launches() -> dict:
    from spcbpt_tpu_torch import kernels
    return kernels.read_launches()


def run_cli(out_dir: str, tag: str, argv: list, spp: int):
    """One render_cli run with every launch counter set to 0 just before it
    and read just after; checks its output and returns (stats, launches)."""
    from spcbpt_tpu_torch.apps import render_cli

    os.makedirs(out_dir, exist_ok=True)
    png, npz, stats_path = (os.path.join(out_dir, f"{tag}{ext}") for ext in
                            (".png", ".npz", ".json"))
    reset_launches()
    assert render_cli.main(argv + ["--spp", str(spp), "--out", png,
                                   "--hdr-out", npz,
                                   "--stats-json", stats_path]) == 0
    launches = read_launches()
    with open(stats_path) as f:
        stats = json.load(f)
    hdr = np.load(npz)["radiance"]
    assert hdr.shape == (stats["height"], stats["width"], 3), hdr.shape
    assert np.isfinite(hdr).all() and stats["finite"], tag
    assert stats["mean_radiance"] > 0, stats
    assert stats["count_min"] == stats["count_max"] == spp, stats
    assert os.path.getsize(png) > 0
    return stats, launches


def _frames(stats) -> str:
    return ", ".join(f"light {f['light_ms']:.1f} + eye {f['eye_ms']:.1f} ms"
                     for f in stats.get("frames", []))


def phase_main_path(out_dir: str, device: str = "cuda", dim: int = 1024,
                    spp: int = 4) -> tuple:
    """PT on the interior through K1/K2, with no call of the plain route's
    `row_entries` pass; returns (launches, stats)."""
    from spcbpt_tpu_torch.ops import ray_walk

    ray_walk.PLAIN_CALLS["row_entries"] = 0
    stats, launches = run_cli(out_dir, "interior", [
        "--scene", "interior", "--alg", "pt", "--dim", f"{dim}x{dim}",
        "--device", device], spp)
    assert ray_walk.PLAIN_CALLS["row_entries"] == 0, ray_walk.PLAIN_CALLS
    ms_spp = stats["render_seconds"] * 1e3 / spp
    log("main", f"interior {dim}x{dim} pt {spp} spp: {ms_spp:.1f} ms/spp, "
                f"{stats['samples_per_second'] / 1e6:.3f} Mpaths/s, mean "
                f"radiance {stats['mean_radiance']:.6f}, launches {launches}")
    assert launches["walk_closest"] > 0 and launches["walk_any"] > 0, launches
    return launches, stats


def phase_cornell(out_dir: str, dev, spp: int = 4) -> tuple:
    """The BDPT/SPCBPT path through K3 on Cornell at the full width; returns
    (SPCBPT launches, saved state path)."""
    from spcbpt_tpu_torch import checkpoint
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.scene.scene import load_trace_scene
    from spcbpt_tpu_torch.train import classify

    classify.use_fp32_matmul()
    ts, _, _ = load_trace_scene(resolve_scene("cornell"), dev)
    assert ts.mode == "brute", ts.mode
    t0 = time.perf_counter()
    ss = classify.synthetic_trained_state(ts, seed=0)
    state_path = os.path.join(out_dir, "cornell_state.npz")
    os.makedirs(out_dir, exist_ok=True)
    checkpoint.save_subspace_state(state_path, ss)
    log("cornell", f"synthetic trained state ({ss.second_stage}) built and "
                   f"saved in {time.perf_counter() - t0:.1f} s")
    base = ["--scene", "cornell", "--light-paths", "100000",
            "--light-depth", "16", "--connection-n", "3", "--max-depth", "16"]
    means, launches = {}, {}
    for alg, extra in (("spcbpt", ["--resume", state_path]), ("bdpt", []),
                       ("pt", [])):
        argv = ["--scene", "cornell", "--alg", alg] if alg == "pt" \
            else base + ["--alg", alg] + extra
        stats, launches[alg] = run_cli(out_dir, f"cornell_{alg}", argv, spp)
        means[alg] = stats["mean_radiance"]
        ms_spp = stats["render_seconds"] * 1e3 / spp
        log("cornell", f"{alg} {stats['width']}x{stats['height']} {spp} spp: "
                       f"{ms_spp:.1f} ms/spp, mean {means[alg]:.6f}, "
                       f"launches {launches[alg]}; {_frames(stats)}")
        k = launches[alg]
        assert k["brute_closest"] > 0 and k["brute_any"] > 0, k
        assert k["walk_closest"] == 0 and k["walk_any"] == 0, k
    for alg in ("spcbpt", "bdpt"):
        rel = abs(means[alg] - means["pt"]) / means["pt"]
        log("cornell", f"{alg} mean vs pt: {rel * 100:.3f}% "
                       f"(bound {MEAN_VS_PT * 100:.0f}%)")
        assert rel <= MEAN_VS_PT, (alg, means)
    return launches["spcbpt"], state_path, means["pt"]


def phase_train(out_dir: str, dev, pt_mean: float, spp: int = 4) -> tuple:
    """Trains Cornell through the CLI at its training defaults, with the
    launch counters set to 0 at the start of the training and read at its
    end; checks the trained state, then renders SPCBPT from the saved
    checkpoint. Returns the checkpoint's path and the training's counts."""
    from spcbpt_tpu_torch import checkpoint
    from spcbpt_tpu_torch.train import gamma_train, pipeline

    ckpt = os.path.join(out_dir, "cornell_trained.npz")
    base = ["--scene", "cornell", "--alg", "spcbpt", "--light-paths",
            "100000", "--light-depth", "16", "--connection-n", "3",
            "--max-depth", "16"]
    seen = {}
    preprocess, train_gamma = pipeline.preprocess, gamma_train.train_gamma

    def counted_preprocess(*a, **kw):
        reset_launches()
        out = preprocess(*a, **kw)
        seen["launches"] = read_launches()
        return out

    def kept_train_gamma(*a, **kw):
        seen["gamma"], seen["losses"] = train_gamma(*a, **kw)
        return seen["gamma"], seen["losses"]

    pipeline.preprocess = counted_preprocess
    gamma_train.train_gamma = kept_train_gamma
    try:
        stats, _ = run_cli(out_dir, "cornell_train",
                           base + ["--checkpoint", ckpt], spp)
    finally:
        pipeline.preprocess, gamma_train.train_gamma = preprocess, train_gamma
    tr, sec = stats["train"], stats["phases"]["preprocess"]
    k = seen["launches"]
    losses = seen["losses"]
    log("train", f"stages (s): " + ", ".join(
        f"{name} {v:.3f}" for name, v in sec.items()))
    log("train", f"{tr['n_paths']} paths, {tr['n_conns']} connections in "
                 f"{tr['pretrace_launches']} pretrace launches; "
                 f"{tr['q_paths']} Q paths in {tr['q_launches']} light "
                 f"traces; Gamma loss {losses[0]:.6g} (first step) -> "
                 f"{losses[-1]:.6g} (step {len(losses)}); second stage "
                 f"'{tr['second_stage']}' (flux DR {tr['flux_dr']:.3f}); "
                 f"launches over the training {k}")
    assert tr["n_paths"] >= TRAIN_PATHS and tr["q_paths"] >= Q_PATHS, tr
    assert k["brute_closest"] > 0 and k["brute_any"] > 0, k
    assert k["walk_closest"] == k["walk_any"] == 0, k
    assert np.isfinite(losses).all() and len(losses) >= 1, losses
    gamma = seen["gamma"]
    rows = gamma.sum(dim=1)
    assert torch.isfinite(gamma).all()
    err = (rows - 1.0).abs().max().item()
    assert err <= GAMMA_ROW_SUM, err
    ss = checkpoint.load_subspace_state(ckpt, dev)
    cmf = ss.cmf_gamma
    assert torch.isfinite(cmf).all() and (torch.diff(cmf, dim=1) >= 0).all()
    assert torch.equal(cmf[:, -1], torch.ones_like(cmf[:, -1]))
    assert ss.trained and ss.second_stage == tr["second_stage"]
    log("train", f"Gamma rows finite, |row sum - 1| <= {err:.3g}; CMF rows "
                 f"monotone, ending at 1; training command's render mean "
                 f"{stats['mean_radiance']:.6f}")
    stats, launches = run_cli(out_dir, "cornell_trained_spcbpt",
                              base + ["--resume", ckpt], spp)
    rel = abs(stats["mean_radiance"] - pt_mean) / pt_mean
    log("train", f"spcbpt from the trained state {stats['width']}x"
                 f"{stats['height']} {spp} spp: "
                 f"{stats['render_seconds'] * 1e3 / spp:.1f} ms/spp, mean "
                 f"{stats['mean_radiance']:.6f} vs pt {pt_mean:.6f} "
                 f"({rel * 100:.3f}%, bound {MEAN_VS_PT * 100:.0f}%), "
                 f"launches {launches}; {_frames(stats)}")
    assert launches["brute_closest"] > 0 and launches["brute_any"] > 0
    assert rel <= MEAN_VS_PT, (stats["mean_radiance"], pt_mean)
    return ckpt, tr, stats["render_seconds"] * 1e3 / spp


def nn_first_stage(ss, dev, n: int = NN_DRAW_LANES):
    """One blended first-stage draw (lvc.sample_first_stage with the
    close-set network) of n lanes made from NN_SEED: eye labels, vertices
    inside the network's scene box, unit normals. Returns (labels, pmf,
    rng state)."""
    from spcbpt_tpu_torch.config import NUM_SUBSPACE
    from spcbpt_tpu_torch.render import lvc
    from spcbpt_tpu_torch.utils import rng as rng_mod

    rng = np.random.default_rng(NN_SEED)
    lo, hi = ss.nn.scene_lo.cpu().numpy(), ss.nn.scene_hi.cpu().numpy()
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    eye = rng.integers(0, NUM_SUBSPACE, n).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)
    state = rng_mod.seed(torch.arange(n, dtype=torch.int64, device=dev), 9)
    return lvc.sample_first_stage(ss, t(eye), state, position=t(pos),
                                  normal=t(nrm))


def nn_corpus_losses(train_args, tables) -> tuple:
    """The mean objective (nn_classifier.corpus_loss) over the batches of
    one train_from_corpus call, with the network it started from and with
    the one it returned: the training's losses are each on another batch,
    so they need not fall step by step."""
    from spcbpt_tpu_torch.train import nn_classifier as nn

    state, mixed, td, pos, nrm, la, lb, lo, hi = train_args
    g = torch.as_tensor(mixed, dtype=torch.float32, device=td.pdf0.device)
    trained = nn.NNParams(tables.w1, tables.b1, tables.w2, tables.b2)
    out = []
    with torch.no_grad():
        for params in (state.params, trained):
            out.append(float(np.mean([
                float(nn.corpus_loss(params, state.close_set, g,
                                     tables.scene_lo, tables.scene_hi,
                                     tables.blend, b))
                for b in nn.corpus_batches(td, pos, nrm, la, lb)])))
    return tuple(out)


def phase_nn(out_dir: str, dev, pt_mean: float, centroid_ms_spp: float,
             spp: int = 4) -> None:
    """The close-set network: Cornell trained through the CLI at its
    training defaults with --classifier nn (launch counters over the
    training alone; the network's losses finite and falling, its
    seconds), SPCBPT rendered from the saved checkpoint (mean within
    MEAN_VS_PT of phase 6's PT mean, K3 launches), and one blended
    first-stage draw of NN_DRAW_LANES lanes on the CPU and on the card
    (NN_AGREE of the picks equal)."""
    from spcbpt_tpu_torch import checkpoint
    from spcbpt_tpu_torch.train import nn_classifier, pipeline

    ckpt = os.path.join(out_dir, "cornell_nn.npz")
    base = ["--scene", "cornell", "--alg", "spcbpt", "--light-paths",
            "100000", "--light-depth", "16", "--connection-n", "3",
            "--max-depth", "16"]
    seen = {}
    preprocess, train = pipeline.preprocess, nn_classifier.train_from_corpus

    def counted_preprocess(*a, **kw):
        reset_launches()
        out = preprocess(*a, **kw)
        seen["launches"] = read_launches()
        return out

    def kept_train(*a, **kw):
        seen["train_args"] = a
        seen["tables"], _ = out = train(*a, **kw)
        return out

    pipeline.preprocess = counted_preprocess
    nn_classifier.train_from_corpus = kept_train
    try:
        stats, _ = run_cli(out_dir, "cornell_nn_train", base + [
            "--classifier", "nn", "--checkpoint", ckpt], spp)
    finally:
        pipeline.preprocess = preprocess
        nn_classifier.train_from_corpus = train
    tr, sec = stats["train"], stats["phases"]["preprocess"]
    losses, k = tr["nn_losses"], seen["launches"]
    steps = min(tr["n_paths"], NN_MAX_PATHS) // NN_BATCH
    before, after = nn_corpus_losses(seen["train_args"], seen["tables"])
    log("nn", f"stages (s): " + ", ".join(
        f"{name} {v:.3f}" for name, v in sec.items()))
    log("nn", f"{tr['n_paths']} paths; network: {len(losses)} Adam steps "
              f"of {NN_BATCH} paths in {sec['nn']:.3f} s, step losses "
              f"{losses[0]:.6g} -> {losses[-1]:.6g}; mean loss over those "
              f"batches {before:.6g} with the initial network, {after:.6g} "
              f"with the trained one ({(after / before - 1) * 100:.3f}%); "
              f"launches over the training {k}")
    assert len(losses) == steps > 0, (len(losses), steps)
    assert np.isfinite(losses).all() and after < before, (before, after)
    assert sec["nn"] > 0, sec
    assert k["brute_closest"] > 0 and k["brute_any"] > 0, k
    assert k["walk_closest"] == k["walk_any"] == 0, k
    ss = checkpoint.load_subspace_state(ckpt, dev)
    assert isinstance(ss.nn, nn_classifier.NNTables) and ss.nn.blend == 0.5
    stats, launches = run_cli(out_dir, "cornell_nn_spcbpt",
                              base + ["--resume", ckpt], spp)
    ms_spp = stats["render_seconds"] * 1e3 / spp
    rel = abs(stats["mean_radiance"] - pt_mean) / pt_mean
    log("nn", f"spcbpt with the network {stats['width']}x{stats['height']} "
              f"{spp} spp: {ms_spp:.1f} ms/spp (the centroid state's "
              f"{centroid_ms_spp:.1f}, x{ms_spp / centroid_ms_spp:.3f}), mean "
              f"{stats['mean_radiance']:.6f} vs pt {pt_mean:.6f} "
              f"({rel * 100:.3f}%, bound {MEAN_VS_PT * 100:.0f}%), launches "
              f"{launches}; {_frames(stats)}")
    assert launches["brute_closest"] > 0 and launches["brute_any"] > 0
    assert rel <= MEAN_VS_PT, (stats["mean_radiance"], pt_mean)
    # the same draw on the CPU and on the card
    cpu = nn_first_stage(checkpoint.load_subspace_state(ckpt, "cpu"), "cpu")
    nn_first_stage(ss, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = nn_first_stage(ss, dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    (la, pa, sa), (lb, pb, sb) = cpu, [x.cpu() for x in card]
    same = la == lb
    agree = float(same.float().mean())
    err = float(((pa - pb).abs() / pa.abs())[same].max())
    log("nn", f"first stage of {NN_DRAW_LANES} lanes on the CPU and the "
              f"card: picks agreeing {agree:.6f} (bound {NN_AGREE}), pmf "
              f"max relative difference {err:.3g} where they agree, rng "
              f"states equal {bool(torch.equal(sa, sb))}; card {ms:.2f} ms "
              f"a draw (host clock, synchronised)")
    assert torch.equal(sa, sb)
    assert agree >= NN_AGREE, agree
    assert err <= NN_PMF_RTOL, err


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _dp_inputs(dev):
    """A Gamma training batch of DP_PATHS paths (the CLI's batch), a fifth
    invalid, and theta from a random Gamma, made from NN_SEED."""
    from spcbpt_tpu_torch.config import NUM_SUBSPACE, PRETRACE_CONN_PADDING
    from spcbpt_tpu_torch.train import gamma_train

    rng = np.random.default_rng(NN_SEED)
    p, c = DP_PATHS, PRETRACE_CONN_PADDING
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    live = rng.random((p, c)) < 0.5
    batch = gamma_train.GammaTrainData(
        f_square=t(rng.uniform(0.1, 1, p).astype(np.float32)),
        pdf0=t(rng.uniform(0.05, 0.5, p).astype(np.float32)),
        peak=t(np.where(live, rng.uniform(0.1, 2, (p, c)), 0).astype(
            np.float32)),
        label_e=t(rng.integers(0, NUM_SUBSPACE ** 2, (p, c)).astype(
            np.int32)),
        valid=t(rng.random(p) > 0.2))
    g = rng.uniform(0.1, 1, (NUM_SUBSPACE, NUM_SUBSPACE))
    g = g / g.sum(1, keepdims=True)
    return batch, t(np.log(g / (1 - g)).astype(np.float32))


def _mesh_on_nccl(out_dir: str, dev, ckpt: str, pt_mean: float) -> None:
    """The sharded renders and the data-parallel step on a 1x1 mesh of
    this process alone over NCCL, each against the sequential route."""
    import tempfile

    import torch.distributed as dist
    from spcbpt_tpu_torch import checkpoint
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.parallel import launch
    from spcbpt_tpu_torch.parallel import tile as par
    from spcbpt_tpu_torch.scene.scene import load_trace_scene
    from spcbpt_tpu_torch.train import gamma_train

    store = tempfile.mkdtemp(prefix="nccl_", dir=out_dir)
    launch.init_rank("cuda", 0, 1, "file://" + os.path.join(store, "store"),
                     MESH_TIMEOUT_S)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        mesh, seq = par.make_mesh(), par.sequential_mesh(1, 1)
        assert mesh.shape == {"tile": 1, "spp": 1}
        for name, keys in (("cornell", ("brute_closest", "brute_any")),
                           ("interior", ("walk_closest", "walk_any"))):
            dim = MESH_PT_DIMS[name]
            ts, _, cam = load_trace_scene(resolve_scene(name), dev)
            cam.aspect = 1.0
            render = lambda m, sub=1: par.sharded_pt_render(
                ts, cam.uvw(), dim, dim, sub, m, max_depth=MESH_PT_DEPTH)
            render(seq, 0)      # warm-up, another subframe
            reset_launches()
            img, ms = _sync_ms(lambda: render(mesh))
            k = read_launches()
            ref, ms_seq = _sync_ms(lambda: render(seq))
            equal = torch.equal(img, ref)
            log("multichip", f"sharded pt {name} {dim}x{dim} on the NCCL 1x1 "
                             f"mesh: {ms:.1f} ms (sequential route "
                             f"{ms_seq:.1f} ms), mean {float(img.mean()):.6f}"
                             f", torch.equal to the sequential route "
                             f"{equal}; launches {k}")
            assert equal and torch.isfinite(img).all()
            assert all(k[key] > 0 for key in keys), k
        ts, _, cam = load_trace_scene(resolve_scene("cornell"), dev)
        cam.aspect = 1.0
        ss = checkpoint.load_subspace_state(ckpt, dev)
        dim = MESH_PT_DIMS["cornell"]
        for alg in ("bdpt", "spcbpt"):
            reset_launches()
            img, ms = _sync_ms(lambda: par.sharded_spcbpt_render(
                ts, ss, cam.uvw(), dim, dim, 1, mesh, MESH_LIGHT_PATHS,
                max_depth=MESH_PT_DEPTH, uniform=alg == "bdpt"))
            k = read_launches()
            m = float(img.mean())
            log("multichip", f"sharded {alg} cornell {dim}x{dim}, 1 subframe, "
                             f"{MESH_LIGHT_PATHS} light paths (the trained "
                             f"state): {ms:.1f} ms, mean {m:.6f} (4-spp PT "
                             f"{pt_mean:.6f}), finite "
                             f"{bool(torch.isfinite(img).all())}; launches "
                             f"{k}")
            assert torch.isfinite(img).all() and m > 0
            assert k["brute_closest"] > 0 and k["brute_any"] > 0, k
        batch, theta0 = _dp_inputs(dev)
        out = []
        for step in ("mesh", "one"):
            theta = theta0.clone().requires_grad_(True)
            opt = torch.optim.Adam([theta], lr=0.01, betas=(0.9, 0.999),
                                   eps=1e-8)
            if step == "mesh":
                loss, ms = _sync_ms(lambda: par.dp_gamma_train_step(
                    theta, opt, batch, mesh))
            else:
                loss = gamma_train.loss_fn(theta, batch)
                loss.backward()
                opt.step()
            out.append((float(loss.detach()), theta.detach()))
        (la, ta), (lb, tb) = out
        rel = abs(la - lb) / abs(lb)
        diff = float((ta - tb).abs().max())
        log("multichip", f"dp_gamma_train_step on {DP_PATHS} paths: loss "
                         f"{la:.8g} vs one process {lb:.8g} ({rel:.2e}), "
                         f"theta after Adam within {diff:.2e}; {ms:.2f} ms")
        assert rel <= DP_LOSS_RTOL and diff <= DP_THETA_ATOL, (rel, diff)
    finally:
        dist.destroy_process_group()


def _bench(out_dir: str, tag: str, argv: list) -> dict:
    from spcbpt_tpu_torch.apps import multichip_bench

    path = os.path.join(out_dir, f"multichip_{tag}.json")
    t0 = time.perf_counter()
    assert multichip_bench.main(argv + ["--json", path]) == 0
    with open(path) as f:
        res = json.load(f)
    log("multichip", f"multichip_bench {' '.join(argv)}: "
                     f"{time.perf_counter() - t0:.1f} s of command")
    return res


def phase_multichip(out_dir: str, dev, ckpt: str, pt_mean: float) -> None:
    """The mesh path (parallel/tile.py) over NCCL at world size 1: sharded
    PT on Cornell 512x512 (K3) and on the interior 1024x1024 (K1/K2), each
    torch.equal to the sequential route, sharded BDPT/SPCBPT 512x512
    finite, the data-parallel Gamma step against one process; then
    multichip_bench, which spawns its ranks: BASELINE config 5
    (cornell_glossy 2048x2048 SPCBPT, one subframe, MESH_SUB_BLOCKS row
    blocks) with its ms and peak memory, and one --equal-time run at
    256x256 against a PT reference this phase renders (key 'img')."""
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.render import pt_pool
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    _mesh_on_nccl(out_dir, dev, ckpt, pt_mean)
    res = _bench(out_dir, "config5", [
        "--dim", "2048x2048", "--meshes", "1x1", "--mesh-algs", "spcbpt",
        "--subframes", "1", "--sub-blocks", str(MESH_SUB_BLOCKS),
        "--checkpoint", ckpt])
    e = res["meshes"]["1x1"]["spcbpt"]
    log("multichip", f"config 5, cornell_glossy 2048x2048 spcbpt on the 1x1 "
                     f"NCCL mesh, {MESH_SUB_BLOCKS} row blocks of "
                     f"{e['lanes_per_chip'] // MESH_SUB_BLOCKS} lanes: "
                     f"{e['seconds'] * 1e3:.1f} ms warm (first run "
                     f"{e['first_seconds'] * 1e3:.1f} ms), mean "
                     f"{e['mean']:.6f}, peak memory "
                     f"{e['peak_mem_gb']:.2f} GiB, "
                     f"{e['mpaths_per_s_total']:.3f} Mpaths/s; launches of "
                     f"the warm run {e['launches']} (on {res['card']})")
    assert e["finite"] and e["mean"] > 0, e
    assert e["launches"]["brute_closest"] > 0, e["launches"]
    # equal time at 256x256 against a PT reference rendered here
    ts, _, cam = load_trace_scene(resolve_scene("cornell_glossy"), dev)
    cam.aspect = 1.0
    d = EQUAL_TIME_DIM
    (fsum, count), ms = _sync_ms(lambda: pt_pool.render_pool(
        ts, cam.uvw(), d, d, EQUAL_TIME_REF_SPP, 12345))
    ref = os.path.join(out_dir, "equal_time_ref.npz")
    np.savez(ref, img=(fsum / torch.clamp(count[:, None], min=1))
             .cpu().numpy())
    log("multichip", f"PT reference cornell_glossy {d}x{d}, "
                     f"{EQUAL_TIME_REF_SPP} spp in {ms:.0f} ms")
    res = _bench(out_dir, "equal_time", [
        "--dim", f"{d}x{d}", "--meshes", "1x1", "--mesh-algs", "pt",
        "--subframes", "1", "--equal-time", str(EQUAL_TIME_S), "--ref-npz",
        ref, "--checkpoint", ckpt])
    for alg, r in res["equal_time"]["algs"].items():
        log("multichip", f"equal time {EQUAL_TIME_S} s, {d}x{d}: {alg} "
                         f"relMSE {r['relmse']:.6f} at {r['subframes']} "
                         f"subframes in {r['seconds']:.2f} s")
        assert np.isfinite(r["relmse"]) and r["subframes"] >= 1, (alg, r)


def phase_cpu_vs_card_pretrace(devices=("cpu", "cuda")) -> None:
    """One pretrace launch of Cornell, PRETRACE_LANES lanes, frame 0, on
    the CPU and on the card; its K3 launches on the card."""
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.scene.scene import load_trace_scene
    from spcbpt_tpu_torch.train import pretrace

    out = []
    for dev in devices:
        ts, _, cam = load_trace_scene(resolve_scene("cornell"), dev)
        launch = pretrace.make_pretracer(cam.uvw(), PRETRACE_LANES)
        reset_launches()
        t0 = time.perf_counter()
        b = pretrace.to_host(launch(ts, 0))
        out.append((b, time.perf_counter() - t0, read_launches()))
    (a, ta, _), (b, tb, k) = out
    agree = ((a.valid == b.valid) & (a.n_conns == b.n_conns)).mean()
    log("cpu-vs-card", f"pretrace {PRETRACE_LANES} lanes, frame 0: cpu "
                       f"{ta:.2f} s, card {tb:.3f} s; lanes agreeing on "
                       f"valid and n_conns {agree:.4f} (bound "
                       f"{PRETRACE_AGREE}); valid {a.valid.mean():.4f} vs "
                       f"{b.valid.mean():.4f}; card launches {k}")
    assert agree >= PRETRACE_AGREE, agree
    assert k["brute_closest"] > 0 and k["brute_any"] > 0, k
    if devices[-1] != "cuda":
        return
    # where one launch at the CLI's width goes: wall (warm, synchronised)
    # against the device activities it issues
    launch = pretrace.make_pretracer(cam.uvw(), TRAIN_LANES)
    pretrace.to_host(launch(ts, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pretrace.to_host(launch(ts, 2))
    wall = (time.perf_counter() - t0) * 1e3
    events = device_events(lambda: pretrace.to_host(launch(ts, 3)))
    busy = sum(ms for _, ms in events.values())
    top = sorted(events.items(), key=lambda kv: -kv[1][1])[:3]
    log("cpu-vs-card", f"one pretrace launch of {TRAIN_LANES} lanes on the "
                       f"card: {wall:.1f} ms wall, "
                       f"{sum(c for c, _ in events.values())} device "
                       f"activities, {busy:.2f} ms busy "
                       f"({busy / wall * 100:.1f}%); largest "
                       + ", ".join(f"{n[:40]} {c}x {ms:.2f} ms"
                                   for n, (c, ms) in top))


def phase_benchmark(out_dir: str, ckpt: str) -> dict:
    """The relMSE benchmark app from the trained checkpoint; returns its
    results."""
    import contextlib

    from spcbpt_tpu_torch.apps import benchmark

    path = os.path.join(out_dir, "benchmark.json")
    log_path = os.path.join(out_dir, "benchmark.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        assert benchmark.main(BENCH_ARGS + ["--checkpoint", ckpt,
                                            "--json", path]) == 0
    with open(path) as f:
        res = json.load(f)
    log("benchmark", f"{' '.join(BENCH_ARGS)}: reference "
                     f"{res['ref_alg']} {res['ref_spp']} spp in "
                     f"{res['ref_seconds']:.1f} s; whole run "
                     f"{time.perf_counter() - t0:.1f} s (log {log_path})")
    for alg, r in res["algs"].items():
        log("benchmark", f"{alg:7s} relMSE {r['relmse']:.6f} at {r['spp']} "
                         f"spp in {r['seconds']:.2f} s (timed frames "
                         f"after the warm-up)")
        assert np.isfinite(r["relmse"]), (alg, r)
    assert set(res["algs"]) == {"pt", "bdpt", "spcbpt"}, res["algs"]
    return res


def phase_cove(out_dir: str, dev) -> tuple:
    """SPCBPT through K1/K2 on interior_cove with a synthetic state; returns
    (stats, saved state path)."""
    from spcbpt_tpu_torch import checkpoint
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.scene.scene import load_trace_scene
    from spcbpt_tpu_torch.train import classify

    ts, _, _ = load_trace_scene(resolve_scene("interior_cove"), dev)
    assert ts.mode == "walk", ts.mode
    state_path = os.path.join(out_dir, "cove_state.npz")
    checkpoint.save_subspace_state(state_path,
                                   classify.synthetic_trained_state(ts, 0))
    stats, launches = run_cli(out_dir, "cove_spcbpt", [
        "--scene", "interior_cove", "--alg", "spcbpt", "--resume",
        state_path, "--dim", "256x256"], 1)
    log("cove", f"{ts.num_tris} tris, spcbpt 256x256 1 spp: "
                f"{stats['render_seconds'] * 1e3:.1f} ms, mean "
                f"{stats['mean_radiance']:.6f}, launches {launches}; "
                f"{_frames(stats)}")
    assert launches["walk_closest"] > 0 and launches["walk_any"] > 0, launches
    assert launches["brute_closest"] == launches["brute_any"] == 0, launches
    return stats, state_path


def connection_wavefront(ts, cam, dev):
    """(name, origins, dirs, tmax): 3 x 2^16 segments from primary hits to
    shuffled hit points, a third of them masked (tmax = -1), as the
    connection wavefront's visibility test builds them."""
    from spcbpt_tpu_torch.render.common import camera_rays
    from spcbpt_tpu_torch.scene.scene import local_geometry, trace_closest
    from spcbpt_tpu_torch.utils import vec

    eye, U, V, W = cam.uvw()
    o, d, _ = camera_rays(eye, U, V, W, 256, 256, 1, device=dev)
    hit = trace_closest(ts, o, d, 1e-3, 1e16, True)
    p = local_geometry(ts, hit, o, d)["P"]
    rs = np.random.RandomState(2)
    a = p.repeat(3, 1)
    b = p[torch.from_numpy(rs.randint(0, p.shape[0], CONN_RAYS)).to(dev)]
    seg = b - a
    dist = torch.sqrt(torch.clamp(vec.dot(seg, seg), min=1e-30))
    dirs = seg / dist[:, None]
    tmax = dist - 1e-3
    masked = torch.from_numpy(rs.rand(CONN_RAYS) < 1 / 3).to(dev)
    tmax = torch.where(masked, -1.0, tmax)
    return ("connection3x2^16", a.contiguous(), dirs.contiguous(), tmax)


def brute_wavefronts(cts, ccam, its, icam, dev) -> list:
    """(name, origins, dirs, tmax, (p0, e1, e2)) of K3's wavefronts:
    Cornell's camera 512x512, bounce 2^17 and connection 3 x 2^16 against
    its 32 triangles, and the interior's camera 512x512 against the
    BRUTE_WIDE triangles that hold most of its closest hits (the interior's
    own walk, cull off), in ascending id order (the tables sliced)."""
    from spcbpt_tpu_torch.scene.scene import trace_closest

    ctris = (cts.tri_p0, cts.tri_e1, cts.tri_e2)
    camera, bounce = wavefronts(cts, ccam, dev)
    out = [w + (ctris,) for w in
           (camera, bounce, connection_wavefront(cts, ccam, dev))]
    name, o, d, tmax = camera_wavefront(icam, dev)
    tri = trace_closest(its, o, d, 1e-3, tmax, False).tri
    count = torch.bincount(tri[tri >= 0].long(), minlength=its.num_tris)
    top = torch.argsort(count, descending=True, stable=True)[:BRUTE_WIDE]
    ids = torch.sort(top).values
    itris = tuple(x[ids].contiguous()
                  for x in (its.tri_p0, its.tri_e1, its.tri_e2))
    out.append((f"interior{BRUTE_WIDE}hit_{name}", o, d, tmax, itris))
    return out


def brute_segments(name, ref, tmax, n, dev):
    """Any-hit segment ends of a K3 wavefront: the connection wavefront has
    its own; the others end at 0.5-1.5x the closest hit (10 on a miss), so
    about half of the hit lanes are occluded (dead lanes stay dead)."""
    if name.startswith("connection"):
        return tmax
    rs = np.random.RandomState(1)
    scale = torch.from_numpy(rs.uniform(0.5, 1.5, n).astype(np.float32))
    t_hit = torch.where(ref.tri >= 0, ref.t, 10.0)
    return torch.where(tmax < 0, -1.0, t_hit * scale.to(dev))


def pair_census(o, d, tmin, tmax, tris, cull, chunk: int = 1 << 14) -> dict:
    """What K3's pair test meets on these inputs, from the plain version's
    tensors (intersect.tri_test): the live lanes (tmax > tmin); the shares
    of their pairs with every triangle that fail at det, that pass det and
    fail at u (u outside [0, 1]), that pass u and fail at v (v < 0 or u + v
    > 1), and that reach the t test; `flops`, the operations of those pairs
    by the stage each stops at (FLOPS_STAGES); `any_tests`, the tests an
    any-hit lane needs: up to and including its first occluder (t in (tmin,
    tmax)) in ascending ids, all T where it has none; and `any_flops`, the
    operations of those tests by stage."""
    from spcbpt_tpu_torch.ops import intersect
    from spcbpt_tpu_torch.utils import vec

    p0, e1, e2 = tris
    t_total = p0.shape[0]
    ids = torch.arange(t_total, device=o.device)
    live_n = any_tests = 0
    stages = dict.fromkeys(FLOPS_STAGES, 0)
    any_stages = dict.fromkeys(FLOPS_STAGES, 0)
    for s in range(0, o.shape[0], chunk):
        lo, hi = tmin[s:s + chunk], tmax[s:s + chunk]
        live = hi > lo
        oo, dd = o[s:s + chunk][live][:, None], d[s:s + chunk][live][:, None]
        lo, hi = lo[live][:, None], hi[live][:, None]
        t, u, v, hit = intersect.tri_test(oo, dd, p0[None], e1[None],
                                          e2[None], cull)
        det = vec.dot(e1[None], vec.cross(dd, e2[None]))
        det_ok = det > intersect._EPS_DET if cull else \
            det.abs() > intersect._EPS_DET
        u_ok = det_ok & (u >= 0.0) & (u <= 1.0)
        stop = {"det": ~det_ok, "u": det_ok & ~u_ok, "v": u_ok & ~hit,
                "t": hit}
        occ = hit & (t > lo) & (t < hi)
        first = torch.where(occ.any(dim=1), occ.int().argmax(dim=1) + 1,
                            t_total)
        tested = ids[None] < first[:, None]
        live_n += int(live.sum())
        any_tests += int(first.sum())
        for k, m in stop.items():
            stages[k] += int(m.sum())
            any_stages[k] += int((m & tested).sum())
    pairs = max(live_n * t_total, 1)
    ops = lambda counts: sum(FLOPS_STAGES[k] * c for k, c in counts.items())
    return dict(live=live_n, **{k: c / pairs for k, c in stages.items()},
                flops=ops(stages), any_tests=any_tests,
                any_flops=ops(any_stages))


def phase_brute(cts, ccam, its, icam, dev) -> dict:
    """K3 against its plain version on Cornell's wavefronts and on the
    interior's 512-triangle wavefront, both cull settings; each kernel
    alone (graph replay), its call, its plain version and its bound; and
    one device kernel per brute-mode trace call."""
    from spcbpt_tpu_torch.kernels import brute_trace as kernels
    from spcbpt_tpu_torch.ops import brute_trace
    from spcbpt_tpu_torch.scene.scene import trace_any, trace_closest

    results = {}
    waves = brute_wavefronts(cts, ccam, its, icam, dev)
    for name, o, d, tmax, tris in waves:
        n, t_total = o.shape[0], tris[0].shape[0]
        tmin = torch.full((n,), 1e-3, device=dev)
        for cull in (True, False):
            got = brute_trace.brute_closest(o, d, tmin, tmax, *tris, cull)
            ref = brute_trace.brute_closest_plain(o, d, tmin, tmax, *tris,
                                                  cull)
            torch.cuda.synchronize()
            err_t = (got.t - ref.t).abs().max().item()
            hits = (ref.tri >= 0).float().mean().item()
            log("brute", f"K3 closest {name} cull={cull}: tri agreement "
                         f"{(got.tri == ref.tri).float().mean().item():.6f}, "
                         f"hits {hits:.4f}, max |dt| {err_t:.3g}")
            for f in ("tri", "t", "u", "v"):
                assert torch.equal(getattr(got, f), getattr(ref, f)), \
                    f"K3 {name} cull={cull}: {f} differs from the plain version"
            assert (got.tri[tmax < tmin] == -1).all(), "dead lane hit"
            if not cull:
                # the checks compare hits, not only misses
                assert hits >= MIN_HIT_SHARE, (name, hits)
            if name.startswith("bounce") and not cull:
                results["brute_closest"] = dict(max_abs_err=err_t)
        tseg = brute_segments(name, ref, tmax, n, dev)
        occ_k = brute_trace.brute_any(o, d, tmin, tseg, *tris)
        occ_p = brute_trace.brute_any_plain(o, d, tmin, tseg, *tris)
        torch.cuda.synchronize()
        assert occ_k.dtype == torch.bool, occ_k.dtype
        assert torch.equal(occ_k, occ_p), \
            f"K3 any {name}: occlusion differs from the plain version"
        occluded = occ_k.float().mean().item()
        log("brute", f"K3 any {name}: occlusion agreement 1.000000 "
                     f"(occluded {occluded:.4f})")
        assert occluded >= MIN_HIT_SHARE, (name, occluded)
        if name.startswith("connection"):
            results["brute_any"] = dict(
                max_abs_err=(occ_k.int() - occ_p.int()).abs().max().item())

        call1 = lambda: kernels.closest(o, d, tmin, tmax, *tris, False)
        call2 = lambda: kernels.any_hit(o, d, tmin, tseg, *tris)
        k1, k2 = graph_ms(call1), graph_ms(call2)
        c1, c2 = cuda_ms(call1, 20), cuda_ms(call2, 20)
        prof = {k[:40]: round(ms, 4) for k, (_, ms) in
                {**device_events(call1, 5), **device_events(call2, 5)}.items()}
        p1 = cuda_ms(lambda: brute_trace.brute_closest_plain(
            o, d, tmin, tmax, *tris, False), 5)
        p2 = cuda_ms(lambda: brute_trace.brute_any_plain(
            o, d, tmin, tseg, *tris), 5)
        cen1 = pair_census(o, d, tmin, tmax, tris, False)
        cen2 = pair_census(o, d, tmin, tseg, tris, False)
        mr = lambda ms: n / ms / 1e3
        log("brute", f"{name} ({n} rays, {cen1['live']} live, {t_total} "
                     f"tris): K3 closest {k1:.4f} ms alone "
                     f"({mr(k1):.1f} Mrays/s), call {c1:.4f}, plain "
                     f"{p1:.4f}; K3 any {k2:.4f} ms alone ({mr(k2):.1f} "
                     f"Mrays/s), call {c2:.4f}, plain {p2:.4f}; profiler "
                     f"ms per kernel {prof}")
        log("brute", f"{name}: live pairs (cull=False) failing at det "
                     f"{cen1['det']:.4f}, at u {cen1['u']:.4f}, at v "
                     f"{cen1['v']:.4f}, reaching t {cen1['t']:.4f} "
                     f"({cen1['flops'] / max(cen1['live'] * t_total, 1):.2f}"
                     f" operations a pair); any-hit tests "
                     f"{cen2['any_tests']} of {cen2['live'] * t_total} live "
                     f"pairs ({cen2['any_flops']} operations)")
        # the live work of these inputs: closest every live lane against
        # every triangle, any each live lane up to its first occluder, each
        # pair's operations up to the stage it stops at; every lane's
        # tmin/tmax read, the live lanes' rays, the outputs and the table
        # once.
        # plain_bound_ms: every lane against every triangle, FLOPS_PER_TEST
        # operations a pair.
        fixed = n * 8 + cen1["live"] * 24 + t_total * TRI_BYTES
        plain = n * RAY_BYTES + t_total * TRI_BYTES
        row = None
        if name.startswith("bounce"):
            row = results["brute_closest"]
            row.update(ms=k1, call_ms=c1, plain_ms=p1,
                       **bound(0, fixed + n * 16, flops=cen1["flops"]),
                       plain_bound_ms=bound(n * t_total,
                                            plain + n * 16)["bound_ms"])
            census = cen1
        if name.startswith("connection"):
            row = results["brute_any"]
            row.update(ms=k2, call_ms=c2, plain_ms=p2,
                       **bound(0, fixed + n, flops=cen2["any_flops"]),
                       plain_bound_ms=bound(n * t_total,
                                            plain + n)["bound_ms"])
            census = cen2
        if row is not None:
            row["pairs_failing_at"] = {k: census[k] for k in FLOPS_STAGES}

    # the path's calls on Cornell's camera rays: one device kernel each,
    # tmin a number as the render loops pass it, tmax a tensor
    _, o, d, tmax, _ = waves[0]
    tseg = tmax * 0.5
    for query, call in (
            ("closest", lambda: trace_closest(cts, o, d, 1e-3, tmax, False)),
            ("any", lambda: trace_any(cts, o, d, 1e-3, tseg))):
        call()
        launched = {}

        def counted(call=call):   # the launches of the window's call
            before = dict(kernels.LAUNCHES)
            call()
            launched.update({k: kernels.LAUNCHES[k] - before[k]
                             for k in before})
        events = device_events(counted)
        log("brute", f"one brute-mode trace_{query} call: device activities "
                     f"{ {k[:60]: c for k, (c, _) in events.items()} }, "
                     f"launches {launched}")
        assert len(events) == 1, events
        (kname, (count, _)), = events.items()
        assert count == 1 and f"{query}_kernel" in kname, events
        assert sum(launched.values()) == 1, launched
    return results


def phase_cpu_vs_card(scene_path: str, devices=("cpu", "cuda"),
                      tag: str = "") -> None:
    from spcbpt_tpu_torch.render import pt_pool
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    out = []
    for dev in devices:
        ts, _, cam = load_trace_scene(scene_path, dev)
        cam.aspect = 1.0
        t0 = time.perf_counter()
        fsum, count = pt_pool.render_pool(ts, cam.uvw(), 64, 64, 2, 0)
        img = (fsum / torch.clamp(count[:, None], min=1)).cpu().numpy()
        out.append((img, count.cpu().numpy(), time.perf_counter() - t0))
    (a, ca, ta), (b, cb, tb) = out
    mean_a, mean_b = float(a.mean()), float(b.mean())
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-20)
    close = float((np.where(np.abs(a - b) == 0, 0.0, rel) <= 1e-3)
                  .all(axis=-1).mean())
    log("cpu-vs-card", f"{tag}64x64 2 spp: cpu {ta:.1f} s, card {tb:.1f} s; mean "
                       f"{mean_a:.6f} vs {mean_b:.6f}; pixels within 1e-3 "
                       f"relative {close:.4f}")
    assert np.array_equal(ca, cb) and (ca == 2).all()
    assert abs(mean_b - mean_a) <= 5e-3 * abs(mean_a), (mean_a, mean_b)
    assert close >= 0.98, close


def phase_cpu_vs_card_spcbpt(state_path: str) -> None:
    """The same 64x64, 1 spp SPCBPT render of Cornell (10,000 light paths,
    one LVC) on the CPU and on the card, from the saved state."""
    from spcbpt_tpu_torch import checkpoint
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.render import light_trace, lvc, spcbpt_pool
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    out = []
    for dev in ("cpu", "cuda"):
        ts, _, cam = load_trace_scene(resolve_scene("cornell"), dev)
        cam.aspect = 1.0
        ss = checkpoint.load_subspace_state(state_path, dev)
        t0 = time.perf_counter()
        lv = light_trace.trace_light_paths(ts, ss, 10_000, 7919,
                                           max_depth=16)
        sampler = lvc.make_builder(ss)(lv, 0)
        fsum, count = spcbpt_pool.render_pool(ts, ss, sampler, cam.uvw(),
                                              64, 64, 1, 0)
        img = (fsum / torch.clamp(count[:, None], min=1)).cpu().numpy()
        out.append((img, count.cpu().numpy(), time.perf_counter() - t0))
    (a, ca, ta), (b, cb, tb) = out
    mean_a, mean_b = float(a.mean()), float(b.mean())
    rel = abs(mean_b - mean_a) / abs(mean_a)
    log("cpu-vs-card", f"spcbpt 64x64 1 spp: cpu {ta:.1f} s, card {tb:.1f} "
                       f"s; mean {mean_a:.6f} vs {mean_b:.6f} "
                       f"({rel * 100:.3f}%, bound {SPCBPT_CPU_CARD * 100:.0f}%)")
    assert np.array_equal(ca, cb) and (ca == 1).all()
    assert np.isfinite(b).all()
    assert rel <= SPCBPT_CPU_CARD, (mean_a, mean_b)


def phase_tile_kernels(tts, wts, waves, dev, first_forms) -> dict:
    """K4 (the round walk, and one round alone) and K5 against their plain
    versions on the tile-mode interior; against brute force and the walk
    mode; K5 closest and K4's round beside their first forms (the libraries
    `first_forms`, by variant name)."""
    import tile_walk_variants as variants
    from spcbpt_tpu_torch.kernels import tile_walk as kernels
    from spcbpt_tpu_torch.ops import clusters, intersect, pallas_tile
    from spcbpt_tpu_torch.ops import ray_walk, tile_trace
    from spcbpt_tpu_torch.scene.scene import TILE_LANES

    cs = tts.clusters
    sizes = clusters.cluster_sizes(cs, tts.num_tris)
    tris = (tts.tri_p0, tts.tri_e1, tts.tri_e2)
    sub = slice(0, BRUTE_SUBSET)
    plain_round = pallas_tile.mt_round_blocks_plain
    results = {}
    for name, o, d, tmax in waves:
        n = o.shape[0]
        tmin = torch.full((n,), 1e-3, device=dev)
        for cull in (True, False):
            # the round walk on the card: one K4 launch, no host sync, its
            # per-tile rounds against the plain walk's visits
            tile_trace.reset_walk_stats()
            kernels.reset_launches()
            tile_trace.ROUND_LOG = rounds = []
            try:
                k4 = tile_trace.tile_closest(cs, o, d, tmin, tmax, cull,
                                             tile=TILE_LANES, use_kernel=True,
                                             sort_rays=True)
            finally:
                tile_trace.ROUND_LOG = None
            stats = dict(tile_trace.WALK_STATS)
            k4_launches = dict(kernels.LAUNCHES)
            p4 = []
            _, _, plain_visits = visits(
                lambda: p4.append(tile_trace.tile_closest_plain(
                    cs, o, d, tmin, tmax, cull, tile=TILE_LANES,
                    sort_rays=True)), sizes)
            p4 = p4[0]
            k5 = pallas_tile.pallas_closest(cs, o, d, tmin, tmax, cull,
                                            sort_rays=True)
            p5 = pallas_tile.pallas_closest_plain(cs, o, d, tmin, tmax, cull,
                                                  sort_rays=True)
            torch.cuda.synchronize()
            for tag, got, ref in (("K4 walk", k4, p4), ("K5 closest", k5, p5)):
                for f in ("tri", "t", "u", "v"):
                    assert torch.equal(getattr(got, f), getattr(ref, f)), \
                        f"{tag} {name} cull={cull}: {f} differs from plain"
                assert (got.tri[tmax < tmin] == -1).all(), "dead lane hit"
            assert k4_launches["tile_round_walk"] == stats["walks"] == 1, \
                (k4_launches, stats)
            assert k4_launches["tile_round"] == 0 and stats["syncs"] == 0, \
                (k4_launches, stats)
            tile_rounds = rounds[0]
            assert int(tile_rounds.sum()) == plain_visits, \
                (int(tile_rounds.sum()), plain_visits)
            walk = ray_walk.walk_closest(wts.clusters_walk, o, d, tmin, tmax,
                                         cull, sort_rays=True)
            bf = intersect.brute_force_closest(o[sub], d[sub], *tris,
                                               tmin[sub], tmax[sub], cull)
            agree = lambda a, b: (a == b).float().mean().item()
            vs_bf = (agree(k4.tri[sub], bf.tri), agree(k5.tri[sub], bf.tri))
            hits = (k5.tri >= 0).float().mean().item()
            log("tile", f"{name} cull={cull}: the K4 walk and K5 closest "
                        f"equal their plain versions; hits {hits:.4f}; tri "
                        f"agreement K4-K5 {agree(k4.tri, k5.tri):.6f}, "
                        f"K4-walk {agree(k4.tri, walk.tri):.6f}, brute on "
                        f"{BRUTE_SUBSET} rays {vs_bf[0]:.6f} / {vs_bf[1]:.6f}"
                        f"; K4 walk: {k4_launches['tile_round_walk']} launch,"
                        f" {stats['syncs']} host syncs, rounds per tile max "
                        f"{int(tile_rounds.max())}, sum "
                        f"{int(tile_rounds.sum())} = the plain walk's visits")
            assert min(vs_bf) >= TRI_AGREE, (name, cull, vs_bf)
            assert agree(k4.tri, walk.tri) >= TRI_AGREE
            if name.startswith("bounce"):
                # the closest times are taken here: they must time hits
                assert hits >= MIN_HIT_SHARE, (name, cull, hits)
            if name.startswith("bounce") and not cull:
                results["tile_round_walk"] = dict(
                    max_abs_err=(k4.t - p4.t).abs().max().item())
                results["tile_walk_closest"] = dict(
                    max_abs_err=(k5.t - p5.t).abs().max().item())
        tseg = any_segments(name, tmax, n, dev)
        occ_k = pallas_tile.pallas_any(cs, o, d, tmin, tseg, sort_rays=True)
        occ_p = pallas_tile.pallas_any_plain(cs, o, d, tmin, tseg,
                                             sort_rays=True)
        torch.cuda.synchronize()
        assert torch.equal(occ_k, occ_p), f"K5 any {name}: differs from plain"
        occ_w = ray_walk.walk_any(wts.clusters_walk, o, d, tmin, tseg,
                                  sort_rays=True)
        bf = intersect.brute_force_any(o[sub], d[sub], *tris, tmin[sub],
                                       tseg[sub])
        bf_agree = (occ_k[sub] == bf).float().mean().item()
        log("tile", f"{name}: K5 any equals its plain version (occluded "
                    f"{occ_k.float().mean().item():.4f}); agreement with the "
                    f"walk {(occ_k == occ_w).float().mean().item():.6f}, "
                    f"brute {bf_agree:.6f}")
        assert bf_agree >= OCC_AGREE, (name, bf_agree)
        if name.startswith("connection"):
            results["tile_walk_any"] = dict(
                max_abs_err=(occ_k.int() - occ_p.int()).abs().max().item())

        # K4's inputs as tile_closest prepares them (sorted, padded, tiles
        # busiest first), and its first round alone against its plain
        # version, both cull settings
        po, pd, ptn, ptx, _ = tile_trace._pad_rays(
            *tile_trace.sort_rays_live(cs, o, d, tmin, tmax)[1:], TILE_LANES)
        entries_s, ids_s, o_t, d_t, tmin_t, tmax_t, _, _ = \
            tile_trace._prepare(cs, po, pd, ptn, ptx, TILE_LANES)
        run0 = entries_s[:, 0] < 1e30
        cid0 = ids_s[:, 0].contiguous()
        round_k = lambda cull: kernels.tile_round(
            o_t, d_t, tmin_t, tmax_t, cid0, run0, cs.tri_block, cs.tri_count,
            cs.tri_k, cull)
        round_p = lambda cull: plain_round(
            o_t, d_t, cs.tri_block, cs.tri_count, cid0, run0, tmin_t, tmax_t,
            cs.tri_k, cull)
        for cull in (True, False):
            got, ref = round_k(cull), round_p(cull)
            torch.cuda.synchronize()
            for f, a, b in zip(("t", "u", "v", "dn", "slot"), got, ref):
                assert torch.equal(a, b), \
                    f"K4 round {name} cull={cull}: {f} differs from plain"
            log("tile", f"{name} cull={cull}: K4 round 0 equals its plain "
                        f"version; {run0.float().mean().item():.4f} of the "
                        f"tiles run, lanes hit "
                        f"{(got[4] < 128).float().mean().item():.4f}")
            if name.startswith("bounce") and not cull:
                results["tile_round"] = dict(
                    max_abs_err=(got[0] - ref[0]).abs().max().item())
        w_args = (o_t, d_t, tmin_t, tmax_t, entries_s, ids_s, cs.tri_block,
                  cs.tri_begin, cs.tri_count, cs.tri_k, False)
        qo, qd, qtn, qtx, _, _ = pallas_tile.prepare(cs, o, d, tmin, tmax,
                                                     True)
        qseg = pallas_tile.prepare(cs, o, d, tmin, tseg, True)[3]
        calls = {
            "K4 walk": lambda: kernels.round_walk(*w_args),
            "K4 round 0": lambda: round_k(False),
            "K5 closest": lambda: kernels.walk_closest(
                qo, qd, qtn, qtx, cs.cmin, cs.cmax, cs.tri_begin,
                cs.tri_block, cs.tri_count, False),
            "K5 any": lambda: kernels.walk_any(
                qo, qd, qtn, qseg, cs.cmin, cs.cmax, cs.tri_block,
                cs.tri_count, cs.tri_k)}
        alone = {k: graph_ms(fn) for k, fn in calls.items()}
        call = {k: cuda_ms(fn, 10) for k, fn in calls.items()}
        # the first forms alone, on the same inputs, equal to the kernels
        inputs, _ = variants.inputs_of(cs, o, d, tmax, tseg, dev)
        first = {}
        for kind, vname in FIRST_FORMS.items():
            run = variants.launcher(kind, first_forms[vname], variants.
                                    VARIANTS[vname][1][kind], inputs)
            ref = calls["K4 round 0" if kind == "K4 round" else kind]()
            assert all(torch.equal(a, b) for a, b in zip(run(), ref)), \
                f"{kind}'s first form on {name} differs from the kernel"
            first[kind] = graph_ms(run)
        p4_ms = cuda_ms(lambda: round_p(False), 10)
        plain_walk = lambda: tile_trace._in_buckets(
            lambda *a: tile_trace._round_walk(*a, False, plain_round))(
            cs, entries_s, ids_s, o_t, d_t, tmin_t, tmax_t)
        walk4 = cuda_ms(lambda: tile_trace.tile_closest(
            cs, o, d, tmin, tmax, False, tile=TILE_LANES, use_kernel=True,
            sort_rays=True), 5)
        walk4_p = cuda_ms(plain_walk, 1) if name.startswith("bounce") \
            else float("nan")
        p5c = cuda_ms(lambda: pallas_tile.closest_tiles_plain(
            cs, qo, qd, qtn, qtx, False), 1)
        p5a = cuda_ms(lambda: pallas_tile.any_tiles_plain(
            cs, qo, qd, qtn, qseg), 1)
        log("tile", f"{name} ({n} rays, {o_t.shape[0]} tiles of "
                    f"{TILE_LANES}): kernel alone / call, ms: " + ", ".join(
                        f"{k} {alone[k]:.4f} / {call[k]:.4f}" for k in calls)
                    + f"; first forms alone: K4 round 0 "
                    f"{first['K4 round']:.4f}, K5 closest "
                    f"{first['K5 closest']:.4f}"
                    f"; plain: K4 walk (host loop, bounce only) "
                    f"{walk4_p:.1f}, K4 round 0 {p4_ms:.4f}, K5 closest "
                    f"{p5c:.2f}, K5 any {p5a:.2f}; tile_closest with K4 "
                    f"(sort + prepare + walk + unsort) {walk4:.3f} ms")
        k4w, k4_ms, k5c, k5a = (alone[k] for k in calls)
        c4w, c4_ms, c5c, c5a = (call[k] for k in calls)
        # bytes: rays (K4: the visit order it reads, one entry and id per
        # round and the stopping one per tile, a round count per tile,
        # tri_begin and tri_count; K5: the cluster boxes, and tri_begin for
        # the closest hit or tri_count for the any hit), the visited
        # clusters' triangles, hits or flags
        nq, c, nt4 = qo.shape[0], cs.num_clusters, o_t.shape[0]
        lanes = nt4 * o_t.shape[1]
        if name.startswith("bounce"):
            t4, tri4, v4 = visits(plain_walk, sizes)
            r4, trir, _ = visits(lambda: round_p(False), sizes)
            results["tile_round_walk"].update(ms=k4w, call_ms=c4w,
                                              plain_ms=walk4_p, **bound(
                t4, lanes * (RAY_BYTES + 16) + (v4 + nt4) * 8 + nt4 * 4
                + c * 8 + tri4 * TRI_BYTES))
            # the round: the plain version's tests (every lane of a running
            # tile) as plain_bound_ms; the kernel's own work as bound_ms:
            # the live lanes of running tiles against their cluster's
            # triangles; bytes: their rays, every lane's outputs, cid and
            # run, the running tiles' tri_count and triangles
            live = ((tmax_t > tmin_t) & run0[:, None]).sum(dim=1)
            r4_own = int((live * sizes[cid0.long()]).sum())
            runs = int(run0.sum())
            plain_r = bound(r4, lanes * (RAY_BYTES + 20) + nt4 * 5
                            + trir * TRI_BYTES)
            results["tile_round"].update(
                ms=k4_ms, call_ms=c4_ms, first_form_ms=first["K4 round"],
                plain_ms=p4_ms, **bound(
                    r4_own, runs * o_t.shape[1] * RAY_BYTES + lanes * 20
                    + nt4 * 5 + runs * 4 + trir * TRI_BYTES),
                plain_bound_ms=plain_r["bound_ms"])
            # K5 closest: the plain walk's tile visits as plain_bound_ms;
            # the groups' own positions and tests (the kernel's optional
            # output) as bound_ms; bytes: rays, the boxes, tri_begin and
            # tri_count, each tile's triangles up to its longest group's
            # stop (its list is its clusters in reach sorted by (entry,
            # id)), hits
            group = kernels.group_rays()
            rounds5 = torch.empty((nq // group, 2), dtype=torch.int32,
                                  device=dev)
            got5 = kernels.walk_closest(qo, qd, qtn, qtx, cs.cmin, cs.cmax,
                                        cs.tri_begin, cs.tri_block,
                                        cs.tri_count, False, rounds5)
            plain_log = visit_log(lambda: pallas_tile.closest_tiles_plain(
                cs, qo, qd, qtn, qtx, False))
            t5, tri5, v5 = tally(plain_log, sizes)
            assert all(torch.equal(a, b) for a, b in
                       zip(got5, calls["K5 closest"]())), "K5 rounds form"
            walked = rounds5[:, 0].long()
            own5 = int(rounds5[:, 1].long().sum())
            per_tile = pallas_tile.TILE // group
            assert int(walked.max()) <= len(plain_log), \
                (int(walked.max()), len(plain_log))
            assert int(walked.sum()) <= v5 * per_tile, \
                (int(walked.sum()), v5 * per_tile)
            nt5 = nq // pallas_tile.TILE
            reach = walked.view(nt5, per_tile).amax(dim=1)
            order = torch.sort(tile_trace.tile_entries(
                cs, qo, qd, qtn, qtx, pallas_tile.TILE), dim=1,
                stable=True).indices
            in_reach = (torch.arange(c, device=dev)[None, :]
                        < reach[:, None])
            reached = int((sizes[order] * in_reach).sum())
            plain5 = bound(t5, nq * (RAY_BYTES + 16) + c * 28
                           + tri5 * TRI_BYTES)
            results["tile_walk_closest"].update(
                ms=k5c, call_ms=c5c, first_form_ms=first["K5 closest"],
                plain_ms=p5c, **bound(
                    own5, nq * (RAY_BYTES + 16) + c * 32
                    + reached * TRI_BYTES),
                plain_bound_ms=plain5["bound_ms"])
            log("tile", f"{name}: K5 closest's {nq // group} groups of "
                        f"{group} walked {int(walked.sum())} positions, at "
                        f"most {int(walked.max())}, against {v5} tile "
                        f"visits of the plain walk (x {per_tile} groups a "
                        f"tile = {v5 * per_tile}), at most {len(plain_log)};"
                        f" ray-triangle tests: the plain walk's {t5}, the "
                        f"groups' own {own5} ({own5 / max(t5, 1):.3f}x); "
                        f"bound {results['tile_walk_closest']['bound_ms']:.4f}"
                        f" ms ({results['tile_walk_closest']['bound_by']}), "
                        f"the plain walk's {plain5['bound_ms']:.4f} ms; K4 "
                        f"round 0: {r4_own} live tests of {r4}, bound "
                        f"{results['tile_round']['bound_ms']:.5f} ms "
                        f"({results['tile_round']['bound_by']}), the plain "
                        f"version's {plain_r['bound_ms']:.5f} ms")
            log("tile", f"{name}: K4 walk {v4} visits of {TILE_LANES} rays "
                        f"({t4} ray-triangle tests)")
        if name.startswith("connection"):
            t5, tri5, v5 = visits(lambda: pallas_tile.any_tiles_plain(
                cs, qo, qd, qtn, qseg), sizes)
            results["tile_walk_any"].update(ms=k5a, call_ms=c5a,
                                            plain_ms=p5a, **bound(
                t5, nq * (RAY_BYTES + 4) + c * 28 + tri5 * TRI_BYTES))
            log("tile", f"{name}: K5 any {v5} visits of {pallas_tile.TILE} "
                        f"rays ({t5} ray-triangle tests)")
    return results


def phase_list_walk(tts, wts, waves, dev) -> dict:
    """K6, all four forms, against their plain versions on both cluster sets
    of one BVH (K=32 of the tile mode, K=128 of the walk mode): the camera,
    bounce and connection wavefronts, both cull settings, tiles of 256 (and
    128 for the resident closest form and both any forms), prune=False once;
    against brute force on a subset; times on the bounce wavefront at tile
    256, K=128 and K=32 (the any forms also on the connection wavefront),
    with the groups' rounds and tests."""
    from spcbpt_tpu_torch.kernels import list_walk as kernels
    from spcbpt_tpu_torch.ops import clusters, intersect, pallas_walk

    assert torch.equal(tts.tri_p0, wts.tri_p0), "cluster sets disagree"
    tris = (wts.tri_p0, wts.tri_e1, wts.tri_e2)
    sub = slice(0, BRUTE_SUBSET)
    fields = ("tri", "t", "u", "v")
    for k, cs in ((32, tts.clusters), (128, wts.clusters_walk)):
        for name, o, d, tmax in waves:
            n = o.shape[0]
            tmin = torch.full((n,), 1e-3, device=dev)
            sort = not name.startswith("camera")
            for cull in (True, False):
                forms = [("resident", 256, True), ("streamed", 256, False)]
                if cull:
                    forms.append(("resident", 128, True))
                for form, tile, resident in forms:
                    got = pallas_walk.walk_closest(
                        cs, o, d, tmin, tmax, cull, tile=tile,
                        sort_rays=sort, vmem_resident=resident)
                    ref = pallas_walk.walk_closest_plain(
                        cs, o, d, tmin, tmax, cull, tile=tile,
                        sort_rays=sort)
                    torch.cuda.synchronize()
                    for f in fields:
                        assert torch.equal(getattr(got, f), getattr(ref, f)), \
                            (f"K6 closest {form} K={k} tile={tile} {name} "
                             f"cull={cull}: {f} differs from plain")
                    assert (got.tri[tmax < tmin] == -1).all(), "dead lane hit"
                bf = intersect.brute_force_closest(o[sub], d[sub], *tris,
                                                   tmin[sub], tmax[sub], cull)
                bf_agree = (got.tri[sub] == bf.tri).float().mean().item()
                log("list", f"K={k} {name} cull={cull}: closest resident "
                            f"(tiles 256, 128) and streamed equal the plain "
                            f"version; hits {(got.tri >= 0).float().mean().item():.4f}"
                            f", brute on {BRUTE_SUBSET} rays {bf_agree:.6f}")
                assert bf_agree >= TRI_AGREE, (k, name, cull, bf_agree)
            tseg = any_segments(name, tmax, n, dev)
            for tile in (256, 128):
                occ_p = pallas_walk.walk_any_plain(cs, o, d, tmin, tseg,
                                                   tile=tile, sort_rays=sort)
                for resident in (True, False):
                    occ_k = pallas_walk.walk_any(cs, o, d, tmin, tseg,
                                                 tile=tile, sort_rays=sort,
                                                 vmem_resident=resident)
                    torch.cuda.synchronize()
                    assert torch.equal(occ_k, occ_p), \
                        (f"K6 any resident={resident} K={k} tile={tile} "
                         f"{name}: differs")
            bf = intersect.brute_force_any(o[sub], d[sub], *tris, tmin[sub],
                                           tseg[sub])
            bf_agree = (occ_k[sub] == bf).float().mean().item()
            log("list", f"K={k} {name}: any resident and streamed (tiles "
                        f"256, 128) equal the plain version (occluded "
                        f"{occ_k.float().mean().item():.4f}), brute "
                        f"{bf_agree:.6f}")
            assert bf_agree >= OCC_AGREE, (k, name, bf_agree)

    # prune=False once: the whole list of every tile, the same hits
    cs = wts.clusters_walk
    name, o, d, tmax = waves[1]
    tmin = torch.full((o.shape[0],), 1e-3, device=dev)
    got = pallas_walk.walk_closest(cs, o, d, tmin, tmax, True,
                                   sort_rays=True, prune=False)
    ref = pallas_walk.walk_closest_plain(cs, o, d, tmin, tmax, True,
                                         sort_rays=True, prune=False)
    pruned = pallas_walk.walk_closest(cs, o, d, tmin, tmax, True,
                                      sort_rays=True)
    torch.cuda.synchronize()
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f"prune {f}"
        assert torch.equal(getattr(got, f), getattr(pruned, f)), f
    log("list", f"K=128 {name} prune=False: equals its plain version and "
                f"the pruned walk")

    # times: each form alone on the prepared lists of the bounce wavefront,
    # tile 256 (closest with culling, any with segments up to 3, as the
    # profiler walks them), against the plain version; the JSON line takes
    # K=128, the closest forms are timed at K=32 too. The closest groups'
    # rounds and their rays' tests (the kernels' optional output) against
    # the plain walk's tile rounds and tests
    group = kernels.group_rays()
    results, err = {}, {}
    for k, cs in ((128, wts.clusters_walk), (32, tts.clusters)):
        sizes = clusters.cluster_sizes(cs, wts.num_tris)
        blocks = cs.blocks()
        po, pd, ptn, ptx, _, entries, ids, bases, counts, _ = \
            pallas_walk.prepare(cs, o, d, tmin, tmax, 256, True)
        npad, nt = po.shape[0], ids.shape[0]
        closest = lambda stream, rounds=None: kernels.closest(
            blocks, cs.tri_count, counts, ids, bases, entries, po, pd, ptn,
            ptx, True, True, stream, rounds)
        plain_c = lambda: pallas_walk.list_walk_closest_plain(
            blocks, counts, ids, bases, entries, po, pd, ptn, ptx, True)
        ref_c = plain_c()
        rounds = {}
        for stream in (False, True):
            rounds[stream] = torch.empty((npad // group, 2),
                                         dtype=torch.int32, device=dev)
            got_c = closest(stream, rounds[stream])
            for f, a, b in zip(("t", "tri", "u", "v"), got_c, ref_c):
                assert torch.equal(a, b), \
                    f"K6 closest K={k} stream={stream}: {f}"
            err[k, stream] = (got_c[0] - ref_c[0]).abs().max().item()
        assert torch.equal(rounds[False], rounds[True]), "rounds differ"
        plain_log = visit_log(plain_c)
        tc, tric, vc = tally(plain_log, sizes)
        walked = rounds[False][:, 0].long()
        own_tests = int(rounds[False][:, 1].long().sum())
        assert int(walked.max()) <= len(plain_log), \
            (int(walked.max()), len(plain_log))
        assert int(walked.sum()) <= vc * (256 // group)
        # the plain walk's bound (plain_bound_ms, the yardstick across
        # forms): its visits' tests; bytes: rays, counts, the list entries
        # the walk reads (ids, entries and bases: one per round and the
        # stopping one per tile), the visited clusters' triangles, hits
        plain_bnd = bound(tc, npad * (RAY_BYTES + 16) + nt * 4
                          + (vc + nt) * 12 + tric * TRI_BYTES)
        # the bound the JSON line takes, of the work the kernels need: the
        # tests they make; bytes: rays, counts, each tile's list (id, entry,
        # base) and the triangles of its clusters up to its longest group's
        # stop, hits
        reach = rounds[False][:, 0].view(nt, -1).amax(dim=1).long()
        lists = int(reach.sum())
        in_reach = (torch.arange(ids.shape[1], device=dev)[None, :]
                    < reach[:, None])
        reached = int((cs.tri_count[ids.long()] * in_reach).sum())
        bnd = bound(own_tests, npad * (RAY_BYTES + 16) + nt * 4 + lists * 12
                    + reached * TRI_BYTES)
        ms = {stream: graph_ms(lambda: closest(stream))
              for stream in (False, True)}
        call_ms = {stream: cuda_ms(lambda: closest(stream), 20)
                   for stream in (False, True)}
        mr = lambda t: o.shape[0] / t / 1e3
        log("list", f"{name} K={k} tile 256 ({nt} tiles, {npad // group} "
                    f"groups of {group}): closest resident {ms[False]:.4f} ms"
                    f" alone (call {call_ms[False]:.4f}), streamed "
                    f"{ms[True]:.4f} ms alone (call {call_ms[True]:.4f}) "
                    f"({mr(ms[False]):.1f} and {mr(ms[True]):.1f} Mrays/s "
                    f"alone); bound "
                    f"{plain_bnd['bound_ms']:.4f} ms "
                    f"({plain_bnd['bound_by']}) from the plain walk's work, "
                    f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) from the "
                    f"kernels' own; groups "
                    f"walked {int(walked.sum())} rounds, at most "
                    f"{int(walked.max())}, against {vc} tile visits of the "
                    f"plain walk (x {256 // group} groups a tile = "
                    f"{vc * (256 // group)}), at most {len(plain_log)}; "
                    f"ray-triangle tests: the plain walk's {tc}, the "
                    f"groups' own {own_tests} ({own_tests / max(tc, 1):.3f}x)")
        if k == 128:
            pc = cuda_ms(plain_c, 2)
            for stream, suffix in ((False, ""), (True, "_stream")):
                results[f"list_walk_closest{suffix}"] = dict(
                    max_abs_err=err[k, stream], ms=ms[stream],
                    call_ms=call_ms[stream], plain_ms=pc,
                    **bnd, plain_bound_ms=plain_bnd["bound_ms"])

    # the any forms on the bounce wavefront with segments up to 3 (as the
    # profiler walks them; K=128 in the JSON line) and on the connection
    # wavefront's own segments, both sets, tile 256; each form's groups'
    # rounds and their own tests (the kernels' optional output, each ray up
    # to its first occluder) against the plain walk's tile rounds and tests
    t3 = torch.where(tmax < 0, -1.0, torch.full_like(tmax, 3.0))
    segments = [(f"{name} tmax 3", o, d, t3), waves[2]]
    forms = ((False, "resident", ""), (True, "streamed", "_stream"))
    for k, cs in ((128, wts.clusters_walk), (32, tts.clusters)):
        sizes = clusters.cluster_sizes(cs, wts.num_tris)
        blocks = cs.blocks()
        for wave, wo, wd, wt in segments:
            wtmin = torch.full((wo.shape[0],), 1e-3, device=dev)
            po, pd, ptn, qtx, _, q_entries, q_ids, _, q_counts, _ = \
                pallas_walk.prepare(cs, wo, wd, wtmin, wt, 256, True)
            npad, nt = po.shape[0], q_ids.shape[0]
            any_hit = lambda stream, rounds=None: kernels.any_hit(
                blocks, cs.tri_count, q_counts, q_ids, q_entries, po, pd, ptn,
                qtx, stream, rounds)
            plain_a = lambda: pallas_walk.list_walk_any_plain(
                blocks, q_counts, q_ids, q_entries, po, pd, ptn, qtx)
            ref_a = plain_a()
            plain_log = visit_log(plain_a)
            ta, tria, va = tally(plain_log, sizes)
            # the plain walk's bound (plain_bound_ms); bytes: rays, counts,
            # ids and entries (one per round and the stopping one per tile),
            # the visited clusters' triangles, flags
            plain_bnd = bound(ta, npad * (RAY_BYTES + 4) + nt * 4
                              + (va + nt) * 8 + tria * TRI_BYTES)
            timed = k == 128 and wave == segments[0][0]    # the JSON line's
            pa = cuda_ms(plain_a, 2) if timed else None
            log("list", f"{wave} K={k} tile 256 ({nt} tiles): occluded "
                        f"{ref_a.float().mean().item():.4f}; the plain walk's "
                        f"{va} tile visits (at most {len(plain_log)} a "
                        f"tile), {ta} ray-triangle tests, bound "
                        f"{plain_bnd['bound_ms']:.4f} ms "
                        f"({plain_bnd['bound_by']})")
            for stream, form, suffix in forms:
                group = kernels.any_group_rays(stream)
                rounds = torch.empty((npad // group, 2), dtype=torch.int32,
                                     device=dev)
                got_a = any_hit(stream, rounds)
                assert torch.equal(got_a, ref_a), \
                    f"K6 any K={k} {wave} {form}"
                walked = rounds[:, 0].long()
                own_tests = int(rounds[:, 1].long().sum())
                assert int(walked.max()) <= len(plain_log), \
                    (int(walked.max()), len(plain_log))
                assert int(walked.sum()) <= va * (256 // group)
                # the bound the JSON line takes, of the work the kernel
                # needs: its tests; bytes: rays, counts, each tile's list
                # (id, entry) and the triangles of its clusters up to its
                # longest group's stop, flags
                reach = walked.view(nt, -1).amax(dim=1)
                in_reach = (torch.arange(q_ids.shape[1], device=dev)[None, :]
                            < reach[:, None])
                reached = int((cs.tri_count[q_ids.long()] * in_reach).sum())
                bnd = bound(own_tests, npad * (RAY_BYTES + 4) + nt * 4
                            + int(reach.sum()) * 8 + reached * TRI_BYTES)
                ms = graph_ms(lambda: any_hit(stream))
                call = cuda_ms(lambda: any_hit(stream), 20)
                log("list", f"{wave} K={k}: any {form} {ms:.4f} ms alone "
                            f"({wo.shape[0] / ms / 1e3:.1f} Mrays/s), call "
                            f"{call:.4f} ms, "
                            f"{npad // group} groups of {group} walked "
                            f"{int(walked.sum())} rounds, at most "
                            f"{int(walked.max())} (x {256 // group} groups "
                            f"a tile: {va * (256 // group)}); own tests "
                            f"{own_tests} ({own_tests / max(ta, 1):.3f}x the "
                            f"plain walk's), own bound {bnd['bound_ms']:.4f} "
                            f"ms ({bnd['bound_by']})")
                if timed:
                    results[f"list_walk_any{suffix}"] = dict(
                        max_abs_err=(got_a - ref_a).abs().max().item(),
                        ms=ms, call_ms=call, plain_ms=pa, **bnd,
                        plain_bound_ms=plain_bnd["bound_ms"])
    return results


def any_segments(name, tmax, n, dev):
    """Any-hit segment ends: the connection wavefront has its own, the
    others random ones in [0.05, 4] (dead lanes stay dead)."""
    if name.startswith("connection"):
        return tmax
    rs = np.random.RandomState(1)
    seg = torch.from_numpy(rs.uniform(0.05, 4.0, n).astype(np.float32))
    return torch.where(tmax < 0, -1.0, seg.to(dev))


def phase_profiler() -> dict:
    """The list walk's path: `python -m spcbpt_tpu_torch.apps.prof_traversal`
    at its defaults in a process of its own (its launch counts start at 0
    there and are read from its last line); returns them."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "spcbpt_tpu_torch.apps.prof_traversal"],
        cwd=REPO, capture_output=True, text=True, timeout=PROFILER_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=REPO))
    for line in out.stdout.splitlines()[:-1]:
        log("profiler", line)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    log("profiler", f"done in {time.perf_counter() - t0:.1f} s on "
                    f"{res['device']}, BVH {res['bvh_route']}; launches "
                    f"{res['launches']}")
    assert all(v > 0 for v in res["launches"].values()), res["launches"]
    assert min(res["tri_agree"].values()) >= TRI_AGREE, res["tri_agree"]
    return res["launches"]


def phase_tile_main(tts, cam, walk_stats) -> dict:
    """PT on the interior in tile mode (K4/K5) at the walk main path's size,
    spp and seeds; returns the render's launch counts. Each closest-hit
    trace must be one K4 walk launch with no host sync of the round loop."""
    from spcbpt_tpu_torch.ops import tile_trace
    from spcbpt_tpu_torch.render import pt_pool

    dim, spp = walk_stats["width"], walk_stats["spp"]
    ref = walk_stats["mean_radiance"]
    torch.cuda.synchronize()
    reset_launches()
    tile_trace.ROUND_LOG = rounds = []
    t0 = time.perf_counter()
    try:
        fsum, count = pt_pool.render_pool(tts, cam.uvw(), dim, dim, spp, 0)
        torch.cuda.synchronize()
    finally:
        tile_trace.ROUND_LOG = None
    ms = (time.perf_counter() - t0) * 1e3 / spp
    launches = read_launches()
    stats = dict(tile_trace.WALK_STATS)
    img = fsum / torch.clamp(count[:, None], min=1)
    assert (count == spp).all(), "per-pixel counts"
    assert torch.isfinite(img).all()
    mean = img.mean().item()
    rel = abs(mean - ref) / ref
    walks = max(stats["walks"], 1)
    per_trace = torch.stack([r.max() for r in rounds]).float()
    log("tile-main", f"interior {dim}x{dim} pt {spp} spp in tile mode: "
                     f"{ms:.1f} ms/spp (walk mode "
                     f"{walk_stats['render_seconds'] * 1e3 / spp:.1f}); mean "
                     f"{mean:.6f} vs walk mode {ref:.6f} ({rel * 100:.4f}%, "
                     f"bound {TILE_MEAN_PT * 100:.1f}%); launches {launches};"
                     f" {stats['walks']} closest traces, "
                     f"{launches['tile_round_walk'] / walks:.1f} K4 walk "
                     f"launches and {stats['syncs'] / walks:.1f} round-loop "
                     f"host syncs per trace; rounds of a trace's longest "
                     f"tile: mean {per_trace.mean().item():.1f}, max "
                     f"{int(per_trace.max())}")
    assert launches["tile_round_walk"] == stats["walks"] > 0, \
        (launches, stats)
    assert stats["syncs"] == 0 and launches["tile_round"] == 0, \
        (launches, stats)
    assert launches["tile_walk_any"] > 0, launches
    assert launches["walk_closest"] == launches["walk_any"] == 0, launches
    assert rel <= TILE_MEAN_PT, (mean, ref)
    return launches


def _capped_mean(img) -> float:
    """Mean over the pixels of (..., 3) radiance, each capped at COVE_CAP."""
    return torch.clamp(img.mean(dim=-1), max=COVE_CAP).mean().item()


def phase_tile_cove(out_dir: str, dev, state_path: str, walk_stats) -> None:
    """Cove SPCBPT 256x256, 1 spp, in tile mode from the saved state, as
    render_cli renders frame 0 (100,000 light paths, depth 16, 3
    connections), against the walk mode's render of phase 7. Before it, in
    walk mode, the same frame once more (the spread between two renders of
    the same seeds) and with planted any-hit faults, which the bounds must
    refuse."""
    from spcbpt_tpu_torch import checkpoint
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.render import light_trace, lvc, spcbpt_pool
    from spcbpt_tpu_torch.scene import scene
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    ss = checkpoint.load_subspace_state(state_path, dev)

    def load(mode):
        ts, _, cam = load_trace_scene(resolve_scene("interior_cove"), dev,
                                      mode=mode)
        cam.aspect = 1.0
        return ts, cam

    def frame(ts, cam):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        lv = light_trace.trace_light_paths(ts, ss, 100_000, 7919,
                                           max_depth=16)
        sampler = lvc.make_builder(ss)(lv, 0)
        fsum, count = spcbpt_pool.render_pool(ts, ss, sampler, cam.uvw(),
                                              256, 256, 1, 0, max_depth=16,
                                              connection_n=3)
        img = fsum / torch.clamp(count[:, None], min=1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        assert (count == 1).all() and torch.isfinite(img).all()
        return img, ms, read_launches()

    def faulty_frame(ts, cam, stride):
        """The frame with every `stride`-th lane of every any-hit trace
        reported unoccluded, whatever the kernel found."""
        sound = scene.trace_any

        def faulty(*args):
            occ = sound(*args).clone()
            occ[::stride] = False
            return occ
        scene.trace_any = faulty
        try:
            return frame(ts, cam)[0]
        finally:
            scene.trace_any = sound

    ref = walk_stats["mean_radiance"]
    ref_cap = _capped_mean(torch.from_numpy(
        np.load(os.path.join(out_dir, "cove_spcbpt.npz"))["radiance"]))
    rel = lambda x, r: abs(x - r) / r
    walk = load("walk")
    again = frame(*walk)[0]
    log("tile-cove", f"walk mode, the same frame again, against phase 7's "
                     f"render: mean off by "
                     f"{rel(again.mean().item(), ref) * 100:.4f}%, mean of "
                     f"pixels capped at {COVE_CAP:g} by "
                     f"{rel(_capped_mean(again), ref_cap) * 100:.4f}%")
    for stride in COVE_FAULT_STRIDES:
        bad = faulty_frame(*walk, stride)
        bad_mean, bad_cap = rel(bad.mean().item(), ref), \
            rel(_capped_mean(bad), ref_cap)
        log("tile-cove", f"walk mode with one any-hit lane in {stride} "
                         f"reported unoccluded: mean off by "
                         f"{bad_mean * 100:.4f}%, capped mean by "
                         f"{bad_cap * 100:.4f}%")
        assert bad_cap > TILE_MEAN_SPCBPT, \
            f"the capped mean's bound passes a planted fault ({stride})"
        assert stride > COVE_FAULT_STRIDES[0] or \
            bad_mean > TILE_MEAN_SPCBPT_TAIL, \
            f"the plain mean's bound passes a planted fault ({stride})"

    img, ms, launches = frame(*load("tile"))
    mean, cap = img.mean().item(), _capped_mean(img)
    log("tile-cove", f"spcbpt 256x256 1 spp in tile mode: {ms:.1f} ms, mean "
                     f"{mean:.6f} vs walk mode {ref:.6f} "
                     f"({rel(mean, ref) * 100:.4f}%, bound "
                     f"{TILE_MEAN_SPCBPT_TAIL * 100:.0f}%); pixels capped at "
                     f"{COVE_CAP:g}: {cap:.6f} vs {ref_cap:.6f} "
                     f"({rel(cap, ref_cap) * 100:.4f}%, bound "
                     f"{TILE_MEAN_SPCBPT * 100:.0f}%); launches {launches}")
    assert launches["tile_round_walk"] > 0 and launches["tile_walk_any"] > 0
    assert launches["walk_closest"] == launches["walk_any"] == 0, launches
    assert rel(cap, ref_cap) <= TILE_MEAN_SPCBPT, (cap, ref_cap)
    assert rel(mean, ref) <= TILE_MEAN_SPCBPT_TAIL, (mean, ref)


def phase_tile_cpu_vs_card(out_dir: str) -> None:
    """PT 64x64, 2 spp, depth 8 on the scale=1 interior in tile mode, CPU
    (matmul walk) against card (K4/K5)."""
    from spcbpt_tpu_torch.apps.render_cli import generate_interior
    from spcbpt_tpu_torch.render import pt_pool
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    path = generate_interior(os.path.join(out_dir, "interior_scale1"), 1)
    out = []
    for dev in ("cpu", "cuda"):
        ts, _, cam = load_trace_scene(path, dev, mode="tile")
        cam.aspect = 1.0
        reset_launches()
        t0 = time.perf_counter()
        fsum, count = pt_pool.render_pool(ts, cam.uvw(), 64, 64, 2, 0,
                                          max_depth=8)
        img = (fsum / torch.clamp(count[:, None], min=1)).cpu().numpy()
        out.append((img, count.cpu().numpy(), time.perf_counter() - t0,
                    read_launches()))
    (a, ca, ta, la), (b, cb, tb, lb) = out
    mean_a, mean_b = float(a.mean()), float(b.mean())
    rel = abs(mean_b - mean_a) / abs(mean_a)
    close = float((np.abs(a - b) <= 1e-3 * np.maximum(np.abs(a), 1e-20))
                  .all(axis=-1).mean())
    log("cpu-vs-card", f"tile mode, {ts.num_tris} tris, 64x64 2 spp depth 8:"
                       f" cpu {ta:.1f} s, card {tb:.1f} s; mean {mean_a:.6f} "
                       f"vs {mean_b:.6f} ({rel * 100:.4f}%, bound "
                       f"{TILE_CPU_CARD * 100:.1f}%); pixels within 1e-3 "
                       f"relative {close:.4f}")
    assert not any(la.values()), la                    # plain on the CPU
    assert lb["tile_round_walk"] > 0 and lb["tile_walk_any"] > 0, lb
    assert np.array_equal(ca, cb) and (ca == 2).all()
    assert np.isfinite(b).all()
    assert rel <= TILE_CPU_CARD, (mean_a, mean_b)


def sky_raster(seed: int = SKY_SEED, h: int = SKY_H,
               w: int = SKY_W) -> np.ndarray:
    """(h, w, 3) float32 sky: a warm horizon to a blue zenith above, a dim
    ground below (rows look up as v = (1 + sin(elevation)) / 2 grows),
    noise from `seed`, and one bright sun texel."""
    rng = np.random.default_rng(seed)
    v = ((np.arange(h, dtype=np.float32) + 0.5) / h)[:, None, None]
    el = np.clip(2.0 * v - 1.0, 0.0, 1.0)
    sky = (1.0 - el) * np.array([1.0, 0.9, 0.75], np.float32) \
        + el * np.array([0.45, 0.65, 1.2], np.float32)
    ground = np.array([0.25, 0.2, 0.15], np.float32)
    rgb = np.where(v >= 0.5, sky, ground) * np.ones((1, w, 1), np.float32)
    rgb = rgb * rng.uniform(0.9, 1.1, (h, w, 1)).astype(np.float32)
    rgb[int(0.8 * h), int(0.3 * w)] = (60.0, 55.0, 45.0)
    return rgb.astype(np.float32)


def _sky_scene_text(text: str, env_file: str, env_lum: float) -> str:
    """`text` (a scene file) with the sky and the Direction light added."""
    text = text.replace("cameraSetting\n{", "cameraSetting\n{\n"
                        f"    env_file {env_file}\n    env_lum {env_lum}", 1)
    d, e = SKY_DIRECTION, SKY_SUN
    return text + ("\nlight\n{\n"
                   f"    direction {d[0]} {d[1]} {d[2]}\n"
                   f"    emission {e[0]} {e[1]} {e[2]}\n"
                   "    type Direction\n}\n")


def write_sky_scenes(out_dir: str) -> dict:
    """Writes the sky (new-RLE scanlines), sky-lit Cornell (and its twin
    with env_lum 0) and the sky-lit furnished scene under out_dir/sky;
    returns their scene paths by name."""
    import shutil

    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.scene import hdr, interior

    root = os.path.join(out_dir, "sky")
    cdir = os.path.join(root, "cornell")
    os.makedirs(cdir, exist_ok=True)
    t0 = time.perf_counter()
    hdr.write_hdr(os.path.join(root, "sky.hdr"), sky_raster(), rle=True)
    src = resolve_scene("cornell")
    for f in os.listdir(os.path.dirname(src)):
        if f.endswith(".obj"):
            shutil.copy(os.path.join(os.path.dirname(src), f), cdir)
    with open(src) as f:
        text = f.read()
    paths = {}
    for name, lum in (("cornell_sky", 1.0), ("cornell_sky_off", 0.0)):
        paths[name] = os.path.join(cdir, f"{name}.scene")
        with open(paths[name], "w") as f:
            f.write(_sky_scene_text(text, "sky.hdr", lum))
    # the interior's furniture (scale 4) on one floor quad, no room shell
    # and no divider, under the sky, the Direction light and one quad light
    ipath = interior.generate(root, scale=4)
    idir = os.path.dirname(ipath)
    with open(os.path.join(idir, "floor.obj"), "w") as f:
        f.write("v -2 0 -2\nv -2 0 16\nv 22 0 16\nv 22 0 -2\n"
                "f 1 2 3\nf 1 3 4\n")
    with open(ipath) as f:
        itext = f.read()
    head = itext[:itext.index("\nlight\n")]
    meshes = "".join(
        f"\nmesh\n{{\n    file interior_interior/{g}.obj\n"
        f"    material {m}\n}}\n" for g, m in
        zip(FURNISHED + ("floor",), ("Wood", "Ornament", "LampMetal",
                                     "BedCloth", "Curtain", "Wall")))
    quad = ("\nlight\n{\n    position 7.0 5.98 4.0\n    v1 13.0 5.98 4.0\n"
            "    v2 7.0 5.98 10.0\n    emission 10 9.2 7.5\n    type Quad\n"
            "    divLevel 8\n}\n")
    paths["furnished_sky"] = os.path.join(idir, "furnished_sky.scene")
    with open(paths["furnished_sky"], "w") as f:
        f.write(_sky_scene_text(head + quad + meshes, "sky.hdr", 1.0))
    log("sky", f"sky {SKY_W}x{SKY_H} (seed {SKY_SEED}, new-RLE scanlines, "
               f"{os.path.getsize(os.path.join(root, 'sky.hdr'))} bytes) and "
               f"scenes {sorted(paths)} written in "
               f"{time.perf_counter() - t0:.1f} s")
    return paths


def env_wavefronts_check(ts, cam, dev, tag: str, side: int = CAMERA_DIM):
    """The kernels of ts's mode against their plain versions on three
    wavefronts of the sky-lit scene: camera rays (closest), their BSDF
    bounce from primary hits, most of which escape (closest), and NEE
    segments from primary hits to one light each (any), env lanes ending at
    2r along the sky direction, outside the scene's bounds. torch.equal, and
    the hit and occluded shares printed."""
    from spcbpt_tpu_torch.config import CULL_BACKFACE, SCENE_EPSILON
    from spcbpt_tpu_torch.ops import brute_trace, bsdf, lights, ray_walk
    from spcbpt_tpu_torch.render.common import camera_rays
    from spcbpt_tpu_torch.scene.scene import local_geometry
    from spcbpt_tpu_torch.utils import rng, vec

    if ts.mode == "brute":
        tris = (ts.tri_p0, ts.tri_e1, ts.tri_e2)
        closest = lambda *r: brute_trace.brute_closest(*r, *tris,
                                                       CULL_BACKFACE)
        closest_plain = lambda *r: brute_trace.brute_closest_plain(
            *r, *tris, CULL_BACKFACE)
        any_hit = lambda *r: brute_trace.brute_any(*r, *tris)
        any_plain = lambda *r: brute_trace.brute_any_plain(*r, *tris)
        names = ("K3 closest", "K3 any")
    else:
        cs = ts.clusters_walk
        closest = lambda *r: ray_walk.walk_closest(cs, *r, CULL_BACKFACE,
                                                   sort_rays=True)
        closest_plain = lambda *r: ray_walk.walk_closest_plain(
            cs, *r, CULL_BACKFACE, sort_rays=True)
        any_hit = lambda *r: ray_walk.walk_any(cs, *r, sort_rays=True)
        any_plain = lambda *r: ray_walk.walk_any_plain(cs, *r,
                                                       sort_rays=True)
        names = ("K1", "K2")

    def closest_equal(label, o, d, tmin, tmax):
        got, ref = closest(o, d, tmin, tmax), closest_plain(o, d, tmin, tmax)
        torch.cuda.synchronize()
        for f in ("tri", "t", "u", "v"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), \
                f"{names[0]} {tag} {label}: {f} differs from the plain version"
        live = tmax >= tmin
        share = (got.tri[live] >= 0).float().mean().item()
        log("sky", f"{tag} {label} wavefront, {int(live.sum())} live lanes: "
                   f"{names[0]} equal to its plain version; hit share "
                   f"{share:.4f}")
        return got

    eye, U, V, W = cam.uvw()
    o, d, state = camera_rays(eye, U, V, W, side, side, 0, device=dev)
    n = o.shape[0]
    tmin = torch.full((n,), SCENE_EPSILON, device=dev)
    hit = closest_equal("camera", o.contiguous(), d, tmin,
                        torch.full((n,), 1e16, device=dev))
    geom = local_geometry(ts, hit, o, d)
    surf = hit.valid & (geom["light_id"] < 0)
    mat = bsdf.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
    nd, state = bsdf.sample_bsdf(mat, geom["Ns"], -d, state)
    closest_equal("bounce", geom["P"].contiguous(), nd.contiguous(), tmin,
                  torch.where(surf, 1e16, -1.0))
    ls, _ = lights.sample_light(ts, state)
    target = torch.where(ls.is_env[..., None],
                         geom["P"] + ls.direction * (2.0 * ts.env.r),
                         ls.position)
    seg = target - geom["P"]
    seg_len = torch.clamp(vec.length(seg), min=1e-8)
    seg_dir = (seg / seg_len[..., None]).contiguous()
    tmax = torch.where(surf, seg_len - SCENE_EPSILON, -1.0)
    P = geom["P"].contiguous()
    occ, occ_p = any_hit(P, seg_dir, tmin, tmax), any_plain(P, seg_dir, tmin,
                                                           tmax)
    torch.cuda.synchronize()
    assert torch.equal(occ, occ_p), \
        f"{names[1]} {tag} env NEE: occlusion differs from the plain version"
    env = surf & ls.is_env
    log("sky", f"{tag} env NEE wavefront, {int(surf.sum())} live lanes "
               f"({env.float().sum().item() / max(int(surf.sum()), 1):.4f} "
               f"to the sky): {names[1]} equal to its plain version; "
               f"occluded share {occ[surf].float().mean().item():.4f} "
               f"(sky lanes {occ[env].float().mean().item():.4f})")


def lvc_vertices(scene_path: str, dev) -> tuple:
    """Valid LVC vertices of one frame (LVC_PATHS light sub-paths of depth
    16, the untrained state) and the share of its origins on the sky."""
    from spcbpt_tpu_torch.render import light_trace
    from spcbpt_tpu_torch.scene.scene import load_trace_scene
    from spcbpt_tpu_torch.train import classify

    ts, _, _ = load_trace_scene(scene_path, dev)
    lv = light_trace.trace_light_paths(ts, classify.untrained_state(dev),
                                       LVC_PATHS, 7919, max_depth=16)
    return int(lv.valid.sum()), float(lv.is_env[0].float().mean())


def phase_sky_cornell(out_dir: str, dev, paths: dict, plain_train: dict,
                      spp: int = 4) -> dict:
    """Sky-lit Cornell through K3 at 512x512 with render_cli: PT, BDPT, and
    SPCBPT trained from the scene at the CLI's defaults (--checkpoint) then
    rendered from it (--resume); the BDPT and SPCBPT means within MEAN_VS_PT
    of PT's; PT with the sky's raster zeroed SKY_ON_OVER_OFF below; the
    training's stage seconds and K3 launches per stage; LVC vertices and
    pretrace acceptance against plain Cornell; CPU vs card; K3 on the env
    wavefronts. Returns the PT render's launches."""
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.scene.scene import load_trace_scene
    from spcbpt_tpu_torch.train import pipeline

    path = paths["cornell_sky"]
    ts, _, cam = load_trace_scene(path, dev)
    cam.aspect = 1.0
    assert ts.mode == "brute" and ts.has_env and ts.num_lights == 2, ts.mode
    log("sky", f"cornell_sky: {ts.num_tris} tris, mode {ts.mode}, "
               f"{ts.num_lights} lights (the sky last), quads' subspace "
               f"base {int(ts.lights.ss_base[0])}, env r {float(ts.env.r):.3f}")
    env_wavefronts_check(ts, cam, dev, "cornell_sky")
    base = ["--scene", path, "--light-paths", str(LVC_PATHS),
            "--light-depth", "16", "--connection-n", "3", "--max-depth", "16"]
    means, launches = {}, {}
    ckpt = os.path.join(out_dir, "cornell_sky_trained.npz")
    per_stage, enter, exit_ = {}, pipeline._Stage.__enter__, \
        pipeline._Stage.__exit__

    def stage_enter(self):
        out = enter(self)
        self.k0 = read_launches()
        return out

    def stage_exit(self, *exc):
        out = exit_(self, *exc)
        k = read_launches()
        per_stage[self.name] = {n: k[n] - self.k0[n] for n in
                                ("brute_closest", "brute_any")}
        return out

    runs = (("pt", ["--scene", path, "--alg", "pt"]),
            ("pt_sky_off", ["--scene", paths["cornell_sky_off"], "--alg",
                            "pt"]),
            ("bdpt", base + ["--alg", "bdpt"]),
            ("spcbpt_train", base + ["--alg", "spcbpt", "--checkpoint",
                                     ckpt]),
            ("spcbpt", base + ["--alg", "spcbpt", "--resume", ckpt]))
    for name, argv in runs:
        if name == "spcbpt_train":
            pipeline._Stage.__enter__ = stage_enter
            pipeline._Stage.__exit__ = stage_exit
        try:
            stats, launches[name] = run_cli(out_dir, f"cornell_sky_{name}",
                                            argv, spp)
        finally:
            pipeline._Stage.__enter__, pipeline._Stage.__exit__ = \
                enter, exit_
        means[name] = stats["mean_radiance"]
        log("sky", f"cornell_sky {name} {stats['width']}x{stats['height']} "
                   f"{spp} spp: {stats['render_seconds'] * 1e3 / spp:.1f} "
                   f"ms/spp, mean {means[name]:.6f}, launches "
                   f"{launches[name]}; {_frames(stats)}")
        k = launches[name]
        assert k["brute_closest"] > 0 and k["brute_any"] > 0, k
        assert k["walk_closest"] == k["walk_any"] == 0, k
        if name == "spcbpt_train":
            tr, sec = stats["train"], stats["phases"]["preprocess"]
            log("sky", "cornell_sky training stages (s): " + ", ".join(
                f"{n} {v:.3f}" for n, v in sec.items()))
            log("sky", "cornell_sky K3 launches per stage: " + ", ".join(
                f"{n} {v['brute_closest']}/{v['brute_any']}"
                for n, v in per_stage.items()) + " (closest/any)")
            acc, acc_plain = (t["n_paths"] / (t["pretrace_launches"]
                                              * TRAIN_LANES)
                              for t in (tr, plain_train))
            log("sky", f"cornell_sky training: {tr['n_paths']} paths in "
                       f"{tr['pretrace_launches']} pretrace launches "
                       f"({acc:.4f} accepted a lane; plain Cornell "
                       f"{plain_train['n_paths']} in "
                       f"{plain_train['pretrace_launches']}, {acc_plain:.4f}"
                       f"); {tr['q_paths']} Q paths in {tr['q_launches']} "
                       f"light traces (plain {plain_train['q_launches']}); "
                       f"second stage '{tr['second_stage']}'")
            assert tr["n_paths"] >= TRAIN_PATHS and tr["q_paths"] >= Q_PATHS
            assert per_stage["pretrace"]["brute_closest"] > 0, per_stage
    for alg in ("bdpt", "spcbpt"):
        rel = abs(means[alg] - means["pt"]) / means["pt"]
        log("sky", f"cornell_sky {alg} mean vs pt: {rel * 100:.3f}% "
                   f"(bound {MEAN_VS_PT * 100:.0f}%)")
        assert rel <= MEAN_VS_PT, (alg, means)
    ratio = means["pt"] / means["pt_sky_off"]
    log("sky", f"cornell_sky pt mean with the sky {means['pt']:.6f}, with "
               f"its raster zeroed {means['pt_sky_off']:.6f}: x{ratio:.4f} "
               f"(at least x{SKY_ON_OVER_OFF})")
    assert ratio >= SKY_ON_OVER_OFF, means
    (n_sky, env_share), (n_plain, _) = (
        lvc_vertices(p, dev) for p in (path, resolve_scene("cornell")))
    log("sky", f"LVC of one frame ({LVC_PATHS} light paths, depth 16): "
               f"{n_sky} vertices on cornell_sky ({env_share:.4f} of the "
               f"paths start on the sky), {n_plain} on plain Cornell "
               f"(x{n_sky / n_plain:.3f})")
    phase_cpu_vs_card(path, tag="cornell_sky ")
    return launches["pt"]


def phase_sky_furnished(out_dir: str, dev, paths: dict) -> dict:
    """The sky-lit furnished scene through K1/K2: the kernels on its env
    wavefronts, PT at 1024x1024 (depth 30, 2^17 pool lanes, 4 spp) and
    SPCBPT at 256x256, 1 spp from a synthetic trained state. Returns the PT
    render's launches."""
    from spcbpt_tpu_torch import checkpoint
    from spcbpt_tpu_torch.scene.scene import load_trace_scene
    from spcbpt_tpu_torch.train import classify

    path = paths["furnished_sky"]
    ts, _, cam = load_trace_scene(path, dev)
    cam.aspect = 1.0
    assert ts.mode == "walk" and ts.has_env and ts.num_tris > 30_000, \
        (ts.mode, ts.num_tris)
    log("sky", f"furnished_sky: {ts.num_tris} tris, "
               f"{ts.clusters_walk.num_clusters} clusters, mode {ts.mode}, "
               f"env r {float(ts.env.r):.3f}")
    env_wavefronts_check(ts, cam, dev, "furnished_sky")
    spp = 4
    stats, launches = run_cli(out_dir, "furnished_sky_pt", [
        "--scene", path, "--alg", "pt", "--dim", "1024x1024", "--max-depth",
        "30"], spp)
    log("sky", f"furnished_sky pt 1024x1024 {spp} spp: "
               f"{stats['render_seconds'] * 1e3 / spp:.1f} ms/spp, "
               f"{stats['samples_per_second'] / 1e6:.3f} Mpaths/s, mean "
               f"{stats['mean_radiance']:.6f}, launches {launches}")
    assert launches["walk_closest"] > 0 and launches["walk_any"] > 0, launches
    state_path = os.path.join(out_dir, "furnished_sky_state.npz")
    checkpoint.save_subspace_state(state_path,
                                   classify.synthetic_trained_state(ts, 0))
    sp_stats, sp_launches = run_cli(out_dir, "furnished_sky_spcbpt", [
        "--scene", path, "--alg", "spcbpt", "--resume", state_path, "--dim",
        "256x256"], 1)
    log("sky", f"furnished_sky spcbpt 256x256 1 spp: "
               f"{sp_stats['render_seconds'] * 1e3:.1f} ms, mean "
               f"{sp_stats['mean_radiance']:.6f}, launches {sp_launches}; "
               f"{_frames(sp_stats)}")
    assert sp_launches["walk_closest"] > 0 and sp_launches["walk_any"] > 0
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.ops import bvh
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = phase_environment()
    first_forms = phase_build()
    out_dir = os.path.join(REPO, "smoke_out")

    scene_path = resolve_scene("interior")
    ts, _, cam = load_trace_scene(scene_path, dev)
    cam.aspect = 1.0
    log("scene", f"interior: {ts.num_tris} tris, "
                 f"{ts.clusters_walk.num_clusters} clusters, mode {ts.mode}, "
                 f"BVH {bvh.BUILD_ROUTE}")
    assert ts.mode == "walk"
    waves = wavefronts(ts, cam, dev)
    numbers = phase_kernels(ts, waves, dev)
    cts, _, ccam = load_trace_scene(resolve_scene("cornell"), dev)
    ccam.aspect = 1.0
    log("scene", f"cornell: {cts.num_tris} tris, mode {cts.mode}")
    numbers.update(phase_brute(cts, ccam, ts, cam, dev))
    t0 = time.perf_counter()
    tts, _, _ = load_trace_scene(scene_path, dev, mode="tile")
    log("scene", f"interior in tile mode: {tts.clusters.num_clusters} "
                 f"clusters of at most {tts.clusters.tri_k} triangles "
                 f"({time.perf_counter() - t0:.1f} s)")
    waves = waves + (connection_wavefront(ts, cam, dev),)
    numbers.update(phase_tile_kernels(tts, ts, waves, dev, first_forms))
    numbers.update(phase_list_walk(tts, ts, waves, dev))
    list_launches = phase_profiler()
    launches, walk_stats = phase_main_path(out_dir)
    brute_launches, state_path, pt_mean = phase_cornell(out_dir, dev)
    trained_path, plain_train, centroid_ms = phase_train(out_dir, dev,
                                                         pt_mean)
    phase_nn(out_dir, dev, pt_mean, centroid_ms)
    launches.update({k: brute_launches[k]
                     for k in ("brute_closest", "brute_any")})
    cove_stats, cove_state = phase_cove(out_dir, dev)
    tile_launches = phase_tile_main(tts, cam, walk_stats)
    launches.update({k: tile_launches[k] for k in
                     ("tile_round_walk", "tile_round", "tile_walk_closest",
                      "tile_walk_any")})
    phase_tile_cove(out_dir, dev, cove_state, cove_stats)
    launches.update(list_launches)
    phase_cpu_vs_card(scene_path)
    phase_cpu_vs_card_spcbpt(state_path)
    phase_tile_cpu_vs_card(out_dir)
    phase_cpu_vs_card_pretrace()
    phase_benchmark(out_dir, trained_path)
    phase_multichip(out_dir, dev, trained_path, pt_mean)
    sky_paths = write_sky_scenes(out_dir)
    phase_sky_cornell(out_dir, dev, sky_paths, plain_train)
    phase_sky_furnished(out_dir, dev, sky_paths)
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")

    sources = {"walk_closest": "ray_walk.cu", "walk_any": "ray_walk.cu",
               "brute_closest": "brute_trace.cu",
               "brute_any": "brute_trace.cu",
               "tile_round_walk": "tile_walk.cu", "tile_round": "tile_walk.cu",
               "tile_walk_closest": "tile_walk.cu",
               "tile_walk_any": "tile_walk.cu",
               "list_walk_closest": "list_walk.cu",
               "list_walk_closest_stream": "list_walk.cu",
               "list_walk_any": "list_walk.cu",
               "list_walk_any_stream": "list_walk.cu"}
    replaces = {"walk_closest": "spcbpt_tpu/ops/ray_walk.py:144",
                "walk_any": "spcbpt_tpu/ops/ray_walk.py:197",
                "brute_closest": "spcbpt_tpu/ops/pallas_trace.py:28",
                "brute_any": "spcbpt_tpu/ops/pallas_trace.py:108",
                "tile_round_walk": "spcbpt_tpu/ops/pallas_tile.py:416",
                "tile_round": "spcbpt_tpu/ops/pallas_tile.py:416",
                "tile_walk_closest": "spcbpt_tpu/ops/pallas_tile.py:163",
                "tile_walk_any": "spcbpt_tpu/ops/pallas_tile.py:236",
                "list_walk_closest": "spcbpt_tpu/ops/pallas_walk.py:156",
                "list_walk_closest_stream": "spcbpt_tpu/ops/pallas_walk.py:97",
                "list_walk_any": "spcbpt_tpu/ops/pallas_walk.py:207",
                "list_walk_any_stream": "spcbpt_tpu/ops/pallas_walk.py:235"}
    kernels = [dict(name=k, route="cuda",
                    source=f"spcbpt_tpu_torch/csrc/{sources[k]}",
                    replaces=replaces[k], launches=launches[k], **numbers[k])
               for k in sources]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
