#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spcbpt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero:
  1. environment: torch, CUDA, nvcc release, card name and power limit;
  2. build: the CUDA kernels of csrc/ (one nvcc per source, all started
     together), through the package's own loader;
  3. kernels vs plain: the row-walk kernels K1 (closest hit) and K2 (any
     hit) against their plain torch versions on the card, on the
     32,576-triangle interior, for a 512x512 camera wavefront and a 2^17-ray
     incoherent bounce wavefront with a quarter of its lanes dead, and
     against brute force on a 4096-ray subset; times per call;
  4. K3 vs plain: the brute-force kernel (closest and any hit) against its
     plain torch version on the 32-triangle Cornell box, for a 512x512
     camera wavefront, a 2^17-ray bounce wavefront with a quarter of its
     lanes dead and a 3 x 2^16-ray connection-shaped segment wavefront with
     masked lanes, both cull settings; times per call;
  5. main path, PT on the interior: `render_cli --scene interior --alg pt
     --dim 1024x1024 --spp 4` through K1/K2;
  6. main path, Cornell through K3: a synthetic trained subspace state
     saved with the port's checkpoint, then `render_cli --scene cornell`
     at 512x512, 4 spp with `--alg spcbpt --resume`, `--alg bdpt` (100,000
     light paths per frame, light and eye depth 16, 3 connections) and
     `--alg pt`; the BDPT and SPCBPT means within MEAN_VS_PT of PT's;
  7. SPCBPT on interior_cove at 256x256, 1 spp, through K1/K2 (the walk
     under the masked connection wavefront);
  8. CPU vs card: the same 64x64 render on both, PT (2 spp, interior) and
     SPCBPT (1 spp, Cornell, 10,000 light paths, the saved state).
Each render phase sets every launch counter to 0 just before its
render_cli call and reads them just after; its PNG, HDR and stats go to
smoke_out/. The last three lines are the card as nvidia-smi names it, one
JSON object with each kernel's numbers, and {"ok": true, "device": {...}}.
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
# CPU vs card, SPCBPT 64x64 1 spp: the two devices trace the same seeds,
# but transcendental ulps, atomic sums and label ties let some paths part;
# the mean must agree within 1%.
SPCBPT_CPU_CARD = 0.01
KERNEL_SOURCES = ("ray_walk", "brute_trace")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}, nvcc "
               f"{release.group(1) if release else 'unknown'}, "
               f"{torch.cuda.device_count()} card(s)")
    log("env", f"nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    from spcbpt_tpu_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(build.build, KERNEL_SOURCES))
    infos = {name: dict(build.BUILD_LOG[name]) for name in KERNEL_SOURCES}
    for name in KERNEL_SOURCES:
        build.load(name)
        info = infos[name]
        log("build", f"csrc/{name}.cu -> sm_90a in {info['seconds']:.2f} s "
                     f"(cached={info['cached']})")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("build", "ptxas: " + line.strip())
    log("build", f"all kernels ready in {time.perf_counter() - t0:.2f} s")


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


def wavefronts(ts, cam, dev):
    """(name, origins, dirs, tmax) of the camera and bounce wavefronts."""
    from spcbpt_tpu_torch.ops import bsdf
    from spcbpt_tpu_torch.render.common import camera_rays
    from spcbpt_tpu_torch.scene.scene import local_geometry, trace_closest
    from spcbpt_tpu_torch.utils import rng

    eye, U, V, W = cam.uvw()
    n_cam = CAMERA_DIM * CAMERA_DIM
    o, d, _ = camera_rays(eye, U, V, W, CAMERA_DIM, CAMERA_DIM, 0, block=32,
                          device=dev)
    camera = ("camera512", o.contiguous(), d, torch.full((n_cam,), 1e16,
                                                         device=dev))
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


def phase_kernels(ts, cam, dev):
    from spcbpt_tpu_torch.kernels import ray_walk as kernels
    from spcbpt_tpu_torch.ops import intersect, ray_walk

    cs = ts.clusters_walk
    camera, bounce = wavefronts(ts, cam, dev)
    results = {}
    for name, o, d, tmax in (camera, bounce):
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

        # times: the row walk alone (kernel vs plain) on the prepared rays,
        # and the stages around it
        po, pd, ptmn, ptmx, row_e, _, _ = ray_walk.prepare(
            cs, o, d, tmin, tmax, True)
        pseg, row_e_seg = ray_walk.prepare(cs, o, d, tmin, tseg, True)[3:5]
        k1 = cuda_ms(lambda: kernels.closest(po, pd, ptmn, ptmx, row_e,
                                             cs.tri_begin, cs.tri_slots,
                                             False), 20)
        k2 = cuda_ms(lambda: kernels.any_hit(po, pd, ptmn, pseg, row_e_seg,
                                             cs.tri_slots), 20)
        p1 = cuda_ms(lambda: ray_walk.closest_rows_plain(
            cs, po, pd, ptmn, ptmx, row_e, False), 2)
        p2 = cuda_ms(lambda: ray_walk.any_rows_plain(
            cs, po, pd, ptmn, pseg, row_e_seg), 2)
        re_ms = cuda_ms(lambda: ray_walk.row_entries(cs.cmin, cs.cmax, po, pd,
                                                     ptmn, ptmx), 10)
        wrap_ms = cuda_ms(lambda: ray_walk.walk_closest(
            cs, o, d, tmin, tmax, False, sort_rays=True), 10)
        mr = lambda ms: n / ms / 1e3
        log("kernels", f"{name} ({n} rays): K1 {k1:.3f} ms ({mr(k1):.1f} "
                       f"Mrays/s) plain {p1:.3f} ms ({mr(p1):.2f} Mrays/s); "
                       f"K2 {k2:.3f} ms ({mr(k2):.1f} Mrays/s) plain "
                       f"{p2:.3f} ms ({mr(p2):.2f} Mrays/s); row_entries "
                       f"{re_ms:.3f} ms; walk_closest wrapper (sort + "
                       f"row_entries + K1 + unsort) {wrap_ms:.3f} ms")
        if name.startswith("bounce"):
            results["walk_closest"].update(ms=k1, plain_ms=p1)
            results["walk_any"].update(ms=k2, plain_ms=p2)
    return results


def reset_launches() -> None:
    from spcbpt_tpu_torch.kernels import brute_trace, ray_walk
    ray_walk.reset_launches()
    brute_trace.reset_launches()


def read_launches() -> dict:
    from spcbpt_tpu_torch.kernels import brute_trace, ray_walk
    return {**ray_walk.LAUNCHES, **brute_trace.LAUNCHES}


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
                    spp: int = 4) -> dict:
    """PT on the interior through K1/K2."""
    stats, launches = run_cli(out_dir, "interior", [
        "--scene", "interior", "--alg", "pt", "--dim", f"{dim}x{dim}",
        "--device", device], spp)
    ms_spp = stats["render_seconds"] * 1e3 / spp
    log("main", f"interior {dim}x{dim} pt {spp} spp: {ms_spp:.1f} ms/spp, "
                f"{stats['samples_per_second'] / 1e6:.3f} Mpaths/s, mean "
                f"radiance {stats['mean_radiance']:.6f}, launches {launches}")
    assert launches["walk_closest"] > 0 and launches["walk_any"] > 0, launches
    return launches


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
    return launches["spcbpt"], state_path


def phase_cove(out_dir: str, dev) -> None:
    """SPCBPT through K1/K2 on interior_cove with a synthetic state."""
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


def phase_brute(ts, cam, dev) -> dict:
    """K3 against its plain version on Cornell's wavefronts."""
    from spcbpt_tpu_torch.kernels import brute_trace as kernels
    from spcbpt_tpu_torch.ops import brute_trace

    tris = (ts.tri_p0, ts.tri_e1, ts.tri_e2)
    camera, bounce = wavefronts(ts, cam, dev)
    results = {}
    for name, o, d, tmax in (camera, bounce,
                             connection_wavefront(ts, cam, dev)):
        n = o.shape[0]
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
            if name.startswith("bounce") and not cull:
                results["brute_closest"] = dict(max_abs_err=err_t)
        # any hit: the connection wavefront has its own segments; the others
        # end at 0.5-1.5x the closest hit (10 on a miss), so about half of
        # the hit lanes are occluded (dead lanes stay dead)
        if name.startswith("connection"):
            tseg = tmax
        else:
            rs = np.random.RandomState(1)
            scale = torch.from_numpy(rs.uniform(0.5, 1.5, n).astype(np.float32))
            t_hit = torch.where(ref.tri >= 0, ref.t, 10.0)
            tseg = torch.where(tmax < 0, -1.0, t_hit * scale.to(dev))
        occ_k = brute_trace.brute_any(o, d, tmin, tseg, *tris)
        occ_p = brute_trace.brute_any_plain(o, d, tmin, tseg, *tris)
        torch.cuda.synchronize()
        assert torch.equal(occ_k, occ_p), \
            f"K3 any {name}: occlusion differs from the plain version"
        log("brute", f"K3 any {name}: occlusion agreement 1.000000 "
                     f"(occluded {occ_k.float().mean().item():.4f})")
        if name.startswith("connection"):
            results["brute_any"] = dict(
                max_abs_err=(occ_k.int() - occ_p.int()).abs().max().item())

        k1 = cuda_ms(lambda: kernels.closest(o, d, tmin, tmax, *tris, False),
                     20)
        k2 = cuda_ms(lambda: kernels.any_hit(o, d, tmin, tseg, *tris), 20)
        p1 = cuda_ms(lambda: brute_trace.brute_closest_plain(
            o, d, tmin, tmax, *tris, False), 5)
        p2 = cuda_ms(lambda: brute_trace.brute_any_plain(
            o, d, tmin, tseg, *tris), 5)
        mr = lambda ms: n / ms / 1e3
        log("brute", f"{name} ({n} rays, {ts.num_tris} tris): K3 closest "
                     f"{k1:.4f} ms ({mr(k1):.1f} Mrays/s) plain {p1:.4f} ms; "
                     f"K3 any {k2:.4f} ms ({mr(k2):.1f} Mrays/s) plain "
                     f"{p2:.4f} ms")
        if name.startswith("bounce"):
            results["brute_closest"].update(ms=k1, plain_ms=p1)
        if name.startswith("connection"):
            results["brute_any"].update(ms=k2, plain_ms=p2)
    return results


def phase_cpu_vs_card(scene_path: str, devices=("cpu", "cuda")) -> None:
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
    log("cpu-vs-card", f"64x64 2 spp: cpu {ta:.1f} s, card {tb:.1f} s; mean "
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    out_dir = os.path.join(REPO, "smoke_out")

    scene_path = resolve_scene("interior")
    ts, _, cam = load_trace_scene(scene_path, dev)
    cam.aspect = 1.0
    log("scene", f"interior: {ts.num_tris} tris, "
                 f"{ts.clusters_walk.num_clusters} clusters, mode {ts.mode}")
    assert ts.mode == "walk"
    numbers = phase_kernels(ts, cam, dev)
    cts, _, ccam = load_trace_scene(resolve_scene("cornell"), dev)
    ccam.aspect = 1.0
    log("scene", f"cornell: {cts.num_tris} tris, mode {cts.mode}")
    numbers.update(phase_brute(cts, ccam, dev))
    launches = phase_main_path(out_dir)
    brute_launches, state_path = phase_cornell(out_dir, dev)
    launches.update({k: brute_launches[k]
                     for k in ("brute_closest", "brute_any")})
    phase_cove(out_dir, dev)
    phase_cpu_vs_card(scene_path)
    phase_cpu_vs_card_spcbpt(state_path)
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")

    sources = {"walk_closest": "ray_walk.cu", "walk_any": "ray_walk.cu",
               "brute_closest": "brute_trace.cu",
               "brute_any": "brute_trace.cu"}
    replaces = {"walk_closest": "spcbpt_tpu/ops/ray_walk.py:144",
                "walk_any": "spcbpt_tpu/ops/ray_walk.py:197",
                "brute_closest": "spcbpt_tpu/ops/pallas_trace.py:28",
                "brute_any": "spcbpt_tpu/ops/pallas_trace.py:108"}
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
