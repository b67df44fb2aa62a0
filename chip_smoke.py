#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spcbpt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero:
  1. environment: torch, CUDA, nvcc release, card name and power limit;
  2. build: the CUDA kernels of csrc/, through the package's own loader;
  3. kernels vs plain: the row-walk kernels K1 (closest hit) and K2 (any
     hit) against their plain torch versions on the card, on the
     32,576-triangle interior, for a 512x512 camera wavefront and a 2^17-ray
     incoherent bounce wavefront with a quarter of its lanes dead, and
     against brute force on a 4096-ray subset; times per call;
  4. main path: `render_cli --scene interior --alg pt --dim 1024x1024
     --spp 4` with the kernels' launch counters reset just before it (its
     PNG, HDR and stats go to smoke_out/);
  5. CPU vs card: the same 64x64, 2 spp render through the plain walk on
     the CPU and through the kernels on the card.
The last three lines are the card as nvidia-smi names it, one JSON object
with each kernel's numbers, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

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
    build.load("ray_walk")
    info = build.BUILD_LOG["ray_walk"]
    log("build", f"csrc/ray_walk.cu -> sm_90a in "
                 f"{time.perf_counter() - t0:.2f} s "
                 f"(cached={info['cached']})")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())


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


def phase_main_path(out_dir: str, device: str = "cuda", dim: int = 1024,
                    spp: int = 4) -> dict:
    from spcbpt_tpu_torch.apps import render_cli
    from spcbpt_tpu_torch.kernels import ray_walk as kernels

    os.makedirs(out_dir, exist_ok=True)
    png, npz, stats_path = (os.path.join(out_dir, f) for f in
                            ("interior.png", "interior.npz", "stats.json"))
    argv = ["--scene", "interior", "--alg", "pt", "--dim", f"{dim}x{dim}",
            "--spp", str(spp), "--device", device, "--out", png,
            "--hdr-out", npz, "--stats-json", stats_path]
    kernels.reset_launches()
    assert render_cli.main(argv) == 0
    launches = dict(kernels.LAUNCHES)
    with open(stats_path) as f:
        stats = json.load(f)
    hdr = np.load(npz)["radiance"]
    ms_spp = stats["render_seconds"] * 1e3 / spp
    log("main", f"interior {dim}x{dim} pt {spp} spp: {ms_spp:.1f} ms/spp, "
                f"{stats['samples_per_second'] / 1e6:.3f} Mpaths/s, mean "
                f"radiance {stats['mean_radiance']:.6f}, launches {launches}")
    assert hdr.shape == (dim, dim, 3) and np.isfinite(hdr).all()
    assert stats["finite"] and stats["mean_radiance"] > 0
    assert stats["count_min"] == stats["count_max"] == spp, stats
    assert all(v > 0 for v in launches.values()), launches
    assert os.path.getsize(png) > 0
    return launches


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

    scene_path = resolve_scene("interior")
    ts, _, cam = load_trace_scene(scene_path, dev)
    cam.aspect = 1.0
    log("scene", f"interior: {ts.num_tris} tris, "
                 f"{ts.clusters_walk.num_clusters} clusters, mode {ts.mode}")
    assert ts.mode == "walk"
    numbers = phase_kernels(ts, cam, dev)
    launches = phase_main_path(os.path.join(REPO, "smoke_out"))
    phase_cpu_vs_card(scene_path)
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")

    source = "spcbpt_tpu_torch/csrc/ray_walk.cu"
    replaces = {"walk_closest": "spcbpt_tpu/ops/ray_walk.py:144",
                "walk_any": "spcbpt_tpu/ops/ray_walk.py:197"}
    kernels = [dict(name=k, route="cuda", source=source, replaces=replaces[k],
                    launches=launches[k], **numbers[k])
               for k in ("walk_closest", "walk_any")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
