"""End-to-end SPCBPT preprocessing: the "training phase" of the renderer.

Port of spcbpt_tpu/train/pipeline.py, mirroring the reference's
preprocessing() (optixPathTracer.cpp:552-608):
  1. pretrace NEE paths until target_samples accepted paths exist
  2. spatially reweight contributions (10x10 pixel blocks)
  3. build eye (1000-label) and light (800-label) classifiers from weighted
     connection endpoints
  4. label every connection record
  5. estimate Q from light-trace launches until target_q_samples paths
  6. initialize Gamma from contribution integrals, train with Adam
  7. publish Q + CMFGamma in a trained SubspaceState
  8. optionally (nn_train, --classifier nn) train the close-set network
     against the conservative-mixed Gamma (train/nn_classifier.py)

`preprocess` runs stage 1 on the scene's device and keeps the accepted rows
of each launch as numpy arrays on the host; `fit_from_corpus` runs stages
2-8 on such a corpus, so a corpus traced elsewhere (the JAX package's) can
be fitted too.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import CONSERVATIVE_RATE, NUM_SUBSPACE, PretraceConfig
from ..render import light_trace
from ..render.autotune import select_second_stage
from ..scene.scene import TraceScene
from . import classify, gamma_train, nn_classifier, pretrace, qgamma

MAX_PRETRACE_LAUNCHES = 20_000
MAX_Q_LAUNCHES = 200
Q_FRAME_OFFSET = 7777
LABEL_CHUNK = 1 << 18
NN_SEED = 12345


@dataclasses.dataclass
class PreprocessStats:
    n_paths: int = 0
    n_conns: int = 0
    q_paths: int = 0
    gamma_losses: list = dataclasses.field(default_factory=list)
    nn_losses: list = dataclasses.field(default_factory=list)
    seconds: dict = dataclasses.field(default_factory=dict)
    pretrace_launches: int = 0
    q_launches: int = 0
    second_stage: str = ""
    flux_dr: float = float("nan")


class _Stage:
    """Wall seconds of one stage into stats.seconds[name], the device
    synchronised at both ends."""

    def __init__(self, stats, name, device):
        self.stats, self.name, self.device = stats, name, torch.device(device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self._sync()
        self.stats.seconds[self.name] = time.perf_counter() - self.t0


def pretrace_corpus(ts: TraceScene, cam_uvw, cfg: PretraceConfig,
                    stats: PreprocessStats | None = None,
                    verbose: bool = False) -> pretrace.PretraceBatch:
    """Stage 1: pretrace launches (frames 0, 1, ...) until target_samples
    accepted paths or MAX_PRETRACE_LAUNCHES; each launch cut down on the
    host to its accepted rows. Returns the corpus as numpy arrays."""
    launch = pretrace.make_pretracer(cam_uvw, cfg.num_core, cfg.padding)
    batches = []
    total = frame = 0
    while total < cfg.target_samples and frame < MAX_PRETRACE_LAUNCHES:
        b = pretrace.to_host(launch(ts, frame))
        frame += 1
        keep = b.valid
        if keep.any():
            batches.append(pretrace.PretraceBatch(*[f[keep] for f in b]))
            total += int(keep.sum())
        if verbose and frame % 20 == 0:
            print(f"pretrace: {total}/{cfg.target_samples} paths "
                  f"({frame} launches)", flush=True)
    if stats is not None:
        stats.pretrace_launches = frame
    if not batches:
        raise RuntimeError(f"pretrace accepted no path in {frame} launches")
    return pretrace.PretraceBatch(*[np.concatenate(xs)
                                    for xs in zip(*batches)])


def label_chunked(c: classify.Classifier, p: np.ndarray, n: np.ndarray,
                  chunk: int = LABEL_CHUNK) -> np.ndarray:
    """classify() over (M, 3) host arrays in chunks of `chunk` rows: the
    (rows, labels) score matrix of one call would not fit at the
    reference's corpus size."""
    dev = c.centers_pos.device
    outs = []
    for i in range(0, len(p), chunk):
        pc = torch.as_tensor(p[i:i + chunk], device=dev)
        nc = torch.as_tensor(n[i:i + chunk], device=dev)
        outs.append(classify.classify(c, pc, nc).cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros((0,), np.int32)


def fit_from_corpus(ts: TraceScene, data: pretrace.PretraceBatch,
                    width: int, height: int,
                    cfg: PretraceConfig | None = None,
                    lt_paths: int = 100_000, lt_depth: int = 8,
                    gamma_cfg=None, nn_train: bool = False,
                    verbose: bool = False,
                    stats: PreprocessStats | None = None):
    """Stages 2-8 on a corpus of numpy arrays (a PretraceBatch of accepted
    rows). Returns (SubspaceState with trained=True, PreprocessStats)."""
    cfg = cfg or PretraceConfig()
    stats = stats or PreprocessStats()
    dev = ts.device
    stats.n_paths = int(len(data.valid))
    stats.n_conns = int(data.conn_valid.sum())
    t = lambda x: torch.as_tensor(x, device=dev)

    # --- 2. reweight ---
    with _Stage(stats, "reweight", dev):
        contri = qgamma.sample_reweight(
            t(data.contri), t(data.sample_pdf), t(data.pixel), width,
            height).cpu().numpy()
    data = data._replace(contri=contri)

    # --- 3. classifiers ---
    with _Stage(stats, "trees", dev):
        w_path = (contri[:, 0] + contri[:, 1] + contri[:, 2]) \
            / np.maximum(data.sample_pdf, 1e-30)
        w_path = np.where(np.isfinite(w_path) & data.valid, w_path, 0.0)
        cv = data.conn_valid
        w_conn = np.broadcast_to(w_path[:, None], cv.shape)[cv]
        eye_cls = classify.build_classifier(
            data.a_position[cv], data.a_normal[cv], w_conn, NUM_SUBSPACE,
            device=dev)
        light_mask = cv & ~data.light_source
        w_light = np.broadcast_to(w_path[:, None], cv.shape)[light_mask]
        light_cls = classify.build_classifier(
            data.b_position[light_mask], data.b_normal[light_mask], w_light,
            classify.NUM_LIGHT_TREE_SUBSPACE, device=dev)

    # --- 4. label connections (node_label device_thrust.cu:569-573) ---
    with _Stage(stats, "labels", dev):
        label_a = label_chunked(eye_cls, data.a_position.reshape(-1, 3),
                                data.a_normal.reshape(-1, 3)
                                ).reshape(cv.shape)
        bl = label_chunked(light_cls, data.b_position.reshape(-1, 3),
                           data.b_normal.reshape(-1, 3))
        label_b = np.where(data.light_source, data.label_b,
                           bl.reshape(cv.shape))

    # --- 5. Q ---
    with _Stage(stats, "q", dev):
        # temporary state: trees trained so light vertices get labeled
        ss_trees = classify.SubspaceState(
            eye=eye_cls, light=light_cls,
            q=torch.ones((NUM_SUBSPACE,), device=dev),
            cmf_gamma=classify.untrained_state(dev).cmf_gamma, trained=True)
        q_mean = torch.zeros((NUM_SUBSPACE,), device=dev)
        occ_total = torch.zeros((NUM_SUBSPACE,), device=dev)
        acc_paths = torch.zeros((), dtype=torch.int32, device=dev)
        f = 0
        while int(acc_paths) < cfg.target_q_samples and f < MAX_Q_LAUNCHES:
            lv = light_trace.trace_light_paths(
                ts, ss_trees, lt_paths, f + Q_FRAME_OFFSET,
                max_depth=lt_depth)
            qs, oc, pc = qgamma.q_batch(lv)
            q_mean, acc_paths = qgamma.q_update(q_mean, acc_paths, qs, pc)
            occ_total = occ_total + oc
            f += 1
        q = qgamma.q_finalize(q_mean)
        inv_occ = qgamma.inv_occ_finalize(occ_total, acc_paths)
    stats.q_paths = int(acc_paths)
    stats.q_launches = f

    # --- 6. Gamma init + train ---
    with _Stage(stats, "gamma", dev):
        batch = pretrace.PretraceBatch(*[t(x) for x in data])
        la, lb = t(label_a), t(label_b)
        g0 = qgamma.gamma_init(la, lb, batch.conn_valid, batch.contri,
                               batch.sample_pdf)
        td = gamma_train.clamp_outliers(
            gamma_train.build_train_data(batch, q, la, lb))
        gcfg = gamma_cfg or {}
        gamma, losses = gamma_train.train_gamma(
            g0, td, lr=gcfg.get("lr", 0.01),
            batch_size=gcfg.get("batch_size", 20000),
            epochs=gcfg.get("epochs", 1), log_every=50 if verbose else 0)
    stats.gamma_losses = losses

    # --- 7. publish ---
    with _Stage(stats, "publish", dev):
        mixed = gamma.cpu().numpy() * (1.0 - CONSERVATIVE_RATE) \
            + CONSERVATIVE_RATE / NUM_SUBSPACE
        aprob, aidx = classify.build_alias(mixed)
        second, sel_stats = select_second_stage(q.cpu().numpy(),
                                                inv_occ.cpu().numpy())
        ss = classify.publish_tables(classify.SubspaceState(
            eye=eye_cls, light=light_cls, q=q,
            cmf_gamma=qgamma.gamma_to_cmf(gamma),
            alias_prob=t(aprob), alias_idx=t(aidx).to(torch.int32),
            inv_occ=inv_occ, trained=True, second_stage=second))
    stats.second_stage = second
    stats.flux_dr = sel_stats["flux_dr"]
    if verbose:
        print(f"[train] second stage '{second}' "
              f"(flux DR {sel_stats['flux_dr']:.2f})", flush=True)

    # --- 8. optional close-set refinement network (C21) ---
    if nn_train:
        with _Stage(stats, "nn", dev):
            # scene AABB over all three triangle vertices, as in JAX
            verts = torch.cat([ts.tri_p0, ts.tri_p0 + ts.tri_e1,
                               ts.tri_p0 + ts.tri_e2])
            nn_state = nn_classifier.init_params(
                np.random.default_rng(NN_SEED), mixed, device=dev)
            nn_tables, stats.nn_losses = nn_classifier.train_from_corpus(
                nn_state, mixed, td, data.a_position, data.a_normal,
                label_a, label_b, torch.amin(verts, dim=0),
                torch.amax(verts, dim=0))
            ss = ss.replace(nn=nn_tables)
        if verbose and stats.nn_losses:
            print(f"[train] nn close-set refinement: loss "
                  f"{stats.nn_losses[0]:.4g} -> {stats.nn_losses[-1]:.4g} "
                  f"({len(stats.nn_losses)} steps)", flush=True)
    return ss, stats


def preprocess(ts: TraceScene, cam_uvw, width: int, height: int,
               cfg: PretraceConfig | None = None,
               lt_paths: int = 100_000, lt_depth: int = 8,
               gamma_cfg=None, nn_train: bool = False,
               verbose: bool = False):
    """Returns (SubspaceState with trained=True, PreprocessStats)."""
    cfg = cfg or PretraceConfig()
    stats = PreprocessStats()
    t_all = time.perf_counter()
    with _Stage(stats, "pretrace", ts.device):
        data = pretrace_corpus(ts, cam_uvw, cfg, stats, verbose)
    ss, stats = fit_from_corpus(ts, data, width, height, cfg, lt_paths,
                                lt_depth, gamma_cfg, nn_train=nn_train,
                                verbose=verbose, stats=stats)
    stats.seconds["total"] = time.perf_counter() - t_all
    return ss, stats
