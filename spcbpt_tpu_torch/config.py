"""Global constants and run configs.

The port's own copy of spcbpt_tpu/config.py (the port imports nothing of
the JAX package); tests/test_torch_host_modules.py keeps the two equal.
Constant values follow the reference knobs (reference:
src/OptiXPathTracer/optixPathTracer.h:31-39) so renders are comparable; they
are plain module constants here plus a dataclass config instead of compile-time
#defines.
"""
from __future__ import annotations

import dataclasses

# Subspace counts (reference optixPathTracer.h:31-32)
NUM_SUBSPACE = 1000
NUM_SUBSPACE_LIGHTSOURCE = int(0.2 * NUM_SUBSPACE)  # 200, reserved for emitter/env bins

# Russian roulette floor (reference optixPathTracer.h:35)
MIN_RR_RATE = 0.3
# Uniform mixture rate applied to Gamma before CMF build (reference :36)
CONSERVATIVE_RATE = 0.2
# Light-vertex connections per eye vertex (reference :37)
CONNECTION_N = 3
# Connection records per pretraced path (reference :39 PRETRACE_CONN_PADDING)
PRETRACE_CONN_PADDING = 10

# Depth caps (reference raygen.cu:144 for PT, :361/:668 for subpaths)
PT_MAX_DEPTH = 30
SUBPATH_MAX_DEPTH = 50

# Transport-ray backface culling. The reference culls backfaces on radiance
# rays but NOT on occlusion rays (cuProg.h:402/427/452 set
# OPTIX_RAY_FLAG_CULL_BACK_FACING_TRIANGLES; :478/:526 do not) — a
# one-sided-surface world where eye/light tracing and connections sample
# DIFFERENT path supports. On scenes with thin sheets or smooth normals this
# makes BDPT/SPCBPT converge to a different image than PT (measured +19%/+50%
# mean on the cove interior). We deliberately diverge (SURVEY.md "quirks not
# to replicate"): all transport rays are two-sided, matching the occlusion
# convention, so every estimator integrates the same path space (backface
# configurations are consistent absorbers — eval_bsdf is zero there).
CULL_BACKFACE = False

# Numerical guards
SCENE_EPSILON = 1e-3  # reference whitted.h SCENE_EPSILON equivalent
# estimator clamp: reference raygen.cu:43 ISINVALIDVALUE rejects >1e5 or nan
INVALID_CLAMP = 1e5

# Tonemap "limit" used by the reference display path (raygen.cu:50-58)
TONEMAP_LIMIT = 1.5


@dataclasses.dataclass
class LightTraceConfig:
    """Light sub-path tracing shape (reference optixPathTracer.cpp:462-467)."""
    num_core: int = 1000          # independent light-path streams
    paths_per_core: int = 100     # M_per_core
    max_depth: int = SUBPATH_MAX_DEPTH

    @property
    def num_paths(self) -> int:
        return self.num_core * self.paths_per_core


@dataclasses.dataclass
class PretraceConfig:
    """Training-data tracer shape (reference optixPathTracer.cpp:479-490)."""
    num_core: int = 10000
    padding: int = PRETRACE_CONN_PADDING
    max_depth: int = PRETRACE_CONN_PADDING  # eye prefix cap == conn padding
    target_samples: int = 2_000_000
    target_q_samples: int = 2_000_000


@dataclasses.dataclass
class GammaTrainConfig:
    """Gamma matrix trainer (reference device_thrust.cu:3327-3344, :1516)."""
    lr: float = 0.01
    batch_size: int = 20000
    epochs: int = 1
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    loss_clamp: float = 1e6   # optimal_E_loss_threshold analogue


@dataclasses.dataclass
class RenderConfig:
    width: int = 512
    height: int = 512
    max_depth: int = PT_MAX_DEPTH
    rr_start_depth: int = 0
    connection_n: int = CONNECTION_N
