"""spcbpt_tpu_torch — the SPCBPT renderer in PyTorch for NVIDIA Hopper.

A port of `spcbpt_tpu` (JAX/Pallas) module by module: each ported module keeps
the file name and public functions of its JAX counterpart, plain tensor code
is PyTorch, and the Pallas kernels on the render path are CUDA C++ kernels
written for sm_90a (`csrc/`, built at first use by `kernels/`). The package
imports torch and numpy and nothing of `spcbpt_tpu`: it keeps its own copies
of that package's host modules (config, scene parsing and generation, BVH
build, native loader), which the tests hold equal to theirs.
"""

__version__ = "0.1.0"
