"""The benchmark of spcbpt_tpu_torch: see README.md."""
