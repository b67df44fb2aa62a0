"""The plain reference: a frozen copy of the program's plain PyTorch code
for the scenes and estimators the benchmark renders, traced by brute force.
It imports nothing of spcbpt_tpu_torch, spcbpt_tpu or jax."""
