"""Multi-device rendering and training over torch.distributed (tile.py),
the per-host rank launcher (launch.py) and the multi-device dry run
(dryrun.py)."""
