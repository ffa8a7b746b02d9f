"""Data parallelism over torch.distributed (parallel/mesh.py) and its dry
run (parallel/dryrun.py)."""
