"""PyTorch + CUDA port of flow_supervisor_tpu (RAFT inference forward and the
flow-supervisor train step on NVIDIA Hopper)."""
