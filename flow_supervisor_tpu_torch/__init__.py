"""PyTorch + CUDA port of flow_supervisor_tpu (RAFT inference forward on NVIDIA Hopper)."""
