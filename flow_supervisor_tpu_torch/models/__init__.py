"""RAFT modules (encoders, update block, model)."""
