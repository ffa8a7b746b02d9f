"""Training losses (supervised sequence losses)."""
