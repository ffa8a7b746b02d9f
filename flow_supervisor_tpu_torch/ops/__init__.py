"""Plain PyTorch tensor ops (coords, correlation, upsampling, padding)."""
