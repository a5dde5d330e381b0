"""Plain PyTorch reference of the detector: forward, decode, targets, loss
and optimizer, in float32 with TF32 off. It imports nothing of the program."""
