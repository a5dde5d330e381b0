"""vsta_tpu_torch: the multi-view BEV pedestrian detector in PyTorch + CUDA.

The serving path (uint8 frames -> EfficientNet encoder -> shared-camera
fused warp + view projection -> CenterNet head -> on-device decode) and
the training step (targets, the same forward in training mode, loss,
backward, Adam) run on an NVIDIA GPU. The multi-view warp
(``csrc/warp_tiles.cu``) and the grouped bilinear sampler with its fused
backward (``csrc/grouped_taps.cu``) are hand-written CUDA kernels. Entry
points take ``device="cuda"`` by default and raise when no CUDA device
exists; ``device="cpu"`` runs the plain PyTorch versions of every kernel.
The training loop (``training/loop.run_training``, ``python -m
vsta_tpu_torch.train`` and ``.evaluate``) reads a Wildtrack-format tree
(``data/``), copies pinned batches to the card and keeps checkpoints.
"""

__version__ = "0.2.0"
