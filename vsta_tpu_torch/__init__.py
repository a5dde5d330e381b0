"""vsta_tpu_torch: the multi-view BEV pedestrian detector in PyTorch + CUDA.

The serving path (uint8 frames -> EfficientNet encoder -> shared-camera
fused warp + view projection -> CenterNet head -> on-device decode) runs
on an NVIDIA GPU; the multi-view warp is a hand-written CUDA kernel
(``csrc/warp_tiles.cu``). Entry points take ``device="cuda"`` by default
and raise when no CUDA device exists; ``device="cpu"`` runs the plain
PyTorch versions of every kernel.
"""

__version__ = "0.1.0"
