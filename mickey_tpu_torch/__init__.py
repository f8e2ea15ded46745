"""mickey_tpu_torch: the PyTorch / CUDA port of mickey_tpu for NVIDIA Hopper.

Metric relative pose between two RGB images (DINOv2 features, MicKey
keypoint heads, fused dual-softmax matcher -> top-K, probabilistic
Procrustes RANSAC), with hand-written CUDA kernels for the hot spots
(``csrc/``). The JAX package ``mickey_tpu`` stays the reference; this package
imports torch and never jax.
"""

from .config import Config, default_config, load_config, preset_path

__all__ = ["Config", "default_config", "load_config", "preset_path"]
