"""gltf_renderer_tpu_torch — the PyTorch/CUDA port of gltf_renderer_tpu.

The JAX package (`gltf_renderer_tpu`) stays the reference; this package
mirrors its module layout and function names and imports neither JAX nor the
JAX package. Device-side work is plain torch ops plus hand-written CUDA
kernels for NVIDIA Hopper (`csrc/`), built at first use.
"""

__version__ = "0.1.0"
