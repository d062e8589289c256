"""PyTorch/CUDA port of the path tracer (the fused-bounce main path).

A second package beside the JAX reference ``raytracing_course_2024_tpu``:
text and glTF scenes -> SoA scene arrays -> hand-written CUDA bounce
kernels for NVIDIA Hopper (``csrc/bounce.cu``) -> average -> ACES tonemap
-> PPM/PNG, behind the same positional CLI. Every kernel has a plain
PyTorch version in the same module; the CPU tests hold the plain versions
against the JAX package. Imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
