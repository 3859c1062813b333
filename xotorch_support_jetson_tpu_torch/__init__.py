"""xotorch_support_jetson_tpu_torch — the PyTorch + CUDA port of
``xotorch_support_jetson_tpu``.

The JAX package stays the reference. This package is its counterpart for an
NVIDIA H100: plain tensor code is PyTorch, and each Pallas kernel of the
reference becomes a CUDA C++ kernel written for Hopper (``csrc/``), built
with ``nvcc`` at first use and bound through ``ctypes`` (ops/kernels.py).
Module paths mirror the JAX package so each counterpart is found by name.

The package imports ``torch``, numpy and the standard library only — never
``jax`` and nothing of the JAX package (tests/test_torch_layering.py).
"""

__version__ = "0.1.0"
