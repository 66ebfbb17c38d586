"""repro_torch: the PyTorch/CUDA port of the ``repro`` JAX package.

The same primitives, models and serving engine, with every TPU kernel on the
ported paths rewritten by hand as a CUDA kernel (``csrc/``).  Imports
neither JAX nor the reference package.
"""
