"""PyTorch + CUDA port of ``interactive_vit_tpu``.

The same wire bytes, graph JSON, node kinds, tap semantics and HTTP
endpoints as the JAX package, with the TPU's Pallas kernels replaced by
kernels written by hand for NVIDIA Hopper (``csrc/``). Module paths mirror
the JAX package: ``interactive_vit_tpu/X/y.py`` has its counterpart at
``interactive_vit_tpu_torch/X/y.py``. This package imports torch and never
jax; importing it loads nothing else and builds no kernel.
"""
