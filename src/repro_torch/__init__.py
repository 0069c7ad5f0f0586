"""repro_torch: SnapStore ported to PyTorch and CUDA on NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout and names, and never imports it.
"""
