"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its
plain PyTorch version:

* chain_resolve — stacked fleet chain walk and direct lookup
* paged_attention — decode attention through block tables, and fused
  with the chain walk
"""
