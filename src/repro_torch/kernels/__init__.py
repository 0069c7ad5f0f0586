"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its
plain PyTorch version:

* chain_resolve — stacked fleet and single-chain walk and direct lookup
* cow_gather — resolved-page gather from the page pool
* paged_attention — decode attention through block tables, and fused
  with the chain walk
* stream_merge — the streaming merge plan (owner scan of a chain's lower
  layers)
"""
