"""patent_tpu_torch — the patent image retrieval path of ``patent_tpu`` in
PyTorch, with its TPU kernels rewritten as CUDA kernels for Hopper (H100).

Layout: ``ops/`` (kernel wrappers and their plain PyTorch versions),
``csrc/`` (the CUDA sources, built at first use by ``_build``),
``models/`` (the ViT image tower and the Flax weight bridge),
``retrieval/`` (index, engine, CLI actions), ``utils/`` (checkpoint
reader), ``cli/`` (``python -m patent_tpu_torch.cli``).  Nothing here
imports JAX.
"""
