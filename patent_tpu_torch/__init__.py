"""patent_tpu_torch — the patent image retrieval path of ``patent_tpu`` in
PyTorch, bf16 and int8, with its TPU kernels rewritten as CUDA kernels for
Hopper (H100).

Layout: ``ops/`` (kernel wrappers and their plain PyTorch versions),
``csrc/`` (the CUDA sources, built at first use by ``_build``),
``models/`` (the bf16 and int8 ViT image towers and the Flax weight
bridge), ``retrieval/`` (index, engine, CLI actions), ``input/``,
``data/`` and ``metrics/`` (host-side decode, corpus and metric battery),
``utils/`` (checkpoint reader, serving profiles), ``cli/``
(``python -m patent_tpu_torch.cli``).  Nothing here imports JAX or any
module of ``patent_tpu``.
"""
