"""PyTorch and CUDA port of the SSAM reproduction (the JAX package
``repro`` is the reference).

``repro_torch.kernels.ops`` holds the public ops; a CUDA tensor runs the
hand-written Hopper kernels, a CPU tensor their plain torch versions.
"""
