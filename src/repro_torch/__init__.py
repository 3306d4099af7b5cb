"""PyTorch/CUDA port of the SFA system (Scaling Attention via Feature Sparsity).

Mirrors the JAX package ``repro`` file for file; the kernels that the JAX
package writes in Pallas for the TPU are hand-written CUDA for Hopper here
(``repro_torch/csrc``). Importing the package needs neither a GPU nor
``nvcc``: kernels are built at first use on the card.
"""
