"""Hand-written Hopper kernels for the TPU kernels on the encoder path.

Each kernel lives in ``<name>/`` with ``ref.py`` (the plain PyTorch
version) and ``ops.py`` (the wrapper: launches the CUDA kernel of
``repro_torch/csrc/<name>.cu`` on a CUDA tensor, runs the plain version
on a CPU tensor, and counts its launches in ``<wrapper>.launches``).

- ``int8_gemm``      : ITA GEMM mode (int8 matmul + requant + activation)
- ``ita_attention``  : fused int8 MHA with streaming ITAMax (flash form)
"""
