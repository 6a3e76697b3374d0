"""Hand-written Hopper kernels for the TPU kernels on the encoder path.

Each kernel lives in ``<name>/`` with ``ref.py`` (the plain PyTorch
version) and ``ops.py`` (the wrapper: launches the CUDA kernel of
``repro_torch/csrc/<name>.cu`` on a CUDA tensor, runs the plain version
on a CPU tensor, and counts its launches in ``<wrapper>.launches``).

- ``int8_gemm``      : ITA GEMM mode (int8 matmul + requant + activation)
- ``ita_attention``  : fused int8 MHA with streaming ITAMax (flash form)
- ``itamax``         : standalone rowwise integer softmax (``w8a8`` attention)
- ``igelu``          : standalone elementwise i-GeLU (unfused GELU nodes)
"""


def wrappers() -> dict:
    """Kernel name -> its public wrapper, whose ``launches`` counts the
    kernel's launches (imported here on call: ``core.attention`` imports
    ``itamax`` while ``ita_attention`` imports ``core.attention``)."""
    from repro_torch.kernels.igelu import igelu
    from repro_torch.kernels.int8_gemm import int8_gemm
    from repro_torch.kernels.ita_attention import ita_attention
    from repro_torch.kernels.itamax import itamax

    return {"int8_gemm": int8_gemm, "ita_attention": ita_attention, "igelu": igelu,
            "itamax": itamax}
