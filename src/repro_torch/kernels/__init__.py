"""Hand-written Hopper kernels for the TPU kernels on the encoder path.

Each kernel lives in ``<name>/`` with ``ref.py`` (the plain PyTorch
version) and ``ops.py`` (the wrapper: launches the CUDA kernel of
``repro_torch/csrc/<name>.cu`` on a CUDA tensor, runs the plain version
on a CPU tensor, and counts its launches in ``<wrapper>.launches``).

- ``int8_gemm``      : ITA GEMM mode (int8 matmul + requant + activation)
- ``ita_attention``  : fused int8 MHA with streaming ITAMax (flash form);
  ``ita_attention_paged``, the same over a paged KV pool (``attn_paged``)
- ``itamax``         : standalone rowwise integer softmax (``w8a8`` attention)
- ``igelu``          : standalone elementwise i-GeLU (unfused GELU nodes)

As in the JAX package, ``repro_torch.kernels.<name>`` and
``<name>_ref`` are the wrapper and its plain version, not the
subpackages.  They are imported on first use (module ``__getattr__``):
``core.attention`` imports ``itamax`` while ``ita_attention`` imports
``core.attention``, so importing all four here would close that cycle.
"""

import importlib
import sys
import types

_KERNELS = ("int8_gemm", "ita_attention", "itamax", "igelu")
_EXPORTS = {**{k: k for k in _KERNELS}, **{f"{k}_ref": k for k in _KERNELS},
            "ita_attention_paged": "ita_attention", "ita_attention_paged_ref": "ita_attention"}


class _Kernels(types.ModuleType):
    def __setattr__(self, name, value):
        # importing the subpackage ``<name>`` binds it here: keep its
        # wrapper under that name instead, as the JAX package's imports do
        if name in _KERNELS and isinstance(value, types.ModuleType):
            value = getattr(value, name)
        super().__setattr__(name, value)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    sub = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(sub, name)


sys.modules[__name__].__class__ = _Kernels


def wrappers() -> dict:
    """Kernel name -> its public wrapper, whose ``launches`` counts the
    kernel's launches."""
    return {name: __getattr__(name) for name in
            ("int8_gemm", "ita_attention", "igelu", "itamax", "ita_attention_paged")}
