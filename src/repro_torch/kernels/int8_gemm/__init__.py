from repro_torch.kernels.int8_gemm.ops import int8_gemm  # noqa: F401
from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref  # noqa: F401
