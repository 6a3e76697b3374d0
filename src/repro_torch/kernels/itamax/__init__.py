from repro_torch.kernels.itamax.ops import itamax  # noqa: F401
from repro_torch.kernels.itamax.ref import itamax_ref  # noqa: F401
