from repro_torch.kernels.igelu.ops import igelu  # noqa: F401
from repro_torch.kernels.igelu.ref import igelu_ref  # noqa: F401
