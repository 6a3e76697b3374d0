from repro_torch.kernels.ita_attention.ops import ita_attention, ita_decode  # noqa: F401
from repro_torch.kernels.ita_attention.ref import ita_attention_ref  # noqa: F401
