from repro_torch.kernels.ita_attention.ops import (  # noqa: F401
    ita_attention,
    ita_attention_paged,
    ita_decode,
)
from repro_torch.kernels.ita_attention.ref import (  # noqa: F401
    ita_attention_paged_ref,
    ita_attention_ref,
)
