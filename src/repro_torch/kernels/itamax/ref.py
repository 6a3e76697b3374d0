"""Plain PyTorch version of the standalone ITAMax kernel: rowwise ITAMax."""

from repro_torch.core.itamax import itamax_rowwise


def itamax_ref(logits, mask=None):
    return itamax_rowwise(logits, mask=mask)
