"""Plain PyTorch version of the standalone ITAMax kernel: rowwise ITAMax."""

from repro_torch.core.itamax import itamax_rowwise as itamax_ref  # noqa: F401
