"""Deployment flow of the port: graph -> passes -> tiling -> static memory
plan -> :class:`~repro_torch.deploy.plan.DeploymentPlan` (a
:class:`~repro_torch.deploy.plan.DecoderPlanPair` for a dense decoder),
executed node by node through the dispatch table (CUDA kernels on the
accelerator engine, plain PyTorch integer operators on the cluster).

``api`` is the inference surface: ``compile(cfg) -> CompiledModel ->
InferenceSession.forward`` (encoders) or ``.prefill`` / ``.decode``
(decoders).
"""

from repro_torch.deploy.api import (  # noqa: F401
    COMPILER_VERSION,
    CompiledModel,
    InferenceSession,
    KVCapacityError,
    UnsupportedFamilyError,
    compile,
    config_fingerprint,
    is_dense_decoder,
)
from repro_torch.deploy.executor import PlanBindingError  # noqa: F401
from repro_torch.deploy.memory import MemoryPlanError  # noqa: F401
