"""Deployment flow of the port: graph -> passes -> tiling -> static memory
plan -> :class:`~repro_torch.deploy.plan.DeploymentPlan` (a
:class:`~repro_torch.deploy.plan.DecoderPlanPair` for a dense decoder),
executed node by node through the dispatch table (CUDA kernels on the
accelerator engine, plain PyTorch integer operators on the cluster).

``api`` is the inference surface: ``compile(cfg) -> CompiledModel ->
InferenceSession.forward`` (encoders) or ``.prefill`` / ``.decode``
(decoders); ``engine`` the request-level scheduler above a decoder
session.  ``verify`` is the static plan verifier that audits every
``compile()`` and ``CompiledModel.load`` (and ``python -m
repro_torch.deploy.verify`` audits artifacts on disk); ``costmodel`` is
the paper's analytical model of the ITA ASIC, which
``compile(autotune=True)`` (``autotune``) argmins over a decoder's
bit-neutral knobs.
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
from repro_torch.deploy.paging import (  # noqa: F401
    BlockAllocator,
    chunk_starts,
)
from repro_torch.deploy.prefix import (  # noqa: F401
    PrefixIndex,
    PrefixMatch,
)
from repro_torch.deploy.engine import (  # noqa: F401
    Engine,
    EngineStats,
    Greedy,
    RequestHandle,
    RequestStatus,
    Temperature,
)
from repro_torch.deploy.executor import PlanBindingError  # noqa: F401
from repro_torch.deploy.memory import MemoryPlanError  # noqa: F401
from repro_torch.deploy.verify import (  # noqa: F401
    KVSharingState,
    KVWrite,
    PlanDiagnostic,
    PlanVerificationError,
    check,
    check_sharing,
    verify_pair,
    verify_plan,
    verify_sharing,
)
