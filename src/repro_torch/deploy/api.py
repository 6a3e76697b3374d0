"""One inference API: ``compile() -> CompiledModel -> InferenceSession`` (torch port).

``compile(cfg)`` lowers an encoder config into its
:class:`~repro_torch.deploy.plan.DeploymentPlan`, wrapped in a
:class:`CompiledModel` that carries a stable config fingerprint and the
``COMPILER_VERSION`` it was produced by, serializes to JSON and is cached
on disk: a second ``compile()`` of the same (config, options, compiler
version) loads the plan instead of lowering it again.  The payload,
fingerprint and plan schema are the JAX package's, so a model saved by
one package loads in the other.

``CompiledModel.session(batch_size)`` binds quantized weights on a device
and returns an :class:`InferenceSession` whose ``forward(x)`` runs the
plan.  Sessions of either backend run on the CUDA device unless the
caller passes ``device="cpu"``; with no card and no explicit CPU request
they raise.

Not ported yet: the decoder plan pair and its session methods, the
static plan verifier (``verify=``), autotuning and the head-by-head
schedule.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.heterogeneous import (
    Backend,
    DispatchTable,
    as_backend,
    backend_granule,
)
from repro_torch.deploy.lowering import UnsupportedFamilyError, lower  # noqa: F401 (re-export)
from repro_torch.deploy.plan import DeploymentPlan

#: The JAX package's compiler version: both packages lower the same plans.
COMPILER_VERSION = 5

_PAYLOAD_FORMAT = "repro.deploy.api/compiled-model"  # shared payload schema id


# ---------------------------------------------------------------------------
# Fingerprint + on-disk plan cache
# ---------------------------------------------------------------------------


def default_cache_dir() -> str:
    """``$REPRO_TORCH_PLAN_CACHE`` or ``~/.cache/repro_torch/plans``."""
    return os.environ.get("REPRO_TORCH_PLAN_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "plans"
    )


def _canonical(obj, path: str = "payload"):
    """JSON-stable normal form of a fingerprint payload value (strict: a
    value JSON cannot represent stably raises instead of hashing its repr)."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        if obj != obj or obj in (float("inf"), float("-inf")):
            raise TypeError(f"{path}: non-finite float {obj!r} is not JSON-stable")
        return obj
    if isinstance(obj, (list, tuple)):
        return [_canonical(v, f"{path}[{i}]") for i, v in enumerate(obj)]
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"{path}: dict key {k!r} is not a string")
            out[k] = _canonical(v, f"{path}.{k}")
        return out
    raise TypeError(f"{path}: {type(obj).__name__} value {obj!r} is not JSON-stable")


def config_fingerprint(cfg: ArchConfig, options: dict | None = None) -> str:
    """Stable hash of (full config, resolved lowering options)."""
    payload = _canonical({
        "config": dataclasses.asdict(cfg),
        "options": dict(sorted((options or {}).items())),
    })
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def _cache_path(cache_dir: str, cfg: ArchConfig, fingerprint: str) -> str:
    safe = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in cfg.name)
    return os.path.join(cache_dir, f"{safe}-{fingerprint[:16]}.plan.json")


def _artifact_from_payload(payload: dict) -> DeploymentPlan:
    if payload["kind"] != "plan":
        raise ValueError(f"payload kind {payload['kind']!r}: only encoder plans are ported")
    return DeploymentPlan.from_dict(payload["artifact"])


def _cache_load(path: str, fingerprint: str):
    """Deserialized plan on a hit; None on any miss (absent, stale compiler
    version, fingerprint mismatch, or corrupt file)."""
    try:
        with open(path) as f:
            payload = json.load(f)
        if payload.get("format") != _PAYLOAD_FORMAT:
            return None
        if payload.get("compiler_version") != COMPILER_VERSION:
            return None
        if payload.get("fingerprint") != fingerprint:
            return None
        return _artifact_from_payload(payload)
    except (OSError, ValueError, KeyError):
        return None


def _cache_store(path: str, payload: dict) -> None:
    """Publish one cache entry atomically: write a private temp file in the
    destination directory, fsync, then ``os.replace`` it over the name."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# CompiledModel
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledModel:
    """The deployable artifact: plan + identity + weights binder."""

    cfg: ArchConfig
    backend: Backend
    artifact: DeploymentPlan
    fingerprint: str
    compiler_version: int
    options: dict
    cache_hit: bool = False
    cache_path: str | None = None

    def bind(self, params: dict | None = None, *, qp: dict | None = None,
             seed: int = 0) -> tuple[dict, dict]:
        """(float init ->) quantize -> bind onto the plan's weight names.

        ``qp`` (quantized params, e.g. carried from the JAX package by
        ``repro_torch.convert``) skips quantization; else ``params`` (float)
        are quantized, and with neither, float params are drawn from
        ``seed``.  Returns ``(weights, qp)`` as CPU tensors.
        """
        from repro_torch.deploy.executor import bind_encoder_weights
        from repro_torch.models import encoder as M

        if qp is None:
            if params is None:
                params = M.init_params(self.cfg, seed)
            qp = M.quantize_params(self.cfg, params)
        return bind_encoder_weights(self.artifact, self.cfg, qp), qp

    def session(
        self,
        batch_size: int,
        *,
        params: dict | None = None,
        qp: dict | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
        table: DispatchTable | None = None,
    ) -> "InferenceSession":
        return InferenceSession(self, batch_size, params=params, qp=qp, seed=seed,
                                device=device, table=table)

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "format": _PAYLOAD_FORMAT,
            "compiler_version": self.compiler_version,
            "fingerprint": self.fingerprint,
            "arch": self.cfg.name,
            "backend": self.backend.value,
            "options": dict(self.options),
            "kind": "plan",
            "artifact": self.artifact.to_dict(),
        }

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str, cfg: ArchConfig) -> "CompiledModel":
        """Rehydrate a saved model; ``cfg`` must be the config it was
        compiled from and the payload must carry ``COMPILER_VERSION``."""
        with open(path) as f:
            payload = json.load(f)
        if payload.get("format") != _PAYLOAD_FORMAT:
            raise ValueError(f"{path}: not a CompiledModel payload")
        if payload.get("compiler_version") != COMPILER_VERSION:
            raise ValueError(
                f"{path}: compiled by compiler version {payload.get('compiler_version')}, "
                f"current is {COMPILER_VERSION} — recompile with compile()"
            )
        fp = config_fingerprint(cfg, payload["options"])
        if fp != payload["fingerprint"]:
            raise ValueError(
                f"{path}: fingerprint mismatch — saved for config {payload['arch']!r} "
                "with different contents/options"
            )
        return CompiledModel(
            cfg=cfg,
            backend=as_backend(payload["backend"]),
            artifact=_artifact_from_payload(payload),
            fingerprint=payload["fingerprint"],
            compiler_version=int(payload["compiler_version"]),
            options=dict(payload["options"]),
            cache_path=path,
        )


# ---------------------------------------------------------------------------
# compile()
# ---------------------------------------------------------------------------


def compile(  # noqa: A001 — torch.compile precedent
    cfg: ArchConfig,
    *,
    backend: Backend | str = Backend.W8A8,
    seq_len: int | None = None,
    head_by_head: bool = False,
    include_head: bool = True,
    cache_dir: str | None = None,
    use_cache: bool = True,
) -> CompiledModel:
    """Compile one encoder config into its deployment plan, cached on disk.

    The engine mapping is solved at the granule of the execution
    ``backend`` (64 for the W8A8 arithmetic, 128 for the kernels), so the
    plan's engine column matches ``DispatchTable.resolve`` at run time.
    The cache key is ``config_fingerprint(cfg, options)`` with the same
    option set as the JAX package (the decoder options at their encoder
    values), so both packages fingerprint a config identically.  Raises
    :class:`UnsupportedFamilyError` for families the port cannot lower.
    """
    be = as_backend(backend)
    granule = backend_granule(be)
    s = seq_len or cfg.max_seq
    options = {
        "backend": be.value,
        "granule": granule,
        "seq_len": s,
        "max_len": 0,
        "kv_block_size": 0,
        "kv_blocks": 0,
        "head_by_head": head_by_head,
        "include_head": include_head,
        "fuse": False,
        "prefix_cache": False,
    }
    fingerprint = config_fingerprint(cfg, options)
    path = _cache_path(cache_dir or default_cache_dir(), cfg, fingerprint)
    if use_cache:
        artifact = _cache_load(path, fingerprint)
        if artifact is not None:
            return CompiledModel(cfg, be, artifact, fingerprint, COMPILER_VERSION, options,
                                 cache_hit=True, cache_path=path)
    artifact = lower(cfg, seq_len, head_by_head=head_by_head, include_head=include_head,
                     granule=granule)
    model = CompiledModel(cfg, be, artifact, fingerprint, COMPILER_VERSION, options,
                          cache_path=path if use_cache else None)
    if use_cache:
        _cache_store(path, model.to_dict())
    return model


# ---------------------------------------------------------------------------
# InferenceSession
# ---------------------------------------------------------------------------


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The card unless the caller asks for the CPU; never a silent fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class InferenceSession:
    """Runtime surface over one compiled encoder plan: ``forward(x)``."""

    def __init__(
        self,
        model: CompiledModel,
        batch_size: int,
        *,
        params: dict | None = None,
        qp: dict | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
        table: DispatchTable | None = None,
    ):
        from repro_torch.deploy.executor import bind_plan

        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.backend = model.backend
        self.batch_size = batch_size
        self.table = table
        self._plan = model.artifact
        weights, _ = model.bind(params=params, qp=qp, seed=seed)
        self.weights = {k: v.to(self.device) for k, v in weights.items()}
        bind_plan(self._plan, backend=self.backend, table=table)

    def forward(self, x) -> torch.Tensor:
        """One batched forward pass of the encoder plan.

        ``x`` is the plan's input (``tokens`` int32 [B, S] or int8 features
        [B, S, D]) or a batch dict keyed by input name; inputs are moved to
        the session's device.
        """
        from repro_torch.deploy.executor import execute

        name = self._plan.inputs[0]
        batch = x if isinstance(x, dict) else {name: x}
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        lead = batch[name].shape[0]
        if lead != self.batch_size:
            raise ValueError(f"batch dim {lead} != session batch_size {self.batch_size}")
        return execute(self._plan, self.weights, batch, backend=self.backend, table=self.table)
