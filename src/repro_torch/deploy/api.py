"""One inference API: ``compile() -> CompiledModel -> InferenceSession`` (torch port).

``compile(cfg)`` lowers an encoder config into its
:class:`~repro_torch.deploy.plan.DeploymentPlan`, or a dense decoder into
its :class:`~repro_torch.deploy.plan.DecoderPlanPair`, wrapped in a
:class:`CompiledModel` that carries a stable config fingerprint and the
``COMPILER_VERSION`` it was produced by, serializes to JSON and is cached
on disk: a second ``compile()`` of the same (config, options, compiler
version) loads the plan instead of lowering it again.  The payload,
fingerprint and plan schema are the JAX package's, so a model saved by
one package loads in the other.

``CompiledModel.session(batch_size)`` binds quantized weights on a device
and returns an :class:`InferenceSession`: ``forward(x)`` runs an encoder
plan; ``prefill(tokens)`` / ``prefill_slot(i, tokens)`` / ``decode(tokens,
pos)`` run a decoder pair over one batched, statically planned KV region,
each request slot at its own depth.  The region is dense per-slot strips,
or, with ``compile(kv_block_size=, kv_blocks=)``, a shared paged block
pool: prompts longer than ``seq_len`` then prefill in chunks
(``prefill_chunk(s)``), ``free_slot`` returns a slot's blocks, and
``attach_prefix`` shares resident blocks between slots, copied on the
first write.  Sessions of either backend run on the CUDA device unless
the caller passes ``device="cpu"``; with no card and no explicit CPU
request they raise.

Every artifact ``compile`` hands out, fresh or from the cache, and every
file ``CompiledModel.load`` reads is audited by the static plan verifier
(:mod:`repro_torch.deploy.verify`) unless the caller passes
``verify=False``.  ``compile(autotune=True)`` picks a decoder's
bit-neutral plan knobs with the ITA cost model
(:mod:`repro_torch.deploy.autotune`).  The request-level ``Engine`` above
a decoder session lives in :mod:`repro_torch.deploy.engine`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.heterogeneous import (
    Backend,
    DispatchTable,
    as_backend,
    backend_granule,
)
from repro_torch.deploy.lowering import (  # noqa: F401 (re-exports)
    UnsupportedFamilyError,
    is_dense_decoder,
    lower,
)
from repro_torch.deploy.paging import (
    SCRATCH_BLOCK,
    BlockAllocator,
    PoolExhausted,
    blocks_for_rows,
    blocks_per_slot,
    chunk_starts,
)
from repro_torch.deploy.plan import DecoderPlanPair, DeploymentPlan
from repro_torch.deploy.verify import KVSharingState

#: The JAX package's compiler version: both packages lower the same plans.
COMPILER_VERSION = 5

_PAYLOAD_FORMAT = "repro.deploy.api/compiled-model"  # shared payload schema id


class KVCapacityError(ValueError):
    """A decode dispatch (or prefill chunk) cannot fit the KV region.

    Two causes share this type (callers branch on the attributes):

    * ``reason == "max_len"`` — a slot's depth reached the compiled
      ``max_len`` (the dense strip or the block table's width).
    * ``reason == "pool"`` — paged region only: the shared block pool is
      exhausted; ``slots`` are the requests that could not grow and
      ``evictable`` the *other* live slots whose eviction would free
      capacity, those holding at least one exclusively owned block (a
      slot whose blocks are all shared frees nothing when evicted).

    Attributes: ``slots``, ``pos`` (their depths, same order),
    ``max_len``, ``reason`` and ``evictable``; ``message`` replaces the
    generated text when given.
    """

    def __init__(self, slots, pos, max_len: int, *, reason: str = "max_len",
                 evictable=(), message: str | None = None):
        self.slots = tuple(int(s) for s in slots)
        self.pos = tuple(int(p) for p in pos)
        self.max_len = int(max_len)
        self.reason = reason
        self.evictable = tuple(int(s) for s in evictable)
        if message is not None:
            msg = message
        elif reason == "pool":
            msg = (f"paged KV pool exhausted: slot(s) {list(self.slots)} at pos "
                   f"{list(self.pos)} need new blocks and none are free; evictable "
                   f"slot(s) holding blocks: {list(self.evictable)}")
        else:
            msg = (f"KV region full: slot(s) {list(self.slots)} at pos {list(self.pos)} >= "
                   f"max_len {self.max_len}; re-admit via prefill_slot or compile with a "
                   "larger max_len")
        super().__init__(msg)


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


def _artifact_from_payload(payload: dict) -> DeploymentPlan | DecoderPlanPair:
    if payload["kind"] == "pair":
        return DecoderPlanPair.from_dict(payload["artifact"])
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
    """The deployable artifact: plan(s) + identity + weights binder."""

    cfg: ArchConfig
    backend: Backend
    artifact: DeploymentPlan | DecoderPlanPair
    fingerprint: str
    compiler_version: int
    options: dict
    cache_hit: bool = False
    cache_path: str | None = None
    # the static verifier's results, not serialized (a reloaded artifact
    # is verified again): the warnings of the pass (errors raise at
    # compile or load time) and its one-time wall-clock cost
    diagnostics: tuple = ()
    verify_ms: float = 0.0

    @property
    def kind(self) -> str:
        return "decoder" if isinstance(self.artifact, DecoderPlanPair) else "encoder"

    def counts(self) -> dict:
        return self.artifact.counts()

    def bind(self, params: dict | None = None, *, qp: dict | None = None,
             seed: int = 0) -> tuple[dict, dict]:
        """(float init ->) quantize -> bind onto the plan's weight names.

        ``qp`` (quantized params, e.g. carried from the JAX package by
        ``repro_torch.convert``) skips quantization; else ``params`` (float)
        are quantized, and with neither, float params are drawn from
        ``seed``.  Returns ``(weights, qp)`` with the tensors where ``qp``
        or ``params`` had them (the CPU for drawn ones).
        """
        from repro_torch.deploy.executor import bind_decoder_weights, bind_encoder_weights

        if self.kind == "decoder":
            from repro_torch.models import transformer as M

            bind_fn, plan = bind_decoder_weights, self.artifact.prefill
        else:
            from repro_torch.models import encoder as M

            bind_fn, plan = bind_encoder_weights, self.artifact
        if qp is None:
            if params is None:
                params = M.init_params(self.cfg, seed)
            qp = M.quantize_params(self.cfg, params)
        return bind_fn(plan, self.cfg, qp), qp

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
            "kind": "pair" if self.kind == "decoder" else "plan",
            "artifact": self.artifact.to_dict(),
        }

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str, cfg: ArchConfig, *, verify: bool = True) -> "CompiledModel":
        """Rehydrate a saved model; ``cfg`` must be the config it was
        compiled from and the payload must carry ``COMPILER_VERSION``.

        With ``verify=True`` the artifact goes through the static
        verifier before anything is bound: a file edited or corrupted on
        disk raises :class:`~repro_torch.deploy.verify.PlanVerificationError`
        here instead of running."""
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
        model = CompiledModel(
            cfg=cfg,
            backend=as_backend(payload["backend"]),
            artifact=_artifact_from_payload(payload),
            fingerprint=payload["fingerprint"],
            compiler_version=int(payload["compiler_version"]),
            options=dict(payload["options"]),
            cache_path=path,
        )
        if verify:
            model.diagnostics, model.verify_ms = _verify_artifact(model.artifact, context=path)
        return model


# ---------------------------------------------------------------------------
# compile()
# ---------------------------------------------------------------------------


def _verify_artifact(artifact, *, context: str) -> tuple[tuple, float]:
    """Run the static plan verifier; return (warnings, elapsed ms).
    Errors raise :class:`~repro_torch.deploy.verify.PlanVerificationError`."""
    from repro_torch.deploy.verify import check

    t0 = time.perf_counter()
    diags = check(artifact, context=context)
    return tuple(diags), (time.perf_counter() - t0) * 1e3


def compile(  # noqa: A001 — torch.compile precedent
    cfg: ArchConfig,
    *,
    backend: Backend | str = Backend.W8A8,
    seq_len: int | None = None,
    max_len: int | None = None,
    kv_block_size: int | None = None,
    kv_blocks: int | None = None,
    head_by_head: bool = False,
    include_head: bool = True,
    fuse: bool = True,
    autotune: bool = False,
    prefix_cache: bool = False,
    cache_dir: str | None = None,
    use_cache: bool = True,
    verify: bool = True,
) -> CompiledModel:
    """Compile one config into its deployment artifact, cached on disk.

    The engine mapping is solved at the granule of the execution
    ``backend`` (64 for the W8A8 arithmetic, 128 for the kernels), so the
    plan's engine column matches ``DispatchTable.resolve`` at run time.
    Dense decoders lower to a :class:`DecoderPlanPair` with a KV region of
    ``max_len`` tokens a slot (default ``seq_len + 1``), fused into
    ``FusedRegion`` nodes unless ``fuse=False``; encoder plans ignore
    ``fuse`` and lower unfused.  ``kv_block_size`` + ``kv_blocks``
    (decoders only, both or neither) switch the KV region from dense
    per-slot strips to a shared pool of ``kv_blocks`` blocks with per-slot
    block tables.  ``prefix_cache`` (paged decoders only) declares that
    the artifact is served with prefix sharing: it changes no plan
    content but enters the fingerprint.  ``head_by_head`` lowers an
    encoder's attention with the paper's per-head schedule.  The cache
    key is ``config_fingerprint(cfg, options)`` with the JAX package's
    option set, so both packages fingerprint a config identically.

    ``autotune=True`` (decoders only; an encoder raises ``ValueError``)
    picks the bit-neutral knobs (``kv_block_size`` with the pool's rows
    kept, the fusion boundary, the GEMM macro-tiles) by the ITA cost
    model's argmin (:mod:`repro_torch.deploy.autotune`), records them and
    the predicted step cost in the decode plan's ``autotune`` payload and
    folds them into the fingerprint: the tuner is deterministic, so a
    second ``compile(autotune=True)`` is a cache hit.

    ``verify=True`` (the default) runs the static plan verifier
    (:mod:`repro_torch.deploy.verify`) over the artifact, fresh or loaded
    from the cache.  Errors raise
    :class:`~repro_torch.deploy.verify.PlanVerificationError`; warnings go
    to ``CompiledModel.diagnostics`` and the cost to
    ``CompiledModel.verify_ms``.  ``verify`` is a checking knob, not a
    lowering option: it never enters the fingerprint.  Raises
    :class:`UnsupportedFamilyError` for families the port cannot lower.
    """
    be = as_backend(backend)
    granule = backend_granule(be)
    s = seq_len or cfg.max_seq
    is_decoder = is_dense_decoder(cfg)
    if (kv_block_size is None) != (kv_blocks is None):
        raise ValueError(
            "kv_block_size and kv_blocks come as a pair (both set the "
            "paged KV region, both absent keeps the dense region)"
        )
    bs, nb = int(kv_block_size or 0), int(kv_blocks or 0)
    # (paged options on a non-decoder family are refused by lower())
    if (bs < 0 or nb < 0) or (bool(bs) != bool(nb)):
        raise ValueError(
            f"kv_block_size/kv_blocks must both be positive, got "
            f"{kv_block_size}/{kv_blocks}"
        )
    fuse = bool(fuse) and is_decoder
    if autotune and not is_decoder:
        raise ValueError(
            "autotune enumerates decode-step knobs (kv_block_size, fusion "
            f"boundary, decode GEMM tiles); {cfg.name} does not lower to a "
            "decoder plan pair"
        )
    if prefix_cache and not (is_decoder and nb):
        raise ValueError(
            "prefix_cache needs a paged decoder artifact: prefix sharing "
            "forks per-slot block-table entries, so compile with "
            "kv_block_size/kv_blocks on a decoder config"
        )
    cap = (max_len or s + 1) if is_decoder else 0
    tuned = None
    fuse_min_nodes = 2
    if autotune:
        from repro_torch.deploy.autotune import tune_decoder

        tuned = tune_decoder(cfg, seq_len=s, max_len=cap, granule=granule,
                             kv_block_size=bs, kv_blocks=nb, fuse=fuse)
        bs = tuned.knobs["kv_block_size"]
        nb = tuned.knobs["kv_blocks"]
        fuse_min_nodes = tuned.knobs["fuse_min_nodes"]
    options = {
        "backend": be.value,
        "granule": granule,
        "seq_len": s,
        "max_len": cap,
        "kv_block_size": bs,
        "kv_blocks": nb,
        "head_by_head": head_by_head,
        "include_head": include_head,
        "fuse": fuse,
        "prefix_cache": bool(prefix_cache),
    }
    if autotune:  # the resolved knobs key the cache
        options["autotune"] = dict(tuned.knobs)
    fingerprint = config_fingerprint(cfg, options)
    path = _cache_path(cache_dir or default_cache_dir(), cfg, fingerprint)
    if use_cache:
        artifact = _cache_load(path, fingerprint)
        if artifact is not None:
            model = CompiledModel(cfg, be, artifact, fingerprint, COMPILER_VERSION, options,
                                  cache_hit=True, cache_path=path)
            if verify:  # bytes read from disk are audited, not trusted
                model.diagnostics, model.verify_ms = _verify_artifact(artifact, context=path)
            return model
    artifact = lower(cfg, seq_len, head_by_head=head_by_head, include_head=include_head,
                     max_len=max_len, kv_block_size=bs, kv_blocks=nb, granule=granule,
                     fuse=fuse, fuse_min_nodes=fuse_min_nodes)
    if tuned is not None:
        artifact.decode.autotune = tuned.payload()
    model = CompiledModel(cfg, be, artifact, fingerprint, COMPILER_VERSION, options,
                          cache_path=path if use_cache else None)
    if verify:
        model.diagnostics, model.verify_ms = _verify_artifact(
            artifact, context=f"compile({cfg.name})")
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
    """Stateful runtime surface over one compiled artifact.

    Encoder: :meth:`forward`.  Decoder: :meth:`prefill` /
    :meth:`prefill_slot` fill the statically planned, batched KV region;
    :meth:`decode` advances all ``batch_size`` request slots by one token
    in one plan dispatch, each slot at its own depth (``pos`` is a
    per-request vector, kept on the host).  Every runner is row-local, so
    slot ``b`` computes the same ints as a lone request at depth
    ``pos[b]``.  The KV region lives on the session's device and is
    written in place.

    Paged sessions keep their block tables, the block allocator and the
    depths on the host; a dispatch copies the tables it needs to the
    device once.  The pools, the copy-on-write copies and the scatter of
    new rows work in place on the device tensors: no step moves a pool.

    ``qp`` holds the quantized params the session was bound from (where
    ``CompiledModel.bind`` left them), for a model-level check of the plan.

    **Thread affinity**: the KV state, the allocator and the depths have
    no locking, so a session belongs to one thread at a time.  The first
    mutating call binds it to the calling thread; mutating from another
    thread raises ``RuntimeError``.  Hand a session over explicitly with
    :meth:`rebind_thread`.
    """

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
        weights, self.qp = model.bind(params=params, qp=qp, seed=seed)
        self.weights = {k: v.to(self.device) for k, v in weights.items()}
        if model.kind == "decoder":
            pair = self._pair = model.artifact
            self._kv = None  # dense: {"k": [L, B, Hkv, max_len, D] int8, "v": ...}
            self._pos = None  # host int32 [B]: each slot's depth
            plans = (pair.prefill, pair.decode)
            if pair.paged:
                cfg = model.cfg
                shape = (cfg.n_layers, pair.kv_blocks + 1, cfg.n_kv_heads,
                         pair.kv_block_size, cfg.head_dim)
                self._pool = {
                    "k": torch.zeros(shape, dtype=torch.int8, device=self.device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=self.device),
                }
                self._alloc = BlockAllocator(pair.kv_blocks)
                self._tables = np.full(
                    (batch_size, blocks_per_slot(pair.max_len, pair.kv_block_size)),
                    SCRATCH_BLOCK, np.int32)
                self._slot_blocks: list[list[int]] = [[] for _ in range(batch_size)]
                self._cow_copies = 0
        else:
            self._plan = model.artifact
            plans = (self._plan,)
        for plan in plans:
            bind_plan(plan, backend=self.backend, table=table)
        self._owner_ident: int | None = None  # thread affinity (bound lazily)

    # -- shared ------------------------------------------------------------

    def _require(self, kind: str, method: str) -> None:
        if self.model.kind != kind:
            raise RuntimeError(
                f"InferenceSession.{method} is a {kind} method; this session "
                f"wraps a {self.model.kind} artifact ({self.cfg.name})"
            )

    def _affine(self, method: str) -> None:
        """Bind the session to the first mutating caller's thread; refuse
        mutation from any other thread."""
        ident = threading.get_ident()
        if self._owner_ident is None:
            self._owner_ident = ident
        elif self._owner_ident != ident:
            raise RuntimeError(
                f"InferenceSession.{method} called from thread {ident} but the session is "
                f"bound to thread {self._owner_ident}; KV state has no locking — call "
                "rebind_thread() from the new owning thread to transfer ownership"
            )

    def rebind_thread(self) -> None:
        """Transfer session ownership to the calling thread (the caller
        asserts that the previous owner has stopped mutating)."""
        self._owner_ident = threading.get_ident()

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.batch_size:
            raise IndexError(f"slot {slot} out of range [0, {self.batch_size})")

    def _require_paged(self, method: str) -> None:
        if not self._pair.paged:
            raise RuntimeError(
                f"{method} needs a paged session; compile with kv_block_size/kv_blocks")

    # -- encoder -----------------------------------------------------------

    def forward(self, x) -> torch.Tensor:
        """One batched forward pass of the encoder plan.

        ``x`` is the plan's input (``tokens`` int32 [B, S] or int8 features
        [B, S, D]) or a batch dict keyed by input name; inputs are moved to
        the session's device.
        """
        from repro_torch.deploy.executor import execute

        self._require("encoder", "forward")
        name = self._plan.inputs[0]
        batch = x if isinstance(x, dict) else {name: x}
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        lead = batch[name].shape[0]
        if lead != self.batch_size:
            raise ValueError(f"batch dim {lead} != session batch_size {self.batch_size}")
        return execute(self._plan, self.weights, batch, backend=self.backend, table=self.table)

    # -- decoder -----------------------------------------------------------

    @property
    def seq_len(self) -> int:
        """Prompt length the prefill schedule was lowered for."""
        self._require("decoder", "seq_len")
        return self._pair.seq_len

    @property
    def max_len(self) -> int:
        self._require("decoder", "max_len")
        return self._pair.max_len

    @property
    def paged(self) -> bool:
        """Is the KV region a shared block pool (vs dense per-slot strips)?"""
        self._require("decoder", "paged")
        return self._pair.paged

    @property
    def kv_block_size(self) -> int:
        self._require("decoder", "kv_block_size")
        return self._pair.kv_block_size

    @property
    def kv_blocks(self) -> int:
        self._require("decoder", "kv_blocks")
        return self._pair.kv_blocks

    @property
    def decode_dispatch_count(self) -> int:
        """Top-level nodes per decode step, ``len(decode.nodes)`` (a fused
        region is one)."""
        self._require("decoder", "decode_dispatch_count")
        return len(self._pair.decode.nodes)

    @property
    def blocks_free(self) -> int:
        """Free blocks in the paged pool (0 for dense sessions)."""
        self._require("decoder", "blocks_free")
        return self._alloc.n_free if self._pair.paged else 0

    def blocks_held(self, slot: int) -> int:
        """Pool blocks one slot holds (0 for dense)."""
        self._require("decoder", "blocks_held")
        self._check_slot(slot)
        return len(self._slot_blocks[slot]) if self._pair.paged else 0

    def block_chain(self, slot: int) -> tuple[int, ...]:
        """One slot's physical block chain in logical row order (empty for
        dense sessions or a freed slot)."""
        self._require("decoder", "block_chain")
        self._check_slot(slot)
        if not self._pair.paged:
            return ()
        return tuple(int(b) for b in self._tables[slot] if b != SCRATCH_BLOCK)

    @property
    def allocator(self) -> BlockAllocator | None:
        """The paged session's block allocator (None for dense): the
        refcount surface a prefix index shares."""
        self._require("decoder", "allocator")
        return self._alloc if self._pair.paged else None

    @property
    def cow_copies(self) -> int:
        """Copy-on-write block copies made so far (paged)."""
        self._require("decoder", "cow_copies")
        return self._cow_copies if self._pair.paged else 0

    @property
    def pos(self):
        """Per-slot generation depth, host int32 [batch_size] (numpy)."""
        self._require("decoder", "pos")
        return self._pos

    @property
    def kv_cache(self) -> dict | None:
        """The batched dense KV region: ``{"k": [L, B, Hkv, max_len, D], ...}``
        on the session's device (written in place by :meth:`decode`)."""
        self._require("decoder", "kv_cache")
        return self._kv

    @property
    def kv_pool(self) -> dict | None:
        """The shared paged pool ``{"k": [L, P+1, Hkv, block_size, D], ...}``
        on the session's device (written in place), or None (dense)."""
        self._require("decoder", "kv_pool")
        return self._pool if self._pair.paged else None

    def _check_tokens(self, tokens, rows: int) -> torch.Tensor:
        tokens = torch.as_tensor(tokens).to(device=self.device, dtype=torch.int32)
        if tokens.dim() == 1:
            tokens = tokens[None]
        if tuple(tokens.shape) != (rows, self._pair.seq_len):
            raise ValueError(
                f"prefill tokens must be [{rows}, {self._pair.seq_len}] (the lowered "
                f"prompt length), got {tuple(tokens.shape)}"
            )
        return tokens

    def _prefill(self, tokens: torch.Tensor):
        from repro_torch.deploy.executor import execute_prefill

        return execute_prefill(self._pair, self.weights, {"tokens": tokens},
                               backend=self.backend, table=self.table)

    def _chunk(self, tokens: torch.Tensor, start, tables: np.ndarray) -> torch.Tensor:
        """One paged prefill dispatch over the pool, in place: ``start`` a
        scalar or a per-lane [B] offset, ``tables`` the lanes' host block
        tables (copied to the device once)."""
        from repro_torch.deploy.executor import execute_prefill_paged

        logits, self._pool = execute_prefill_paged(
            self._pair, self.weights, self._pool, tokens,
            torch.from_numpy(np.asarray(start, np.int32)),
            torch.from_numpy(np.ascontiguousarray(tables)).to(self.device),
            backend=self.backend, table=self.table)
        return logits

    def _zero_pos(self) -> None:
        if self._pos is None:
            self._pos = np.zeros((self.batch_size,), np.int32)

    def prefill(self, tokens) -> torch.Tensor:
        """Prefill every slot with one prompt each: tokens int32 [B, S].
        Returns the last-token logits [B, 1, vocab_padded] and sets every
        slot's depth to ``S``.  Paged sessions release every slot's blocks
        first and allocate fresh ones for rows ``[0, S)`` (one batched
        chunk-0 dispatch)."""
        self._require("decoder", "prefill")
        self._affine("prefill")
        tokens = self._check_tokens(tokens, self.batch_size)
        s = self._pair.seq_len
        if self._pair.paged:
            # checked before the release: a failed prefill must leave every
            # slot's blocks and depth as they were
            need = blocks_for_rows(s, self._pair.kv_block_size)
            if self._pair.kv_blocks < need * self.batch_size:
                raise KVCapacityError(list(range(self.batch_size)), [0] * self.batch_size,
                                      self._pair.max_len, reason="pool")
            for b in range(self.batch_size):
                self._release_blocks(b)
            for b in range(self.batch_size):
                self._grow_table(b, need)
            for b in range(self.batch_size):
                self._note_writes(b, 0, s)
            logits = self._chunk(tokens, 0, self._tables)
        else:
            logits, cache = self._prefill(tokens)
            self._kv = {"k": cache["k"], "v": cache["v"]}
        self._pos = np.full((self.batch_size,), s, np.int32)
        return logits

    def prefill_slot(self, slot: int, tokens) -> torch.Tensor:
        """Admit a new request into one slot: its KV rows and depth are
        installed in slot ``slot``; the other slots' rows and depths are
        untouched, so they keep decoding.  Dense: the prefill schedule at
        batch 1, prompt of exactly ``seq_len`` tokens.  Paged: any prompt
        of ``seq_len <= T <= max_len`` tokens, in ``seq_len``-token chunks
        (:meth:`prefill_chunk`).  Returns the prompt's last-token logits
        [1, 1, vocab_padded]."""
        self._require("decoder", "prefill_slot")
        self._affine("prefill_slot")
        self._check_slot(slot)
        if self._pair.paged:
            tokens = torch.as_tensor(tokens).to(device=self.device, dtype=torch.int32)
            if tokens.dim() == 1:
                tokens = tokens[None]
            t = tokens.shape[-1]
            if tokens.shape[0] != 1 or not self._pair.seq_len <= t <= self._pair.max_len:
                raise ValueError(
                    f"paged prefill_slot tokens must be [1, T] with {self._pair.seq_len} "
                    f"<= T <= {self._pair.max_len}, got {tuple(tokens.shape)}")
            logits = None
            for start in chunk_starts(t, self._pair.seq_len):
                logits = self.prefill_chunk(slot, tokens[:, start: start + self._pair.seq_len],
                                            start)
            return logits
        logits, cache = self._prefill(self._check_tokens(tokens, 1))
        if self._kv is None:
            l, _, hkv, m, d = cache["k"].shape
            shape = (l, self.batch_size, hkv, m, d)
            self._kv = {"k": cache["k"].new_zeros(shape), "v": cache["v"].new_zeros(shape)}
            self._pos = np.zeros((self.batch_size,), np.int32)
        self._kv["k"][:, slot] = cache["k"][:, 0]
        self._kv["v"][:, slot] = cache["v"][:, 0]
        self._pos[slot] = self._pair.seq_len
        return logits

    def _check_chunk(self, slot: int, start: int) -> None:
        if start != 0 and not 0 < start <= int(self._pos[slot]):
            raise ValueError(
                f"chunk at start {start} leaves a gap: slot {slot} has "
                f"{int(self._pos[slot])} rows (chunks must be contiguous or overlapping)")
        if start + self._pair.seq_len > self._pair.max_len:
            raise KVCapacityError([slot], [start], self._pair.max_len)

    def prefill_chunk(self, slot: int, tokens, start: int) -> torch.Tensor:
        """One chunked-prefill dispatch (paged sessions only): the static
        ``seq_len``-token prefill schedule at global offset ``start``,
        writing cache rows ``[start, start + seq_len)`` of slot ``slot``
        through its block table.  ``start == 0`` frees the slot's blocks
        first; a later chunk may overlap the previous one (re-writing a
        row with the same ints).  Returns the chunk's last-token logits
        [1, 1, vocab_padded]; raises :class:`KVCapacityError` (``reason
        == "pool"``) when the chunk's blocks cannot be allocated."""
        self._require("decoder", "prefill_chunk")
        self._affine("prefill_chunk")
        self._require_paged("prefill_chunk")
        self._check_slot(slot)
        tokens = self._check_tokens(tokens, 1)
        s = self._pair.seq_len
        self._zero_pos()
        start = int(start)
        if start == 0:
            self._release_blocks(slot)
        self._check_chunk(slot, start)
        self._grow_table(slot, blocks_for_rows(start + s, self._pair.kv_block_size))
        self._cow_range(slot, start, start + s)
        self._note_writes(slot, start, start + s)
        logits = self._chunk(tokens, start, self._tables[slot: slot + 1])
        self._pos[slot] = start + s
        return logits

    def prefill_chunks(self, chunks: dict) -> torch.Tensor:
        """Batched chunked prefill: one dispatch for several slots (paged
        only).  ``chunks`` maps ``slot -> (tokens, start)``, the arguments
        of :meth:`prefill_chunk`.  Lanes not named are parked on
        all-scratch block tables, so their placeholder rows land in the
        scratch block.  Every validation, release and allocation happens
        before the dispatch, so a :class:`KVCapacityError` leaves the pool
        untouched.  Returns logits [batch_size, 1, vocab_padded]; row ``b``
        is meaningful only for ``b in chunks``."""
        self._require("decoder", "prefill_chunks")
        self._affine("prefill_chunks")
        self._require_paged("prefill_chunks")
        if not chunks:
            raise ValueError("prefill_chunks needs at least one slot chunk")
        s = self._pair.seq_len
        self._zero_pos()
        checked: dict[int, tuple] = {}
        for slot, (tokens, start) in sorted(chunks.items()):
            slot, start = int(slot), int(start)
            self._check_slot(slot)
            tokens = self._check_tokens(tokens, 1)
            self._check_chunk(slot, start)
            checked[slot] = (tokens, start)
        # host state changes after all validation; release-then-grow is
        # idempotent per slot, so a pool failure midway can be retried
        for slot, (_, start) in checked.items():
            if start == 0:
                self._release_blocks(slot)
        for slot, (_, start) in checked.items():
            self._grow_table(slot, blocks_for_rows(start + s, self._pair.kv_block_size))
        for slot, (_, start) in checked.items():
            # a chunk overlapping an attached shared prefix re-writes
            # identical rows: still a write, so still copied first
            self._cow_range(slot, start, start + s)
        for slot, (_, start) in checked.items():
            self._note_writes(slot, start, start + s)
        tokens = torch.zeros((self.batch_size, s), dtype=torch.int32, device=self.device)
        starts = np.zeros((self.batch_size,), np.int32)
        tables = np.full_like(self._tables, SCRATCH_BLOCK)
        for slot, (toks, start) in checked.items():
            tokens[slot] = toks[0]
            starts[slot] = start
            tables[slot] = self._tables[slot]
        logits = self._chunk(tokens, starts, tables)
        for slot, (_, start) in checked.items():
            self._pos[slot] = start + s
        return logits

    def free_slot(self, slot: int) -> None:
        """Release one slot's KV state (paged: its blocks go back to the
        pool, shared ones lose a reference); dense sessions only reset the
        depth."""
        self._require("decoder", "free_slot")
        self._affine("free_slot")
        self._check_slot(slot)
        if self._pair.paged:
            self._release_blocks(slot)
        if self._pos is not None:
            self._pos[slot] = 0

    def attach_prefix(self, slot: int, blocks, rows: int) -> None:
        """Install a shared prefix into a free slot (paged only).

        ``blocks`` is a resident block chain covering cache rows ``[0,
        rows)`` in logical order.  Every block is forked (refcount + 1, no
        data moves) into the slot's table and the slot's depth starts at
        ``rows``: prefill then runs only on the novel suffix.  The first
        write into a still-shared block copies it (:meth:`_cow_range`), so
        the other holders never see the attach.
        """
        self._require("decoder", "attach_prefix")
        self._affine("attach_prefix")
        self._require_paged("attach_prefix")
        self._check_slot(slot)
        self._zero_pos()
        if self._slot_blocks[slot] or int(self._pos[slot]) != 0:
            raise RuntimeError(
                f"attach_prefix into live slot {slot} (pos {int(self._pos[slot])}, "
                f"{len(self._slot_blocks[slot])} blocks held); free_slot it first")
        chain = [int(b) for b in blocks]
        rows = int(rows)
        if not 1 <= rows <= self._pair.max_len:
            raise ValueError(f"attach_prefix rows must be in [1, {self._pair.max_len}], "
                             f"got {rows}")
        need = blocks_for_rows(rows, self._pair.kv_block_size)
        if len(chain) != need:
            raise ValueError(f"{rows} prefix rows cover {need} blocks of size "
                             f"{self._pair.kv_block_size}, got a chain of {len(chain)}")
        self._alloc.fork(chain, owner=slot)  # loud on any dead block
        self._tables[slot, : len(chain)] = chain
        self._slot_blocks[slot] = chain
        self._pos[slot] = rows

    def sharing_state(self, index_blocks=()) -> KVSharingState:
        """Snapshot of the pool's sharing structure: live block tables,
        per-block refcounts and (caller-supplied) a prefix index's pins."""
        self._require("decoder", "sharing_state")
        if not self._pair.paged:
            raise RuntimeError("sharing_state needs a paged session")
        return KVSharingState(
            n_blocks=self._pair.kv_blocks,
            refcounts={b: self._alloc.refcount(b) for b in range(1, self._pair.kv_blocks + 1)
                       if self._alloc.refcount(b) > 0},
            tables={b: self.block_chain(b) for b in range(self.batch_size)
                    if self._slot_blocks[b]},
            index_blocks=tuple(int(b) for b in index_blocks),
        )

    # -- paged internals ---------------------------------------------------

    def _release_blocks(self, slot: int) -> None:
        if self._slot_blocks[slot]:
            self._alloc.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
        self._tables[slot, :] = SCRATCH_BLOCK

    def _pool_capacity_error(self, slot: int) -> KVCapacityError:
        """Pool exhaustion for ``slot``, naming as evictable only the slots
        that hold at least one exclusively owned (refcount 1) block."""
        evictable = sorted(
            b for b in range(self.batch_size)
            if b != slot and any(self._alloc.refcount(blk) == 1
                                 for blk in self._slot_blocks[b])
        )
        pos = 0 if self._pos is None else int(self._pos[slot])
        return KVCapacityError([slot], [pos], self._pair.max_len, reason="pool",
                               evictable=evictable)

    def _grow_table(self, slot: int, need: int) -> None:
        """Allocate blocks until the slot's table covers ``need`` logical
        blocks; all or nothing."""
        missing = [i for i in range(need) if self._tables[slot, i] == SCRATCH_BLOCK]
        if not missing:
            return
        try:
            got = self._alloc.allocate(len(missing), owner=slot)
        except PoolExhausted:
            raise self._pool_capacity_error(slot) from None
        self._tables[slot, missing] = got
        self._slot_blocks[slot].extend(got)

    def _cow_range(self, slot: int, lo: int, hi: int) -> None:
        """Copy-on-write every shared block ``slot`` is about to write in
        cache rows ``[lo, hi)``: a whole-block copy on the device, in
        place in the pool, and the table and chain patched."""
        if hi <= lo:
            return
        bsz = self._pair.kv_block_size
        for i in range(lo // bsz, blocks_for_rows(hi, bsz)):
            blk = int(self._tables[slot, i])
            if blk == SCRATCH_BLOCK or self._alloc.refcount(blk) <= 1:
                continue
            try:
                fresh, copied = self._alloc.cow(blk, owner=slot)
            except PoolExhausted:
                raise self._pool_capacity_error(slot) from None
            assert copied, (slot, blk)
            for part in ("k", "v"):
                self._pool[part][:, fresh] = self._pool[part][:, blk]
            self._tables[slot, i] = fresh
            chain = self._slot_blocks[slot]
            chain[chain.index(blk)] = fresh
            self._cow_copies += 1

    def _note_writes(self, slot: int, lo: int, hi: int) -> None:
        """Tell the shadow block sanitizer (``REPRO_SANITIZE=1``) that the
        next dispatch writes ``slot``'s cache rows ``[lo, hi)``: it fails
        with BLK001 (freed block) or BLK003 (still-shared block, i.e. a
        skipped copy-on-write) here, on the host and before the launch,
        instead of letting the scatter corrupt another request's rows.
        Reads the host-side block table only."""
        shadow = self._alloc.shadow
        if shadow is None or hi <= lo:
            return
        bsz = self._pair.kv_block_size
        for i in range(lo // bsz, blocks_for_rows(hi, bsz)):
            blk = int(self._tables[slot, i])
            if blk != SCRATCH_BLOCK:
                shadow.write(slot, blk, self._alloc)

    def decode(self, tokens, pos=None, *, active=None) -> torch.Tensor:
        """One batched decode dispatch.

        ``tokens`` int32 [B] or [B, 1]: the next token of each request.
        ``pos`` int32 [B]: each request's depth (default: the session's
        host-side depths).  Slot ``b`` rotates by ``pos[b]``, appends its
        K/V at cache row ``pos[b]`` and attends rows ``[0, pos[b]]``.  A
        slot at ``max_len`` raises :class:`KVCapacityError` before any
        write.  Returns logits [B, 1, vocab_padded]; active depths advance
        to ``pos + 1``.

        ``active`` (paged sessions only) is a per-lane bool mask: parked
        lanes still ride in the dispatch, but they write into the scratch
        block, skip the capacity checks and keep their depth.
        """
        self._require("decoder", "decode")
        self._affine("decode")
        paged = self._pair.paged
        if (self._pos is None) if paged else (self._kv is None):
            raise RuntimeError("decode before prefill: no KV state in the session")
        if active is not None and not paged:
            raise ValueError("active lane masks are a paged-session feature (dense "
                             "dispatches park free lanes at pos 0 instead)")
        tokens = torch.as_tensor(tokens).to(device=self.device, dtype=torch.int32)
        if tokens.dim() == 1:
            tokens = tokens[:, None]
        if tuple(tokens.shape) != (self.batch_size, 1):
            raise ValueError(
                f"decode tokens must be [{self.batch_size}, 1], got {tuple(tokens.shape)}")
        pos = self._pos if pos is None else np.asarray(
            pos.cpu() if isinstance(pos, torch.Tensor) else pos, np.int32)
        if pos.shape != (self.batch_size,):
            raise ValueError(
                f"pos must be a per-request vector [{self.batch_size}], got {pos.shape}")
        act = np.ones((self.batch_size,), bool) if active is None else np.asarray(
            active.cpu() if isinstance(active, torch.Tensor) else active, bool).reshape(-1)
        if act.shape != (self.batch_size,):
            raise ValueError(
                f"active must be a per-request mask [{self.batch_size}], got {act.shape}")
        # a write past the region would raise inside the cache write (the
        # reference's scatter would clamp it onto the last row): bound it
        # first, naming the slots, so nothing is written
        full = [b for b in range(self.batch_size)
                if act[b] and int(pos[b]) >= self._pair.max_len]
        if full:
            raise KVCapacityError(full, [int(pos[b]) for b in full], self._pair.max_len)
        if paged:
            from repro_torch.deploy.executor import execute_decode_paged

            # a lane crossing into a new logical block allocates it first:
            # pool exhaustion raises before the pool changes
            bs = self._pair.kv_block_size
            for b in range(self.batch_size):
                if act[b] and int(pos[b]) % bs == 0:
                    self._grow_table(b, int(pos[b]) // bs + 1)
            for b in range(self.batch_size):
                if act[b]:
                    self._cow_range(b, int(pos[b]), int(pos[b]) + 1)
                    self._note_writes(b, int(pos[b]), int(pos[b]) + 1)
            logits, self._pool = execute_decode_paged(
                self._pair, self.weights, self._pool, tokens, torch.from_numpy(pos.copy()),
                torch.from_numpy(self._tables.copy()).to(self.device),
                torch.from_numpy(act), backend=self.backend, table=self.table)
        else:
            from repro_torch.deploy.executor import execute_decode

            logits, cache = execute_decode(self._pair, self.weights, self._kv, tokens,
                                           pos=pos, backend=self.backend, table=self.table)
            self._kv = {"k": cache["k"], "v": cache["v"]}
        self._pos = np.where(act, pos + 1,
                             self._pos if self._pos is not None else 0).astype(np.int32)
        return logits
