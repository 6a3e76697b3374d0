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
each request slot at its own depth.  Sessions of either backend run on
the CUDA device unless the caller passes ``device="cpu"``; with no card
and no explicit CPU request they raise.

Not ported yet: the paged KV region and the prefix cache (ROADMAP queue
1, item 3), the request-level ``Engine`` (item 4), the static plan
verifier (``verify=``) and autotuning (item 5), and the head-by-head
schedule (item 2).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading

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
from repro_torch.deploy.plan import DecoderPlanPair, DeploymentPlan

#: The JAX package's compiler version: both packages lower the same plans.
COMPILER_VERSION = 5

_PAYLOAD_FORMAT = "repro.deploy.api/compiled-model"  # shared payload schema id


class KVCapacityError(ValueError):
    """A decode dispatch cannot fit the dense KV region: a slot's depth
    reached the compiled ``max_len``.

    Attributes: ``slots`` (the offending slot indices), ``pos`` (their
    depths, same order) and ``max_len``, so that a scheduler can evict
    exactly those slots.
    """

    def __init__(self, slots, pos, max_len: int):
        self.slots = tuple(int(s) for s in slots)
        self.pos = tuple(int(p) for p in pos)
        self.max_len = int(max_len)
        super().__init__(
            f"KV region full: slot(s) {list(self.slots)} at pos {list(self.pos)} >= "
            f"max_len {self.max_len}; re-admit via prefill_slot or compile with a "
            "larger max_len"
        )


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
) -> CompiledModel:
    """Compile one config into its deployment artifact, cached on disk.

    The engine mapping is solved at the granule of the execution
    ``backend`` (64 for the W8A8 arithmetic, 128 for the kernels), so the
    plan's engine column matches ``DispatchTable.resolve`` at run time.
    Dense decoders lower to a :class:`DecoderPlanPair` with a KV region of
    ``max_len`` tokens a slot (default ``seq_len + 1``), fused into
    ``FusedRegion`` nodes unless ``fuse=False``; encoder plans ignore
    ``fuse`` and lower unfused.  The cache key is
    ``config_fingerprint(cfg, options)`` with the JAX package's option
    set, so both packages fingerprint a config identically.

    Not ported yet, and refused with ``NotImplementedError``: the paged
    KV region (``kv_block_size`` / ``kv_blocks``) and ``prefix_cache``
    (ROADMAP queue 1, item 3), and ``autotune`` (item 5).  Raises
    :class:`UnsupportedFamilyError` for families the port cannot lower.
    """
    if (kv_block_size is None) != (kv_blocks is None):
        raise ValueError(
            "kv_block_size and kv_blocks come as a pair (both set the "
            "paged KV region, both absent keeps the dense region)"
        )
    if kv_block_size is not None or kv_blocks is not None:
        raise NotImplementedError(
            "the paged KV region (kv_block_size/kv_blocks) is not ported yet "
            "(ROADMAP queue 1, item 3)")
    if prefix_cache:
        raise NotImplementedError(
            "prefix_cache needs the paged KV region, which is not ported yet "
            "(ROADMAP queue 1, item 3)")
    if autotune:
        raise NotImplementedError(
            "autotune needs the cost model, which is not ported yet (ROADMAP queue 1, item 5)")
    be = as_backend(backend)
    granule = backend_granule(be)
    s = seq_len or cfg.max_seq
    is_decoder = is_dense_decoder(cfg)
    fuse = bool(fuse) and is_decoder
    options = {
        "backend": be.value,
        "granule": granule,
        "seq_len": s,
        "max_len": (max_len or s + 1) if is_decoder else 0,
        "kv_block_size": 0,
        "kv_blocks": 0,
        "head_by_head": head_by_head,
        "include_head": include_head,
        "fuse": fuse,
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
                     max_len=max_len, granule=granule, fuse=fuse)
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
    """Stateful runtime surface over one compiled artifact.

    Encoder: :meth:`forward`.  Decoder: :meth:`prefill` /
    :meth:`prefill_slot` fill the statically planned, batched KV region;
    :meth:`decode` advances all ``batch_size`` request slots by one token
    in one plan dispatch, each slot at its own depth (``pos`` is a
    per-request vector, kept on the host).  Every runner is row-local, so
    slot ``b`` computes the same ints as a lone request at depth
    ``pos[b]``.  The KV region lives on the session's device and is
    written in place.

    **Thread affinity**: the KV state and the depths have no locking, so
    a session belongs to one thread at a time.  The first mutating call
    (prefill, prefill_slot, decode) binds it to the calling thread;
    mutating from another thread raises ``RuntimeError``.  Hand a session
    over explicitly with :meth:`rebind_thread`.
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
        weights, _ = model.bind(params=params, qp=qp, seed=seed)
        self.weights = {k: v.to(self.device) for k, v in weights.items()}
        if model.kind == "decoder":
            self._pair = model.artifact
            self._kv = None  # {"k": [L, B, Hkv, max_len, D] int8, "v": ...}
            self._pos = None  # host int32 [B]: each slot's depth
            plans = (self._pair.prefill, self._pair.decode)
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

    def prefill(self, tokens) -> torch.Tensor:
        """Prefill every slot with one prompt each: tokens int32 [B, S].
        Returns the last-token logits [B, 1, vocab_padded] and sets every
        slot's depth to ``S``."""
        self._require("decoder", "prefill")
        self._affine("prefill")
        logits, cache = self._prefill(self._check_tokens(tokens, self.batch_size))
        self._kv = {"k": cache["k"], "v": cache["v"]}
        self._pos = np.full((self.batch_size,), self._pair.seq_len, np.int32)
        return logits

    def prefill_slot(self, slot: int, tokens) -> torch.Tensor:
        """Admit a new request into one slot: the prefill schedule runs at
        batch 1 and its KV rows and depth are installed in slot ``slot``;
        the other slots' rows and depths are untouched, so they keep
        decoding.  Returns the prompt's last-token logits [1, 1,
        vocab_padded]."""
        self._require("decoder", "prefill_slot")
        self._affine("prefill_slot")
        if not 0 <= slot < self.batch_size:
            raise IndexError(f"slot {slot} out of range [0, {self.batch_size})")
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

    def decode(self, tokens, pos=None) -> torch.Tensor:
        """One batched decode dispatch.

        ``tokens`` int32 [B] or [B, 1]: the next token of each request.
        ``pos`` int32 [B]: each request's depth (default: the session's
        host-side depths).  Slot ``b`` rotates by ``pos[b]``, appends its
        K/V at cache row ``pos[b]`` and attends rows ``[0, pos[b]]``.  A
        slot at ``max_len`` raises :class:`KVCapacityError` before any
        write.  Returns logits [B, 1, vocab_padded]; depths advance to
        ``pos + 1``.
        """
        from repro_torch.deploy.executor import execute_decode

        self._require("decoder", "decode")
        self._affine("decode")
        if self._kv is None:
            raise RuntimeError("decode before prefill: no KV state in the session")
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
        # a write past the region would raise inside the cache write (the
        # reference's dynamic_update_slice would clamp it onto the last
        # row): bound it first, naming the slots, so nothing is written
        full = [b for b in range(self.batch_size) if int(pos[b]) >= self._pair.max_len]
        if full:
            raise KVCapacityError(full, [int(pos[b]) for b in full], self._pair.max_len)
        logits, cache = execute_decode(self._pair, self.weights, self._kv, tokens, pos=pos,
                                       backend=self.backend, table=self.table)
        self._kv = {"k": cache["k"], "v": cache["v"]}
        self._pos = (pos + 1).astype(np.int32)
        return logits
