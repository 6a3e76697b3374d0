"""CI smoke of the PyTorch port: shared prompts over an undersized pool,
copy-on-write audit clean.

    PYTHONPATH=src python ci/torch_smoke_prefix_cache.py [--device cpu]
    REPRO_SANITIZE=1 PYTHONPATH=src python ci/torch_smoke_prefix_cache.py

The twin of ``ci/smoke_prefix_cache.py`` over ``repro_torch``: the same
pool, schedule and asserts, on the card unless ``--device cpu``.  Run
plain and again with ``REPRO_SANITIZE=1`` (the shadow block sanitizer
mirrors every fork/COW/free of the prefix-cache traffic and must end with
zero findings).  The prompt comes from a seeded ``numpy.random.Generator``.
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.deploy import api, sanitize
from repro_torch.deploy.engine import Engine, RequestStatus


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced(get_config("olmo-1b"))
    SEQ, GEN, PROMPT = 8, 3, 32
    # pool holds ~1.5 prompts' worth of blocks — 8 shared-prompt
    # requests only fit because matches fork resident blocks
    model = api.compile(cfg, backend="w8a8", seq_len=SEQ,
                        max_len=PROMPT + GEN + 1, kv_block_size=4,
                        kv_blocks=14, prefix_cache=True,
                        use_cache=False)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "plan_prefix.json"))
    prompt = [int(t) for t in np.random.default_rng(0).integers(0, cfg.vocab, PROMPT)]

    eng = Engine(model, 4, device=args.device)
    handles = [eng.submit(list(prompt), GEN) for _ in range(8)]
    stats = eng.run_until_idle(max_steps=5000)
    # complete-or-shed: every request finished with a structured
    # reason; nobody hung, nobody crashed the pool
    assert all(h.status is RequestStatus.DONE for h in handles)
    assert all(h.finish_reason in ("length", "kv_capacity")
               for h in handles), [h.finish_reason for h in handles]
    assert stats.prefix_hits > 0, stats.summary()
    assert stats.full_prefix_hits > 0, stats.summary()
    # one request's worth of prompt tokens prefilled, not eight
    assert stats.prompt_tokens_prefilled <= PROMPT, stats.summary()
    assert eng.audit_sharing(strict=True) == []

    if sanitize.enabled():
        # shadow mirrored every fork/COW/free of the run: zero findings
        alloc = eng.session.allocator
        assert alloc.shadow.findings == []
        assert alloc.shadow.audit(alloc) == []
        assert sanitize.runtime_findings() == ()

    tag = " [REPRO_SANITIZE=1]" if sanitize.enabled() else ""
    print(f"prefix smoke{tag} on {eng.session.device}:", stats.summary())


if __name__ == "__main__":
    main()
