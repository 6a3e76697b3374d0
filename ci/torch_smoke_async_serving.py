"""CI smoke of the PyTorch port: HTTP frontend, 8 concurrent streams, SLOs
and graceful drain.

    PYTHONPATH=src python ci/torch_smoke_async_serving.py [--device cpu]
    REPRO_SANITIZE=1 PYTHONPATH=src python ci/torch_smoke_async_serving.py

The twin of ``ci/smoke_async_serving.py`` over ``repro_torch``: the same
undersized pool, traffic and asserts, on the card unless ``--device cpu``.
Run plain and again with ``REPRO_SANITIZE=1`` (the lockdep runtime
checker and the shadow block sanitizer must stay silent under real
concurrent traffic — the script asserts zero findings when enabled).
The prompts come from a seeded ``numpy.random.Generator``.
"""

import argparse
import json
import os
import tempfile
import threading
import urllib.error

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.deploy import api, sanitize
from repro_torch.deploy.serving import AsyncEngine, ServingFrontend
from repro_torch.deploy.serving.scheduler import PriorityDeadline
from repro_torch.launch.cli import http_generate, http_get_json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced(get_config("olmo-1b"))
    SEQ, GEN = 8, 4
    # deliberately undersized paged pool (6 blocks = 24 rows for up
    # to 4 residents) so tight-deadline traffic exercises the
    # preemption/kv_capacity paths, not just the happy path
    model = api.compile(cfg, backend="w8a8", seq_len=SEQ,
                        max_len=SEQ + GEN + 2, kv_block_size=4,
                        kv_blocks=6, use_cache=False)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "plan_served.json"))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, SEQ)] for _ in range(8)]

    eng = AsyncEngine(model, 4, scheduler=PriorityDeadline(max_queue=6),
                      device=args.device)
    fe = ServingFrontend(eng, port=0)
    host, port = fe.start()
    done, shed, errors = {}, [], []

    def client(i):
        # two urgent requests carry a tight completion deadline on
        # the undersized pool; the rest are background traffic
        slo = (dict(priority=0, ttft_slo_ms=60_000.0, deadline_ms=50.0)
               if i < 2 else dict(priority=5))
        try:
            try:
                events = list(http_generate(host, port, prompts[i], GEN,
                                            timeout=120, **slo))
            except urllib.error.HTTPError as e:
                assert e.code == 429, e
                body = json.loads(e.read().decode())
                assert body["retry_after_s"] > 0, body
                shed.append(i)
                return
            final = events[-1]
            assert final["done"], final
            toks = [ev["token"] for ev in events if "token" in ev]
            assert toks == final["tokens"], (toks, final)
            if final["finish_reason"] == "shed":
                # displaced by a higher-ranked arrival while queued
                assert final["tokens"] == [], final
                shed.append(i)
                return
            done[i] = final
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors

    # every request completed or was shed (429 backpressure or queue
    # displacement), and every completed stream ended with a structured
    # finish reason
    assert len(done) + len(shed) == 8, (done, shed)
    assert all(f["finish_reason"] in ("length", "kv_capacity")
               for f in done.values()), done
    stats = http_get_json(host, port, "/v1/stats")
    assert stats["requests_completed"] == len(done), stats
    assert stats["shed_requests"] == len(shed), stats
    assert stats["tokens_generated"] == sum(
        len(f["tokens"]) for f in done.values()), stats
    st = http_get_json(host, port,
                       f"/v1/status/{next(iter(done.values()))['rid']}")
    assert st["status"] == "done", st

    # the sanitizer (when enabled) must be silent after real traffic
    assert stats["sanitize"]["enabled"] == sanitize.enabled(), stats
    if sanitize.enabled():
        for k in ("lockdep_findings", "shadow_findings", "audit_findings"):
            assert stats["sanitize"][k] == 0, stats["sanitize"]
        alloc = eng.engine.session.allocator
        assert alloc.shadow.audit(alloc) == []

    fe.shutdown(drain=True, timeout=120)  # graceful: engine idles
    try:
        http_get_json(host, port, "/healthz")
    except urllib.error.URLError:
        tag = " [REPRO_SANITIZE=1]" if sanitize.enabled() else ""
        print(f"async serving smoke{tag} on {eng.engine.session.device}: 8 streams ->",
              f"{len(done)} completed / {len(shed)} shed,",
              f"{stats['preemptions']} preemptions; listener closed")
    else:
        raise AssertionError("listener still up after shutdown")


if __name__ == "__main__":
    main()
