"""Plain integer forward of OLMo-1B as the ``ita`` deployment flow serves it.

Per layer: non-parametric integer LayerNorm, the Q, K and V projections,
integer RoPE on Q and K, causal flash-ITAMax attention, the output
projection, the residual add, a second LayerNorm, the SwiGLU MLP (integer
SiLU of the gate times the up projection, requantized, then the down
projection) and the residual add; the final LayerNorm and the tied LM
head, ``float32(h @ table.T) * s_act * s_w``.

One full forward over a prompt and the tokens served after it.  Flash
attention's result depends on how the keys are cut into blocks, and the
configuration fixes the cut: a prompt row walks the keys in blocks of
``prefill_block_k`` (512) from row 0, a generated row sees all its keys
in one block (``decode_block_k`` covers the whole context).  A block in
which every key is masked leaves the state as it was, so the keys past a
row do not matter.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference import intops as I


def _rope_tables(n_rows: int, head_dim: int, theta: float, device):
    """The Q0.7 tables of rows [0, n), from a table over a power of two of
    rows (the vectorised float32 cos/sin then see the same lengths)."""
    n = max(64, 1 << (max(n_rows, 1) - 1).bit_length())
    c, s = I.rope_tables(np.arange(n), head_dim, theta, device)
    return c[:n_rows], s[:n_rows]


def _attention(arch, sc, q, k, v, prompt_len: int, prec: I.Prec):
    """Causal attention of every row [H, T, D], cut into blocks as served."""
    t = q.shape[-2]
    dev = q.device
    s = sc["s_act"]
    rows = torch.arange(t, device=dev)
    out = torch.empty_like(q)
    bk = arch["prefill_block_k"]
    p = min(prompt_len, t)
    if p:
        blocks = [(j, min(j + bk, t)) for j in range(0, p, bk)]
        out[:, :p] = I.flash_attention(q[:, :p], k, v, s, s, s, s, blocks, rows[:p], prec)
    if t > p:
        out[:, p:] = I.flash_attention(q[:, p:], k, v, s, s, s, s, [(0, t)], rows[p:], prec)
    return out


def _layer(arch, sc, lp, x, c, s, prompt_len, prec):
    s_act, s_w, s_res = sc["s_act"], sc["s_w"], sc["s_res"]
    h, hkv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    t = x.shape[0]

    def lin(p, u):
        return I.qlinear(u, p["w_q"], p.get("b_q"), s_act, s_w, s_act, prec=prec)

    hq = I.layernorm_np(x, s_act, prec)
    qkv = lin(lp["attn"]["wqkv"], hq)
    qm, km, vm = qkv.split([h * hd, hkv * hd, hkv * hd], -1)
    q = I.rope(qm.reshape(t, h, hd).permute(1, 0, 2), c, s, prec)
    k = I.rope(km.reshape(t, hkv, hd).permute(1, 0, 2), c, s, prec)
    v = vm.reshape(t, hkv, hd).permute(1, 0, 2)
    if h != hkv:
        k, v = (u.repeat_interleave(h // hkv, dim=0) for u in (k, v))
    a = _attention(arch, sc, q, k, v, prompt_len, prec)
    x = I.iadd(x, lin(lp["attn"]["wo"], a.permute(1, 0, 2).reshape(t, h * hd)),
               s_res, s_act, s_res, prec)
    hq = I.layernorm_np(x, s_act, prec)
    g, u = lin(lp["mlp"]["gate"], hq), lin(lp["mlp"]["up"], hq)
    prod = I.requantize(I.i32(I.silu(g, s_act, s_act)) * I.i32(u),
                        *I.make_qparams(s_act, s_act, s_act), prec=prec)
    return I.iadd(x, lin(lp["mlp"]["down"], prod), s_res, s_act, s_res, prec)


def logits_at(arch: dict, scales: dict, qp: dict, tokens, prompt_len: int, rows,
              *, prec: I.Prec = I.INT8) -> torch.Tensor:
    """float32 [len(rows), vocab_padded]: the LM head at ``rows`` of one
    sequence (a prompt of ``prompt_len`` tokens and the tokens served
    after it)."""
    table = prec.snap(qp["embed"]["table_q"])
    dev = table.device
    tok = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
    x = table[tok]
    c, s = _rope_tables(len(tokens), arch["head_dim"], arch["rope_theta"], dev)
    for lp in qp["layers"]:
        x = _layer(arch, scales, lp, x, c, s, prompt_len, prec)
    hq = I.layernorm_np(x[torch.as_tensor(list(rows), device=dev)], scales["s_act"], prec)
    return I.imatmul(hq, table.T).to(torch.float32) * (scales["s_act"] * scales["s_w"])
