"""Plain float32 forward of the DeepSeek MoE configurations, with their
multi-head or latent attention.

A straightforward implementation of the semantics that the serving
engine runs, independent of the program: it imports nothing of
``repro_torch``, runs every product in float32 with TF32 off, and reads
only the benchmark's weights (bf16 views, cast to float32 one layer at a
time, so that it fits beside them on the card). Each sequence is a prompt
and the tokens served after it; the forward returns the logits at the
positions that produced each served token.

What it computes, and where that departs from the published models (the
configuration files list the same):

* embedding rows; pre-norm residual blocks; RMSNorm ``x / rms(x) * (1 +
  scale)`` with eps 1e-6; a final norm and an untied LM head;
* RoPE on interleaved pairs ``(x[2i], x[2i + 1])`` at ``theta ** (-2i /
  dim)`` (no YaRN scaling, where DeepSeek-V2-Lite publishes one);
* multi-head attention with a causal mask, or MLA: queries ``x W_q``
  split into a no-RoPE and a RoPE part, the latent ``RMSNorm(x W_dkv[:
  rank])`` and one shared RoPE key ``x W_dkv[rank:]``, per-head keys and
  values ``c W_uk`` and ``c W_uv``, scale ``1 / sqrt(nope + rope)``;
* a SwiGLU FFN in the first ``first_k_dense_replace`` layers, else an MoE:
  softmax over the router's logits, the top-k (ties to the lower expert),
  their weights renormalised to sum to 1 (the published configs say
  ``norm_topk_prob: false``), the shared experts on every token. A
  prompt's assignments beyond ``capacity_factor`` times an expert's mean
  load are dropped in k-major order (every token's first choice, then
  every second...), as the engine's prefill of that prompt alone does;
  the served tokens' assignments are never dropped (the published model
  drops none).

``quant="fp8"`` is the control: every product but the router's takes its
operands rounded to float8 e4m3 (the weights scaled per output column,
the activations per row), accumulating in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

EPS = 1e-6
FP8_MAX = 448.0
#: query rows of one block of attention scores
Q_BLOCK = 1024


def set_precision() -> None:
    """float32 products in float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale along ``dim`` (its
    largest magnitude maps to 448), back in float32."""
    scale = t.abs().amax(dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Layer:
    """One layer's weights in float32 (rounded to fp8 first for the
    control), and the product every projection goes through."""

    def __init__(self, weights: Dict[str, torch.Tensor], prefix: str,
                 quant: Optional[str]):
        self.quant = quant
        self.w = {}
        for name, t in weights.items():
            if name.startswith(prefix):
                t = t.float()
                if quant and t.dim() >= 2 and not name.endswith("router.w"):
                    t = fp8(t, -2)
                self.w[name[len(prefix):]] = t

    def mm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.matmul(x, self.w[name])

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant:
            x = fp8(x, -1)
        return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) \
        * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (N, heads, dim) at positions 0..N-1: each pair turned by its
    position times ``theta ** (-2i / dim)``, the angles in float64."""
    n, dim = x.shape[0], x.shape[-1]
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64,
                                  device=x.device) / dim)
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv
    turn = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    pairs = torch.view_as_complex(x.reshape(*x.shape[:-1], dim // 2, 2)
                                  .contiguous())
    return torch.view_as_real(pairs * turn[:, None, :]).reshape(x.shape)


def causal_attention(scores_of, values: torch.Tensor, n: int,
                     scale: float) -> torch.Tensor:
    """Softmax attention over the causal past, in blocks of query rows:
    ``scores_of(lo, hi)`` gives the (heads, hi - lo, n) raw scores of the
    queries lo..hi; ``values`` is (n, heads, dv). Returns (n, heads, dv)."""
    out = []
    key = torch.arange(n, device=values.device)
    for lo in range(0, n, Q_BLOCK):
        hi = min(lo + Q_BLOCK, n)
        s = scores_of(lo, hi) * scale
        mask = key[None, :] > torch.arange(lo, hi, device=key.device)[:, None]
        s = s.masked_fill(mask[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", p, values))
    return torch.cat(out)


def attention(cfg: dict, lw: Layer, x: torch.Tensor) -> torch.Tensor:
    n, h = x.shape[0], cfg["num_attention_heads"]
    theta = float(cfg["rope_theta"])
    if cfg.get("kv_lora_rank"):
        r, dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
        dn, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
        q = lw.mm(x, "mixer.wq.w").view(n, h, dn + dr)
        q_nope, q_rope = q[..., :dn], rope(q[..., dn:], theta)
        ckr = lw.mm(x, "mixer.wdkv.w")
        c = rms_norm(ckr[:, :r], lw.w["mixer.kv_norm.scale"])
        k_rope = rope(ckr[:, None, r:], theta)[:, 0]
        k_nope = lw.mm(c, "mixer.wuk.w").view(n, h, dn)
        v = lw.mm(c, "mixer.wuv.w").view(n, h, dv)

        def scores(lo, hi):
            return (torch.einsum("qhd,khd->hqk", q_nope[lo:hi], k_nope)
                    + torch.einsum("qhd,kd->hqk", q_rope[lo:hi], k_rope))
        out = causal_attention(scores, v, n, 1.0 / math.sqrt(dn + dr))
    else:
        hd, hkv = cfg["hidden_size"] // h, cfg["num_key_value_heads"]
        q = rope(lw.mm(x, "mixer.wq.w").view(n, h, hd), theta)
        k = rope(lw.mm(x, "mixer.wk.w").view(n, hkv, hd), theta)
        v = lw.mm(x, "mixer.wv.w").view(n, hkv, hd)
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)

        def scores(lo, hi):
            return torch.einsum("qhd,khd->hqk", q[lo:hi], k)
        out = causal_attention(scores, v, n, 1.0 / math.sqrt(hd))
    return lw.mm(out.reshape(n, -1), "mixer.wo.w")


def swiglu(lw: Layer, x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    return lw.matmul(torch.nn.functional.silu(lw.matmul(x, gate))
                     * lw.matmul(x, up), down)


def route(cfg: dict, logits: torch.Tensor, n_prompt: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts (N, k), weights (N, k)) of one sequence's tokens; the
    weight of a dropped assignment is 0."""
    k, n_exp = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    w = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    if n_prompt:
        cap = min(max(math.ceil(n_prompt * k * cfg["capacity_factor"]
                                / n_exp), k), n_prompt)
        order = idx[:n_prompt].T.reshape(-1)                # k-major
        onehot = torch.nn.functional.one_hot(order, n_exp)
        seen = (torch.cumsum(onehot, 0) * onehot).amax(-1)  # 1-based
        kept = (seen <= cap).reshape(k, n_prompt).T
        w = torch.cat([w[:n_prompt] * kept, w[n_prompt:]])
    return idx, w


def moe(cfg: dict, lw: Layer, xs: List[torch.Tensor],
        n_prompts: Sequence[int]) -> List[torch.Tensor]:
    """The MoE FFN of every sequence: routing per sequence, the experts
    over all of them at once."""
    x = torch.cat(xs)
    logits = x @ lw.w["ffn.router.w"]
    idx, w = zip(*(route(cfg, lg, p) for lg, p in
                   zip(torch.split(logits, [len(t) for t in xs]), n_prompts)))
    idx, w = torch.cat(idx), torch.cat(w)
    k, n_exp = idx.shape[1], cfg["n_routed_experts"]
    token = torch.arange(x.shape[0], device=x.device).repeat_interleave(k)
    flat_e, flat_w = idx.reshape(-1), w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=n_exp).tolist()
    y = torch.zeros_like(x)
    start = 0
    for e, cnt in enumerate(counts):
        sel = order[start:start + cnt]
        start += cnt
        if cnt == 0:
            continue
        rows = token[sel]
        out = swiglu(lw, x[rows], lw.w["ffn.experts.gate.w"][e],
                     lw.w["ffn.experts.up.w"][e],
                     lw.w["ffn.experts.down.w"][e])
        y.index_add_(0, rows, out * flat_w[sel, None])
    y = y + swiglu(lw, x, lw.w["ffn.shared.gate.w"], lw.w["ffn.shared.up.w"],
                   lw.w["ffn.shared.down.w"])
    return list(torch.split(y, [len(t) for t in xs]))


def served_logits(cfg: dict, weights: Dict[str, torch.Tensor],
                  seqs: Sequence[Tuple[Sequence[int], Sequence[int]]],
                  device, quant: Optional[str] = None) -> List[torch.Tensor]:
    """For each (prompt, served tokens) pair, the float32 logits (T,
    vocab) at the T positions that produced the served tokens: the
    prompt's last and each served token but the last."""
    set_precision()
    toks = [torch.as_tensor(list(p) + list(s)[:-1], dtype=torch.int64,
                            device=device) for p, s in seqs]
    n_prompts = [len(p) for p, _ in seqs]
    table = weights["embed.table"]
    hs = [table[t].float() for t in toks]
    for i in range(cfg["num_hidden_layers"]):
        lw = Layer(weights, f"blocks.{i}.", quant)
        hs = [h + attention(cfg, lw, rms_norm(h, lw.w["norm1.scale"]))
              for h in hs]
        normed = [rms_norm(h, lw.w["norm2.scale"]) for h in hs]
        if i < cfg["first_k_dense_replace"]:
            ffn = [swiglu(lw, x, lw.w["ffn.gate.w"], lw.w["ffn.up.w"],
                          lw.w["ffn.down.w"]) for x in normed]
        else:
            ffn = moe(cfg, lw, normed, n_prompts)
        hs = [h + f for h, f in zip(hs, ffn)]
        del lw
    head = Layer(weights, "lm_head.", quant)
    scale = weights["final_norm.scale"].float()
    return [head.mm(rms_norm(h[p - 1:], scale), "w")
            for h, p in zip(hs, n_prompts)]
