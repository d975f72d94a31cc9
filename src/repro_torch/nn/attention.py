"""Grouped-query attention with RoPE and optional qk-norm,
cross-attention, and the decode KV cache — ``repro/nn/attention.py``.

Layouts (the reference's): q proj ``(d_model, n_heads * d_head)`` "wq",
k/v ``(d_model, n_kv * d_head)`` "wk"/"wv", out ``(n_heads * d_head,
d_model)`` "wo". After the projections, qk-norm and RoPE, the attention
itself is ``kernels/flash_attention/ops.py::flash_attention``: the
hand-written CUDA kernel on the card, its plain version on the CPU. It
follows the Pallas flash kernel's contract, which differs from the
reference ``mha``'s einsums in one place: the softmax probabilities stay
float32 for P.V, where the reference rounds them to the activation type
first. In float32 the two agree up to the order of summation; in bf16
the port is the more precise. Cross-attention (``mha(kv_x=)``: queries
from x, keys and values from an encoder's states, no RoPE and no mask)
runs through the same kernel with the key length apart from the query
length, where the reference computes it with the same plain einsums.

Q-chunked attention (``set_attention_chunking``): the reference attends
query block by query block under a ``lax.map``, so that its score buffer
is (B, H, chunk, S) and never (B, H, S, S). On the CPU the port's plain
version does the same (``_chunked_self_attention``, the flash
contract's arithmetic a chunk at a time); on the card the flash kernel
already never forms the (S, S) scores, so it runs unchanged under any
chunking. Chunking applies, as in the reference, only to self-attention
with ``S > chunk`` and ``S % chunk == 0``.

Decode (``init_cache``, ``mha_decode``) is plain PyTorch, as the
reference's is plain ``jnp``: one query row against the whole cache
buffer under a ``NEG_INF`` additive bias, scores and softmax in float32,
the probabilities rounded to the activation type for P.V. The cache is
updated in place (the reference returns a new one). Cross-attention
decode (``cross_kv``, ``precompute_cross_kv``'s encoder K/V) attends
over every encoder position under a zero bias and leaves the self cache
as it is. The int8 cache (``init_cache(kv_int8=True)``) holds int8 k
and v with float32 per-(token, head) scales, each the amax over hd over
127 (``_quantize_kv``); a decode step writes the new token's payload and
scales in place and attends over the whole cache dequantized to the
activation type, as the reference does. A prefill into an int8 cache
(``mha(kv_int8=True)``) runs the flash kernel over the dequantized k and
v, which is what the reference's decode steps attend over.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     on_head_shards)
from repro_torch.nn.module import (dense_init, quantize_absmax, rmsnorm,
                                   rmsnorm_init, truncated_normal_init)

NEG_INF = -1e30

# The query chunk of self-attention (``set_attention_chunking``): None
# attends over all queries at once.
_CHUNK = {"q_chunk": None}


def set_attention_chunking(q_chunk: Optional[int]) -> None:
    _CHUNK["q_chunk"] = q_chunk


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n, d_head); positions: (..., S) or (S,)."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, device=x.device)      # (d_head/2,)
    angles = positions[..., None].float() * freqs           # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_init(gen, d_model: int, n_heads: int, n_kv: int, d_head: int,
                   qk_norm: bool = False, param_dtype=torch.float32,
                   lead=(), device=None):
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(gen, d_model, n_heads * d_head, param_dtype, **kw),
        "wk": dense_init(gen, d_model, n_kv * d_head, param_dtype, **kw),
        "wv": dense_init(gen, d_model, n_kv * d_head, param_dtype, **kw),
        "wo": {"kernel": truncated_normal_init(
            gen, (*lead, n_heads * d_head, d_model),
            (n_heads * d_head) ** -0.5, param_dtype, device)},
    }
    if qk_norm:
        p["q_norm"] = rmsnorm_init(d_head, param_dtype, **kw)
        p["k_norm"] = rmsnorm_init(d_head, param_dtype, **kw)
    return p


def _proj(w, x: torch.Tensor, n: int, d_head: int) -> torch.Tensor:
    k = w["kernel"]
    y = shd.grad_like(shd.splittable(
        torch.matmul(shd.matmul_ready(x, k), k.to(x.dtype)), -1, n))
    return y.reshape(*x.shape[:-1], n, d_head)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(S_q, S_k) additive float32 bias: 0 where query position ``q_pos``
    may attend key position ``k_pos``, ``NEG_INF`` elsewhere."""
    qp, kp = q_pos[:, None], k_pos[None, :]
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (qp - kp < window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _chunked_self_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool,
                            window: Optional[int], qc: int) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, S, KV, hd): exact attention one block of
    ``qc`` queries at a time, each block's scores (B, KV, G, qc, S).
    Float32 scores, softmax and P.V, rounded once to q's dtype (the flash
    kernel's contract). Returns (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(S, device=q.device)
    out = []
    for lo in range(0, S, qc):
        s = torch.einsum("bsngh,btnh->bngst", qg[:, lo:lo + qc], kf)
        bias = _mask_bias(k_pos[lo:lo + qc], k_pos, causal, window)
        p = torch.softmax(s * hd ** -0.5 + bias, dim=-1)
        out.append(torch.einsum("bngst,btnh->bsngh", p, vf))
    return torch.cat(out, dim=1).reshape(B, S, H, hd).to(q.dtype)


def mha(params, x: torch.Tensor, *, n_heads: int, n_kv: int, d_head: int,
        rope_theta: float = 1e4, positions: Optional[torch.Tensor] = None,
        causal: bool = True, window: Optional[int] = None,
        kv_x: Optional[torch.Tensor] = None, use_rope: bool = True,
        qk_norm: bool = False, return_kv: bool = False,
        kv_int8: bool = False):
    """Full-sequence attention. x: (B, S, d) -> (B, S, d); with
    ``return_kv`` also the post-RoPE ``(k, v)``, each (B, S, n_kv, d_head),
    for a prefill to write into its decode cache. ``kv_x`` (B, T, d)
    switches to cross-attention: k and v from ``kv_x``, no RoPE, and no
    mask whatever ``causal`` and ``window`` say (the reference's).
    ``kv_int8`` (a prefill into an int8 cache): the queries attend over k
    and v quantized as the cache stores them and dequantized to x's
    dtype; ``return_kv`` still gives the unquantized k and v, which the
    cache's writes quantize to the same payloads and scales."""
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    q = _proj(params["wq"], x, n_heads, d_head)     # (B,S,H,hd)
    k = _proj(params["wk"], src, n_kv, d_head)      # (B,T,KV,hd)
    v = _proj(params["wv"], src, n_kv, d_head)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if kv_x is not None:
        causal, window = False, None
    elif use_rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    kv = (k, v)
    if kv_int8:
        k, v = (_dequantize_kv(*_quantize_kv(t), x.dtype) for t in kv)
    qc = _CHUNK["q_chunk"]
    if qc is not None and kv_x is None and S > qc and S % qc == 0 \
            and x.device.type == "cpu":
        chunked = functools.partial(_chunked_self_attention, causal=causal,
                                    window=window, qc=qc)
        ctx = on_head_shards(chunked, q, k, v) if shd.is_dtensor(q) \
            else chunked(q, k, v)
    else:
        ctx = flash_attention(q, k, v, causal=causal, window=window)
    ctx = shd.grad_like(ctx.reshape(B, S, n_heads * d_head))
    out = shd.grad_like(torch.matmul(ctx, params["wo"]["kernel"].to(x.dtype)))
    return (out, kv) if return_kv else out


# -------------------------------------------------------------- decode ----

def init_cache(batch: int, max_len: int, n_kv: int, d_head: int,
               dtype=torch.bfloat16, device=None, kv_int8: bool = False):
    """Zeroed KV buffers (B, max_len, n_kv, d_head) of ``dtype``; with
    ``kv_int8`` int8 ``k``/``v`` and float32 ``k_scale``/``v_scale`` of
    (B, max_len, n_kv)."""
    shape = (batch, max_len, n_kv, d_head)
    if kv_int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x: torch.Tensor):
    """x (..., hd) -> (int8 payload (..., hd), float32 scale (...)), one
    scale a token and head (``quantize_absmax``)."""
    q, scale = quantize_absmax(x)
    return q, scale[..., 0]


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def write_kv(cache, slots, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k, v (B, T, KV, hd) at the T cache positions ``slots`` (a
    slice or a (T,) index tensor), in place: cast to the cache dtype, or
    quantized into an int8 cache's payloads and scales."""
    if cache["k"].dtype == torch.int8:
        for name, t in (("k", k), ("v", v)):
            cache[name][:, slots], cache[name + "_scale"][:, slots] = \
                _quantize_kv(t)
        return
    cache["k"][:, slots] = k.to(cache["k"].dtype)
    cache["v"][:, slots] = v.to(cache["v"].dtype)


def read_kv(cache, dtype: torch.dtype):
    """The whole cache's k and v (B, T, KV, hd) in ``dtype``: an int8
    cache's payloads times their scales, rounded to ``dtype``."""
    if cache["k"].dtype == torch.int8:
        return tuple(_dequantize_kv(cache[n], cache[n + "_scale"], dtype)
                     for n in ("k", "v"))
    return cache["k"].to(dtype), cache["v"].to(dtype)


def decode_qkv(params, x: torch.Tensor, pos: int, *, n_heads: int,
               n_kv: int, d_head: int, rope_theta: float, use_rope: bool,
               qk_norm: bool):
    """q, k, v of one token x (B, 1, d) at position ``pos``, post-norm and
    post-RoPE. The position is built on x's device from the Python int,
    so no host-to-device copy or sync happens per token."""
    q = _proj(params["wq"], x, n_heads, d_head)     # (B,1,H,hd)
    k = _proj(params["wk"], x, n_kv, d_head)        # (B,1,KV,hd)
    v = _proj(params["wv"], x, n_kv, d_head)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if use_rope:
        positions = torch.arange(pos, pos + 1, device=x.device)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def decode_attend(params, q: torch.Tensor, k_all: torch.Tensor,
                  v_all: torch.Tensor, bias: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """One query row q (B, 1, H, hd) against the buffers (B, T, KV, hd)
    under an additive float32 bias (T,): float32 scores and softmax, the
    probabilities rounded to ``dtype`` for P.V, then the output
    projection. Returns (B, 1, d)."""
    B, _, H, hd = q.shape
    attend = functools.partial(_decode_ctx, bias=bias, dtype=dtype)
    ctx = on_head_shards(attend, q, k_all, v_all) if shd.is_dtensor(q) \
        else attend(q, k_all, v_all)
    ctx = ctx.reshape(B, 1, H * hd)
    return torch.matmul(ctx, params["wo"]["kernel"].to(dtype))


def _decode_ctx(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``decode_attend``'s attention before the output projection:
    (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    KV = k_all.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(), k_all.float())
    probs = torch.softmax(scores * (hd ** -0.5) + bias, dim=-1).to(dtype)
    ctx = torch.einsum("bngst,btnh->bsngh", probs, v_all.to(dtype))
    return ctx.reshape(B, 1, H, hd)


def mha_decode(params, x: torch.Tensor, cache: Any, cur_index: int, *,
               n_heads: int, n_kv: int, d_head: int,
               rope_theta: float = 1e4, window: Optional[int] = None,
               use_rope: bool = True, qk_norm: bool = False,
               cross_kv: Optional[Any] = None):
    """Single-token decode. x: (B, 1, d); cache k/v: (B, Smax, KV, hd)
    (``init_cache``'s, bf16 or int8 with scales); ``cur_index``: the
    Python int position being generated. Writes the token's k, v at
    ``cur_index`` in place and returns (out (B, 1, d), cache). With ``cross_kv`` (``precompute_cross_kv``'s encoder K/V,
    each (B, T, KV, hd)) the query (qk-normed, never rotated) attends
    over every encoder position and ``cache`` is returned untouched."""
    if cross_kv is not None:
        q = _proj(params["wq"], x, n_heads, d_head)
        if qk_norm:
            q = rmsnorm(params["q_norm"], q)
        k_all, v_all = cross_kv["k"], cross_kv["v"]
        bias = torch.zeros((k_all.shape[1],), dtype=torch.float32,
                           device=x.device)
        return decode_attend(params, q, k_all.to(x.dtype), v_all.to(x.dtype),
                             bias, x.dtype), cache
    q, k_new, v_new = decode_qkv(
        params, x, cur_index, n_heads=n_heads, n_kv=n_kv, d_head=d_head,
        rope_theta=rope_theta, use_rope=use_rope, qk_norm=qk_norm)
    write_kv(cache, slice(cur_index, cur_index + 1), k_new, v_new)
    k_all, v_all = read_kv(cache, x.dtype)
    k_pos = torch.arange(k_all.shape[1], device=x.device)
    valid = k_pos <= cur_index
    if window is not None:
        valid = valid & (cur_index - k_pos < window)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    return decode_attend(params, q, k_all, v_all, bias, x.dtype), cache


def precompute_cross_kv(params, enc: torch.Tensor, *, n_kv: int,
                        d_head: int, qk_norm: bool = False):
    """Encoder K/V for cross-attention decode, computed once per request:
    each (B, T, n_kv, d_head), k qk-normed where the model has it."""
    k = _proj(params["wk"], enc, n_kv, d_head)
    v = _proj(params["wv"], enc, n_kv, d_head)
    if qk_norm:
        k = rmsnorm(params["k_norm"], k)
    return {"k": k, "v": v}
