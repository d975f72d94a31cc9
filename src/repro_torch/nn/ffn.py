"""Feed-forward variants, as in ``repro/nn/ffn.py``: gated (SwiGLU-style)
or plain, and the RWKV channel mix."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.nn.module import dense, dense_init

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
    "relu": F.relu,
    "tanh": torch.tanh,
}


def ffn_init(gen, d_model: int, d_ff: int, gated: bool,
             param_dtype=torch.float32, lead=(), device=None):
    kw = dict(lead=lead, device=device)
    p = {
        "wi": dense_init(gen, d_model, d_ff, param_dtype, **kw),
        "wd": dense_init(gen, d_ff, d_model, param_dtype, **kw),
    }
    if gated:
        p["wg"] = dense_init(gen, d_model, d_ff, param_dtype, **kw)
    return p


def ffn_apply(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated if a 'wg' kernel is present: wd(act(wg x) * (wi x)); else
    wd(act(wi x))."""
    h = dense(params["wi"], x)
    if "wg" in params:
        h = ACTS[act](dense(params["wg"], x)) * h
    else:
        h = ACTS[act](h)
    return dense(params["wd"], h)


def rwkv_channel_mix_init(gen, d_model: int, d_ff: int,
                          param_dtype=torch.float32, lead=(), device=None):
    kw = dict(lead=lead, device=device)
    return {
        "wk": dense_init(gen, d_model, d_ff, param_dtype, **kw),
        "wv": dense_init(gen, d_ff, d_model, param_dtype, **kw),
        "wr": dense_init(gen, d_model, d_model, param_dtype, **kw),
        "mix_k": torch.full((*lead, d_model), 0.5, dtype=param_dtype,
                            device=device),
        "mix_r": torch.full((*lead, d_model), 0.5, dtype=param_dtype,
                            device=device),
    }


def rwkv_channel_mix(params, x: torch.Tensor,
                     x_prev: torch.Tensor) -> torch.Tensor:
    """RWKV channel mix: token-shift interpolation + squared-ReLU key net,
    sigmoid receptance gate (Peng et al., arXiv:2404.05892)."""
    mk = shd.whole(params["mix_k"]).to(x.dtype)
    mr = shd.whole(params["mix_r"]).to(x.dtype)
    xk = x * mk + x_prev * (1 - mk)
    xr = x * mr + x_prev * (1 - mr)
    k = torch.square(F.relu(dense(params["wk"], xk)))
    return torch.sigmoid(dense(params["wr"], xr)) * dense(params["wv"], k)
