"""Feed-forward block: gated (SwiGLU-style) or plain, as in
``repro/nn/ffn.py``. The RWKV channel mix waits for the RWKV slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
