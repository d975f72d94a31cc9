"""The port's flash attention (repro_torch/kernels/flash_attention) held
against the JAX package's Pallas kernel in interpret mode, on the CPU.

On a CPU tensor the port's wrapper runs its plain PyTorch version
(``ref.py``); the CUDA kernel is held against that same plain version on
the card by ``chip_smoke.py``. Mirrors tests/test_kernels.py's
``test_flash_attention_causal_sweep`` (MHA, GQA 4:1, MQA at hd 128, ragged
S = 200), ``_noncausal_and_window`` (windows 64 and 130, non-causal) and
``_matches_model_attention``. Tolerances are the ones that file holds the
Pallas kernel to: fp32 rtol = atol = 2e-5, bf16 2e-2 (the sums run in
other orders). Inputs come from numpy RandomState, rounded once by JAX
and carried to torch bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.nn import attention as jattn
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention.ops import _aligned, flash_attention
from repro_torch.nn import attention as tattn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(seed, B, S, H, KV, hd, dtype):
    rs = np.random.RandomState(seed)
    out = []
    for n in (H, KV, KV):
        xj = jnp.asarray(rs.randn(B, S, n, hd).astype(np.float32)) \
            .astype(DTYPES[dtype][0])
        out.append((xj, tensor_from_numpy(np.asarray(xj))))
    return out


def _check(seed, B, S, H, KV, hd, dtype, causal=True, window=None):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(seed, B, S, H, KV, hd, dtype)
    ref = jax_flash(qj, kj, vj, causal=causal, window=window, interpret=True)
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, S, H, hd)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])
    assert LAUNCHES["flash_attention"] == 0   # the CPU takes the plain version


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 64),      # MHA, single block
    (2, 256, 8, 2, 64),      # GQA 4:1, two blocks
    (1, 384, 4, 1, 128),     # MQA, 3 blocks, wide head
    (1, 200, 4, 2, 64),      # ragged S (not a block multiple)
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_causal_sweep_matches_jax(B, S, H, KV, hd, dtype):
    _check(1, B, S, H, KV, hd, dtype)


@pytest.mark.parametrize("causal,window", [(False, None), (True, 64),
                                           (True, 130), (False, 64)])
def test_flash_attention_noncausal_and_window_matches_jax(causal, window):
    _check(2, 1, 256, 2, 2, 64, "float32", causal, window)


def _first_visited_tile_fully_masked(S, window, block):
    """Query rows whose first kv tile (the loop's lower bound, computed as
    the Pallas kernel and the CUDA kernel compute it) holds no valid key."""
    rows = []
    for q in range(S):
        q0 = q - q % block
        lo_tile = max(0, q0 - (window - 1)) // block
        if lo_tile * block + block - 1 < q - window + 1:
            rows.append(q)
    return rows


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_fully_masked_first_tile(dtype):
    """Ragged S = 200 under a window of 40: many rows' first visited tile
    is fully masked, both at the Pallas kernel's 128-row tiles and at the
    CUDA kernel's 32-row tiles. The finite -1e30 mask makes that tile's
    weights vanish at the next tile's rescale (with -inf they would be
    NaN); the port matches the Pallas kernel there."""
    for block in (128, 32):
        assert _first_visited_tile_fully_masked(200, 40, block)
    _check(3, 2, 200, 4, 1, 128, dtype, True, 40)


def test_mha_runs_flash_and_matches_reference_mha():
    """nn/attention.py::mha (projections, qk-norm, RoPE, then the flash
    wrapper) == the reference's einsum mha, windowed and not, in fp32."""
    d, H, KV, hd, S = 32, 4, 2, 8, 24
    p = jattn.attention_init(jax.random.PRNGKey(3), d, H, KV, hd,
                             qk_norm=True)
    x = np.random.RandomState(4).randn(2, S, d).astype(np.float32)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    for window in (None, 8):
        kw = dict(n_heads=H, n_kv=KV, d_head=hd, window=window, qk_norm=True)
        ref = jattn.mha(p, jnp.asarray(x), **kw)
        out = tattn.mha(pt, torch.from_numpy(x), **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-5)


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the card-only
    branch of the wrapper without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_flash_attention_raises_where_it_has_no_kernel():
    q = torch.zeros(1, 8, 2, 64)
    # a device with no kernel: no plain-version fallback
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(q.to("meta"), q[:, :, :1].to("meta"),
                        q[:, :, :1].to("meta"))
    # on the card: a dtype or head width the kernel lacks raises before
    # any build or launch
    with pytest.raises(TypeError, match="float64"):
        d = q.double().as_subclass(_CudaLike)
        flash_attention(d, d, d)
    with pytest.raises(ValueError, match="head width 48"):
        w = torch.zeros(1, 8, 2, 48).as_subclass(_CudaLike)
        flash_attention(w, w, w)
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64))
    assert LAUNCHES["flash_attention"] == 0


def test_kernel_reads_aligned_views_in_place():
    """The kernel reads q, k, v through their strides: a (B, S, H, hd)
    view with 4-element aligned strides and address passes as is; a view
    that is not is copied once into a fresh, aligned buffer."""
    x = torch.randn(2, 8, 3, 64)
    assert _aligned(x) is x
    heads = x[:, :, 1:]                       # offset of 64 elements
    assert _aligned(heads) is heads
    odd = x.reshape(-1)[1:1 + 2 * 8 * 3 * 62].reshape(2, 8, 3, 62)
    fixed = _aligned(odd)
    assert fixed is not odd and fixed.is_contiguous()
    assert torch.equal(fixed, odd)
