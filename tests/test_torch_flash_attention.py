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

The CUDA kernel's 16-bit path runs on the tensor cores with its own
arithmetic (scores from exact 16-bit products, P split into a 16-bit hi
and lo for P.V); ``_mma_emulation`` repeats that arithmetic on the CPU,
so its numeric contract is held here against the Pallas kernel and the
float32 reference before the card runs it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.nn import attention as jattn
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention.ops import _aligned, flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref
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
    (1, 200, 6, 2, 192),     # Nemotron-4's width, GQA 3:1, ragged S
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_causal_sweep_matches_jax(B, S, H, KV, hd, dtype):
    _check(1, B, S, H, KV, hd, dtype)


@pytest.mark.parametrize("causal,window", [(False, None), (True, 64),
                                           (True, 130), (False, 64)])
def test_flash_attention_noncausal_and_window_matches_jax(causal, window):
    _check(2, 1, 256, 2, 2, 64, "float32", causal, window)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_width_192_window_matches_jax(dtype):
    """Head width 192 under a binding window of 130 (MQA 4/1, ragged S
    = 200): the window's lower loop bound at the kernels' tiles."""
    _check(4, 1, 200, 4, 1, 192, dtype, True, 130)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_attention_at_width_192_matches_reference_mha(dtype):
    """``Sq != Sk`` at head width 192: 20 queries over 45 frames (GQA
    4/2), non-causal, through ``mha(kv_x=)`` and the flash wrapper against
    the reference's cross-attention (plain ``jnp``: the Pallas kernel has
    one S), at the float32 and 16-bit tolerances."""
    d, H, KV, hd = 48, 4, 2, 192
    p = jattn.attention_init(jax.random.PRNGKey(9), d, H, KV, hd)
    rs = np.random.RandomState(10)
    x, mem = (jnp.asarray(rs.randn(2, n, d).astype(np.float32))
              .astype(DTYPES[dtype][0]) for n in (20, 45))
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    kw = dict(n_heads=H, n_kv=KV, d_head=hd)
    ref = jattn.mha(p, x, kv_x=mem, **kw)
    out = tattn.mha(pt, tensor_from_numpy(np.asarray(x)),
                    kv_x=tensor_from_numpy(np.asarray(mem)), **kw)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (2, 20, d)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               **(TOL[dtype] if dtype == "bfloat16" else
                                  dict(rtol=2e-4, atol=2e-5)))
    assert LAUNCHES["flash_attention"] == 0


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
    is fully masked, at the Pallas kernel's 128-row tiles and at the CUDA
    kernels' tiles (64 rows and keys for bf16 and fp16 at hd 128, 32 for
    float32). The finite -1e30 mask makes that tile's weights vanish at
    the next tile's rescale (with -inf they would be NaN); the port
    matches the Pallas kernel there."""
    for block in (128, 64, 32):
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


def test_head_width_16_is_float32_only():
    """The reduced LMs' head width 16 has a float32 kernel (the
    continuous-depth hypersolver fit runs them on the card) and no 16-bit
    one: a bf16 call raises before any build or launch."""
    from repro_torch.kernels.flash_attention import ops
    assert 16 in ops.FP32_HEAD_DIMS and 16 not in ops.HEAD_DIMS
    w = torch.zeros(1, 8, 2, 16).to(torch.bfloat16).as_subclass(_CudaLike)
    with pytest.raises(ValueError, match="head width 16 in torch.bfloat16"):
        flash_attention(w, w, w)
    assert LAUNCHES["flash_attention"] == 0


def test_kernel_forward_takes_the_plain_versions_gradient(monkeypatch):
    """Where autograd needs a backward, ``_Flash`` runs the kernel's
    forward and differentiates the plain version at the same inputs (the
    kernel has none). With the launch standing in for the kernel on the
    CPU, values and gradients are the plain version's, windowed or not,
    and the launch ran once per forward."""
    from repro_torch.kernels.flash_attention import ops
    calls = []

    def fake_launch(out, q, k, v, causal=True, window=None):
        calls.append(q.shape)
        out.copy_(attention_ref(q, k, v, causal=causal, window=window))

    monkeypatch.setattr(ops, "launch", fake_launch)
    rs = np.random.RandomState(8)
    for window in (None, 5):
        qkv = [torch.from_numpy(rs.randn(2, 12, n, 16).astype(np.float32))
               for n in (4, 2, 2)]
        mine = [t.clone().requires_grad_() for t in qkv]
        ref = [t.clone().requires_grad_() for t in qkv]
        out = ops._Flash.apply(*mine, True, window)
        want = attention_ref(*ref, causal=True, window=window)
        assert torch.equal(out, want)
        g = torch.from_numpy(rs.randn(*out.shape).astype(np.float32))
        out.backward(g)
        want.backward(g)
        for a, b in zip(mine, ref):
            assert torch.equal(a.grad, b.grad)
    assert len(calls) == 2


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_alignment_is_counted_in_bytes(dtype):
    """16-bit operands need 16-byte (8-element) strides and address, what
    a 16-byte cp.async copy needs: an offset of 4 elements (8 bytes) is
    copied, one of 8 elements (16 bytes) is read in place."""
    x = torch.randn(2, 8, 3, 64).to(dtype)
    for offset, inplace in ((4, False), (8, True)):
        view = x.reshape(-1)[offset:offset + 2 * 8 * 3 * 56] \
            .reshape(2, 8, 3, 56)
        got = _aligned(view)
        assert (got is view) == inplace, offset
        assert torch.equal(got, view)
    heads = x[:, :, 1:, :56]                 # strides 192 / 64 elements
    assert _aligned(heads) is heads
    odd_stride = torch.randn(2, 8, 3, 60).to(dtype)[..., :56]   # 120 bytes
    assert _aligned(odd_stride) is not odd_stride


@pytest.mark.parametrize("hd", [64, 128, 192, 256])
def test_mha_gives_the_kernel_operands_it_reads_in_place(monkeypatch, hd):
    """On the main path nothing is copied before the kernel: the q, k, v
    that ``mha`` hands the wrapper (projections, qk-norm, RoPE) are bf16
    and pass the 16-byte rule as they are, at every instantiated width."""
    seen = []

    def record(q, k, v, **kw):
        seen.append((q, k, v))
        return attention_ref(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", record)
    d, H, KV = 64, 4, 2
    p = jattn.attention_init(jax.random.PRNGKey(5), d, H, KV, hd,
                             qk_norm=True)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    pt = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16), pt)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 24, d)
                         .astype(np.float32)).to(torch.bfloat16)
    tattn.mha(pt, x, n_heads=H, n_kv=KV, d_head=hd, qk_norm=True)
    (q, k, v), = seen
    for t in (q, k, v):
        assert t.dtype == torch.bfloat16 and t.shape[-1] == hd
        assert _aligned(t) is t


LOG2E = 1.4426950408889634


def _mma_emulation(q, k, v, *, causal=True, window=None, split=True):
    """The tensor-core kernel's arithmetic (flash_attention_mma_kernel),
    on the CPU, in float32, returned before the final rounding: q, k, v in
    their 16-bit type; scores from products exact in fp32, times
    float32(hd^-0.5) * float32(log2 e) after the product; per 64-row query
    tile, kv tiles of 64 keys (32 at hd 64 and 192, 16 at hd 256) from the
    window's lower tile to the causal diagonal (over every key of a
    longer or shorter k, non-causal), masked with the finite -1e30; an
    online softmax in base 2; each probability split into hi = T(p) and
    lo = T(p - hi) for P.V (``split=False``: hi alone, p rounded once);
    o = acc / max(l, 1e-30)."""
    B, S, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    BQ, BK = 64, (16 if hd >= 256 else 32 if hd in (64, 192) else 64)
    T = q.dtype
    n = -(-max(S, Sk) // max(BQ, BK)) * max(BQ, BK)

    def heads(t, rep):              # (B, S, n, hd) -> (B, H, n_pad, hd)
        t = t.float().repeat_interleave(rep, dim=2).transpose(1, 2)
        return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[2]))

    qf, kf, vf = heads(q, 1), heads(k, G), heads(v, G)
    scale2 = torch.tensor(hd ** -0.5, dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.zeros(B, H, n, hd)
    for q0 in range(0, S, BQ):
        hi = -(-Sk // BK)
        if causal:
            hi = min(hi, (q0 + BQ + BK - 1) // BK)
        lo = max(0, q0 - (window - 1)) // BK if window else 0
        qpos = torch.arange(q0, q0 + BQ)[:, None]
        acc = torch.zeros(B, H, BQ, hd)
        m = torch.full((B, H, BQ, 1), NEG_INF)
        l = torch.zeros(B, H, BQ, 1)
        for j in range(lo, hi):
            kpos = torch.arange(j * BK, (j + 1) * BK)[None, :]
            ok = kpos < Sk
            if causal:
                ok = ok & (kpos <= qpos)
            if window:
                ok = ok & (qpos - kpos < window)
            s = qf[:, :, q0:q0 + BQ] @ kf[:, :, j * BK:(j + 1) * BK] \
                .transpose(-1, -2)
            s = torch.where(ok, s * scale2, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            p_hi = p.to(T).float()
            p_lo = (p - p_hi).to(T).float() if split \
                else torch.zeros_like(p)
            vt = vf[:, :, j * BK:(j + 1) * BK]
            acc = acc * alpha + p_hi @ vt + p_lo @ vt
            m = m_new
        out[:, :, q0:q0 + BQ] = acc / torch.clamp(l, min=1e-30)
    return out[:, :, :S].transpose(1, 2)


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (1, 128, 4, 4, 64, None),
    (2, 256, 8, 2, 64, None),
    (1, 384, 4, 1, 128, None),
    (1, 200, 4, 2, 64, None),
    (2, 200, 4, 1, 128, 40),     # first visited tiles fully masked
    (1, 150, 2, 1, 256, 50),     # Griffin's width: 16-key tiles
    (1, 200, 6, 2, 192, 70),     # Nemotron-4's width: 32-key tiles
])
def test_mma_emulation_matches_pallas_kernel(B, S, H, KV, hd, window):
    """The tensor-core kernel's arithmetic, rounded to bf16, agrees with
    the Pallas kernel in interpret mode at the bf16 tolerance, over the
    sweep's shapes and the windowed, ragged and hd-256 cases."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(7, B, S, H, KV, hd, "bfloat16")
    ref = jax_flash(qj, kj, vj, causal=True, window=window, interpret=True)
    out = _mma_emulation(qt, kt, vt, window=window).to(torch.bfloat16)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               **TOL["bfloat16"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 256, 8, 2, 128, None),
    (2, 200, 4, 1, 128, 40),
    (1, 150, 2, 1, 256, 50),
    (1, 200, 6, 2, 192, 70),
])
def test_mma_emulation_is_float32_before_rounding(B, S, H, KV, hd, window,
                                                  dtype):
    """Before the final rounding the emulated kernel is within 1e-5 of
    the float32 reference on the same 16-bit inputs (rtol 1e-5, atol 1e-5
    of the largest output): the products are exact and hi + lo carries
    each p to 2^-18 of itself in bf16. Rounding p once to the operand
    type instead (what the kernel does not do) misses that bound."""
    rs = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rs.randn(B, S, n, hd).astype(np.float32))
               .to(dtype) for n in (H, KV, KV))
    ref = attention_ref(q.float(), k.float(), v.float(), window=window)
    out = _mma_emulation(q, k, v, window=window)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)
    once = _mma_emulation(q, k, v, window=window, split=False)
    assert float((once - ref).abs().max()) > 1e-5 * scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_mma_emulation_of_cross_lengths(dtype):
    """Cross-attention on the tensor-core path: 77 queries over 203 keys
    (GQA 8/2, hd 64: 32-key tiles, a ragged last one), non-causal, is
    within 1e-5 of the float32 reference before the final rounding, as
    the self-attention cases are."""
    rs = np.random.RandomState(9)
    q = torch.from_numpy(rs.randn(2, 77, 8, 64).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rs.randn(2, 203, 2, 64).astype(np.float32))
            .to(dtype) for _ in range(2))
    ref = attention_ref(q.float(), k.float(), v.float(), causal=False)
    out = _mma_emulation(q, k, v, causal=False)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
