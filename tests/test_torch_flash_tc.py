"""The tensor-core variants of the flash kernels, as far as the CPU can see
them: their arithmetic, which inputs they take, and how they are built.

The CUDA kernels (``flash_fwd_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``,
``flash_bwd_dkv_wgmma_kernel`` in ``ops/csrc/flash_attention.cu``) run only
on the card, where ``chip_smoke.py`` holds them to the plain versions. Here
a PyTorch emulation of their arithmetic stands in for them: bf16 operands,
f32 sums, 64-row tiles, exp2 with log2(e) folded into the scale (the
forward's online softmax), and the f32 operand of each second product split
into bf16 terms: ``p`` into hi and lo in the forward, ``ds`` into two terms
in dQ, ``p`` and ``ds`` into three terms in dK/dV. It is held to the plain
versions at the card's tolerance (one bf16 ulp of the plain value plus
5e-6) and to the JAX package's ``_flash_flat_lse``. Rounding ``p`` and
``ds`` to bf16 once fails that tolerance, which is why the split is there;
two terms in dK/dV fail it where a dV element cancels to below the 5e-6
floor, which is why dK/dV takes three, while dQ, which sums over a row of
``p``, holds with two.

The routing tests run the wrappers against a stand-in for the kernel
library, so they see which C entry each input reaches.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multidisttorch_tpu.ops.pallas_attention as jax_pa
from multidisttorch_tpu_torch.ops import _build
from multidisttorch_tpu_torch.ops import attention as port_attn

TILE = 64  # rows of every staged tile
FWD_TERMS, DQ_TERMS, BWD_TERMS = 2, 2, 3  # bf16 terms of p (forward), ds (dQ), p and ds (dK/dV)
NEG_INF = -1e30  # the kernels' finite causal sentinel
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
F32_FWD = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(v.float().abs().clamp_min(2.0**-126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _outside_tolerance(got: torch.Tensor, ref: torch.Tensor) -> int:
    """Elements of ``got`` farther from ``ref`` than one bf16 ulp of ``ref``
    plus 5e-6: chip_smoke's bf16 tolerance for the flash kernels."""
    diff = (got.float() - ref.float()).abs()
    return int((diff > _bf16_ulp(ref) + 5e-6).sum())


def _split(x: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """An f32 operand as ``terms`` bf16 terms: bf16(x), then the bf16 of
    what is left, and so on."""
    out = []
    for _ in range(terms):
        out.append(x.to(torch.bfloat16))
        x = x - out[-1].float()
    return out


def _product(x: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """``x @ b`` with ``x`` f32 as the kernels take it: each bf16 term times
    the bf16 ``b``, summed in f32."""
    out = torch.zeros(*x.shape[:-1], b.shape[-1])
    for term in _split(x, terms):
        out = out + torch.matmul(term.float(), b.float())
    return out


def _causal_keep(t: int, k0: int, width: int) -> torch.Tensor:
    """(t, width): whether key k0 + j is at or before query i."""
    rows = torch.arange(t)[:, None]
    cols = k0 + torch.arange(width)[None, :]
    return cols <= rows


def tc_forward(q, k, v, scale: float, causal: bool, *, terms: int = FWD_TERMS):
    """The forward kernel's arithmetic: ``(o, lse)`` from bf16 (BH, T, D)
    operands. K tiles above a Q tile's diagonal, which the kernel skips,
    are masked here; the two give the same bits (p 0, correction 1)."""
    bh, t, d = q.shape
    scale_log2 = np.float32(scale) * LOG2E
    qf = q.float()
    acc = torch.zeros(bh, t, d)
    m = torch.full((bh, t), NEG_INF)
    l = torch.zeros(bh, t)
    for k0 in range(0, t, TILE):
        kt, vt = k[:, k0 : k0 + TILE], v[:, k0 : k0 + TILE]
        s = torch.matmul(qf, kt.float().transpose(-1, -2)) * float(scale_log2)
        if causal:
            s = s.masked_fill(~_causal_keep(t, k0, kt.shape[1]), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _product(p, vt, terms)
        m = m_new
    denom = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / denom[..., None]).to(q.dtype), m * float(LN2) + torch.log(denom)


def tc_backward_dkv(q, k, v, do, lse, delta, scale: float, causal: bool, *, terms: int = BWD_TERMS):
    """The dK/dV kernel's arithmetic: ``(dk, dv)`` from bf16 operands and
    f32 ``lse`` and ``delta``, summed over 64-row Q tiles in order."""
    bh, t, d = q.shape
    scale_log2 = float(np.float32(scale) * LOG2E)
    lse2 = lse.float() * float(LOG2E)
    dk = torch.zeros(bh, t, d)
    dv = torch.zeros(bh, t, d)
    for q0 in range(0, t, TILE):
        qt, dot = q[:, q0 : q0 + TILE], do[:, q0 : q0 + TILE]
        # Transposed tiles: rows are keys, columns queries.
        st = torch.matmul(k.float(), qt.float().transpose(-1, -2))
        dpt = torch.matmul(v.float(), dot.float().transpose(-1, -2))
        pt = torch.exp2(st * scale_log2 - lse2[:, None, q0 : q0 + TILE])
        if causal:  # a key after the query: p = 0
            keys, queries = torch.arange(t)[:, None], q0 + torch.arange(qt.shape[1])[None, :]
            pt = pt.masked_fill(queries < keys, 0.0)
        dst = pt * (dpt - delta[:, None, q0 : q0 + TILE]) * scale
        dv = dv + _product(pt, dot, terms)
        dk = dk + _product(dst, qt, terms)
    return dk.to(k.dtype), dv.to(v.dtype)


def tc_backward_dq(q, k, v, do, lse, delta, scale: float, causal: bool, *, terms: int = DQ_TERMS):
    """The dQ kernel's arithmetic: ``dq`` from bf16 operands and f32
    ``lse`` and ``delta``, summed over 64-row K tiles in order. K tiles
    above a Q tile's diagonal, which the kernel skips, are masked here to
    p = 0, which adds nothing."""
    return _tc_dq_f32(q, k, v, do, lse, delta, scale, causal, terms).to(q.dtype)


def _tc_dq_f32(q, k, v, do, lse, delta, scale, causal, terms):
    """:func:`tc_backward_dq`'s f32 accumulator, before the rounding."""
    bh, t, d = q.shape
    scale_log2 = float(np.float32(scale) * LOG2E)
    lse2 = lse.float() * float(LOG2E)
    dq = torch.zeros(bh, t, d)
    for k0 in range(0, t, TILE):
        kt, vt = k[:, k0 : k0 + TILE], v[:, k0 : k0 + TILE]
        s = torch.matmul(q.float(), kt.float().transpose(-1, -2))
        dp = torch.matmul(do.float(), vt.float().transpose(-1, -2))
        p = torch.exp2(s * scale_log2 - lse2[..., None])
        if causal:
            p = p.masked_fill(~_causal_keep(t, k0, kt.shape[1]), 0.0)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + _product(ds, kt, terms)
    return dq


def _bf16_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(rng.normal(0, 1, shape).astype(np.float32)).to(torch.bfloat16) for _ in range(4))
    g_lse = torch.tensor(rng.normal(0, 1, shape[:2]).astype(np.float32))
    return q, k, v, do, g_lse


def _against_plain(shape, seed, fwd_terms: int, bwd_terms: int, heads=slice(None), *, dq_terms: int = DQ_TERMS):
    """Elements of o, dq, dk and dv outside the bf16 tolerance, emulation
    against the plain versions, causal bf16 with an lse cotangent folded
    into delta, on the ``heads`` of inputs drawn as chip_smoke draws them."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen).to(torch.bfloat16)[heads] for _ in range(4))
    g_lse = torch.randn(shape[:2], generator=gen)[heads]
    scale = 1.0 / math.sqrt(shape[-1])
    op, lp = port_attn.flash_fwd_plain(q, k, v, scale, True)
    delta = (do.float() * op.float()).sum(-1) - g_lse
    dqp, dkp, dvp = port_attn.flash_bwd_plain(q, k, v, do, lp, delta, scale, True)
    o, lse = tc_forward(q, k, v, scale, True, terms=fwd_terms)
    dq = tc_backward_dq(q, k, v, do, lp, delta, scale, True, terms=dq_terms)
    dk, dv = tc_backward_dkv(q, k, v, do, lp, delta, scale, True, terms=bwd_terms)
    np.testing.assert_allclose(lse.numpy(), lp.numpy(), **F32_FWD)
    pairs = (("o", o, op), ("dq", dq, dqp), ("dk", dk, dkp), ("dv", dv, dvp))
    return {name: _outside_tolerance(a, b) for name, a, b in pairs}


def test_split_terms_hold_the_plain_versions_to_one_bf16_ulp():
    assert _against_plain((8, 512, 64), 3, FWD_TERMS, BWD_TERMS) == {"o": 0, "dq": 0, "dk": 0, "dv": 0}


def test_one_bf16_rounding_of_p_and_ds_misses_the_tolerance():
    # Why the kernels split p and ds: rounded once, about an eighth of
    # o, dq, dk and dv leaves the tolerance.
    bad = _against_plain((8, 512, 64), 3, 1, 1, dq_terms=1)
    assert sum(bad.values()) > 0.05 * 4 * 8 * 512 * 64, bad
    assert min(bad.values()) > 0, bad


def test_two_terms_miss_the_tolerance_where_dv_cancels():
    # chip_smoke's main inputs ((128, 512, 64) causal bf16, seed
    # 512 * 31 + 64 + 1), head 0: dv[0, 1, 60] sums terms near 1 to 1.8e-6,
    # and hi + lo leave 5.5e-6 of error, past the 5e-6 floor. Three terms
    # do not; the forward, normalised by its row sums, is fine with two.
    seed = 512 * 31 + 64 + 1
    assert _against_plain((128, 512, 64), seed, 2, 2, heads=slice(0, 1))["dv"] > 0
    assert _against_plain((128, 512, 64), seed, 2, 3, heads=slice(0, 1)) == {"o": 0, "dq": 0, "dk": 0, "dv": 0}


MAIN_SEED = 512 * 31 + 64 + 1  # chip_smoke's main inputs: (128, 512, 64) causal bf16


@pytest.mark.parametrize(
    "shape, seed, heads",
    [((8, 512, 64), 3, slice(None)), ((128, 512, 64), MAIN_SEED, slice(0, 1))],
    ids=["8x512x64", "chip-smoke-main-head0"],
)
def test_dq_with_its_term_count_holds_the_plain_version(shape, seed, heads):
    assert _against_plain(shape, seed, FWD_TERMS, BWD_TERMS, heads)["dq"] == 0


def _dq_f32_error(shape, seed, heads, terms):
    """The dQ emulation's f32 error before the bf16 rounding, against the
    plain f32 product, over max(5e-6, one bf16 ulp) of the value: below 1
    at every element, no rounding of the two can put them outside the
    tolerance."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen).to(torch.bfloat16)[heads] for _ in range(4))
    g_lse = torch.randn(shape[:2], generator=gen)[heads]
    scale = 1.0 / math.sqrt(shape[-1])
    op, lp = port_attn.flash_fwd_plain(q, k, v, scale, True)
    delta = (do.float() * op.float()).sum(-1) - g_lse
    p = torch.exp(port_attn._scores(q, k, scale, True) - lp[..., None])
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None]) * scale
    ref = torch.matmul(ds, k.float())
    got = _tc_dq_f32(q, k, v, do, lp, delta, scale, True, terms)
    return float(((got - ref).abs() / torch.clamp_min(_bf16_ulp(ref), 5e-6)).max())


def test_dq_takes_two_terms_and_one_fails():
    # Why dQ takes two terms where dK/dV takes three: at chip_smoke's main
    # inputs two keep dq's f32 error below max(5e-6, one bf16 ulp) at
    # every element, so no rounding can fail; one term puts thousands of
    # elements outside the tolerance.
    head0 = slice(0, 1)
    assert _dq_f32_error((128, 512, 64), MAIN_SEED, head0, DQ_TERMS) < 1
    assert _against_plain((128, 512, 64), MAIN_SEED, FWD_TERMS, BWD_TERMS, head0, dq_terms=DQ_TERMS - 1)["dq"] > 1000


@pytest.mark.parametrize("causal", [False, True])
def test_emulation_matches_jax_flash_flat_lse(causal):
    # The JAX package's Pallas kernels in interpret mode, bf16 in, with an
    # lse cotangent: the emulation's o and lse, and its dk and dv fed the
    # JAX side's lse and delta, within one bf16 ulp (lse at the f32 rtol).
    q, k, v, do, g_lse = _bf16_inputs((2, 128, 64), seed=11 + causal)
    scale = 1.0 / math.sqrt(64)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v, do))
    (jo, jl), vjp = jax.vjp(lambda a, b, c: jax_pa._flash_flat_lse(a, b, c, scale, causal), jq, jk, jv)
    jdq, jdk, jdv = vjp((jdo, jnp.asarray(g_lse.numpy())))
    from_jax = lambda x: torch.tensor(np.asarray(x, dtype=np.float32))

    o, lse = tc_forward(q, k, v, scale, causal)
    assert _outside_tolerance(o, from_jax(jo)) == 0
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **F32_FWD)
    # delta as the JAX backward forms it: rowsum(dO * O) - g_lse, from its o.
    delta = (do.float() * from_jax(jo)).sum(-1) - g_lse
    dq = tc_backward_dq(q, k, v, do, from_jax(jl), delta, scale, causal)
    assert _outside_tolerance(dq, from_jax(jdq)) == 0
    dk, dv = tc_backward_dkv(q, k, v, do, from_jax(jl), delta, scale, causal)
    assert _outside_tolerance(dk, from_jax(jdk)) == 0
    assert _outside_tolerance(dv, from_jax(jdv)) == 0


def _flat(d, dtype=torch.bfloat16, device="cpu", bh=2, t=8):
    return torch.empty(bh, t, d, dtype=dtype, device=device)


def _unaligned(d, dtype=torch.bfloat16, bh=2, t=8):
    n = bh * t * d
    view = torch.empty(n + 1, dtype=dtype)[1:].view(bh, t, d)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_at_head_dims_64_and_128_takes_the_tensor_core_variant(d, device):
    ops = [_flat(d, device=device) for _ in range(4)]
    assert port_attn.uses_tensor_cores(*ops[:3])
    assert port_attn.uses_tensor_cores(*ops)


@pytest.mark.parametrize(
    "make",
    [
        lambda: [_flat(64, torch.float32) for _ in range(3)],
        lambda: [_flat(16) for _ in range(3)],
        lambda: [_flat(20) for _ in range(3)],
        lambda: [_flat(256) for _ in range(3)],
        lambda: [_flat(64, torch.float32, device="meta") for _ in range(3)],
        lambda: [_unaligned(64), _flat(64), _flat(64)],
        lambda: [_flat(128), _flat(128), _unaligned(128)],
    ],
    ids=["f32", "D16", "D20", "D256", "f32-meta", "unaligned-q", "unaligned-v"],
)
def test_other_inputs_take_the_simt_kernels(make):
    assert not port_attn.uses_tensor_cores(*make())


def test_an_unaligned_dout_sends_the_backward_to_the_simt_kernel():
    ops = [_flat(64) for _ in range(3)]
    assert not port_attn.uses_tensor_cores(*ops, _unaligned(64))


class _FakeKernels:
    """Stands in for the kernel library: records the C entry each launch
    reaches and returns ``err`` from it."""

    def __init__(self):
        self.calls, self.args, self.err = [], [], 0

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            self.args.append(args)
            return self.err

        return entry


@pytest.fixture
def fake_kernels(monkeypatch):
    lib = _FakeKernels()
    monkeypatch.setattr(port_attn, "_kernels", lambda: lib)
    # The wrappers refuse CPU tensors there, and take the CUDA stream and
    # device context around the launch; the routing comes before both.
    monkeypatch.setattr(port_attn, "_check_kernel_operands", lambda *tensors: None)
    monkeypatch.setattr(port_attn, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    port_attn.reset_launches()
    yield lib
    port_attn.reset_launches()


def _launch(kernel, q, k, v, do, **kw):
    """One wrapper call of ``kernel`` on these operands (lse and delta f32)."""
    bh, t, _ = q.shape
    lse, delta = torch.zeros(bh, t), torch.zeros(bh, t)
    if kernel == "flash_fwd":
        return port_attn.flash_fwd_cuda(q, k, v, 0.125, True, **kw)
    wrapper = getattr(port_attn, f"{kernel}_cuda")
    return wrapper(q, k, v, do, lse, delta, 0.125, True, **kw)


@pytest.mark.parametrize(
    "make, variant",
    [
        (lambda: [_flat(64) for _ in range(4)], "wgmma"),
        (lambda: [_flat(128) for _ in range(4)], "wgmma"),
        (lambda: [_flat(64), _flat(64), _flat(64), _unaligned(64)], "simt"),
        (lambda: [_unaligned(128), _flat(128), _flat(128), _flat(128)], "simt"),
        (lambda: [_flat(64, torch.float32) for _ in range(4)], "simt"),
        (lambda: [_flat(20) for _ in range(4)], "simt"),
    ],
    ids=["bf16-D64", "bf16-D128", "unaligned-dO", "unaligned-q", "f32", "D20"],
)
def test_dq_launches_the_variant_its_operands_call_for(fake_kernels, make, variant):
    _launch("flash_bwd_dq", *make())
    assert fake_kernels.calls == ["mdt_flash_bwd_dq_wgmma" if variant == "wgmma" else "mdt_flash_bwd_dq"]
    assert {key: n for key, n in port_attn.LAUNCHES_BY_VARIANT.items() if n} == {f"flash_bwd_dq:{variant}": 1}
    assert port_attn.LAUNCHES["flash_bwd_dq"] == 1


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_force_simt_takes_the_simt_entry(fake_kernels, kernel):
    ops = [_flat(64) for _ in range(4)]
    _launch(kernel, *ops)
    _launch(kernel, *ops, _force_simt=True)
    assert fake_kernels.calls == [f"mdt_{kernel}_wgmma", f"mdt_{kernel}"]
    assert {key: n for key, n in port_attn.LAUNCHES_BY_VARIANT.items() if n} == {
        f"{kernel}:wgmma": 1,
        f"{kernel}:simt": 1,
    }


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("variant", ["wgmma", "simt"])
def test_a_failed_launch_raises_naming_its_variant_and_counts_nothing(fake_kernels, kernel, variant):
    fake_kernels.err = 700
    ops = [_flat(64) for _ in range(4)]
    with pytest.raises(RuntimeError, match=rf"{kernel} \({variant}\) launch failed with CUDA error 700"):
        _launch(kernel, *ops, _force_simt=variant == "simt")
    assert len(fake_kernels.calls) == 1  # no second try on the other variant
    assert set(port_attn.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("code, kernel", enumerate(["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]))
def test_wgmma_smem_bytes_names_the_kernel_by_the_c_entrys_code(fake_kernels, code, kernel):
    # mdt_flash_wgmma_smem numbers the kernels 0 (forward), 1 (dQ), 2 (dK/dV).
    fake_kernels.err = 4096
    assert port_attn.wgmma_smem_bytes(kernel, 128) == 4096
    assert fake_kernels.args == [(code, 128)]
    with pytest.raises(ValueError, match="no flash kernel"):
        port_attn.wgmma_smem_bytes("flash_bwd", 64)


def test_reset_launches_clears_totals_and_variants():
    port_attn.LAUNCHES["flash_fwd"] += 3
    port_attn.LAUNCHES_BY_VARIANT["flash_bwd_dkv:wgmma"] += 2
    port_attn.LAUNCHES_BY_VARIANT["flash_bwd_dq:wgmma"] += 1
    port_attn.reset_launches()
    assert set(port_attn.LAUNCHES.values()) == {0}
    assert set(port_attn.LAUNCHES_BY_VARIANT.values()) == {0}
    assert {key.split(":")[0] for key in port_attn.LAUNCHES_BY_VARIANT} == set(port_attn.LAUNCHES)


def test_flash_library_hashes_the_headers_it_includes():
    names = [p.name for p in _build._sources_of("flash_attention")]
    assert names == ["flash_attention.cu", "hopper_tc.cuh"]
    assert [p.name for p in _build._sources_of("elbo")] == ["elbo.cu"]


def test_an_edited_header_changes_the_library_path(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "unused.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "SOURCES", {"k": "k.cu"})
    first = _build.library_path("k")
    (tmp_path / "unused.cuh").write_text("// edited, still not included\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\nint k2;\n')
    assert _build.library_path("k") not in (first, second)


def test_the_ablation_variants_still_apply_to_the_source():
    # ops/flash_ablation.py edits flash_attention.cu by substitution; each
    # edit must still find its text, or the variant would time the base.
    from multidisttorch_tpu_torch.ops import flash_ablation

    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    assert flash_ablation.VARIANTS["base"] == []
    for name, subs in flash_ablation.VARIANTS.items():
        for old, _ in subs:
            assert src.count(old) == 1, (name, old)
