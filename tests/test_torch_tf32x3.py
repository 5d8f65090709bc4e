"""The arithmetic of `gptst_tpu_torch/csrc/tf32x3.cuh`, modelled in torch.

`ring_spmm` and `spmm_dvals` compute their f32 products on the tensor
cores as 3xTF32: each operand splits into TF32 parts hi and lo, and
a . b is a_lo . b_hic + a_hic . b_lo + a_hi . b_hi, with hic = hi and
lo = 0 wherever the value is not finite. This file models the header's
split bit for bit (masks on `view(torch.int32)`; its exact form, which
the header's fast form equals for finite values below 0x7f7ff000), lets
each product read only the 19 bits a TF32 operand keeps, and sums the
three products of each k8 step in f32, then the steps in order. It holds the arithmetic, not the kernel: the
kernels are held against their plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).

Against the f32 product at the main paths' depths (K = 4,096 per ring
step, F = 1,024 for `spmm_dvals`), the error must stay inside the card
tolerances (`chip_smoke.py` TOL: f32 rtol/atol 1e-5, dvals rtol 1e-5 and
atol 1e-4), and NaN and Inf must land where the dense f32 product puts
them.
"""

import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread

# many tiny torch ops: one intra-op thread (the workers share the cores)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

MASK = -8192                    # 0xffffe000: the bits a TF32 value keeps
TOP = 0x7F7FF000                # |v| from here on rounds up to Inf
FLT_MAX = float(np.finfo(np.float32).max)
TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
       "dvals": dict(rtol=1e-5, atol=1e-4)}


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.contiguous().view(torch.int32)


def _float(u: torch.Tensor) -> torch.Tensor:
    return u.contiguous().view(torch.float32)


def _round(u: torch.Tensor) -> torch.Tensor:
    """To nearest TF32, ties away from zero (int32 adds wrap as the
    header's unsigned ones do)."""
    return (u + 0x1000) & MASK


def split(v: torch.Tensor):
    """(hi, hic, lo) of f32 v as the header's `split_exact` makes them."""
    u = _bits(v)
    a = u & 0x7FFFFFFF
    nonfinite = a >= 0x7F800000
    hi = torch.where(a >= TOP, u & MASK, _round(u))
    hi = torch.where(nonfinite, u, hi)
    hi = torch.where(a > 0x7F800000, u | 0x00400000, hi)
    zero = torch.zeros_like(u)
    hic = torch.where(nonfinite, zero, hi)
    lo = _round(_bits(v - _float(torch.where(nonfinite, zero, hi))))
    lo = torch.where(nonfinite, zero, lo)
    return hi, hic, lo


def _tc(u: torch.Tensor) -> torch.Tensor:
    """The value a tensor core reads from a TF32 operand register."""
    return _float(u & MASK)


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) . b (K, N) as the kernels compute it: per k8 step the two
    correction products, then the main one, into a fresh f32 sum, which
    is then added to the running f32 sum, step after step."""
    m, k = a.shape
    ah, ac, al = (_tc(t).reshape(m, k // 8, 8).transpose(0, 1)
                  for t in split(a))
    bh, bc, bl = (_tc(t).reshape(k // 8, 8, -1) for t in split(b))
    steps = (al @ bc + ac @ bl) + ah @ bh          # (K / 8, M, N)
    return steps.cumsum(0)[-1]


def _close(got, want, kind):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], **TOL[kind])


def test_split_parts_are_tf32_and_rebuild_the_value():
    """hi and lo keep only TF32 bits; hi + lo is v to 2^-22 for values
    from 2^-100 (lo a normal f32 too) up to the top binade (truncated,
    never Inf); non-finite values keep hi and have hic = lo = 0."""
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(4096) * 2.0 ** rng.integers(-100, 120, 4096))
    v = torch.tensor(np.concatenate(
        [v, [FLT_MAX, -FLT_MAX, np.nextafter(FLT_MAX, 0), 3.4e38, 1e-30]]),
        dtype=torch.float32)
    hi, hic, lo = split(v)
    assert not ((hi & ~MASK) | (lo & ~MASK)).any()
    assert torch.equal(hi, hic)
    assert bool(torch.isfinite(_float(hi)).all())
    rebuilt = _float(hi).double() + _float(lo).double()
    assert bool(((rebuilt - v.double()).abs()
                 <= 2.0 ** -22 * v.double().abs()).all())
    nf = torch.tensor([float("inf"), -float("inf"), float("nan")])
    nf = torch.cat([nf, _float(torch.tensor([0x7F800001, -0x00001FFF],
                                            dtype=torch.int32))])
    hi, hic, lo = split(nf)
    assert not hic.any() and not lo.any()
    assert torch.equal(_tc(hi)[:2], nf[:2])
    # NaNs stay NaN where the tensor core reads them, also one whose
    # payload lay only in the 13 low bits (0x7f800001) and a negative one
    assert bool(torch.isnan(_tc(hi)[2:]).all())


@pytest.mark.parametrize("name,m,k,n,kind", [
    ("ring_step", 64, 4096, 48, "f32"),     # acc += A[:, s] . buf, K = n_loc
    ("spmm_dvals", 64, 1024, 64, "dvals"),  # G[rows] . X[cols]^T, K = F
])
def test_product_within_card_tolerance(name, m, k, n, kind):
    """Finite operands: within the card tolerance of the f32 product,
    and closer to the exact product than the one TF32 product."""
    rng = np.random.default_rng(1)
    if name == "ring_step":     # every weight of the dense block nonzero
        a = rng.uniform(0.0, 1.0, (m, k)) / 8.0
    else:
        a = rng.standard_normal((m, k))
    b = rng.standard_normal((k, n))
    a, b = (torch.tensor(t, dtype=torch.float32) for t in (a, b))
    got = product(a, b)
    _close(got, a @ b, kind)
    exact = a.double() @ b.double()
    err3 = (got.double() - exact).abs().max()
    err1 = (_tc(split(a)[0]) @ _tc(split(b)[0])).double().sub(exact).abs()
    assert err3 < err1.max() / 100


def _ring_case(case: str):
    """Weights (16, 4096) with zeros, x (4096, 8), one special x value."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0.1, 1.0, (16, 4096)) * (rng.random((16, 4096)) < 0.5)
    x = rng.standard_normal((4096, 8))
    r, c = 100, 3
    if case == "inf_x":
        x[r, c] = np.inf
    elif case == "neg_inf_x":
        x[r, c] = -np.inf
    elif case == "nan_x":
        x[r, c] = np.nan
    elif case == "flt_max_x":       # the only value of its column
        x[:, c] = 0.0
        x[r, c] = FLT_MAX
    a, x = (torch.tensor(t, dtype=torch.float32) for t in (a, x))
    if case == "nan_low_payload_x":
        x[r, c] = _float(torch.tensor([0x7F800001], dtype=torch.int32))[0]
    return a, x, r, c


@pytest.mark.parametrize("case", ["inf_x", "neg_inf_x", "nan_x",
                                  "flt_max_x", "nan_low_payload_x"])
def test_nonfinite_land_where_the_dense_product_puts_them(case):
    """An Inf in x under zero and nonzero weights gives NaN and +-Inf
    where the dense f32 product does; a NaN (one with a low-bit payload
    too) fills its column; FLT_MAX under weights <= 1 stays finite."""
    a, x, r, c = _ring_case(case)
    want = a @ x
    got = product(a, x)
    _close(got, want, "f32")
    col = want[:, c]
    if case.endswith("inf_x"):
        assert bool(torch.isnan(col).any()) and bool(torch.isinf(col).any())
    elif case.startswith("nan"):
        assert bool(torch.isnan(col).all())
    else:
        assert bool(torch.isfinite(got).all()) and col.abs().max() > 1e37
    # the same with the operands' roles swapped, as spmm_dvals has them
    _close(product(x.t(), a.t()), want.t(), "f32")


def test_naive_split_turns_inf_into_nan():
    """Without the zeroing, lo(Inf) = Inf - Inf = NaN: the corrections
    turn the dense product's Inf into NaN. The header's rule keeps it."""
    a, x, r, c = _ring_case("inf_x")
    want = a @ x

    def naive(t):
        hi = _round(_bits(t))
        return _float(hi), _float(_round(_bits(t - _float(hi))))

    (ah, al), (xh, xl) = naive(a), naive(x)
    got = (al @ xh + ah @ xl) + ah @ xh
    inf = torch.isinf(want)
    assert bool(inf.any()) and bool(torch.isnan(got[inf]).all())
    _close(product(a, x), want, "f32")
