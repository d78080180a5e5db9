"""The serving tiers' products on the card against the CPU's route.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device and
skips when there is no card. The file imports no JAX, so it runs on the
card's machine: ``python -m pytest --noconftest
tests/test_torch_serving_card.py -q``.

Tolerances, with their reasons:
- ``matmul_f32`` in bf16 (``torch.mm(..., out_dtype=torch.float32)`` on the
  card, fp32-widened operands on the CPU): every product of two bf16
  values is exact in fp32 and only the order of the fp32 sums differs, so
  each element may differ by 1e-5 of the sum of its products' magnitudes
  (about 7 x sqrt(K) fp32 ulps at K = 2048); a result rounded to bf16
  anywhere would miss that by far.
- ``int8_matmul``: bitwise (an exact int32 product on both sides).
- W8A8 ``linear``: bitwise. The per-token quantization is IEEE division,
  round half to even and clamp on both sides, the product is exact and the
  epilogue is the same fp32 multiplications, then one cast.
"""

import numpy as np
import pytest
import torch

from open_pi_zero_torch.ops import linear as t_lin
from open_pi_zero_torch.ops import quantization as t_quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _operands(m=276, k=2048, n=2560, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, n)) / k**0.5).astype(np.float32))
    return x, w


@pytest.mark.parametrize("shape", [(1, 276, 2048), (4, 281, 1024)])
def test_matmul_f32_card_matches_cpu_route(cuda, shape):
    x, w = _operands(m=shape[0] * shape[1], k=shape[2], n=512)
    x, w = x.reshape(*shape).bfloat16(), w.bfloat16()
    got = t_lin.matmul_f32(x.to(cuda), w.to(cuda)).cpu()
    want = t_lin.matmul_f32(x, w)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    noise = 1e-5 * torch.matmul(x.float().abs(), w.float().abs())
    assert bool(((got - want).abs() <= noise).all()), float(((got - want).abs() / noise).max())


@pytest.mark.parametrize("column_major", [False, True])
def test_int8_matmul_card_is_bitwise_cpu(cuda, column_major):
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (276, 2048), dtype=torch.int8, generator=gen)
    b = torch.randint(-127, 128, (2048, 2560), dtype=torch.int8, generator=gen)
    b_card = b.to(cuda)
    if column_major:  # the W8A8 payload's layout (int8_mm_layout)
        b_card = t_quant.int8_mm_layout(b_card)
    assert torch.equal(t_lin.int8_matmul(a.to(cuda), b_card).cpu(), t_lin.int8_matmul(a, b))


@pytest.mark.parametrize("m, k, n", [(276, 2044, 2560), (276, 2048, 2564)])
def test_int8_matmul_refuses_what_the_card_cannot_take(cuda, m, k, n):
    a = torch.zeros((m, k), dtype=torch.int8, device=cuda)
    b = torch.zeros((k, n), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        t_lin.int8_matmul(a, b)


@pytest.mark.parametrize("m", [1, 2, 16])
def test_int8_matmul_pads_few_rows_on_the_card(cuda, m):
    """A decode step's B rows, padded to 17 on the card: bitwise the CPU's
    unpadded product."""
    gen = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, 2048), dtype=torch.int8, generator=gen)
    b = torch.randint(-127, 128, (2048, 2560), dtype=torch.int8, generator=gen)
    got = t_lin.int8_matmul(a.to(cuda), t_quant.int8_mm_layout(b.to(cuda))).cpu()
    assert torch.equal(got, t_lin.int8_matmul(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_linear_card_is_bitwise_cpu(cuda, dtype):
    x, w = _operands()
    q, scale = t_quant.quantize_int8_rowwise(w)
    kernel = {"qa": t_quant.int8_mm_layout(q), "scale": scale}
    bias = torch.linspace(-0.1, 0.1, w.shape[1])
    x, bias = x.to(dtype), bias.to(dtype)
    want = t_lin.linear(x, kernel, bias)
    got = t_lin.linear(x.to(cuda), {k: v.to(cuda) for k, v in kernel.items()}, bias.to(cuda)).cpu()
    assert torch.equal(got, want)
