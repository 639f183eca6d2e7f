"""The numerical premise of the fp32 flash kernel (``csrc/flash_attention_f32.cu``):
attention whose two products each run as three TF32 products (3xTF32) stays
within the 1e-4 gate that ``chip_smoke.py`` holds the kernel to, where one
TF32 product does not.

numpy only. Each fp32 operand x is split as the kernel splits it: hi = x
rounded to TF32 (10 mantissa bits; the kernel's ``cvt.rna``, or truncated),
lo = x - hi rounded the same way; a product a b runs as a_hi b_hi + a_hi b_lo
+ a_lo b_hi. TF32 values multiply exactly in fp32, so fp32 matrix products of
the parts stand for the tensor core's products with fp32 sums. The scores,
the softmax and P stay fp32, P is split like the operands, and the result is
held against a float64 reference by ``max |o - ref| / max |ref|``.
"""

import numpy as np
import pytest

SQ = SK = D = 512
GATE = 1e-4  # chip_smoke.F32_KERNEL_TOL


def tf32(x: np.ndarray, mode: str) -> np.ndarray:
    """fp32 ``x`` rounded to TF32: to nearest with ties away from zero
    (``"rna"``, ``cvt.rna.tf32.f32``) or truncated (``"trunc"``)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    if mode == "rna":
        u = u + np.uint32(0x1000)  # half of the 13 dropped bits, on the magnitude
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray, mode: str):
    hi = tf32(x, mode)
    return hi, tf32(x - hi, mode)


def product(a: np.ndarray, b: np.ndarray, mode: str, passes: int) -> np.ndarray:
    """``a @ b`` in fp32 from TF32 parts: three products, or hi*hi alone."""
    a_hi, a_lo = split(a, mode)
    b_hi, b_lo = split(b, mode)
    out = a_hi @ b_hi
    if passes == 3:
        out = out + (a_hi @ b_lo + a_lo @ b_hi)
    return out


def attention_tf32(q, k, v, scale, mode, passes):
    s = product(q, k.T, mode, passes) * np.float32(scale)
    p = np.exp(s - s.max(axis=-1, keepdims=True)).astype(np.float32)
    return product(p, v, mode, passes) / p.sum(axis=-1, keepdims=True)


def inputs(input_scale: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((n, D)) * input_scale).astype(np.float32)
                 for n in (SQ, SK, SK))


def rel_err(q, k, v, scale, mode, passes) -> float:
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    s = q64 @ k64.T * scale
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    ref = (p @ v64) / p.sum(axis=-1, keepdims=True)
    out = attention_tf32(q, k, v, scale, mode, passes)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 1 + 2**-10 + 2**-12], np.float32)
    assert tf32(x, "rna").tolist() == [1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1 + 2**-10]
    assert tf32(x, "trunc").tolist() == [1.0, 1 + 2**-10, -1.0, 1 + 2**-10]
    x = (np.random.default_rng(1).standard_normal(10000) * 3).astype(np.float32)
    hi, lo = split(x, "rna")
    assert np.abs(hi.astype(np.float64) - x).max() <= 2.0**-11 * np.abs(x).max()
    # hi + lo keeps 22 of fp32's 24 bits (lo rounds the 13 bits past hi to 11)
    assert (np.abs(hi.astype(np.float64) + lo - x) <= 2.0**-22 * np.abs(x)).all()


@pytest.mark.parametrize("input_scale", [1.0, 3.0])
@pytest.mark.parametrize("mode", ["rna", "trunc"])
def test_three_tf32_products_are_near_fp32(mode, input_scale):
    """3xTF32 attention within 1e-5 of float64: ten times inside the gate."""
    q, k, v = inputs(input_scale)
    assert rel_err(q, k, v, D ** -0.5, mode, 3) <= 1e-5


def test_one_tf32_product_fails_the_gate():
    """One TF32 product per product lands past 1e-4: the gate tells the
    routes apart."""
    q, k, v = inputs(1.0)
    assert rel_err(q, k, v, D ** -0.5, "rna", 1) > GATE
