"""Fixture generation: reproducible quantized test tensors + on-disk bundles.

Replaces the reference's offline ``.bin`` fixture dumps (``main.cc:11-82`` read
them from an absolute path; ours are generated deterministically from a seed and
written in the layout ``cpp/xbit_verify.cc`` consumes)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from xbitops import formats
from xbitops.utils import cpp_oracle


@dataclass
class Fixture:
    """One quantized-GEMV test case in the GPTQ interchange layout."""

    a: np.ndarray  # fp16 [M, K]
    qweight: np.ndarray  # int32
    scales: np.ndarray  # fp16 [G, N]
    qzeros: np.ndarray  # int32
    weight: np.ndarray  # fp16 [K, N] golden dequantized weights (C++ oracle)
    out: np.ndarray  # fp16 [M, N] golden gemv output (C++ oracle)
    bits: int
    group_size: int
    K: int
    N: int
    M: int
    add_zero_bias: int = 0


def make_fixture(
    M: int, K: int, N: int, bits: int, group_size: int, seed: int = 0,
    add_zero_bias: int = 0,
) -> Fixture:
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((M, K)) * 0.5).astype(np.float16)
    wq, scales, zeros = formats.quantize(w, bits, group_size)
    if add_zero_bias:
        zeros = zeros - add_zero_bias  # stored zero-bias convention (old GPTQ)
    qweight, scales16, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    weight = cpp_oracle.dequant_f16(
        qweight, scales16, qzeros, bits, group_size, K, add_zero_bias
    )
    out = cpp_oracle.gemv_f16(
        a, qweight, scales16, qzeros, bits, group_size, K, add_zero_bias
    )
    return Fixture(a, qweight, scales16, qzeros, weight, out, bits, group_size, K, N, M,
                   add_zero_bias)


def write_fixture(fx: Fixture, dir_path: str | Path) -> Path:
    """Write the raw-binary layout ``xbit_verify`` reads."""
    d = Path(dir_path)
    d.mkdir(parents=True, exist_ok=True)
    (d / "shape.txt").write_text(
        f"{fx.K} {fx.N} {fx.bits} {fx.group_size} {fx.add_zero_bias} {fx.M}\n"
    )
    fx.a.astype(np.float16).tofile(d / "input.bin")
    fx.qweight.astype(np.int32).tofile(d / "qweight.bin")
    fx.scales.astype(np.float16).tofile(d / "scales.bin")
    fx.qzeros.astype(np.int32).tofile(d / "qzeros.bin")
    fx.weight.astype(np.float16).tofile(d / "weight.bin")
    fx.out.astype(np.float16).tofile(d / "out.bin")
    return d
