"""xbitops — weight-only quantized inference framework in JAX.

A from-scratch JAX/Pallas rebuild of the capabilities of wejoncy/XbitOps
(2–8-bit GPTQ-packed weight dequantization and fused A16Wx GEMV/GEMM), extended
with tensor-parallel sharding over device meshes, a quantized Llama decode engine,
and continuous batching.

Public reference-compatible surface (reference ``dq_torch_ops.cc:80-85``):
    - :func:`dequant`  — unpack 1–8-bit packed weights to fp16/bf16
    - :func:`gemv`     — fused dequantize + A16Wx GEMV/GEMM

Native surface:
    - :class:`QTensor`, :func:`from_gptq`, :func:`quantize_array` — packed layout
    - :func:`qmatmul` — fused quantized matmul on a QTensor
"""

from xbitops.formats import (  # noqa: F401
    PLANE_DECOMP,
    QTensor,
    from_gptq,
    gptq_pack,
    gptq_unpack_weight,
    gptq_unpack_zeros,
    make_qtensor,
    quantize,
)
from xbitops.ops.dequant import dequant  # noqa: F401
from xbitops.ops.gptq import (  # noqa: F401
    gptq_quantize_array,
    hessian_from_inputs,
    quantize_model_gptq,
)
from xbitops.ops.qmatmul import gemv, qmatmul  # noqa: F401
from xbitops.ops.quantize import quantize_array, requantize_a8  # noqa: F401

__version__ = "0.1.0"
