from xbitops.ops.dequant import dequant, dequant_qtensor  # noqa: F401
from xbitops.ops.dense import dense_matmul  # noqa: F401
from xbitops.ops.qmatmul import gemv, qmatmul  # noqa: F401
from xbitops.ops.quantize import quantize_array  # noqa: F401
