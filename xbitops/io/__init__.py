from xbitops.io.gptq_loader import load_autogptq  # noqa: F401
from xbitops.io.checkpoint import load_packed, save_packed  # noqa: F401
