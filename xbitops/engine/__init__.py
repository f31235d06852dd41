from xbitops.engine.engine import Completion, Engine, Request  # noqa: F401
from xbitops.engine.sampling import sample_tokens  # noqa: F401
