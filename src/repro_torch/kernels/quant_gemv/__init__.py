# Skinny-M packed low-bit GEMV (decode linears): ops dispatch, plain
# version (ref.py) and the CUDA binding (kernel.py).
from .ops import quant_gemv  # noqa: F401
from .kernel import GEMV_MAX_M  # noqa: F401
from .ref import quant_gemv_ref  # noqa: F401
