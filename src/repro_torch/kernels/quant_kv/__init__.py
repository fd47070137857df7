# Quantized-KV decode step (dense cache): ops dispatch, plain version
# (ref.py) and the CUDA binding (kernel.py).
from .ops import (quant_kv_append, quant_kv_attention,  # noqa: F401
                  quant_kv_decode_step, resolve_impl)
