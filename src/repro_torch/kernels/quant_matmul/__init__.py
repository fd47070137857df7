# Packed low-bit GEMM (prefill linears): ops dispatch, plain version
# (ref.py) and the CUDA binding (kernel.py).
