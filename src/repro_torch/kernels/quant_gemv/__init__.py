# Skinny-M packed low-bit GEMV (decode linears): ops dispatch, plain
# version (ref.py) and the CUDA binding (kernel.py).
