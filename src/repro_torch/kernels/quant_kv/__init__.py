# Quantized-KV decode step (dense cache): ops dispatch, plain version
# (ref.py) and the CUDA binding (kernel.py).
