# Per-channel fake quantization for QAT and its straight-through backward:
# ops dispatch, plain version (ref.py) and the CUDA binding (kernel.py).
