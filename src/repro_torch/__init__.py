"""PyTorch / CUDA port of the SigmaQuant serving stack (the JAX package
``repro`` is the reference).  The layout mirrors ``repro``: ``configs``,
``core``, ``quant``, ``kernels/<family>/{ops,ref,kernel}.py``, ``kvcache``,
``models``, ``serve``, ``launch``; the hand-written CUDA sources are in
``csrc``.  Importing the package loads no kernel and touches no device."""
