"""Hand-written Hopper kernels behind the JAX package's ``impl`` dispatch.

Each family's ``ops.py`` takes ``impl`` in {"auto", "cuda", "torch"}:
"auto" launches the CUDA kernel for CUDA tensors and runs the plain PyTorch
version (``ref.py``) for CPU tensors; "cuda" on a CPU tensor raises.

``LAUNCHES`` counts kernel launches (incremented by each wrapper in
``kernel.py`` right where it launches) and ``PLAIN_CALLS`` counts calls of
the plain versions, so a run can show which of the two it went through.
"""
from __future__ import annotations

KERNELS = ("quant_gemv", "quant_matmul", "quant_kv_decode_step", "quant_kv_attention_paged",
           "quant_kv_decode_step_paged", "quant_kv_append_paged", "quant_kv_attention",
           "quant_kv_append", "fake_quant", "fake_quant_ste_bwd", "quant_kv_decode_step_proj",
           "quant_gemv_experts", "quant_matmul_experts")

LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS: dict[str, int] = dict.fromkeys(KERNELS, 0)

IMPLS = ("auto", "cuda", "torch")


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in PLAIN_CALLS:
        PLAIN_CALLS[name] = 0


def resolve_impl(impl: str, device) -> str:
    """The impl a call dispatches to: "cuda" or "torch" (``"auto"`` resolved).

    Decided by where the tensors lie, never by what is installed: "auto" on
    a CUDA tensor means the kernel, and "cuda" on a CPU tensor is an error.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    on_cuda = getattr(device, "type", device) == "cuda"
    if impl == "auto":
        return "cuda" if on_cuda else "torch"
    if impl == "cuda" and not on_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; pass impl='torch' or "
                         "'auto' for CPU tensors")
    return impl
