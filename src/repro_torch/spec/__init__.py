"""Self-speculative decoding (port of ``repro/spec``): a low-bit *draft*
re-packing of the SAME weights proposes K tokens, the deployed policy
verifies them in one batched pass, and the engine rewinds the quantized
cache to the accepted prefix.

* ``draft``  derives the draft weight containers from a second ``BitPolicy``;
* ``loop``   holds the accept/reject math and the cache snapshot/replay commit.
"""
from .draft import build_draft_params  # noqa: F401
