"""Bitwidth policies and layer registries (the data types of ``repro/core/policy.py``).

A ``BitPolicy`` maps quantizable-layer names to weight bits, plus a global
activation bitwidth.  Its JSON form is the JAX package's, so a policy moves
between the two packages unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Mapping

import numpy as np

from . import packing


@dataclasses.dataclass(frozen=True)
class LayerInfo:
    """Static description of one quantizable layer.

    ``kind == "state"`` marks a decode-state surface (a KV cache tensor):
    it is priced by ``state_bytes`` and left out of the weight metrics.
    """

    name: str
    shape: tuple[int, ...]
    macs: int
    kind: str = "dense"  # dense | embedding | conv | expert | state

    @property
    def n_params(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass
class BitPolicy:
    """Ordered per-layer weight bits + global activation bits."""

    layers: tuple[LayerInfo, ...]
    bits: dict[str, int]
    act_bits: int = 8

    @classmethod
    def uniform(cls, layers: Iterable[LayerInfo], w_bits: int, act_bits: int = 8) -> "BitPolicy":
        layers = tuple(layers)
        return cls(layers, {l.name: int(w_bits) for l in layers}, act_bits)

    @classmethod
    def from_bits(cls, layers: Iterable[LayerInfo], bits: Mapping[str, int],
                  act_bits: int = 8) -> "BitPolicy":
        layers = tuple(layers)
        missing = [l.name for l in layers if l.name not in bits]
        if missing:
            raise KeyError(f"policy missing layers: {missing[:5]}")
        return cls(layers, {l.name: int(bits[l.name]) for l in layers}, act_bits)

    def weight_layers(self) -> tuple[LayerInfo, ...]:
        return tuple(l for l in self.layers if l.kind != "state")

    def state_layers(self) -> tuple[LayerInfo, ...]:
        return tuple(l for l in self.layers if l.kind == "state")

    def container_bytes(self) -> int:
        return sum(packing.container_bytes(l.shape, self.bits[l.name])
                   for l in self.weight_layers())

    def state_bytes(self) -> int:
        """Packed container bytes of the decode state (int lanes only, no scales)."""
        return sum(packing.container_bytes(l.shape, self.bits[l.name])
                   for l in self.state_layers())

    def bit_vector(self) -> np.ndarray:
        return np.asarray([self.bits[l.name] for l in self.layers], dtype=np.int64)

    def mean_bits(self) -> float:
        sizes = np.asarray([l.n_params for l in self.layers], dtype=np.float64)
        return float((self.bit_vector() * sizes).sum() / sizes.sum())

    def to_json(self) -> str:
        return json.dumps(
            {
                "act_bits": self.act_bits,
                "bits": self.bits,
                "layers": [dataclasses.asdict(l) for l in self.layers],
            },
            indent=2,
            default=lambda o: list(o) if isinstance(o, tuple) else o,
        )

    @classmethod
    def from_json(cls, s: str) -> "BitPolicy":
        d = json.loads(s)
        layers = tuple(
            LayerInfo(x["name"], tuple(x["shape"]), int(x["macs"]), x.get("kind", "dense"))
            for x in d["layers"]
        )
        return cls(layers, {k: int(v) for k, v in d["bits"].items()}, int(d["act_bits"]))
