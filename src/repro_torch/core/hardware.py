"""DEPRECATED compat shim (port of ``repro/core/hardware.py``): the shift-add
PPA model lives in ``repro_torch.cost.shift_add``.

The analytical 28 nm shift-add MAC model (paper §III-B, Table VI, Fig. 5)
sits behind the swappable ``CostModel`` seam beside the roofline backend;
import :mod:`repro_torch.cost` for new code.  Everything historically
importable from here still resolves to the exact same objects (Table VI /
Fig. 5 values unchanged), but each access emits a ``DeprecationWarning``
via module ``__getattr__``; importing ``repro_torch.core`` alone stays silent.
"""
from __future__ import annotations

import warnings

from repro_torch.cost import shift_add as _shift_add

_EXPORTS = (
    "AREA_UM2",
    "ENERGY_ALPHA",
    "ENERGY_BETA",
    "FP_ENERGY_X",
    "HardwareReport",
    "ShiftAddCostModel",
    "area_saving_vs_int8",
    "evaluate_policy",
    "mac_cycles",
    "mac_energy",
    "uniform_sweep",
)


def __getattr__(name: str):
    if name in _EXPORTS:
        warnings.warn(
            f"repro_torch.core.hardware.{name} is deprecated; import it from "
            "repro_torch.cost.shift_add (the CostModel seam)",
            DeprecationWarning, stacklevel=2)
        return getattr(_shift_add, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(_EXPORTS)
