# The multi-constraint cost-model seam: one CostReport vector, swappable
# hardware backends.  Importing the package registers the shift-add backend;
# the roofline backend prices against a TPU spec and is not ported.
from .base import (  # noqa: F401
    CostModel,
    CostReport,
    available_cost_models,
    get_cost_model,
    register_cost_model,
)
from .shift_add import ShiftAddCostModel  # noqa: F401
