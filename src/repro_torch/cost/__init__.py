# The multi-constraint cost-model seam: one CostReport vector, swappable
# hardware backends.  Importing the package registers both backends (the
# roofline one priced on the port's H100 spec).
from .base import (  # noqa: F401
    CostModel,
    CostReport,
    available_cost_models,
    get_cost_model,
    register_cost_model,
)
from .roofline import RooflineCostModel  # noqa: F401
from .shift_add import ShiftAddCostModel  # noqa: F401
