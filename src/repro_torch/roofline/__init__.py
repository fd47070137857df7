# The three-term roofline model (port of ``repro/roofline/model.py``) with the
# port's H100 spec, and the op-level cost analysis of a traced run that takes
# the place of the reference's HLO parsers (``hlo_cost``, ``extract``,
# ``reprice``).
from .model import H100_SXM, HwSpec, RooflineTerms, active_params, model_flops, roofline_terms  # noqa: F401
from .extract import collective_bytes, cost_summary, CollectiveStats  # noqa: F401
from . import hlo_cost  # noqa: F401
