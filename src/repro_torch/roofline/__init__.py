# The three-term roofline model (port of ``repro/roofline/model.py``) with the
# port's H100 spec.  The HLO parsers of ``repro/roofline`` (extract, hlo_cost,
# reprice) read XLA's compiled modules and have no twin here.
from .model import H100_SXM, HwSpec, RooflineTerms, active_params, model_flops, roofline_terms  # noqa: F401
