# SigmaQuant's core: bit policies and artifacts, the two-phase controller,
# packing, the quantizer, statistics, clustering and the baselines.
from .policy import (  # noqa: F401
    BitPolicy,
    Budget,
    BudgetItem,
    LayerInfo,
    PolicyArtifact,
    Targets,
    Zone,
    classify_zone,
    layer_registry_hash,
)
from .controller import (  # noqa: F401
    ControllerConfig,
    QuantEnv,
    SigmaQuantController,
    SigmaQuantResult,
)
from . import baselines, clustering, hardware, packing, quantizer, stats  # noqa: F401
