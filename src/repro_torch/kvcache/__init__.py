# Packed quantized decode state (dense container) and its bit resolution.
from .cache import (  # noqa: F401
    DEFAULT_BLOCK,
    QuantizedKVLayer,
    append_token,
    init_kv_layer,
    insert_rows,
    insert_state_rows,
    quantize_kv_rows,
)
from .policy import (  # noqa: F401
    kv_entry_names,
    packed_state_bits,
    resolve_state_bits,
    state_bits_by_name,
    state_layer_infos,
)
