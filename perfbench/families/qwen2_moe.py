"""Qwen2-MoE (``model_type`` ``qwen2_moe``): the Qwen2 decoder with
sparse experts, whose four functions (:mod:`families.qwen2`) read the
experts from the configuration file."""
from pathlib import Path

import harness as H

_QWEN2 = H.module_at("families", "qwen2", Path(__file__).resolve().parents[1])

port_config = _QWEN2.port_config
leaf_specs = _QWEN2.leaf_specs
readings = _QWEN2.readings
counts = _QWEN2.counts
