"""Simulator core of the port: counter-based randomness, channels and
scenarios, the LGC compressors with error feedback, the server registry and
the loop engine (``repro/core``, ROADMAP A1-A5)."""
from .channels import (DEFAULT_CHANNELS, ChannelSpec, DeviceProfile,
                       comm_cost, comp_cost, sample_channels_from,
                       stack_specs)
from .compressor import (PALLAS_MIN_ELEMS, LGCCompressor, flatten_tree,
                         lgc_compress, lgc_layers, qsgd_dequantize,
                         qsgd_quantize, top_k, tree_size, unflatten_like,
                         wire_bytes)
from .error_feedback import EFState, ef_compress, init_ef
from .fl import (ControllerFleet, FixedController, FLConfig, FLTask, History,
                 LGCSimulator, RoundDecision, run_baseline)
from .scenario import (SCENARIOS, Scenario, get_scenario, init_carry,
                       sample_from_carry, step_carry, stream_key)
from .server import AGGREGATORS, get_aggregator

__all__ = [
    "DEFAULT_CHANNELS", "ChannelSpec", "DeviceProfile", "comm_cost",
    "comp_cost", "sample_channels_from", "stack_specs",
    "PALLAS_MIN_ELEMS", "LGCCompressor", "flatten_tree", "lgc_compress",
    "lgc_layers", "qsgd_dequantize", "qsgd_quantize", "top_k", "tree_size",
    "unflatten_like", "wire_bytes",
    "EFState", "ef_compress", "init_ef",
    "ControllerFleet", "FixedController", "FLConfig", "FLTask", "History",
    "LGCSimulator", "RoundDecision", "run_baseline",
    "SCENARIOS", "Scenario", "get_scenario", "init_carry",
    "sample_from_carry", "step_carry", "stream_key",
    "AGGREGATORS", "get_aggregator",
]
