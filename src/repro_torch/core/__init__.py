"""Simulator core of the port: counter-based randomness, channels and
scenarios, the LGC compressors with error feedback and per-layer budgets,
the server aggregation modes, the engines, the DDPG control plane, the
spend audit, the population layer, the sharded engine's FL axis and the
convergence bound (``repro/core``, ROADMAP A1-A12)."""
from .channels import (DEFAULT_CHANNELS, ChannelSpec, DeviceProfile,
                       comm_cost, comp_cost, sample_channels_from,
                       stack_specs)
from .compressor import (LAYER_POLICIES, PALLAS_MIN_ELEMS, LGCCompressor,
                         flatten_tree, layer_budgets, lgc_compress,
                         lgc_layers, per_layer_compress,
                         per_layer_wire_bytes, qsgd_dequantize,
                         qsgd_quantize, top_k, tree_layer_slices, tree_size,
                         unflatten_like, wire_bytes)
from .error_feedback import (EF_STORES, DenseEFStore, EFState, Int8EFStore,
                             ServerEFStore, ef_compress, init_ef,
                             make_ef_store)
from .fl import (ControllerFleet, FixedController, FLConfig, FLTask, History,
                 LGCSimulator, RoundDecision, run_baseline)
from .scenario import (SCENARIOS, Scenario, get_scenario, init_carry,
                       sample_from_carry, step_carry, stream_key)
from .server import (AGGREGATORS, ServerState, get_aggregator,
                     init_server_state, window_deadline)
from .controller import (DDPGConfig, DDPGController, FleetDDPG,
                         decode_actions, make_ddpg_controllers,
                         make_fleet_ddpg, obs_dim)
from .audit import audit_simulator, recompute_spend
from .population import (COHORT_SAMPLERS, Population, make_population,
                         make_population_task, run_population, sample_cohort)
from .convergence import ProblemConstants, corollary1_rate, theorem1_bound

__all__ = [
    "DEFAULT_CHANNELS", "ChannelSpec", "DeviceProfile", "comm_cost",
    "comp_cost", "sample_channels_from", "stack_specs",
    "LAYER_POLICIES", "PALLAS_MIN_ELEMS", "LGCCompressor", "flatten_tree",
    "layer_budgets", "lgc_compress", "lgc_layers", "per_layer_compress",
    "per_layer_wire_bytes", "qsgd_dequantize", "qsgd_quantize", "top_k",
    "tree_layer_slices", "tree_size", "unflatten_like", "wire_bytes",
    "EF_STORES", "DenseEFStore", "EFState", "Int8EFStore", "ServerEFStore",
    "ef_compress", "init_ef", "make_ef_store",
    "ControllerFleet", "FixedController", "FLConfig", "FLTask", "History",
    "LGCSimulator", "RoundDecision", "run_baseline",
    "SCENARIOS", "Scenario", "get_scenario", "init_carry",
    "sample_from_carry", "step_carry", "stream_key",
    "AGGREGATORS", "ServerState", "get_aggregator", "init_server_state",
    "window_deadline",
    "DDPGConfig", "DDPGController", "FleetDDPG", "decode_actions",
    "make_ddpg_controllers", "make_fleet_ddpg", "obs_dim",
    "audit_simulator", "recompute_spend",
    "COHORT_SAMPLERS", "Population", "make_population",
    "make_population_task", "run_population", "sample_cohort",
    "ProblemConstants", "corollary1_rate", "theorem1_bound",
]
