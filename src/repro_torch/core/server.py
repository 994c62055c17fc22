"""Server aggregation modes: the registry.

Port of ``repro/core/server.py:84-115``: :class:`AggregatorSpec`,
:data:`AGGREGATORS` and :func:`get_aggregator`.  Only ``"mean"`` (the
synchronous cohort mean) runs in the port so far; the simulator raises for
``"diloco"`` and ``"semi_sync"``, whose server math (the Nesterov outer
step, the staleness ring and its deadline) is ROADMAP A10.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AggregatorSpec:
    """One server aggregation mode (an :data:`AGGREGATORS` entry)."""
    name: str
    uses_timing: bool       # window needs per-device times + a deadline
    carries_state: bool     # window threads a ServerState carry
    doc: str


AGGREGATORS: dict[str, AggregatorSpec] = {
    "mean": AggregatorSpec(
        "mean", uses_timing=False, carries_state=False,
        doc="synchronous cohort mean (the default)"),
    "diloco": AggregatorSpec(
        "diloco", uses_timing=False, carries_state=True,
        doc="H inner SGD steps per device, Nesterov-momentum outer step on "
            "the averaged net delta (outer_lr / outer_momentum)"),
    "semi_sync": AggregatorSpec(
        "semi_sync", uses_timing=True, carries_state=True,
        doc="per-window uplink deadline; late updates fold s windows later "
            "with weight 1/(1+s)^alpha up to staleness_cap, EF carrying the "
            "undelivered mass"),
}


def get_aggregator(name: str) -> AggregatorSpec:
    """Resolve a registry name, raising on unknown aggregators."""
    try:
        return AGGREGATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; registered: "
            f"{sorted(AGGREGATORS)}") from None
