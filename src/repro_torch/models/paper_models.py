"""The task registry: ``TASKS`` and ``make_task``.

Port of ``repro/models/paper_models.py:240-285``.  Only ``qwen2_100m`` is
ported; the paper's MNIST and Shakespeare tasks raise until their ROADMAP
item.
"""
from __future__ import annotations

import dataclasses

_NOT_PORTED = {
    "lr_mnist": "ROADMAP A4",
    "cnn_mnist": "ROADMAP A7",
    "rnn_shakespeare": "ROADMAP A7",
}


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One registry workload (the reference's fields)."""
    name: str
    model: str              # "lr" | "cnn" | "gru" | "qwen2"
    dataset: str            # "mnist" | "shakespeare" | "tokens"
    partition: str

    def make(self, m_devices: int = 3, seed: int = 0, scenario=None, **kw):
        if self.name in _NOT_PORTED:
            raise NotImplementedError(
                f"task {self.name!r} is not ported yet "
                f"({_NOT_PORTED[self.name]})")
        from repro_torch.models.lgc_transformer import make_qwen2_100m_task
        return make_qwen2_100m_task(m_devices, seed=seed, scenario=scenario,
                                    **kw)


TASKS: dict[str, TaskSpec] = {
    "lr_mnist": TaskSpec("lr_mnist", model="lr", dataset="mnist",
                         partition="iid"),
    "cnn_mnist": TaskSpec("cnn_mnist", model="cnn", dataset="mnist",
                          partition="iid"),
    "rnn_shakespeare": TaskSpec("rnn_shakespeare", model="gru",
                                dataset="shakespeare",
                                partition="dirichlet"),
    "qwen2_100m": TaskSpec("qwen2_100m", model="qwen2", dataset="tokens",
                           partition="iid"),
}


def make_task(name: str, m_devices: int = 3, seed: int = 0, scenario=None,
              **kw):
    """Resolve a registry name and build the task (extra kwargs pass
    through, e.g. ``preset``/``aggregate``/``backend``/``device``)."""
    try:
        spec = TASKS[name]
    except KeyError:
        raise ValueError(
            f"unknown task {name!r}; registered: {sorted(TASKS)}") from None
    return spec.make(m_devices, seed=seed, scenario=scenario, **kw)
