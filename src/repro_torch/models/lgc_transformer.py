"""The 100M-parameter federated transformer task (``qwen2_100m``).

Port of ``repro/models/lgc_transformer.py:49-208``.  The reference maps the
FL devices onto a mesh; here there is no mesh: the M FL devices live on the
one card, and :func:`repro_torch.launch.steps.make_lgc_train_step` runs them
one after another and takes the mean of their compressed updates where the
reference calls ``pmean``.  Everything else mirrors the reference: f32 net
progress, ``w.f32 - lr * g`` cast back to ``w.dtype``, ``ef += g - g_wire``,
the server subtract, the stacked (M, ...) error memory.

Only the ``static`` scenario runs: its delivery mask is all ones.  The
other scenarios draw their masks from the reference's threefry streams and
wait for the PRNG slice (ROADMAP A1, A3, A7).  The step also takes an
explicit (M, C) ``received`` mask.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (LGCStepConfig, init_ef_tree,
                                      lgc_wire_bytes_per_round,
                                      make_lgc_train_step)
from repro_torch.models import transformer as tf

PORTED_SCENARIOS = ("static",)


def _scenario_name(scenario) -> str:
    name = "static" if scenario is None else getattr(scenario, "name",
                                                     scenario)
    if name not in PORTED_SCENARIOS:
        raise NotImplementedError(
            f"scenario {name!r} is not ported yet: its delivery masks come "
            "from the reference's threefry streams (ROADMAP A1, A3, A7); "
            f"ported: {PORTED_SCENARIOS}")
    return name


@dataclasses.dataclass
class LGCTransformerTask:
    """A registry task backed by the one-card LGC train step.

    ``build()`` makes params, error memory, step and token pipeline once;
    ``run(steps)`` trains and returns the loss trajectory plus wire
    accounting, as the reference's task does.
    """
    arch: ArchConfig
    m_devices: int
    scenario: str
    step_cfg: LGCStepConfig
    device: torch.device
    batch_per_device: int = 2
    seq: int = 64
    seed: int = 0
    name: str = "qwen2-100m"

    _built: dict | None = dataclasses.field(default=None, repr=False)

    def param_count(self) -> int:
        return tf.param_count(self.arch)

    def wire_bytes_per_round(self) -> int:
        """Per-device uplink bytes under the configured aggregate mode."""
        shapes = tf.init_params(self.arch, device="meta")
        return lgc_wire_bytes_per_round(shapes, self.step_cfg)[
            self.step_cfg.aggregate]

    # -- construction -------------------------------------------------------

    def build(self, params: dict | None = None) -> dict:
        """Make the state once.  ``params`` (e.g. from
        :func:`repro_torch.weights.params_from_jax`) replaces the random
        init; it must have the config's names and shapes."""
        if self._built is not None:
            return self._built
        shapes = tf.init_params(self.arch, device="meta")
        if params is None:
            params = tf.init_params(self.arch, seed=self.seed,
                                    device=self.device)
        else:
            if list(params) != list(shapes) or any(
                    params[k].shape != shapes[k].shape for k in shapes):
                raise ValueError("params do not match the config's leaves")
            params = {k: v.to(self.device, self.arch.dtype)
                      for k, v in params.items()}
        pipe = TokenPipeline(self.arch.vocab_size, self.seq,
                             self.batch_per_device * self.m_devices,
                             seed=self.seed)
        # the reference draws one batch at build time (to derive its batch
        # shardings) and trains from the second: draw it too, so the same
        # seed trains on the same batches
        pipe.next_batch()
        ef = init_ef_tree(params, self.m_devices,
                          getattr(torch, self.step_cfg.ef_dtype))
        step = make_lgc_train_step(self.arch, self.m_devices, self.step_cfg)
        received = torch.ones((self.m_devices, self.step_cfg.n_channels),
                              dtype=torch.int32, device=self.device)
        self._built = dict(params=params, ef=ef, step=step, pipe=pipe,
                           received=received)
        return self._built

    def next_batch(self) -> dict:
        x, y = self.build()["pipe"].next_batch()
        return {"tokens": torch.from_numpy(x).to(self.device, torch.long),
                "labels": torch.from_numpy(y).to(self.device, torch.long)}

    # -- training -----------------------------------------------------------

    def run(self, steps: int, log_every: int = 0) -> dict:
        """Train for ``steps`` sync rounds; returns losses + throughput +
        wire accounting."""
        b = self.build()
        params, ef, step = b["params"], b["ef"], b["step"]
        losses, t_steady = [], None
        t0 = time.perf_counter()
        for i in range(steps):
            params, ef, loss = step(params, ef, self.next_batch(),
                                    b["received"])
            losses.append(float(loss))   # float() waits for the round
            if i == 0:
                t_steady = time.perf_counter()   # exclude first-call set-up
            if log_every and (i % log_every == 0 or i == steps - 1):
                print(f"[{self.name}] round {i:4d} loss {losses[-1]:.4f} "
                      f"({time.perf_counter() - t0:.0f}s)")
        steady_s = (time.perf_counter() - t_steady) if steps > 1 else 0.0
        # device-steps/s: every round advances each of the M devices by H
        dev_steps = (steps - 1) * self.m_devices * self.step_cfg.local_steps
        b["params"], b["ef"] = params, ef
        return {
            "losses": losses,
            "device_steps_per_s": (dev_steps / steady_s) if steady_s else 0.0,
            "wire_bytes_per_round_per_device": self.wire_bytes_per_round(),
            "param_count": self.param_count(),
        }


def make_qwen2_100m_task(m_devices: int = 8, seed: int = 0,
                         scenario=None, preset: str = "full",
                         sparsity: tuple = (0.01, 0.02, 0.02),
                         aggregate: str = "sparse_gather",
                         local_steps: int = 2, local_lr: float = 3e-3,
                         batch_per_device: int = 2, seq: int = 64,
                         backend: str = "pallas",
                         pallas_min_elems: int | None = None,
                         model_axis: int = 1,
                         arch: ArchConfig | None = None,
                         device: str | torch.device | None = None
                         ) -> LGCTransformerTask:
    """Factory behind ``make_task("qwen2_100m", ...)``, with the reference's
    defaults.  ``preset="full"`` is the real ~128M-parameter config,
    ``preset="smoke"`` a tiny same-shape variant.  The reference's default
    ``aggregate="sparse_gather"`` is not ported yet and raises; pass
    ``aggregate="dense_masked"`` (or ``"none"``).  ``device=None`` means the
    card and raises without CUDA.
    """
    dev = resolve_device(device)
    if model_axis != 1:
        raise NotImplementedError("model_axis > 1 (tensor parallelism) is "
                                  "not ported (ROADMAP A12)")
    if arch is None:
        arch = (get_config("qwen2-100m") if preset == "full"
                else get_smoke_config("qwen2-100m"))
    scn = _scenario_name(scenario)
    kw = {} if pallas_min_elems is None else {
        "pallas_min_elems": pallas_min_elems}
    step_cfg = LGCStepConfig(local_steps=local_steps, local_lr=local_lr,
                             sparsity=tuple(sparsity), aggregate=aggregate,
                             backend=backend, **kw)
    return LGCTransformerTask(arch=arch, m_devices=m_devices, scenario=scn,
                              step_cfg=step_cfg, device=dev, seed=seed,
                              batch_per_device=batch_per_device, seq=seq,
                              name=arch.name)
