"""The 100M-parameter federated transformer task (``qwen2_100m``).

Port of ``repro/models/lgc_transformer.py:49-208``.  The reference maps the
FL devices onto a mesh; here there is no mesh: the M FL devices live on the
one card, and :func:`repro_torch.launch.steps.make_lgc_train_step` runs them
one after another and takes the mean of their compressed updates where the
reference calls ``pmean`` (or sums their gathered sparse pairs).
Everything else mirrors the reference: f32 net
progress, ``w.f32 - lr * g`` cast back to ``w.dtype``, ``ef += g - g_wire``,
the server subtract, the stacked (M, ...) error memory.

The scenario drives the channels: per round the (M, C) delivery mask is
the scenario's Gilbert-Elliott state (channel c of device m up or down)
times the whole-uplink dropout, drawn from the reference's threefry
streams on the host (:meth:`LGCTransformerTask._round_mask`), so it is
bitwise the reference's; undelivered mass stays in the device's error
memory.  Under ``static`` the mask is all ones.

The model axis (``model_axis=P`` > 1, ROADMAP A12): the task runs inside a
P-rank ``torch.distributed`` group (``launch.mesh.spawn``), on a
("data", "model") = (1, P) mesh.  Each rank holds its model shard of every
leaf (``launch.sharding_rules.param_specs``), for all M devices: params
``(*shard)``, error memory ``(M, *shard)``; the FL devices stay rows, as
on one rank.  The reference's mesh is (M, P) on M * P devices, its FL
axis GSPMD's data axis, which the port folds into the rows.  Every rank
draws the whole leaves (or takes the whole tree given to ``build``) and
keeps its block, so the runs at P = 1 and at P start from the same bits;
the ranks share the batches and the masks, and every rank returns the
same ``run`` dict.  :meth:`LGCTransformerTask.gathered_state` gives the
whole params and error memory back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch import parallel
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.core.scenario import (Scenario, ScenarioCarry, dropout_mask,
                                       get_scenario, init_carry,
                                       stack_carries, step_carry_rows)
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding_rules as rules
from repro_torch.launch.steps import (LGCStepConfig, init_ef_tree,
                                      leaf_model_axis,
                                      lgc_wire_bytes_per_round,
                                      make_lgc_train_step)
from repro_torch.models import transformer as tf

@dataclasses.dataclass
class LGCTransformerTask:
    """A registry task backed by the one-card LGC train step.

    ``build()`` makes params, error memory, step and token pipeline once;
    ``run(steps)`` trains and returns the loss trajectory plus wire
    accounting, as the reference's task does.
    """
    arch: ArchConfig
    m_devices: int
    scenario: Scenario
    step_cfg: LGCStepConfig
    device: torch.device
    batch_per_device: int = 2
    seq: int = 64
    seed: int = 0
    name: str = "qwen2-100m"
    mesh: meshlib.Mesh | None = None

    _built: dict | None = dataclasses.field(default=None, repr=False)

    @property
    def model_axis(self) -> int:
        return self.mesh.model_size if self.mesh is not None else 1

    def _specs(self, shapes: dict) -> dict | None:
        if self.model_axis == 1:
            return None
        return rules.param_specs(self.arch, shapes, self.mesh)

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
        init; it must have the config's names and shapes (the whole
        leaves: under a model axis each rank keeps its block)."""
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
        specs = self._specs(shapes)
        if specs is not None:
            params = rules.shard_tree(params, specs, self.mesh)
        pipe = TokenPipeline(self.arch.vocab_size, self.seq,
                             self.batch_per_device * self.m_devices,
                             seed=self.seed)
        # the reference draws one batch at build time (to derive its batch
        # shardings) and trains from the second: draw it too, so the same
        # seed trains on the same batches
        pipe.next_batch()
        ef = init_ef_tree(params, self.m_devices,
                          getattr(torch, self.step_cfg.ef_dtype))
        # the reference's task passes its param specs: the sparse uplinks
        # select per row of each leaf's model-dim view
        step = make_lgc_train_step(self.arch, self.m_devices, self.step_cfg,
                                   model_axis=leaf_model_axis,
                                   mesh=self.mesh)
        self._built = dict(params=params, ef=ef, step=step, pipe=pipe,
                           specs=specs)
        return self._built

    def gathered_state(self) -> tuple[dict, dict]:
        """(params, error memory) with whole leaves, on every rank: the
        state itself without a model axis."""
        b = self.build()
        if b["specs"] is None:
            return b["params"], b["ef"]
        specs = b["specs"]
        return ({k: parallel.gather_model(self.mesh, v, specs[k])
                 for k, v in b["params"].items()},
                {k: parallel.gather_model(self.mesh, v, (None, *specs[k]))
                 for k, v in b["ef"].items()})

    def next_batch(self) -> dict:
        x, y = self.build()["pipe"].next_batch()
        return {"tokens": torch.from_numpy(x).to(self.device, torch.long),
                "labels": torch.from_numpy(y).to(self.device, torch.long)}

    # -- scenario-driven channel availability -------------------------------

    def _mask_state(self) -> tuple[torch.Tensor, torch.Tensor, ScenarioCarry]:
        """The mask streams' base key, the device ids and the (M, C) carry
        at its stationary draw, on the host."""
        base = prng.PRNGKey(self.seed)
        dev_ids = torch.arange(self.m_devices, dtype=torch.int64)
        n_ch = self.step_cfg.n_channels
        carry = stack_carries([init_carry(self.scenario, base, i, n_ch)
                               for i in range(self.m_devices)])
        return base, dev_ids, carry

    def _round_mask(self, base: torch.Tensor, dev_ids: torch.Tensor,
                    carry: ScenarioCarry, t: int
                    ) -> tuple[ScenarioCarry, torch.Tensor]:
        """Step the chains through round ``t``, then the (M, C) int32
        delivery mask: Gilbert-Elliott availability times the whole-uplink
        dropout, both on the shared TAG streams."""
        carry = step_carry_rows(self.scenario, base, carry, [t], dev_ids)
        drop = dropout_mask(self.scenario, base, t, dev_ids)
        received = (carry.good.to(torch.int32)
                    * (~drop).to(torch.int32)[:, None])
        return carry, received

    # -- training -----------------------------------------------------------

    def run(self, steps: int, log_every: int = 0,
            on_round: Callable[[int, float], None] | None = None) -> dict:
        """Train for ``steps`` sync rounds; returns losses + throughput +
        wire accounting, and each round's host ms (``round_ms``: from the
        round's start to its loss on the host).  ``on_round(i, loss)`` is
        called after round ``i``.  Under a model axis the steady time is
        the slowest rank's, so every rank returns the same dict."""
        b = self.build()
        params, ef, step = b["params"], b["ef"], b["step"]
        base, dev_ids, carry = self._mask_state()
        losses, t_steady, round_ms = [], None, []
        self.masks = []                     # each round's (M, C) mask, host
        t0 = time.perf_counter()
        for i in range(steps):
            t_round = time.perf_counter()
            carry, received = self._round_mask(base, dev_ids, carry, i)
            self.masks.append(received)
            if self.device.type == "cuda":   # no wait for the card
                received = received.pin_memory().to(self.device,
                                                    non_blocking=True)
            params, ef, loss = step(params, ef, self.next_batch(), received)
            losses.append(float(loss))   # float() waits for the round
            round_ms.append((time.perf_counter() - t_round) * 1e3)
            if on_round is not None:
                on_round(i, losses[-1])
            if i == 0:
                t_steady = time.perf_counter()   # exclude first-call set-up
            if log_every and (i % log_every == 0 or i == steps - 1):
                print(f"[{self.name}] round {i:4d} loss {losses[-1]:.4f} "
                      f"({time.perf_counter() - t0:.0f}s)")
        steady_s = (time.perf_counter() - t_steady) if steps > 1 else 0.0
        if self.model_axis > 1:
            slowest = parallel.all_reduce_max(self.mesh, torch.tensor(
                [steady_s, *round_ms], dtype=torch.float64,
                device=self.device)).tolist()
            steady_s, round_ms = slowest[0], slowest[1:]
        # device-steps/s: every round advances each of the M devices by H
        dev_steps = (steps - 1) * self.m_devices * self.step_cfg.local_steps
        b["params"], b["ef"] = params, ef
        return {
            "losses": losses,
            "device_steps_per_s": (dev_steps / steady_s) if steady_s else 0.0,
            "wire_bytes_per_round_per_device": self.wire_bytes_per_round(),
            "param_count": self.param_count(),
            "round_ms": round_ms,
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
    ``preset="smoke"`` a tiny same-shape variant.  Every aggregate of the
    reference runs: the default ``sparse_gather`` (per channel the top k of
    its band, selected per row of each leaf's model-dim view, through the
    maxabs and histogram row kernels), ``bucket_sparse``, ``dense_masked``
    and ``none``.  ``device=None`` means the card and raises without CUDA.

    ``model_axis=P`` > 1 runs the task inside a live P-rank
    ``torch.distributed`` group (``launch.mesh.spawn``; gloo for CPU
    tensors and ranks sharing a card, NCCL for one card a rank), on a
    (1, P) mesh: the dense family, P dividing ``n_kv_heads``.
    """
    dev = resolve_device(device)
    mesh = None
    if model_axis != 1:
        live = (torch.distributed.get_world_size()
                if torch.distributed.is_initialized() else 1)
        if live != model_axis:
            raise ValueError(f"make_qwen2_100m_task(model_axis="
                             f"{model_axis}) runs inside a {model_axis}-rank "
                             f"group; the live group has {live} rank(s)")
        mesh = meshlib.make_host_mesh(model_axis, model=model_axis,
                                      device=dev)
    if arch is None:
        arch = (get_config("qwen2-100m") if preset == "full"
                else get_smoke_config("qwen2-100m"))
    scn = get_scenario(scenario)
    kw = {} if pallas_min_elems is None else {
        "pallas_min_elems": pallas_min_elems}
    step_cfg = LGCStepConfig(local_steps=local_steps, local_lr=local_lr,
                             sparsity=tuple(sparsity), aggregate=aggregate,
                             backend=backend, **kw)
    if mesh is not None:
        tf.model_axis_mesh(arch, mesh)       # P | n_kv_heads and the vocab
        dev = mesh.device
    return LGCTransformerTask(arch=arch, m_devices=m_devices, scenario=scn,
                              step_cfg=step_cfg, device=dev, seed=seed,
                              batch_per_device=batch_per_device, seq=seq,
                              name=arch.name, mesh=mesh)
