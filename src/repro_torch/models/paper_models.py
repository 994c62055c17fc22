"""The paper's evaluation models (§4.1) and the task registry.

Port of ``repro/models/paper_models.py``: ``_xent``, ``_acc``, the LR and
CNN models on (synthetic) MNIST, the GRU char-RNN on Shakespeare,
``make_mnist_task``, ``make_shakespeare_task``, and ``TASKS`` /
``make_task``.  Parameters are flat ``{name: Tensor}`` dicts and forward
passes plain functions, as in the reference.  The CNN keeps the
reference's NHWC layout and its shift-im2col formulation of the 3x3 conv
(pad, nine shifted views, one matmul) instead of ``F.conv2d``, so the same
weights compute the same function and no cuDNN TF32 setting comes in.  The
GRU is a Python loop over the sequence in plain torch ops (the reference's
``lax.scan``), usable under ``torch.func.vmap(torch.func.grad(...))``.

``lr_init`` / ``cnn_init`` / ``rnn_init`` draw from the ported threefry
(:mod:`repro_torch.core.prng`): the CNN's ``he_normal`` and the RNN's
``glorot_normal`` are bitwise equal to the reference's, the ``normal``
draws of the LR and the RNN's embedding within 2 ulp
(tests/test_torch_paper_models.py, tests/test_torch_shakespeare.py).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.fl import FLTask
from repro_torch.core.scenario import Scenario, get_scenario, partition_fn
from repro_torch.data.mnist import load_synthetic_mnist
from repro_torch.data.shakespeare import (VOCAB_SIZE, char_shards,
                                          load_shakespeare)

_F32 = torch.float32


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, -1)
    return -torch.mean(torch.gather(logp, -1, y[..., None].long()))


def _acc(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == y).to(_F32))


# ---------------------------------------------------------------------------
# LR on MNIST
# ---------------------------------------------------------------------------

def lr_init(key: torch.Tensor) -> dict[str, torch.Tensor]:
    k1, _ = prng.split(key)
    return {"b": torch.zeros((10,), dtype=_F32),
            "w": prng.normal(k1, (784, 10)) * 0.01}


def lr_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1) @ params["w"] + params["b"]


# ---------------------------------------------------------------------------
# CNN on MNIST (LeNet-style)
# ---------------------------------------------------------------------------

def _variance_scaling(key: torch.Tensor, shape: tuple[int, ...],
                      scale: float, mode: str) -> torch.Tensor:
    """``jax.nn.initializers.variance_scaling(scale, mode,
    "truncated_normal")``: truncated normal on (-2, 2) scaled to variance
    ``scale`` / fan (fan_in = shape[-2] x receptive field, fan_out =
    shape[-1] x receptive field, fan_avg their mean), in f32."""
    receptive = torch.Size(shape).numel() // (shape[-2] * shape[-1])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    fan = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2}[mode]
    variance = torch.tensor(scale / fan, dtype=_F32)
    stddev = prng.sqrt_f32(variance) / torch.tensor(.87962566103423978,
                                                    dtype=_F32)
    return prng.truncated_normal(key, -2.0, 2.0, shape) * stddev


def _he_normal(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.nn.initializers.he_normal()``."""
    return _variance_scaling(key, shape, 2.0, "fan_in")


def _glorot_normal(key: torch.Tensor, shape: tuple[int, ...]
                   ) -> torch.Tensor:
    """``jax.nn.initializers.glorot_normal()``."""
    return _variance_scaling(key, shape, 1.0, "fan_avg")


def cnn_init(key: torch.Tensor) -> dict[str, torch.Tensor]:
    ks = prng.split(key, 4)
    return {
        "c1": _he_normal(ks[0], (3, 3, 1, 16)), "b1": torch.zeros(16),
        "c2": _he_normal(ks[1], (3, 3, 16, 32)), "b2": torch.zeros(32),
        "w1": _he_normal(ks[2], (7 * 7 * 32, 128)), "bw1": torch.zeros(128),
        "w2": _he_normal(ks[3], (128, 10)), "bw2": torch.zeros(10),
    }


def _conv3x3(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """SAME 3x3 conv on NHWC as shift-im2col: pad, the nine shifted views
    concatenated on the channel axis, one matmul with the (9 cin, cout)
    kernel (``repro/models/paper_models.py:70``)."""
    _, h, wd, cin = z.shape
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    patches = torch.cat([zp[:, i:i + h, j:j + wd, :]
                         for i in range(3) for j in range(3)], dim=-1)
    return patches @ w.reshape(9 * cin, w.shape[-1]) + b


def _pool2x2(z: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool as a reshape + max (ties share the gradient evenly,
    as ``jnp.max`` shares it)."""
    bsz, h, wd, c = z.shape
    return torch.amax(z.reshape(bsz, h // 2, 2, wd // 2, 2, c), dim=(2, 4))


def cnn_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    # relu after pool: max and relu commute exactly
    z = torch.relu(_pool2x2(_conv3x3(x, params["c1"], params["b1"])))
    z = torch.relu(_pool2x2(_conv3x3(z, params["c2"], params["b2"])))
    z = z.reshape(z.shape[0], -1)
    z = torch.relu(z @ params["w1"] + params["bw1"])
    return z @ params["w2"] + params["bw2"]


# ---------------------------------------------------------------------------
# char-RNN on Shakespeare (GRU)
# ---------------------------------------------------------------------------

_RNN_EMB, _RNN_HID = 64, 128


def rnn_init(key: torch.Tensor) -> dict[str, torch.Tensor]:
    ks = prng.split(key, 5)
    v, e, h = VOCAB_SIZE, _RNN_EMB, _RNN_HID
    return {
        "emb": prng.normal(ks[0], (v, e)) * 0.02,
        "wz": _glorot_normal(ks[1], (e + h, h)), "bz": torch.zeros(h),
        "wr": _glorot_normal(ks[2], (e + h, h)), "br": torch.zeros(h),
        "wh": _glorot_normal(ks[3], (e + h, h)), "bh": torch.zeros(h),
        "out": _glorot_normal(ks[4], (h, v)), "bo": torch.zeros(v),
    }


def rnn_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S) integer tokens -> (B, S, V) next-character logits; the GRU
    cell of the reference (gates on ``[e_t, h]``, candidate on ``[e_t, r *
    h]``), one step per position."""
    emb = params["emb"][x]                              # (B, S, E)
    h = torch.zeros(x.shape[0], _RNN_HID, dtype=emb.dtype, device=emb.device)
    hs = []
    for t in range(x.shape[1]):
        et = emb[:, t]
        ze = torch.cat([et, h], -1)
        z = torch.sigmoid(ze @ params["wz"] + params["bz"])
        r = torch.sigmoid(ze @ params["wr"] + params["br"])
        cand = torch.tanh(torch.cat([et, r * h], -1) @ params["wh"]
                          + params["bh"])
        h = (1 - z) * h + z * cand
        hs.append(h)
    return torch.stack(hs, 1) @ params["out"] + params["bo"]


# ---------------------------------------------------------------------------
# FLTask factories
# ---------------------------------------------------------------------------

def make_mnist_task(model: str = "lr", m_devices: int = 3, n_train: int = 6000,
                    seed: int = 0, partition: str = "iid",
                    alpha: float = 0.5,
                    scenario: str | Scenario | None = None) -> FLTask:
    """The LR or CNN task on synthetic MNIST, sharded over ``m_devices``
    (``partition`` / ``alpha``, or the scenario's when ``scenario`` is
    given).  The data stay numpy arrays; the simulator moves them to its
    device."""
    if model not in ("lr", "cnn"):
        raise ValueError(f"unknown MNIST model {model!r}")
    if scenario is not None:
        scn = get_scenario(scenario)
        partition, alpha = scn.partition, scn.alpha
    (xtr, ytr), (xte, yte) = load_synthetic_mnist(n_train=n_train, seed=seed)
    shards = partition_fn(Scenario(partition=partition, alpha=alpha))(
        xtr, ytr, m_devices, seed)
    init, logits = ((lr_init, lr_logits) if model == "lr"
                    else (cnn_init, cnn_logits))

    def loss_fn(params, batch):
        x, y = batch
        return _xent(logits(params, x), y)

    def metric_fn(params, batch):
        x, y = batch
        return _acc(logits(params, x), y)
    return FLTask(init, loss_fn, metric_fn, shards, (xte, yte),
                  name=f"{model}-mnist")


def make_shakespeare_task(m_devices: int = 3, seq: int = 48, seed: int = 0,
                          n_train: int | None = None, n_eval: int = 1024,
                          partition: str = "dirichlet", alpha: float = 0.5,
                          scenario: str | Scenario | None = None,
                          test_frac: float = 0.15) -> FLTask:
    """The char-RNN task: ``n_train`` (default 2,000 per device) windows of
    ``seq`` characters from the train split, labelled by corpus region and
    dealt to devices by ``partition`` / ``alpha`` (or the scenario's), and
    ``n_eval`` eval windows from the disjoint test tail
    (:func:`repro_torch.data.shakespeare.char_shards`).  Tokens stay int32
    numpy arrays; the simulator moves them to its device."""
    if scenario is not None:
        scn = get_scenario(scenario)
        partition, alpha = scn.partition, scn.alpha
    stream = load_shakespeare(seed=seed)
    n_train = 2000 * m_devices if n_train is None else n_train
    shards, eval_data = char_shards(
        stream, m_devices, seq=seq, n_train=n_train, n_eval=n_eval,
        seed=seed, test_frac=test_frac,
        partition_fn=partition_fn(Scenario(partition=partition,
                                           alpha=alpha)))

    def loss_fn(params, batch):
        x, y = batch
        return _xent(rnn_logits(params, x), y)

    def metric_fn(params, batch):
        x, y = batch
        return _acc(rnn_logits(params, x), y)
    return FLTask(rnn_init, loss_fn, metric_fn, shards, eval_data,
                  name="rnn-shakespeare")


# ---------------------------------------------------------------------------
# the task registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One registry workload (the reference's fields)."""
    name: str
    model: str              # "lr" | "cnn" | "gru" | "qwen2"
    dataset: str            # "mnist" | "shakespeare" | "tokens"
    partition: str

    def make(self, m_devices: int = 3, seed: int = 0, scenario=None, **kw):
        if self.dataset == "tokens":
            from repro_torch.models.lgc_transformer import (
                make_qwen2_100m_task)
            return make_qwen2_100m_task(m_devices, seed=seed,
                                        scenario=scenario, **kw)
        kw.setdefault("partition", self.partition)
        if self.dataset == "mnist":
            return make_mnist_task(self.model, m_devices, seed=seed,
                                   scenario=scenario, **kw)
        return make_shakespeare_task(m_devices, seed=seed,
                                     scenario=scenario, **kw)


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
    through: ``n_train`` for the MNIST tasks, ``n_train`` / ``seq`` /
    ``n_eval`` for ``rnn_shakespeare``; ``preset`` / ``aggregate`` /
    ``backend`` / ``device`` for ``qwen2_100m``)."""
    try:
        spec = TASKS[name]
    except KeyError:
        raise ValueError(
            f"unknown task {name!r}; registered: {sorted(TASKS)}") from None
    return spec.make(m_devices, seed=seed, scenario=scenario, **kw)
