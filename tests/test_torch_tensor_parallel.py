"""The model axis (tensor parallelism, ROADMAP A12) on the CPU over gloo.

One module fixture starts two gloo ranks once (``launch.mesh.spawn``, one
intra-op thread each), which run every job of ``JOBS`` (their bodies in
``tests/_torch_tp_jobs.py``) on a (data=1, model=2) mesh, while this
process runs the reference's 100M task at ``model_axis=2`` in a
subprocess (four forced host devices: its mesh is (M, P) = (2, 2)) and
the unsharded counterparts here.  Everything is qwen2-100m's smoke config in f32 (the
TINY config's single kv head cannot split two ways):

* (a) the sharded compression is bitwise the unsharded, leaf by leaf:
  the split pipeline (the row kernels' plain versions, ``backend="cuda"``
  with ``pallas_min_elems=1``, and the exact backend's) under
  ``dense_masked``, and the step's whole compression under every
  aggregate, also with the driver's whole-leaf selection rows;
* (b) loss and every gradient of the sharded forward and backward against
  the unsharded port at rtol 1e-5 / atol 1e-6;
* (c) the 100M task at P = 2, M = 2, 3 rounds of ``dense_masked`` and
  ``sparse_gather``, against the reference's task at ``model_axis=2``
  from the same weights: losses at rtol 1e-5, params and error memory at
  rtol 1e-5 / atol 1e-6 with at most 0.1% of a leaf off (a coordinate
  that crosses a bin edge changes layer).  The reference's ``run()``
  raises on a mesh whose data axis is above 1 under the installed jax
  ("Sharding passed to jit does not match", for ``received``), so the
  subprocess drives ``build()["step"]`` itself with ``received`` placed on
  ``P(fl_ax)``;
* (d) the sync step at P = 2 (AdamW with the clip) for 3 steps against
  the reference's ``make_sync_train_step`` in this process: losses at
  rtol 1e-5.  AdamW divides each gradient by its own running size, so a
  rounding difference of a gradient moves its coordinate by a share of
  the STEP, not of the value: over these 3 steps the port at P = 1
  already differs from the reference by up to 0.6% of the summed steps
  (sum of lr, 2.5e-2; 1.4e-4 on ``wo``), at P = 2 by up to 0.8%.  Every
  coordinate is held within 2% of the summed steps, except the key bias:
  its gradient is zero up to rounding (a constant added to all of a
  query's logits), so its coordinates may move whole steps either way,
  at most two a step;
* (e) the driver at ``--model-parallel 2 --device cpu --smoke`` in all
  four modes (the rank body in the fixture's ranks, and once through
  ``train.main``, which spawns its own): both ranks' losses equal; its
  checkpoint at P = 2 (rank 0 writes the gathered leaves) loads into a
  P = 1 template;
* (f) the refusals;
* P = 4 on four gloo ranks: the smoke config with 4 kv heads (its 2 do
  not split four ways), the compression bitwise and the task's 3 rounds
  against the unsharded port at rtol 1e-5.
"""
import concurrent.futures
import dataclasses
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tp_jobs as tp_jobs  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data.tokens import TokenPipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.models.layers import local_heads  # noqa: E402
from repro_torch.models.lgc_transformer import make_qwen2_100m_task  # noqa: E402
from repro_torch.optim import optimizers as popt  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
MAX_FLIP_SHARE = 1e-3
AGGREGATES = ("dense_masked", "sparse_gather", "bucket_sparse", "none")
TASK_AGGREGATES = ("dense_masked", "sparse_gather")
MODES = ("sync", "lgc", "lgc_sparse", "fedavg")
J_CFG = dataclasses.replace(j_smoke("qwen2-100m"), dtype=jnp.float32)
P_CFG = dataclasses.replace(get_smoke_config("qwen2-100m"),
                            dtype=torch.float32)
SYNC_OPT = dict(lr=1e-2, warmup_steps=2)
SYNC_STEPS, SYNC_BATCH, SEQ = 3, 4, 16


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


P0 = _flat(jax.device_get(jtf.init_params(J_CFG, jax.random.PRNGKey(0))))


def _batches(n: int, batch: int, seed: int) -> list:
    pipe = TokenPipeline(J_CFG.vocab_size, SEQ, batch, seed=seed)
    return [dict(zip(("tokens", "labels"), pipe.next_batch()))
            for _ in range(n)]


LOSS_BATCH = _batches(1, 4, 3)[0]
SYNC_BATCHES = _batches(SYNC_STEPS, SYNC_BATCH, 5)


def _driver_argv(mode: str) -> list:
    return ["--arch", "qwen2-100m", "--smoke", "--steps", "3", "--batch",
            "8", "--seq", str(SEQ), "--mode", mode, "--devices", "4",
            "--model-parallel", "2", "--lr", "3e-2", "--local-steps", "2",
            "--device", "cpu", "--log-every", "100"]


def _jobs() -> list:
    small = dict(smoke=True, f32=True)
    jobs = [dict(name=f"compress {agg}", kind="compress", aggregate=agg,
                 min_elems=1, **small) for agg in AGGREGATES]
    jobs.append(dict(name="compress exact", kind="compress",
                     aggregate="dense_masked", backend="exact", min_leaf=1,
                     **small))
    jobs += [dict(name=f"compress {agg} whole-leaf rows", kind="compress",
                  aggregate=agg, min_elems=1, rule=None, **small)
             for agg in ("sparse_gather", "bucket_sparse")]
    jobs.append(dict(name="loss_grads", kind="loss_grads", params=P0,
                     batch=LOSS_BATCH, **small))
    jobs += [dict(name=f"task {agg}", kind="task", aggregate=agg, m=2,
                  rounds=3, seq=SEQ, min_elems=1, params=P0, state=True,
                  **small) for agg in TASK_AGGREGATES]
    jobs.append(dict(name="sync", kind="sync", params=P0, opt=SYNC_OPT,
                     batches=SYNC_BATCHES, **small))
    jobs += [dict(name=f"driver {mode}", kind="driver",
                  argv=_driver_argv(mode)) for mode in MODES]
    return jobs


JOBS = _jobs()

REFERENCE = r'''
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.models.lgc_transformer import make_qwen2_100m_task


def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


cfg = dataclasses.replace(get_smoke_config("qwen2-100m"), dtype=jnp.float32)
out = {}
for agg in sys.argv[2].split(","):
    t = make_qwen2_100m_task(m_devices=2, arch=cfg, aggregate=agg,
                             local_steps=2, seq=int(sys.argv[3]),
                             backend="exact", model_axis=2)
    b = t.build()
    for k, v in flat(jax.device_get(b["params"])).items():
        out[f"{agg}|p0|{k}"] = v
    base, dev_ids, carry = t._mask_state()
    on_fl = NamedSharding(b["mesh"], P(b["fl_ax"]))
    params, ef, losses = b["params"], b["ef"], []
    for i in range(3):
        carry, received = t._round_mask(base, dev_ids, carry, i)
        x, y = b["pipe"].next_batch()
        params, ef, loss = b["step"](
            params, ef, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)},
            jax.device_put(received, on_fl))
        losses.append(float(loss))
    for k, v in flat(jax.device_get(params)).items():
        out[f"{agg}|p|{k}"] = v
    for k, v in flat(jax.device_get(ef)).items():
        out[f"{agg}|ef|{k}"] = v
    out[f"{agg}|losses"] = np.asarray(losses)
np.savez(sys.argv[1], **out)
'''


def _reference_task_runs(path: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", REFERENCE, path,
                          ",".join(TASK_AGGREGATES), str(SEQ)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            agg, part, *leaf = key.split("|")
            node = out.setdefault(agg, {})
            if leaf:
                node.setdefault(part, {})[leaf[0]] = z[key]
            else:
                node[part] = z[key]
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The jobs on two spawned gloo ranks (and the driver once more with a
    checkpoint directory) and, meanwhile, the reference's task at
    model_axis=2 in a subprocess."""
    tmp = tmp_path_factory.mktemp("tp")
    ckpt = tmp / "ckpt"
    jobs = JOBS + [dict(name="driver checkpoint", kind="driver",
                        argv=_driver_argv("lgc") + ["--ckpt-dir", str(ckpt)])]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(pmesh.spawn, tp_jobs.rank_main, 2, "gloo",
                            (jobs, "cpu"), 300.0)
        ref = pool.submit(_reference_task_runs, str(tmp / "reference.npz"))
        return ranks.result(), ref.result(), ckpt


def _both(world, name: str) -> tuple[dict, dict]:
    r0, r1 = (r["results"][name] for r in world[0])
    return r0, r1


def _flip_share(got: np.ndarray, want: np.ndarray) -> float:
    off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    return float(off.mean()) if off.size else 0.0


# ---------------------------------------------------------------------------
# (a) the compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [j["name"] for j in JOBS
                                  if j["kind"] == "compress"])
def test_sharded_compression_is_bitwise_the_unsharded(world, name):
    for rank in _both(world, name):
        leaves = {k: v for k, v in rank.items() if k != "seconds"}
        assert len(leaves) == len(P0)
        for leaf, row in leaves.items():
            assert row["step_bitwise"], (name, leaf)
            if "pipeline_bitwise" in row:
                assert row["pipeline_bitwise"] and row["plain_bitwise"], (
                    name, leaf)
        # every matmul leaf and bias splits; the norms stay whole
        split = {k for k, v in leaves.items() if v["split"]}
        assert split == {k for k in leaves if "norm" not in k}


def test_model_dim_rule_agrees_with_the_ported_param_specs():
    """``steps.leaf_model_axis`` (the sparse uplinks' rows) names the dim
    the ported specs shard over "model", for every leaf of every dense
    config."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch import sharding_rules as rules
    fake = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((1, 2)))
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.arch_type != "dense":
            continue
        shapes = ptf.init_params(cfg, device="meta")
        for k, spec in rules.param_specs(cfg, shapes, fake).items():
            assert psteps.leaf_model_axis(k, shapes[k].dim()) == \
                rules.model_dim(spec), (arch, k, spec)


# ---------------------------------------------------------------------------
# (b) loss and gradients
# ---------------------------------------------------------------------------

def test_sharded_loss_and_grads_match_the_unsharded(world):
    params = {k: torch.from_numpy(v.copy()) for k, v in P0.items()}
    batch = {k: torch.from_numpy(v).long() for k, v in LOSS_BATCH.items()}
    names = list(params)
    leaves = [params[k].requires_grad_(True) for k in names]
    loss = ptf.lm_loss(dict(zip(names, leaves)), P_CFG, batch)
    grads = torch.autograd.grad(loss, leaves)
    r0, r1 = _both(world, "loss_grads")
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], float(loss.detach()), rtol=RTOL)
    for k, g in zip(names, grads):
        for r in (r0, r1):
            np.testing.assert_allclose(r["grads"][k], g.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# (c) the 100M task against the reference's at model_axis=2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aggregate", TASK_AGGREGATES)
def test_task_at_model_axis_2_matches_the_reference(world, aggregate):
    ref = world[1][aggregate]
    for k, v in ref["p0"].items():
        assert np.array_equal(v, P0[k]), k       # the same start
    r0, r1 = _both(world, f"task {aggregate}")
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=RTOL)
    for part in ("params", "ef"):
        want = ref["p" if part == "params" else "ef"]
        for k, v in want.items():
            for r in (r0, r1):
                assert r[part][k].shape == v.shape, (part, k)
                assert _flip_share(r[part][k], v) <= MAX_FLIP_SHARE, (part,
                                                                      k)
    # the LGC statistics reduce over the model group: 2 a split leaf
    first = r0["per_round"][0]
    assert first["collectives"] > 0 and first["collective_bytes"] > 0


# ---------------------------------------------------------------------------
# (d) the sync step against the reference's
# ---------------------------------------------------------------------------

def test_sync_step_at_model_axis_2_matches_the_reference(world):
    opt = jopt.OptimizerConfig(**SYNC_OPT)
    step = jax.jit(jsteps.make_sync_train_step(J_CFG, opt_cfg=opt))
    init, _ = jopt.get_optimizer(J_CFG.optimizer)
    params = jtf.init_params(J_CFG, jax.random.PRNGKey(0))
    state, losses = init(params), []
    for b in SYNC_BATCHES:
        params, state, loss = step(params, state,
                                   {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    want = params_from_jax(jax.device_get(params))
    r0, r1 = _both(world, "sync")
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], losses, rtol=RTOL)
    steps = sum(float(popt._schedule(popt.OptimizerConfig(**SYNC_OPT), i))
                for i in range(SYNC_STEPS))
    for k, v in want.items():
        got = r0["params"][k]
        np.testing.assert_array_equal(got, r1["params"][k])
        bound = 2 * steps if k == "blocks/attn/bk" else 0.02 * steps
        assert float(np.abs(got - v.numpy()).max()) <= bound, k


# ---------------------------------------------------------------------------
# (e) the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_driver_rank_body_runs_every_mode(world, mode):
    r0, r1 = _both(world, f"driver {mode}")
    assert r0["losses"] == r1["losses"]
    assert len(r0["losses"]) == 3 and np.isfinite(r0["losses"]).all()
    assert r0["losses"][-1] < r0["losses"][0]


def test_checkpoint_saved_at_model_axis_2_loads_at_1(world):
    """The driver's checkpoint at P = 2: rank 0 writes the gathered whole
    leaves in the one format, which loads into a P = 1 template."""
    from repro_torch.checkpoint import load_checkpoint
    like = ptf.init_params(get_smoke_config("qwen2-100m"), seed=0,
                           device="cpu")
    got = load_checkpoint(str(world[2]), 3, like)
    for k, v in like.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert torch.isfinite(got[k].float()).all(), k
    assert not torch.equal(got["blocks/attn/wq"], like["blocks/attn/wq"])
    r0, r1 = _both(world, "driver checkpoint")
    assert r0["losses"] == r1["losses"] == _both(world, "driver lgc")[0][
        "losses"]


def test_driver_spawns_its_ranks(capfd):
    losses = train.main(_driver_argv("lgc"))
    assert len(losses) == 3 and losses[-1] < losses[0]
    out = capfd.readouterr().out
    assert "model_parallel=2 fl_devices=2 transport=gloo" in out


# ---------------------------------------------------------------------------
# P = 4
# ---------------------------------------------------------------------------

P4 = dict(smoke=True, f32=True, replace=dict(n_kv_heads=4))


def test_model_axis_4():
    jobs = [dict(name="compress", kind="compress", aggregate="dense_masked",
                 min_elems=1, **P4),
            dict(name="task", kind="task", aggregate="dense_masked", m=2,
                 rounds=3, seq=SEQ, min_elems=1, state=True, **P4)]
    ranks = pmesh.spawn(tp_jobs.rank_main, 4, "gloo", (jobs, "cpu"), 300.0)
    cfg = dataclasses.replace(P_CFG, n_kv_heads=4)
    task = make_qwen2_100m_task(m_devices=2, arch=cfg, seq=SEQ,
                                aggregate="dense_masked", backend="cuda",
                                pallas_min_elems=1, device="cpu")
    want = task.run(3)["losses"]
    params, ef = task.gathered_state()
    for r in ranks:
        for leaf, row in r["results"]["compress"].items():
            if leaf != "seconds":
                assert row["step_bitwise"], leaf
                assert row.get("pipeline_bitwise", True), leaf
        got = r["results"]["task"]
        assert got["losses"] == ranks[0]["results"]["task"]["losses"]
        np.testing.assert_allclose(got["losses"], want, rtol=RTOL)
        for part, whole in (("params", params), ("ef", ef)):
            for k, v in whole.items():
                assert _flip_share(got[part][k], v.numpy()) <= \
                    MAX_FLIP_SHARE, (part, k)


# ---------------------------------------------------------------------------
# (f) the refusals
# ---------------------------------------------------------------------------

def _fake_mesh(model: int):
    return SimpleNamespace(model_size=model, model_rank=0,
                           shape={"data": 1, "model": model},
                           axis_names=("data", "model"), rank=0)


def test_model_axis_must_divide_the_kv_heads():
    assert local_heads(12, 4, 4) == (3, 1)
    with pytest.raises(ValueError, match="must divide n_kv_heads=2"):
        local_heads(4, 2, 4)
    batch = {k: torch.from_numpy(v).long() for k, v in LOSS_BATCH.items()}
    with pytest.raises(ValueError, match="n_kv_heads"):
        ptf.lm_loss({}, P_CFG, batch, mesh=_fake_mesh(4))
    with pytest.raises(ValueError, match="n_kv_heads"):
        psteps.make_lgc_train_step(P_CFG, 2, psteps.LGCStepConfig(),
                                   mesh=_fake_mesh(4))


def test_other_families_refuse_the_model_axis():
    """No family is refused (the audio family trains since A12c's third
    part, tests/test_torch_audio_model_axis.py); what a model axis still
    refuses is a P that does not divide the padded vocab, here
    whisper-small's 51,968 rows at P = 3 (which divides its 12 heads),
    before any weight is drawn or any rank spawned."""
    cfg = get_config("whisper-small")
    assert ptf.model_axis_mesh(cfg, _fake_mesh(2)) is not None
    batch = {k: torch.from_numpy(v).long() for k, v in LOSS_BATCH.items()}
    with pytest.raises(ValueError, match="padded vocab 51968"):
        ptf.lm_loss({}, cfg, batch, mesh=_fake_mesh(3))
    with pytest.raises(ValueError, match="padded vocab 51968"):
        train.main(["--arch", "whisper-small", "--model-parallel", "3",
                    "--devices", "3", "--device", "cpu"])


def test_task_refuses_a_group_of_another_size():
    with pytest.raises(ValueError, match="2-rank group; the live group has "
                                         "1 rank"):
        make_qwen2_100m_task(model_axis=2, preset="smoke", device="cpu")


def test_driver_refuses_devices_the_model_axis_does_not_divide():
    with pytest.raises(ValueError, match="3 devices do not factor into a "
                                         r"\(data=3/2, model=2\) mesh"):
        train.main(["--arch", "qwen2-100m", "--smoke", "--model-parallel",
                    "2", "--devices", "3", "--device", "cpu"])
