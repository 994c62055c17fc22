"""The ssm and hybrid families under the model axis (ROADMAP A12c) on the
CPU over gloo.

One module fixture spawns two gloo ranks (one intra-op thread each) that
run ``mamba2-smoke`` and ``zamba2-smoke`` in f32 from the reference's
weights (``weights.params_from_jax``) at P = 2 (their bodies in
``tests/_torch_tp_jobs.py``), while this process runs the reference and
the unsharded port.  Each SSD block runs H / P heads: ``in_proj``'s
columns are gathered, the gated norm's squares summed over the ranks,
``out_proj``'s partial outputs summed; the hybrid's shared block is the
dense family's tensor-parallel block at each of its sites.

* (a) ``lm_loss`` and every leaf's gradient, gathered whole, against
  ``jax.value_and_grad`` of the reference's ``lm_loss``: the loss at rtol
  1e-5, the gradients at rtol 1e-5 / atol 1e-5 (the SSD families' atol of
  tests/test_torch_family_training.py: the chunked scan's einsums sum in
  other orders).  The leaves held whole but used a head block at a time
  (``ssd.SPLIT_USE``) are summed over the ranks by
  ``transformer.sum_split_use_grads``; each of them, left unsummed, fails
  that check on every rank.
* (b) The LGC step (``dense_masked``, M = 2, H = 2, 2 rounds, a dropped
  channel, the row kernels' plain versions on every leaf) at P = 2
  against the unsharded port step: the split statistics of every leaf
  bitwise the unsharded ones (``steps.split_compress_rows`` and the
  step's compression), the losses at rtol 1e-5, params and error memory
  at rtol 1e-5 / atol 1e-6 with at most 0.1% of a leaf off (a coordinate
  next to a bin edge changes layer); the train driver's rank body at
  ``--model-parallel 2`` (mamba2 ``lgc``, zamba2 ``sync``).
* (c) Prefill and 12 greedy steps past a 24-slot ring's wrap, and 6
  steps over a 25-slot cache: the prefill's logits against the
  reference's ``logits_fn(forward_hidden(...))[:, -1]`` (its ssm / hybrid
  ``prefill`` takes them from the last token's embedding), each step's
  logits against its ``decode_step`` at rtol 1e-5 / atol 1e-5 with equal
  greedy tokens; both ranks' logits equal bit for bit; each rank's cache
  its ``cache_specs`` block of the P = 1 port's cache within that
  tolerance, the P = 1 port's cache the reference's; the collectives of
  each run pinned.  ``cache_specs`` keeps the conv tail whole where P
  does not divide C = d_inner + 2 ns; under a param layout that splits
  ``in_proj`` that cannot happen (its width is C + d_inner + nh, and P
  divides d_inner and nh), so the 25-slot runs gather the prefill's conv
  tails whole on every rank before the steps, the layout ``cache_specs``
  gives such a conv: each rank then convolves every channel, with one
  collective a layer less (the odd cache also keeps zamba2's K/V whole).
* (d) The refusals: P not dividing ``ssm_heads`` or the hybrid's
  ``n_kv_heads`` raises ValueError.
"""
import concurrent.futures
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tp_jobs as tp_jobs  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.base import ArchConfig as PArch  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import sharding_rules as rules  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.models import ssd as pssd  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RTOL = 1e-5
SSD_ATOL = 1e-5                 # the SSD families' gradients and logits
STATE_ATOL = 1e-6               # LGC params and error memory
MAX_FLIP_SHARE = 1e-3
ARCHS = ("mamba2-370m", "zamba2-1.2b")
SEQ, M_DEV, H = 32, 2, 2
STEP = dict(local_steps=H, local_lr=3e-3, sparsity=(0.05, 0.1, 0.1),
            aggregate="dense_masked", backend="cuda", pallas_min_elems=1)
RECEIVED = [np.ones((M_DEV, 3), np.int32),
            np.array([[1, 1, 1], [1, 0, 1]], np.int32)]
PROMPT = 16


def _port_cfg(arch: str) -> PArch:
    j_cfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32)
    kw = {f.name: getattr(j_cfg, f.name) for f in dataclasses.fields(j_cfg)
          if f.name != "dtype"}
    return PArch(**kw, dtype=torch.float32)


def _case(name, cache_len, window, steps, seed, **kw):
    prompts = np.random.default_rng(seed).integers(
        0, 512, (2, PROMPT), dtype=np.int32)
    return dict(name=name, prompts=prompts, cache_len=cache_len,
                window=window, steps=steps, **kw)


#: positions 16-27 over a 24-slot ring (12 slots a rank; wraps at 24);
#: 16-21 over 25 slots (K/V whole), the conv tails gathered whole
CASES = [_case("ring", 24, 24, 12, 1),
         _case("whole", 25, 0, 6, 2, conv_whole=True)]


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batch(n: int, seed: int) -> dict:
    toks = np.random.default_rng(seed).integers(0, 512, (n, SEQ + 1))
    return {"tokens": toks[:, :-1].astype(np.int64),
            "labels": toks[:, 1:].astype(np.int64)}


LOSS_BATCH = _batch(2, 3)
LGC_BATCHES = [_batch(M_DEV * H, 5 + i) for i in range(len(RECEIVED))]


def _driver_argv(arch: str, mode: str) -> list:
    return ["--arch", arch, "--smoke", "--steps", "2", "--batch", "4",
            "--seq", "16", "--mode", mode, "--devices", "4",
            "--model-parallel", "2", "--lr", "3e-2", "--local-steps", "2",
            "--device", "cpu", "--log-every", "100"]


DRIVER_MODES = {"mamba2-370m": "lgc", "zamba2-1.2b": "sync"}


def _jobs(arch: str, p0: dict) -> list:
    small = dict(arch=arch, smoke=True, f32=True)
    return [dict(name=f"{arch} loss", kind="loss_grads", params=p0,
                 batch=LOSS_BATCH, **small),
            dict(name=f"{arch} compress", kind="compress",
                 aggregate="dense_masked", min_elems=1, rule=None, **small),
            dict(name=f"{arch} lgc", kind="lgc", params=p0, m=M_DEV,
                 step=STEP, batches=LGC_BATCHES, received=RECEIVED, **small),
            dict(name=f"{arch} serve", kind="serve", params=p0, cases=CASES,
                 **small),
            dict(name=f"{arch} driver", kind="driver",
                 argv=_driver_argv(arch, DRIVER_MODES[arch]))]


def _reference(arch: str, jp) -> dict:
    """The reference's loss and gradients, and each case's prefill (the
    full forward's last logits, the cache) and greedy steps."""
    cfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in LOSS_BATCH.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, cfg, batch)))(jp)
    out = {"loss": float(loss), "grads": _flat(jax.device_get(grads))}

    @functools.partial(jax.jit, static_argnums=2)
    def prefill(params, toks, cache_len):
        _, cache = jtf.prefill(params, cfg, {"tokens": toks}, cache_len)
        hidden, _, _ = jtf.forward_hidden(params, cfg, toks)
        return jtf.logits_fn(params, cfg, hidden)[:, -1], cache

    @functools.partial(jax.jit, static_argnums=3)
    def step(params, token, cache, window):
        lg, cache = jtf.decode_step(params, cfg, token, cache, window=window)
        return lg, jnp.argmax(lg, -1).astype(jnp.int32)[:, None], cache
    for c in CASES:
        logits, cache = prefill(jp, jnp.asarray(c["prompts"]),
                                c["cache_len"])
        res = {"prefill_logits": np.asarray(logits),
               "prefill_cache": _cache(cache)}
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        toks_out, step_logits = [np.asarray(tok)], []
        for _ in range(c["steps"]):
            lg, tok, cache = step(jp, tok, cache, c["window"])
            toks_out.append(np.asarray(tok))
            step_logits.append(np.asarray(lg))
        res |= {"logits": np.stack(step_logits),
                "tokens": np.concatenate(toks_out, 1),
                "cache": _cache(cache), "pos": int(cache["pos"])}
        out[c["name"]] = res
    return out


def _cache(cache) -> dict:
    return {k: np.asarray(t) for g in ("kv", "ssm")
            for k, t in cache.get(g, {}).items()}


def _port_p1(arch: str, pp: dict) -> dict:
    """The unsharded port: each case's caches after prefill and after the
    steps, and the LGC step's rounds."""
    cfg = _port_cfg(arch)
    out = {}
    for c in CASES:
        logits, cache = psteps.make_prefill_step(cfg, c["cache_len"],
                                                 device="cpu")(
            pp, {"tokens": torch.from_numpy(c["prompts"])})
        res = {"prefill_cache": tp_jobs._caches(cache)}
        step = psteps.make_serve_step(cfg, c["window"], device="cpu")
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for _ in range(c["steps"]):
            tok, cache = step(pp, tok, cache)
        res["cache"] = tp_jobs._caches(cache)
        out[c["name"]] = res
    step = psteps.make_lgc_train_step(cfg, M_DEV, psteps.LGCStepConfig(**STEP))
    params = {k: v.clone() for k, v in pp.items()}
    ef = psteps.init_ef_tree(params, M_DEV)
    losses = []
    for b, recv in zip(LGC_BATCHES, RECEIVED):
        params, ef, loss = step(params, ef,
                                {k: torch.from_numpy(v) for k, v in b.items()},
                                torch.from_numpy(recv))
        losses.append(float(loss))
    out["lgc"] = {"losses": losses,
                  "params": {k: v.numpy() for k, v in params.items()},
                  "ef": {k: v.numpy() for k, v in ef.items()}}
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """Every job of both archs on two spawned gloo ranks and, meanwhile,
    the reference's runs and the unsharded port's in this process."""
    weights, jobs = {}, []
    for arch in ARCHS:
        cfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32)
        jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
        weights[arch] = jp
        jobs += _jobs(arch, _flat(jax.device_get(jp)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pmesh.spawn, tp_jobs.rank_main, 2, "gloo",
                            (jobs, "cpu"), 300.0)
        ref = {a: _reference(a, jp) for a, jp in weights.items()}
        p1 = {a: _port_p1(a, params_from_jax(jax.device_get(jp)))
              for a, jp in weights.items()}
        ranks = ranks.result()
    return [r["results"] for r in ranks], ref, p1


def _both(world, name: str) -> list:
    return [r[name] for r in world[0]]


def _flip_share(got: np.ndarray, want: np.ndarray) -> float:
    off = ~np.isclose(got, want, rtol=RTOL, atol=STATE_ATOL)
    return float(off.mean()) if off.size else 0.0


# ---------------------------------------------------------------------------
# (a) loss and gradients against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(world, arch):
    want = world[1][arch]
    r0, r1 = _both(world, f"{arch} loss")
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], want["loss"], rtol=RTOL)
    assert set(r0["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        for r in (r0, r1):
            np.testing.assert_allclose(r["grads"][k], g, rtol=RTOL,
                                       atol=SSD_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_an_unsummed_split_use_gradient_fails(world, arch):
    """Each leaf of ``ssd.SPLIT_USE``, with this rank's gradient alone,
    fails (a)'s check on every rank."""
    want = world[1][arch]["grads"]
    names = {k.rsplit("/", 1)[-1] for k in _both(world, f"{arch} loss")[0][
        "unsummed"]}
    assert names == set(pssd.SPLIT_USE)
    for r in _both(world, f"{arch} loss"):
        for k, own in r["unsummed"].items():
            assert not np.allclose(own, want[k], rtol=RTOL, atol=SSD_ATOL), k


# ---------------------------------------------------------------------------
# (b) the LGC step against the unsharded port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_split_statistics_are_bitwise_the_unsharded(world, arch):
    cfg = _port_cfg(arch)
    shapes = ptf.init_params(cfg, device="meta")
    for r in _both(world, f"{arch} compress"):
        leaves = {k: v for k, v in r.items() if k != "seconds"}
        assert set(leaves) == set(shapes)
        for leaf, row in leaves.items():
            assert row["step_bitwise"], leaf
            if row["split"]:
                assert row["pipeline_bitwise"] and row["plain_bitwise"], leaf
        split = {k for k, v in leaves.items() if v["split"]}
        assert {"blocks/ssm/in_proj", "blocks/ssm/out_proj", "embed"} <= split
        assert not split & set(ptf.split_use_leaves(cfg, shapes))


@pytest.mark.parametrize("arch", ARCHS)
def test_lgc_step_matches_the_unsharded_port(world, arch):
    want = world[2][arch]["lgc"]
    r0, r1 = _both(world, f"{arch} lgc")
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=RTOL)
    for part in ("params", "ef"):
        for k, v in want[part].items():
            for r in (r0, r1):
                assert r[part][k].shape == v.shape, (part, k)
                assert _flip_share(r[part][k], v) <= MAX_FLIP_SHARE, (part, k)
    assert r0["collectives"] == r1["collectives"]


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_rank_body_trains(world, arch):
    r0, r1 = _both(world, f"{arch} driver")
    assert r0["losses"] == r1["losses"]
    assert len(r0["losses"]) == 2 and np.isfinite(r0["losses"]).all()


# ---------------------------------------------------------------------------
# (c) serving against the reference and the P = 1 port's caches
# ---------------------------------------------------------------------------

def _collectives(arch: str, case: dict) -> tuple[int, int]:
    """(prefill, prefill + steps): the embedding's sum and the logits'
    gather; an SSD layer's ``in_proj`` gather, norm SUM, ``out_proj`` SUM
    and, a step with the conv split, the conv's gather; a shared-block
    site's K/V (prefill) or q / k / v gather, two row-parallel SUMs and, a
    step with the K/V split, the merge's gather."""
    cfg = _port_cfg(arch)
    layers = cfg.n_layers
    sites = ptf._n_sites(cfg) if cfg.arch_type == "hybrid" else 0
    split = not case.get("conv_whole")
    kv_split = case["cache_len"] % 2 == 0
    prefill = 2 + 3 * layers + 3 * sites
    step = 2 + (4 if split else 3) * layers + (4 if kv_split else 3) * sites
    return prefill, prefill + case["steps"] * step


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_p2_serving_matches_the_reference(world, arch, case):
    want = world[1][arch][case["name"]]
    r0, r1 = (r[case["name"]] for r in _both(world, f"{arch} serve"))
    for r in (r0, r1):
        np.testing.assert_allclose(r["prefill_logits"], want["prefill_logits"],
                                   rtol=RTOL, atol=SSD_ATOL)
        np.testing.assert_array_equal(r["tokens"], want["tokens"])
        for i in range(case["steps"]):
            np.testing.assert_allclose(r["logits"][i], want["logits"][i],
                                       rtol=RTOL, atol=SSD_ATOL,
                                       err_msg=f"step {i}")
        assert r["pos"] == want["pos"] == PROMPT + case["steps"]
        assert r["slots"] == (case["cache_len"] if arch == "zamba2-1.2b"
                              else None)
    for key in ("prefill_logits", "logits", "tokens"):
        assert np.array_equal(r0[key], r1[key]), key
    prefill, total = _collectives(arch, case)
    assert r0["prefill_collectives"] == r1["prefill_collectives"] == prefill
    assert r0["collectives"] == r1["collectives"] == total


def _rank_mesh(rank: int):
    return SimpleNamespace(axis_names=("data", "model"), rank=rank,
                           model_rank=rank, model_size=2,
                           shape={"data": 1, "model": 2})


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_caches_are_their_cache_specs_blocks(world, arch, case):
    ranks, ref, p1 = world
    cfg = _port_cfg(arch)
    whole = p1[arch][case["name"]]
    for stage in ("prefill_cache", "cache"):
        want = ref[arch][case["name"]][stage]
        assert set(whole[stage]) == set(want)
        for k, v in want.items():                # P = 1 holds the reference's
            np.testing.assert_allclose(whole[stage][k], v, rtol=RTOL,
                                       atol=SSD_ATOL, err_msg=f"{stage} {k}")
        tree = {"pos": 0, "kv": {k: torch.from_numpy(whole[stage][k])
                                 for k in ("k", "v") if k in want},
                "ssm": {k: torch.from_numpy(whole[stage][k])
                        for k in ("conv", "state")}}
        for rank, res in enumerate(ranks):
            mesh = _rank_mesh(rank)
            specs = rules.cache_specs(cfg, tree, mesh)
            assert specs["ssm"]["state"][2] == "model"
            assert specs["ssm"]["conv"][3] == "model"
            block = rules.shard_tree(tree, specs, mesh)
            got = res[f"{arch} serve"][case["name"]][stage]
            for group in ("kv", "ssm"):
                for k, t in block[group].items():
                    if stage == "cache" and k == "conv" and \
                            case.get("conv_whole"):
                        t = tree["ssm"]["conv"]     # gathered whole
                    assert got[k].shape == tuple(t.shape), (stage, k)
                    np.testing.assert_allclose(
                        got[k], t.numpy(), rtol=RTOL, atol=SSD_ATOL,
                        err_msg=f"{stage} {k} rank {rank}")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_gives_each_rank_its_block(arch):
    cfg = _port_cfg(arch)
    whole = ptf.init_cache(cfg, 2, 24, device="cpu")
    specs = rules.cache_specs(cfg, whole, _rank_mesh(1))
    block = rules.shard_tree(whole, specs, _rank_mesh(1))
    got = ptf.init_cache(cfg, 2, 24, device="cpu", mesh=_rank_mesh(1))
    assert got.get("slots") == (24 if "kv" in whole else None)
    for group in ("kv", "ssm"):
        assert set(got.get(group, {})) == set(block.get(group, {}))
        for k, t in block.get(group, {}).items():
            assert got[group][k].shape == t.shape, (group, k)


# ---------------------------------------------------------------------------
# (d) the refusals
# ---------------------------------------------------------------------------

def _fake_mesh(model: int):
    return SimpleNamespace(model_size=model, model_rank=0,
                           shape={"data": 1, "model": model},
                           axis_names=("data", "model"), rank=0,
                           device=torch.device("cpu"))


def test_model_axis_must_divide_the_ssd_and_kv_heads():
    mamba, zamba = _port_cfg("mamba2-370m"), _port_cfg("zamba2-1.2b")
    assert (mamba.ssm_heads, zamba.ssm_heads, zamba.n_kv_heads) == (8, 8, 4)
    batch = {k: torch.from_numpy(v) for k, v in LOSS_BATCH.items()}
    for cfg, p, what in ((mamba, 3, "ssm_heads=8"), (zamba, 3, "n_kv_heads=4"),
                         (zamba, 8, "n_kv_heads=4"), (mamba, 16,
                                                      "ssm_heads=8")):
        for make in (
                lambda: ptf.lm_loss({}, cfg, batch, mesh=_fake_mesh(p)),
                lambda: psteps.make_lgc_train_step(
                    cfg, 2, psteps.LGCStepConfig(), mesh=_fake_mesh(p)),
                lambda: psteps.make_serve_step(cfg, 8, mesh=_fake_mesh(p)),
                lambda: ptf.init_cache(cfg, 1, 8, device="cpu",
                                       mesh=_fake_mesh(p))):
            with pytest.raises(ValueError, match=what):
                make()
    with pytest.raises(ValueError, match="ssm_heads=8"):
        pssd.local_ssm_heads(zamba, 16)
    assert pssd.local_ssm_heads(mamba, 4) == 2
