"""The moe and vlm families under the model axis (ROADMAP A12c) on the CPU
over gloo.

One module fixture spawns two gloo ranks (one intra-op thread each) that
run ``olmoe-smoke`` (E = 4 at P = 2: expert-parallel, with capacity drops
at the loss batch), ``grok1-smoke`` (gated-GELU experts, expert-parallel),
``olmoe-smoke`` with ``n_experts=3`` (P does not divide E: each expert's
F split) and ``phi3v-smoke`` in f32 from the reference's weights
(``weights.params_from_jax``) at P = 2 (their bodies in
``tests/_torch_tp_jobs.py``), while this process runs the reference and
the unsharded port.  The MoE dispatch is global on every rank; a rank
runs its experts (or its block of every expert's F), its partial output
is summed over the ranks; the router's gradient is summed with the other
split-use leaves', the load-balance loss's gradient counted once; the
vlm's ``vis_proj`` projects on the rank's columns, gathered whole.

* (a) ``lm_loss`` and every leaf's gradient, gathered whole, against
  ``jax.value_and_grad`` of the reference's ``lm_loss``: the loss at rtol
  1e-5, the gradients at rtol 1e-5 / atol 1e-6 (the dense tolerance of
  tests/test_torch_family_training.py).  Each MoE layer's router ids and
  kept rows equal on both ranks and equal to the reference's (its ids
  read in an eager run; its kept rows from its dispatch's formulas,
  ``src/repro/models/moe.py:79-88``).  Two planted faults fail that
  check: the router's gradient left unsummed (each rank's own), and the
  load-balance loss's gradient counted on every rank
  (``parallel.count_once`` made the identity).
* (b) The LGC step (``dense_masked``, M = 2, H = 2, 2 rounds, a dropped
  channel, the row kernels' plain versions on every leaf) at P = 2
  against the unsharded port step: the split statistics of every leaf,
  the expert shards among them, bitwise the unsharded ones
  (``steps.split_compress_rows`` and the step's compression), the losses
  at rtol 1e-5, params and error memory at rtol 1e-5 / atol 1e-6 with at
  most 0.1% of a leaf off (a coordinate next to a bin edge changes
  layer); the train driver's rank body at ``--model-parallel 2``
  (olmoe ``lgc`` with a checkpoint, phi-3-vision ``sync``).  The
  checkpoint saved at P = 2 loads at P = 1 and holds the P = 1 driver's
  params after the same rounds, each leaf's mean gap below a quarter of
  the mean step the rounds took (the driver trains in bf16).
* (c) Prefill and greedy steps (10 past a ring's wrap, 6 over an odd
  cache kept whole) against the reference's ``prefill`` /
  ``decode_step`` at rtol 1e-5 / atol 1e-5 with equal greedy tokens;
  both ranks' logits equal bit for bit; each rank's K/V its
  ``cache_specs`` block of the P = 1 port's cache within that tolerance,
  the P = 1 port's cache the reference's; the collectives of each run
  pinned (2 + 3 L a prefill, 1 more for ``vis_proj``; 2 + 4 L a step with
  the K/V split, 2 + 3 L whole).
* (d) The refusals: P not dividing ``n_kv_heads`` raises ValueError;
  biased GELU experts split on F raise NotImplementedError.
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.base import ArchConfig as PArch  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import sharding_rules as rules  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RTOL = 1e-5
ATOL = 1e-6                     # loss gradients, LGC params and error memory
SERVE_ATOL = 1e-5               # logits and caches
MAX_FLIP_SHARE = 1e-3
CKPT_GAP_SHARE = 0.25           # the bf16 driver's checkpoint, see its test
#: key -> (arch, the smoke config's fields replaced)
CONFIGS = {"olmoe": ("olmoe-1b-7b", {}), "grok": ("grok-1-314b", {}),
           "olmoe_e3": ("olmoe-1b-7b", {"n_experts": 3}),
           "phi3v": ("phi-3-vision-4.2b", {})}
KEYS = tuple(CONFIGS)
MOE_KEYS = ("olmoe", "grok", "olmoe_e3")
SEQ, M_DEV, H = 32, 2, 2
STEP = dict(local_steps=H, local_lr=3e-3, sparsity=(0.05, 0.1, 0.1),
            aggregate="dense_masked", backend="cuda", pallas_min_elems=1)
RECEIVED = [np.ones((M_DEV, 3), np.int32),
            np.array([[1, 1, 1], [1, 0, 1]], np.int32)]
PROMPT = 16


def _j_cfg(key: str):
    arch, replace = CONFIGS[key]
    return dataclasses.replace(j_smoke(arch), dtype=jnp.float32, **replace)


def _port_cfg(key: str) -> PArch:
    j_cfg = _j_cfg(key)
    kw = {f.name: getattr(j_cfg, f.name) for f in dataclasses.fields(j_cfg)
          if f.name != "dtype"}
    return PArch(**kw, dtype=torch.float32)


def _prefix(key: str, n: int, seed: int) -> dict:
    """The vlm's patch embeddings (n, P, 1024), else nothing."""
    cfg = _j_cfg(key)
    if cfg.arch_type != "vlm":
        return {}
    return {"prefix": np.random.default_rng(seed).standard_normal(
        (n, cfg.n_prefix_tokens, 1024)).astype(np.float32)}


def _batch(key: str, n: int, seed: int) -> dict:
    toks = np.random.default_rng(seed).integers(0, 512, (n, SEQ + 1))
    return {"tokens": toks[:, :-1].astype(np.int64),
            "labels": toks[:, 1:].astype(np.int64), **_prefix(key, n, seed)}


def _positions(key: str) -> int:
    """A prompt's positions: its tokens after the vlm's patches."""
    return PROMPT + _j_cfg(key).n_prefix_tokens


def _cases(key: str) -> list:
    """Over a ring of the prompt's positions + 8 slots, 10 steps (the
    ring wraps at step 8; its slots split over the ranks), and (olmoe,
    phi-3-vision) 6 steps over an odd cache (kept whole on every rank)."""
    out = []
    for name, extra, window, steps, seed in (("ring", 8, True, 10, 1),
                                             ("whole", 9, False, 6, 2)):
        if name not in SERVE_CASES[key]:
            continue
        slots = _positions(key) + extra
        out.append(dict(
            name=name, cache_len=slots, window=slots if window else 0,
            steps=steps, prompts=np.random.default_rng(seed).integers(
                0, 512, (2, PROMPT), dtype=np.int32),
            prefix=_prefix(key, 2, seed).get("prefix")))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


LOSS_BATCH = {k: _batch(k, 2, 3) for k in KEYS}
LGC_BATCHES = {k: [_batch(k, M_DEV * H, 5 + i) for i in range(len(RECEIVED))]
               for k in KEYS}
DRIVER_MODES = {"olmoe": "lgc", "phi3v": "sync"}
#: the serving cases of each config (grok-1's and the F-split experts'
#: serving differs from olmoe's only in the expert layer)
SERVE_CASES = {"olmoe": ("ring", "whole"), "grok": ("ring",),
               "olmoe_e3": ("ring",), "phi3v": ("ring", "whole")}
KEY_CASES = [(k, c) for k in KEYS for c in SERVE_CASES[k]]


def _driver_argv(key: str, model: int, ckpt=None) -> list:
    argv = ["--arch", CONFIGS[key][0], "--smoke", "--steps", "2", "--batch",
            "4", "--seq", "16", "--mode", DRIVER_MODES[key], "--devices",
            str(2 * model), "--model-parallel", str(model), "--lr", "3e-2",
            "--local-steps", "2", "--device", "cpu", "--log-every", "100"]
    return argv + (["--ckpt-dir", str(ckpt)] if ckpt else [])


def _jobs(key: str, p0: dict, ckpt) -> list:
    arch, replace = CONFIGS[key]
    small = dict(arch=arch, smoke=True, f32=True, replace=replace)
    jobs = [dict(name=f"{key} loss", kind="loss_grads", params=p0,
                 batch=LOSS_BATCH[key], **small),
            dict(name=f"{key} compress", kind="compress",
                 aggregate="dense_masked", min_elems=1, rule=None, **small),
            dict(name=f"{key} lgc", kind="lgc", params=p0, m=M_DEV,
                 step=STEP, batches=LGC_BATCHES[key], received=RECEIVED,
                 **small),
            dict(name=f"{key} serve", kind="serve", params=p0,
                 cases=_cases(key), **small)]
    if key in MOE_KEYS:
        jobs.append(dict(name=f"{key} aux fault", kind="loss_grads",
                         params=p0, batch=LOSS_BATCH[key],
                         fault="aux_every_rank", **small))
    if key in DRIVER_MODES:
        jobs.append(dict(name=f"{key} driver", kind="driver",
                         argv=_driver_argv(key, 2, ckpt)))
    return jobs


def _kept(ids: np.ndarray, n_experts: int, factor: float = 1.25
          ) -> np.ndarray:
    """The reference dispatch's kept rows (``valid``, in its stable
    expert-sorted order) of the (N, K) ids (src/repro/models/moe.py:79-88)."""
    flat = ids.reshape(-1)
    se = flat[np.argsort(flat, kind="stable")]
    pos = np.arange(flat.size) - np.searchsorted(se, np.arange(n_experts))[se]
    return pos < max(1, int(flat.size / n_experts * factor))


def _reference_ids(cfg, jp, batch) -> list:
    """Each MoE layer's router ids in the reference's forward, run eagerly
    (``jax.disable_jit``) so that its ``_router`` hands them out."""
    calls, orig = [], jmoe._router

    def rec(x2, w, k):
        out = orig(x2, w, k)
        calls.append(np.asarray(out[1]))
        return out
    jmoe._router = rec
    try:
        with jax.disable_jit():
            jtf.lm_loss(jp, cfg, batch)
    finally:
        jmoe._router = orig
    return calls


def _reference(key: str, jp) -> dict:
    """The reference's loss, gradients and router ids, and each case's
    prefill and greedy steps."""
    cfg = _j_cfg(key)
    batch = {k: jnp.asarray(v) for k, v in LOSS_BATCH[key].items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, cfg, batch)))(jp)
    out = {"loss": float(loss), "grads": _flat(jax.device_get(grads)),
           "ids": (_reference_ids(cfg, jp, batch)
                   if cfg.arch_type == "moe" else [])}

    @functools.partial(jax.jit, static_argnums=2)
    def prefill(params, batch, cache_len):
        return jtf.prefill(params, cfg, batch, cache_len)

    @functools.partial(jax.jit, static_argnums=3)
    def step(params, token, cache, window):
        lg, cache = jtf.decode_step(params, cfg, token, cache, window=window)
        return lg, jnp.argmax(lg, -1).astype(jnp.int32)[:, None], cache
    for c in _cases(key):
        logits, cache = prefill(jp, _case_batch(c, jnp.asarray),
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


def _case_batch(case: dict, to) -> dict:
    batch = {"tokens": to(case["prompts"])}
    if case["prefix"] is not None:
        batch["prefix"] = to(case["prefix"])
    return batch


def _cache(cache) -> dict:
    return {k: np.asarray(t) for k, t in cache["kv"].items()}


def _port_p1(key: str, pp: dict) -> dict:
    """The unsharded port: each case's caches after prefill and after the
    steps, and the LGC step's rounds."""
    cfg = _port_cfg(key)
    out = {}
    for c in _cases(key):
        logits, cache = psteps.make_prefill_step(cfg, c["cache_len"],
                                                 device="cpu")(
            pp, _case_batch(c, torch.from_numpy))
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
    for b, recv in zip(LGC_BATCHES[key], RECEIVED):
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
def world(tmp_path_factory):
    """Every job of the four configs on two spawned gloo ranks and,
    meanwhile, the reference's runs, the unsharded port's and the olmoe
    driver at P = 1 in this process (each driver with a checkpoint)."""
    tmp = tmp_path_factory.mktemp("moe_vlm")
    weights, jobs = {}, []
    for key in KEYS:
        jp = jtf.init_params(_j_cfg(key), jax.random.PRNGKey(0))
        weights[key] = jp
        jobs += _jobs(key, _flat(jax.device_get(jp)), tmp / "p2")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pmesh.spawn, tp_jobs.rank_main, 2, "gloo",
                            (jobs, "cpu"), 300.0)
        ref = {k: _reference(k, jp) for k, jp in weights.items()}
        p1 = {k: _port_p1(k, params_from_jax(jax.device_get(jp)))
              for k, jp in weights.items()}
        p1["driver"] = train.train(train._parse(
            _driver_argv("olmoe", 1, tmp / "p1")))
        ranks = ranks.result()
    return [r["results"] for r in ranks], ref, p1, tmp


def _both(world, name: str) -> list:
    return [r[name] for r in world[0]]


def _flip_share(got: np.ndarray, want: np.ndarray) -> float:
    off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    return float(off.mean()) if off.size else 0.0


# ---------------------------------------------------------------------------
# (a) loss and gradients against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", KEYS)
def test_loss_and_grads_match_the_reference(world, key):
    want = world[1][key]
    r0, r1 = _both(world, f"{key} loss")
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], want["loss"], rtol=RTOL)
    assert set(r0["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        for r in (r0, r1):
            np.testing.assert_allclose(r["grads"][k], g, rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("key", MOE_KEYS)
def test_router_ids_and_drops_are_the_references(world, key):
    """Every rank runs the whole router and the global dispatch: each
    layer's ids and kept rows are equal on both ranks and equal to the
    reference's; olmoe-smoke drops rows at this batch."""
    cfg = _port_cfg(key)
    want = world[1][key]["ids"]
    r0, r1 = _both(world, f"{key} loss")
    assert len(want) == len(r0["dispatch"]) == cfg.n_layers
    dropped = 0
    for (ids0, kept0), (ids1, kept1), ids_ref in zip(r0["dispatch"],
                                                     r1["dispatch"], want):
        np.testing.assert_array_equal(ids0, ids_ref)
        np.testing.assert_array_equal(ids1, ids_ref)
        np.testing.assert_array_equal(kept0, _kept(ids_ref, cfg.n_experts))
        np.testing.assert_array_equal(kept1, kept0)
        dropped += int((~kept0).sum())
    if key == "olmoe":
        assert dropped > 0


def _fails(got: dict, want: dict) -> list:
    return [k for k, g in want.items()
            if not np.allclose(got[k], g, rtol=RTOL, atol=ATOL)]


@pytest.mark.parametrize("key", MOE_KEYS)
def test_planted_router_faults_fail(world, key):
    """The router's own (unsummed) gradient on each rank, and the run
    with the load-balance loss's gradient counted on every rank, each
    fail (a)'s check at the router."""
    want = world[1][key]["grads"]
    for r in _both(world, f"{key} loss"):
        assert set(r["unsummed"]) == {"blocks/moe/router"}
        own = r["unsummed"]["blocks/moe/router"]
        assert _fails({"r": own}, {"r": want["blocks/moe/router"]})
    for r in _both(world, f"{key} aux fault"):
        assert "blocks/moe/router" in _fails(r["grads"], want)


# ---------------------------------------------------------------------------
# (b) the LGC step against the unsharded port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", KEYS)
def test_split_statistics_are_bitwise_the_unsharded(world, key):
    cfg = _port_cfg(key)
    shapes = ptf.init_params(cfg, device="meta")
    for r in _both(world, f"{key} compress"):
        leaves = {k: v for k, v in r.items() if k != "seconds"}
        assert set(leaves) == set(shapes)
        for leaf, row in leaves.items():
            assert row["step_bitwise"], leaf
            if row["split"]:
                assert row["pipeline_bitwise"] and row["plain_bitwise"], leaf
        split = {k for k, v in leaves.items() if v["split"]}
        if cfg.arch_type == "moe":
            experts = {f"blocks/moe/experts/{w}"
                       for w in ("w_gate", "w_up", "w_down")}
            assert experts <= split and "blocks/moe/router" not in split
            for k in experts:          # (L, E, ...): E or F split in two
                whole, local = leaves[k]["shape"], leaves[k]["local"]
                if cfg.n_experts % 2 == 0:
                    assert local[1] == whole[1] // 2, k
                else:
                    assert local[1] == whole[1] and local != whole, k
        else:
            assert "vis_proj" in split
            assert leaves["vis_proj"]["local"] == [1024, cfg.d_model // 2]


@pytest.mark.parametrize("key", KEYS)
def test_lgc_step_matches_the_unsharded_port(world, key):
    want = world[2][key]["lgc"]
    r0, r1 = _both(world, f"{key} lgc")
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=RTOL)
    for part in ("params", "ef"):
        for k, v in want[part].items():
            for r in (r0, r1):
                assert r[part][k].shape == v.shape, (part, k)
                assert _flip_share(r[part][k], v) <= MAX_FLIP_SHARE, (part, k)
    assert r0["collectives"] == r1["collectives"]


@pytest.mark.parametrize("key", tuple(DRIVER_MODES))
def test_driver_rank_body_trains(world, key):
    r0, r1 = _both(world, f"{key} driver")
    assert r0["losses"] == r1["losses"]
    assert len(r0["losses"]) == 2 and np.isfinite(r0["losses"]).all()


def test_checkpoint_saved_at_p2_loads_at_p1(world):
    """The olmoe driver's checkpoint at P = 2 (rank 0 writes the gathered
    whole leaves) loads into a P = 1 template and holds the P = 1
    driver's params after the same two rounds: the driver trains in bf16,
    where the two runs' roundings move 1.5-8% of a leaf's coordinates
    across an LGC bin edge, so each leaf's mean gap to P = 1 is held
    below a share of the mean step the rounds took (0.04-0.14 sound; a
    leaf's blocks put back in the wrong order give ~1)."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_smoke_config
    like = ptf.init_params(get_smoke_config("olmoe-1b-7b"), seed=0,
                           device="cpu")
    tmp = world[3]
    got = load_checkpoint(str(tmp / "p2"), 2, like)
    want = load_checkpoint(str(tmp / "p1"), 2, like)
    for k, v in like.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        moved = float((want[k].float() - v.float()).abs().mean())
        gap = float((got[k].float() - want[k].float()).abs().mean())
        assert gap <= CKPT_GAP_SHARE * moved, (k, gap, moved)
    assert not torch.equal(got["blocks/moe/experts/w_up"],
                           like["blocks/moe/experts/w_up"])
    got, want = _both(world, "olmoe driver")[0]["losses"], world[2]["driver"]
    # round 1's loss comes before any compression: bf16 partial sums only
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    assert got[-1] < got[0] and want[-1] < want[0]


# ---------------------------------------------------------------------------
# (c) serving against the reference and the P = 1 port's caches
# ---------------------------------------------------------------------------

def _collectives(key: str, case: dict) -> tuple[int, int]:
    """(prefill, prefill + steps): the embedding's sum and the logits'
    gather; a layer's K/V gather (prefill) or q / k / v gather, the
    attention's and the FFN's SUMs and, a step with the K/V split, the
    merge's gather; the vlm's ``vis_proj`` gather."""
    cfg = _port_cfg(key)
    layers = cfg.n_layers
    split = case["cache_len"] % 2 == 0
    prefill = 2 + 3 * layers + (cfg.arch_type == "vlm")
    return prefill, prefill + case["steps"] * (2 + (4 if split else 3)
                                               * layers)


@pytest.mark.parametrize("key,case", KEY_CASES)
def test_p2_serving_matches_the_reference(world, key, case):
    spec = {c["name"]: c for c in _cases(key)}[case]
    want = world[1][key][case]
    r0, r1 = (r[case] for r in _both(world, f"{key} serve"))
    for r in (r0, r1):
        np.testing.assert_allclose(r["prefill_logits"], want["prefill_logits"],
                                   rtol=RTOL, atol=SERVE_ATOL)
        np.testing.assert_array_equal(r["tokens"], want["tokens"])
        for i in range(spec["steps"]):
            np.testing.assert_allclose(r["logits"][i], want["logits"][i],
                                       rtol=RTOL, atol=SERVE_ATOL,
                                       err_msg=f"step {i}")
        assert r["pos"] == want["pos"] == _positions(key) + spec["steps"]
        assert r["slots"] == spec["cache_len"]
    for k in ("prefill_logits", "logits", "tokens"):
        assert np.array_equal(r0[k], r1[k]), k
    prefill, total = _collectives(key, spec)
    assert r0["prefill_collectives"] == r1["prefill_collectives"] == prefill
    assert r0["collectives"] == r1["collectives"] == total


def _rank_mesh(rank: int):
    return SimpleNamespace(axis_names=("data", "model"), rank=rank,
                           model_rank=rank, model_size=2,
                           shape={"data": 1, "model": 2})


@pytest.mark.parametrize("key,case", KEY_CASES)
def test_rank_caches_are_their_cache_specs_blocks(world, key, case):
    ranks, ref, p1, _ = world
    cfg = _port_cfg(key)
    whole = p1[key][case]
    for stage in ("prefill_cache", "cache"):
        want = ref[key][case][stage]
        assert set(whole[stage]) == set(want) == {"k", "v"}
        for k, v in want.items():                # P = 1 holds the reference's
            np.testing.assert_allclose(whole[stage][k], v, rtol=RTOL,
                                       atol=SERVE_ATOL, err_msg=f"{stage} {k}")
        tree = {"pos": 0, "kv": {k: torch.from_numpy(whole[stage][k])
                                 for k in ("k", "v")}}
        for rank, res in enumerate(ranks):
            mesh = _rank_mesh(rank)
            block = rules.shard_tree(tree, rules.cache_specs(cfg, tree, mesh),
                                     mesh)
            got = res[f"{key} serve"][case][stage]
            for k, t in block["kv"].items():
                assert got[k].shape == tuple(t.shape), (stage, k)
                np.testing.assert_allclose(
                    got[k], t.numpy(), rtol=RTOL, atol=SERVE_ATOL,
                    err_msg=f"{stage} {k} rank {rank}")


# ---------------------------------------------------------------------------
# (d) the refusals
# ---------------------------------------------------------------------------

def _fake_mesh(model: int):
    return SimpleNamespace(model_size=model, model_rank=0,
                           shape={"data": 1, "model": model},
                           axis_names=("data", "model"), rank=0,
                           device=torch.device("cpu"))


@pytest.mark.parametrize("key,p,what", [("olmoe", 3, "n_kv_heads=4"),
                                        ("grok", 4, "n_kv_heads=2"),
                                        ("phi3v", 3, "n_kv_heads=4")])
def test_model_axis_must_divide_the_kv_heads(key, p, what):
    cfg = _port_cfg(key)
    batch = {k: torch.from_numpy(v) for k, v in LOSS_BATCH[key].items()}
    for make in (lambda: ptf.lm_loss({}, cfg, batch, mesh=_fake_mesh(p)),
                 lambda: psteps.make_lgc_train_step(
                     cfg, 2, psteps.LGCStepConfig(), mesh=_fake_mesh(p)),
                 lambda: psteps.make_serve_step(cfg, 8, mesh=_fake_mesh(p)),
                 lambda: ptf.init_cache(cfg, 1, 8, device="cpu",
                                        mesh=_fake_mesh(p))):
        with pytest.raises(ValueError, match=what):
            make()


def test_gelu_experts_split_on_f_are_refused():
    """No config has biased GELU experts; split on F their ``b_down``
    would join every rank's partial."""
    cfg = _port_cfg("olmoe_e3")
    p = pmoe.moe_init(None, (), cfg.d_model, 3, cfg.d_exp, "gelu",
                      torch.float32, torch.device("meta"))
    x = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match="P must divide n_experts"):
        pmoe.moe_forward(x, p, n_experts=3, top_k=2, mlp_kind="gelu",
                         mesh=_fake_mesh(2))
