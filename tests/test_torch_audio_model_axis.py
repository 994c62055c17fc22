"""The audio family under the model axis (ROADMAP A12c) on the CPU over
gloo.

One module fixture spawns two gloo ranks (one intra-op thread each) that
run ``whisper-small-smoke`` (2 encoder blocks over 64 frames, 2 decoder
blocks with cross-attention, 4 heads) in f32 from the reference's weights
(``weights.params_from_jax``) at P = 2 (their bodies in
``tests/_torch_tp_jobs.py``), while this process runs the reference and
the unsharded port.  The encoder blocks run as dense blocks on the rank's
heads and MLP columns; the encoder output, the same bits on every rank,
passes once through ``copy_to_model`` (its gradient summed over the ranks
before the encoder's backward); each decoder block's cross-attention
runs on the rank's heads, its ``wo`` rows summed.  Prefill gathers every
head's cross K/V into the cross cache, whole on every rank; a decode step
attends with the rank's query heads over their heads of it.

* (a) ``lm_loss`` and every leaf's gradient, gathered whole, against
  ``jax.value_and_grad`` of the reference's ``lm_loss``: the loss at rtol
  1e-5, the gradients at rtol 1e-5 / atol 1e-6; both ranks' encoder
  outputs equal bit for bit.  Two planted faults fail that check: the
  encoder output's gradient left unsummed (its ``copy_to_model`` made the
  identity) and the cross ``wo`` output left unsummed.
* (b) The LGC step (``dense_masked``, M = 2, H = 2, 2 rounds, a dropped
  channel, the row kernels' plain versions on every leaf) at P = 2
  against the unsharded port step: the split statistics of every leaf,
  ``enc_blocks/*`` and ``blocks/cross/*`` among them, bitwise the
  unsharded ones, the losses at rtol 1e-5, params and error memory at
  rtol 1e-5 / atol 1e-6 with at most 0.1% of a leaf off; the train
  driver's rank body at ``--model-parallel 2`` (``lgc`` with a
  checkpoint, and ``sync``); the checkpoint saved at P = 2 loads at
  P = 1 near the P = 1 driver's.
* (c) Prefill and greedy steps (10 past a ring's wrap, 6 over an odd
  cache kept whole) against the reference's ``prefill`` /
  ``decode_step`` at rtol 1e-5 / atol 1e-5 with equal greedy tokens;
  both ranks' logits and encoder outputs equal bit for bit (the ring's
  frames drawn on each rank by ``serve_decode.stub_prefix`` from the same
  seed); each rank's self K/V its ``cache_specs`` block and its cross
  cache the whole of the P = 1 port's, within that tolerance; the
  collectives pinned (2 + 2 L_enc + 5 L a prefill, 2 + 5 L a step with
  the K/V split, 2 + 4 L whole).  A planted fault, the cross cache
  written with the rank's heads only, fails the cross cache's check.
* (d) The refusals: a P that divides the heads but not the padded vocab
  (whisper-small itself at P = 3: 12 heads, 51,968 rows) raises a
  ValueError naming both, from the config alone; ``model_axis_mesh``
  admits every family.
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
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ArchConfig as PArch  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import sharding_rules as rules  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.serve_decode import stub_prefix  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RTOL = 1e-5
ATOL = 1e-6                     # loss gradients, LGC params and error memory
SERVE_ATOL = 1e-5               # logits and caches
MAX_FLIP_SHARE = 1e-3
CKPT_GAP_SHARE = 0.5            # the bf16 driver's checkpoint, see its test
ARCH = "whisper-small"
SEQ, M_DEV, H = 32, 2, 2
STEP = dict(local_steps=H, local_lr=3e-3, sparsity=(0.05, 0.1, 0.1),
            aggregate="dense_masked", backend="cuda", pallas_min_elems=1)
RECEIVED = [np.ones((M_DEV, 3), np.int32),
            np.array([[1, 1, 1], [1, 0, 1]], np.int32)]
PROMPT = 16
ENC_FAULTS = ("enc_unsummed", "cross_wo_unsummed")


def _j_cfg():
    return dataclasses.replace(j_smoke(ARCH), dtype=jnp.float32)


def _port_cfg() -> PArch:
    j_cfg = _j_cfg()
    kw = {f.name: getattr(j_cfg, f.name) for f in dataclasses.fields(j_cfg)
          if f.name != "dtype"}
    return PArch(**kw, dtype=torch.float32)


def _frames(n: int, seed: int) -> np.ndarray:
    cfg = _j_cfg()
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _batch(n: int, seed: int) -> dict:
    toks = np.random.default_rng(seed).integers(0, 512, (n, SEQ + 1))
    return {"tokens": toks[:, :-1].astype(np.int64),
            "labels": toks[:, 1:].astype(np.int64),
            "prefix": _frames(n, seed)}


def _cases() -> list:
    """Over a ring of the prompt's 16 positions + 8 slots, 10 steps (the
    ring wraps at step 8; its slots split over the ranks), its frames
    drawn by ``stub_prefix`` on each rank; 6 steps over an odd cache (kept
    whole on every rank) with frames from numpy."""
    out = []
    for name, extra, window, steps, seed in (("ring", 8, True, 10, 1),
                                             ("whole", 9, False, 6, 2)):
        slots = PROMPT + extra
        case = dict(name=name, cache_len=slots, window=slots if window else 0,
                    steps=steps, prompts=np.random.default_rng(seed).integers(
                        0, 512, (2, PROMPT), dtype=np.int32))
        if name == "ring":
            case["stub_seed"] = seed
        else:
            case["prefix"] = _frames(2, seed)
        out.append(case)
    return out


def _case_frames(case: dict) -> np.ndarray:
    """The case's frames, as each rank gets or draws them."""
    if case.get("stub_seed") is None:
        return case["prefix"]
    return stub_prefix(_port_cfg(), 2,
                       torch.Generator().manual_seed(case["stub_seed"]),
                       torch.device("cpu")).numpy()


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


LOSS_BATCH = _batch(2, 3)
LGC_BATCHES = [_batch(M_DEV * H, 5 + i) for i in range(len(RECEIVED))]
CASES = _cases()
CASE_NAMES = [c["name"] for c in CASES]


def _driver_argv(mode: str, model: int, ckpt=None) -> list:
    argv = ["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "4",
            "--seq", "16", "--mode", mode, "--devices", str(2 * model),
            "--model-parallel", str(model), "--lr", "3e-2", "--local-steps",
            "2", "--device", "cpu", "--log-every", "100"]
    return argv + (["--ckpt-dir", str(ckpt)] if ckpt else [])


def _jobs(p0: dict, ckpt) -> list:
    small = dict(arch=ARCH, smoke=True, f32=True)
    jobs = [dict(name="loss", kind="loss_grads", params=p0,
                 batch=LOSS_BATCH, **small),
            dict(name="compress", kind="compress", aggregate="dense_masked",
                 min_elems=1, rule=None, **small),
            dict(name="lgc", kind="lgc", params=p0, m=M_DEV, step=STEP,
                 batches=LGC_BATCHES, received=RECEIVED, **small),
            dict(name="serve", kind="serve", params=p0, cases=CASES,
                 **small),
            dict(name="serve cross_cache_own_heads", kind="serve", params=p0,
                 cases=CASES[:1], fault="cross_cache_own_heads", **small),
            dict(name="driver lgc", kind="driver",
                 argv=_driver_argv("lgc", 2, ckpt)),
            dict(name="driver sync", kind="driver",
                 argv=_driver_argv("sync", 2))]
    jobs += [dict(name=f"loss {f}", kind="loss_grads", params=p0,
                  batch=LOSS_BATCH, fault=f, **small) for f in ENC_FAULTS]
    return jobs


def _reference(jp) -> dict:
    """The reference's loss and gradients, and each case's prefill and
    greedy steps."""
    cfg = _j_cfg()
    batch = {k: jnp.asarray(v) for k, v in LOSS_BATCH.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, cfg, batch)))(jp)
    out = {"loss": float(loss), "grads": _flat(jax.device_get(grads))}

    @functools.partial(jax.jit, static_argnums=2)
    def prefill(params, batch, cache_len):
        return jtf.prefill(params, cfg, batch, cache_len)

    @functools.partial(jax.jit, static_argnums=3)
    def step(params, token, cache, window):
        lg, cache = jtf.decode_step(params, cfg, token, cache, window=window)
        return lg, jnp.argmax(lg, -1).astype(jnp.int32)[:, None], cache
    for c in CASES:
        logits, cache = prefill(jp, {"tokens": jnp.asarray(c["prompts"]),
                                     "prefix": jnp.asarray(_case_frames(c))},
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
    return {k: np.asarray(t) for k, t in cache["kv"].items()} | {
        k: np.asarray(cache[k]) for k in ("cross_k", "cross_v")}


def _port_p1(pp: dict) -> dict:
    """The unsharded port: each case's caches after prefill and after the
    steps and its encoder output, the loss batch's encoder output, and
    the LGC step's rounds."""
    cfg = _port_cfg()
    out = {"loss_enc": ptf._encode(
        pp, cfg, torch.from_numpy(LOSS_BATCH["prefix"])).numpy()}
    for c in CASES:
        frames = torch.from_numpy(_case_frames(c))
        logits, cache = psteps.make_prefill_step(cfg, c["cache_len"],
                                                 device="cpu")(
            pp, {"tokens": torch.from_numpy(c["prompts"]), "prefix": frames})
        res = {"prefill_cache": tp_jobs._caches(cache),
               "enc": ptf._encode(pp, cfg, frames).numpy()}
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
def world(tmp_path_factory):
    """Every job on two spawned gloo ranks and, meanwhile, the reference's
    run, the unsharded port's and the driver at P = 1 in this process
    (with a checkpoint)."""
    tmp = tmp_path_factory.mktemp("audio")
    jp = jtf.init_params(_j_cfg(), jax.random.PRNGKey(0))
    jobs = _jobs(_flat(jax.device_get(jp)), tmp / "p2")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pmesh.spawn, tp_jobs.rank_main, 2, "gloo",
                            (jobs, "cpu"), 300.0)
        ref = _reference(jp)
        p1 = _port_p1(params_from_jax(jax.device_get(jp)))
        p1["driver"] = train.train(train._parse(
            _driver_argv("lgc", 1, tmp / "p1")))
        ranks = ranks.result()
    return [r["results"] for r in ranks], ref, p1, tmp


def _both(world, name: str) -> list:
    return [r[name] for r in world[0]]


def _fails(got: dict, want: dict) -> list:
    return [k for k, g in want.items()
            if not np.allclose(got[k], g, rtol=RTOL, atol=ATOL)]


def _flip_share(got: np.ndarray, want: np.ndarray) -> float:
    off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    return float(off.mean()) if off.size else 0.0


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# (a) loss and gradients against the reference
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_the_reference(world):
    want = world[1]
    r0, r1 = _both(world, "loss")
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], want["loss"], rtol=RTOL)
    assert set(r0["grads"]) == set(want["grads"])
    assert any(k.startswith("enc_blocks/") for k in want["grads"])
    for k, g in want["grads"].items():
        for r in (r0, r1):
            np.testing.assert_allclose(r["grads"][k], g, rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    assert r0["unsummed"] == r1["unsummed"] == {}


def test_encoder_output_is_the_same_bits_on_both_ranks(world):
    """One encoder call a forward; its output (after the heads' SUMs of
    every block) equal on both ranks bit for bit and within rtol 1e-5 of
    the unsharded port's."""
    r0, r1 = _both(world, "loss")
    assert len(r0["enc"]) == len(r1["enc"]) == 1
    assert _bits_equal(r0["enc"][0], r1["enc"][0])
    np.testing.assert_allclose(r0["enc"][0], world[2]["loss_enc"],
                               rtol=RTOL, atol=SERVE_ATOL)


@pytest.mark.parametrize("fault", ENC_FAULTS)
def test_planted_faults_fail(world, fault):
    """The encoder output's gradient left each rank's own heads' part
    fails (a) at every encoder leaf the decoder's gradient reaches, with
    the loss itself unchanged; the cross ``wo`` output left unsummed fails
    the loss and the gradients."""
    want = world[1]
    for r in _both(world, f"loss {fault}"):
        bad = _fails(r["grads"], want["grads"])
        if fault == "enc_unsummed":
            np.testing.assert_allclose(r["loss"], want["loss"], rtol=RTOL)
            assert "enc_pos" in bad and "enc_norm/scale" in bad
            assert all(k.startswith(("enc_", "enc_blocks/")) for k in bad)
        else:
            assert not np.isclose(r["loss"], want["loss"], rtol=RTOL)
            assert "blocks/cross/wo" in bad


# ---------------------------------------------------------------------------
# (b) the LGC step against the unsharded port
# ---------------------------------------------------------------------------

def test_split_statistics_are_bitwise_the_unsharded(world):
    shapes = ptf.init_params(_port_cfg(), device="meta")
    for r in _both(world, "compress"):
        leaves = {k: v for k, v in r.items() if k != "seconds"}
        assert set(leaves) == set(shapes)
        for leaf, row in leaves.items():
            assert row["step_bitwise"], leaf
            if row["split"]:
                assert row["pipeline_bitwise"] and row["plain_bitwise"], leaf
        split = {k for k, v in leaves.items() if v["split"]}
        for stack in ("enc_blocks", "blocks"):
            assert {f"{stack}/attn/{w}" for w in ("wq", "wk", "wv", "wo")} \
                <= split
            assert {f"{stack}/mlp/{w}" for w in ("w_up", "b_up", "w_down")} \
                <= split
        assert {f"blocks/cross/{w}" for w in ("wq", "wk", "wv", "wo")} \
            <= split
        assert not split & {"enc_pos", "dec_pos", "enc_blocks/mlp/b_down",
                            "blocks/norm_x/scale", "enc_norm/scale"}


def test_lgc_step_matches_the_unsharded_port(world):
    want = world[2]["lgc"]
    r0, r1 = _both(world, "lgc")
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=RTOL)
    for part in ("params", "ef"):
        for k, v in want[part].items():
            for r in (r0, r1):
                assert r[part][k].shape == v.shape, (part, k)
                assert _flip_share(r[part][k], v) <= MAX_FLIP_SHARE, (part, k)
    assert r0["collectives"] == r1["collectives"]


@pytest.mark.parametrize("mode", ("lgc", "sync"))
def test_driver_rank_body_trains(world, mode):
    r0, r1 = _both(world, f"driver {mode}")
    assert r0["losses"] == r1["losses"]
    assert len(r0["losses"]) == 2 and np.isfinite(r0["losses"]).all()


def test_checkpoint_saved_at_p2_loads_at_p1(world):
    """The lgc driver's checkpoint at P = 2 (rank 0 writes the gathered
    whole leaves) loads into a P = 1 template and holds the P = 1
    driver's params after the same two rounds: the driver trains in bf16,
    so each leaf's mean gap to P = 1 is held below a share of the mean
    step the rounds took.  Sound readings 0.004-0.081, and 0.378 at
    ``enc_blocks/attn/wk``: the driver's zero frames leave the encoder's
    keys a gradient near bf16's rounding (the leaf moves 2.6e-5 in the
    mean; in f32 the P = 2 step is the P = 1 step's within 1e-5, (b));
    a leaf's blocks put back in the wrong order give a gap of the
    weights' own size, hundreds of times the step."""
    from repro_torch.checkpoint import load_checkpoint
    like = ptf.init_params(get_smoke_config(ARCH), seed=0, device="cpu")
    tmp = world[3]
    got = load_checkpoint(str(tmp / "p2"), 2, like)
    want = load_checkpoint(str(tmp / "p1"), 2, like)
    for k, v in like.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        moved = float((want[k].float() - v.float()).abs().mean())
        gap = float((got[k].float() - want[k].float()).abs().mean())
        assert gap <= CKPT_GAP_SHARE * moved, (k, gap, moved)
    for k in ("enc_blocks/attn/wq", "blocks/cross/wk"):
        assert not torch.equal(got[k], like[k]), k
    got, want = _both(world, "driver lgc")[0]["losses"], world[2]["driver"]
    # round 1's loss comes before any compression: bf16 partial sums only
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    assert got[-1] < got[0] and want[-1] < want[0]


# ---------------------------------------------------------------------------
# (c) serving against the reference and the P = 1 port's caches
# ---------------------------------------------------------------------------

def _collectives(case: dict, cross_gathered: bool = True) -> tuple[int, int]:
    """(prefill, prefill + steps): the embedding's sum and the logits'
    gather; a prefill's encoder block's two SUMs, a decoder block's K/V
    gather, self and cross ``wo`` SUMs, FFN SUM and (``cross_gathered``)
    cross K/V gather; a step's block's q / k / v gather, its three SUMs
    and, with the K/V split, the merge's gather."""
    cfg = _port_cfg()
    split = case["cache_len"] % 2 == 0
    prefill = (2 + 2 * cfg.encoder_layers
               + (5 if cross_gathered else 4) * cfg.n_layers)
    return prefill, prefill + case["steps"] * (2 + (5 if split else 4)
                                               * cfg.n_layers)


@pytest.mark.parametrize("case", CASE_NAMES)
def test_p2_serving_matches_the_reference(world, case):
    spec = {c["name"]: c for c in CASES}[case]
    want = world[1][case]
    r0, r1 = (r[case] for r in _both(world, "serve"))
    for r in (r0, r1):
        np.testing.assert_allclose(r["prefill_logits"], want["prefill_logits"],
                                   rtol=RTOL, atol=SERVE_ATOL)
        np.testing.assert_array_equal(r["tokens"], want["tokens"])
        for i in range(spec["steps"]):
            np.testing.assert_allclose(r["logits"][i], want["logits"][i],
                                       rtol=RTOL, atol=SERVE_ATOL,
                                       err_msg=f"step {i}")
        assert r["pos"] == want["pos"] == PROMPT + spec["steps"]
        assert r["slots"] == spec["cache_len"]
    for k in ("prefill_logits", "logits", "tokens"):
        assert np.array_equal(r0[k], r1[k]), k
    assert len(r0["enc"]) == len(r1["enc"]) == 1
    assert _bits_equal(r0["enc"][0], r1["enc"][0])
    np.testing.assert_allclose(r0["enc"][0], world[2][case]["enc"],
                               rtol=RTOL, atol=SERVE_ATOL)
    prefill, total = _collectives(spec)
    assert r0["prefill_collectives"] == r1["prefill_collectives"] == prefill
    assert r0["collectives"] == r1["collectives"] == total


def _rank_mesh(rank: int):
    return SimpleNamespace(axis_names=("data", "model"), rank=rank,
                           model_rank=rank, model_size=2,
                           shape={"data": 1, "model": 2})


def _cache_tree(caches: dict) -> dict:
    return {"pos": 0,
            "kv": {k: torch.from_numpy(caches[k]) for k in ("k", "v")}} | {
        k: torch.from_numpy(caches[k]) for k in ("cross_k", "cross_v")}


def _assert_rank_caches(got: dict, whole: dict, rank: int, what: str):
    """``got`` (a rank's caches by name) is its ``cache_specs`` block of
    ``whole`` (the P = 1 port's): the self K/V its slots, the cross cache
    whole."""
    tree = _cache_tree(whole)
    mesh = _rank_mesh(rank)
    block = rules.shard_tree(tree, rules.cache_specs(_port_cfg(), tree, mesh),
                             mesh)
    want = dict(block["kv"]) | {k: block[k] for k in ("cross_k", "cross_v")}
    assert set(got) == set(want), what
    assert want["cross_k"].shape == tree["cross_k"].shape
    for k, t in want.items():
        assert got[k].shape == tuple(t.shape), (what, k)
        np.testing.assert_allclose(got[k], t.numpy(), rtol=RTOL,
                                   atol=SERVE_ATOL,
                                   err_msg=f"{what} {k} rank {rank}")


@pytest.mark.parametrize("case", CASE_NAMES)
def test_rank_caches_are_their_cache_specs_blocks(world, case):
    ranks, ref, p1, _ = world
    whole = p1[case]
    for stage in ("prefill_cache", "cache"):
        want = ref[case][stage]
        assert set(whole[stage]) == set(want) == {"k", "v", "cross_k",
                                                  "cross_v"}
        for k, v in want.items():                # P = 1 holds the reference's
            np.testing.assert_allclose(whole[stage][k], v, rtol=RTOL,
                                       atol=SERVE_ATOL, err_msg=f"{stage} {k}")
        for rank, res in enumerate(ranks):
            _assert_rank_caches(res["serve"][case][stage], whole[stage],
                                rank, stage)
    r0, r1 = (r["serve"][case]["prefill_cache"] for r in ranks)
    for k in ("cross_k", "cross_v"):
        assert _bits_equal(r0[k], r1[k]), k


def test_cross_cache_of_the_rank_heads_only_fails(world):
    """The planted fault: each rank writes only its heads of the cross
    cache (no gather).  The rank's decode reads only its own heads, so
    its logits still agree; the cross cache is not the P = 1 port's (the
    other rank's heads are zeros), and the prefill runs one collective a
    block fewer."""
    ranks, ref, p1, _ = world
    spec = CASES[0]
    for rank, res in enumerate(ranks):
        got = res["serve cross_cache_own_heads"][spec["name"]]
        with pytest.raises(AssertionError):
            _assert_rank_caches(got["prefill_cache"],
                                p1[spec["name"]]["prefill_cache"], rank,
                                "prefill_cache")
        assert got["prefill_collectives"] == _collectives(spec, False)[0]
        np.testing.assert_array_equal(got["tokens"],
                                      ref[spec["name"]]["tokens"])


# ---------------------------------------------------------------------------
# (d) the refusals
# ---------------------------------------------------------------------------

def _fake_mesh(model: int):
    return SimpleNamespace(model_size=model, model_rank=0,
                           shape={"data": 1, "model": model},
                           axis_names=("data", "model"), rank=0,
                           device=torch.device("cpu"))


def test_model_axis_must_divide_the_padded_vocab():
    """whisper-small at P = 3: 3 divides its 12 heads, not its 51,968
    padded vocab rows; every entry point raises before a weight is drawn
    (the driver before it spawns a rank).  The smoke config's 4 heads
    refuse P = 3 first."""
    cfg = get_config(ARCH)
    assert cfg.n_heads % 3 == cfg.n_kv_heads % 3 == 0
    assert cfg.vocab_padded == 51_968 and cfg.vocab_padded % 3
    what = "model axis of 3 must divide the padded vocab 51968"
    batch = {k: torch.from_numpy(v) for k, v in LOSS_BATCH.items()}
    for make in (lambda: ptf.check_model_axis(cfg, 3),
                 lambda: ptf.lm_loss({}, cfg, batch, mesh=_fake_mesh(3)),
                 lambda: psteps.make_lgc_train_step(
                     cfg, 2, psteps.LGCStepConfig(), mesh=_fake_mesh(3)),
                 lambda: psteps.make_prefill_step(cfg, 8, mesh=_fake_mesh(3)),
                 lambda: ptf.init_cache(cfg, 1, 8, device="cpu",
                                        mesh=_fake_mesh(3)),
                 lambda: train.main(["--arch", ARCH, "--model-parallel", "3",
                                     "--devices", "3", "--device", "cpu"])):
        with pytest.raises(ValueError, match=what):
            make()
    for p in (2, 4):
        ptf.check_model_axis(cfg, p)
    with pytest.raises(ValueError, match="n_kv_heads=4"):
        ptf.check_model_axis(_port_cfg(), 3)


#: a config of each of the six families
FAMILY_ARCHS = ("qwen2-1.5b", "olmoe-1b-7b", "mamba2-370m", "zamba2-1.2b",
                "phi-3-vision-4.2b", ARCH)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_axis_admits_every_family(arch):
    """No family is refused a model axis any more: a smoke config of each
    of the six takes P = 2, and P = 1 is no model axis."""
    cfg = get_smoke_config(arch)
    mesh = _fake_mesh(2)
    assert ptf.model_axis_mesh(cfg, mesh) is mesh
    assert ptf.model_axis_mesh(cfg, _fake_mesh(1)) is None
    assert {get_smoke_config(a).arch_type
            for a in FAMILY_ARCHS} == set(ptf.FAMILIES)
