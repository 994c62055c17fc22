"""Serving under the model axis (ROADMAP A12b) on the CPU over gloo.

The decode cache is split on its slots over the model axis as the
reference's ``sharding_rules.cache_specs`` splits it, each rank attends over
its slots through ``swa_decode``'s partial form and the ranks' softmax
states merge (``kernels.ref.merge_decode_partials``).

* (a) the plain partial form and the merge: P in {1, 2, 4} shards of a
  window, some rows ending inside the first shard (later ranks empty) and
  a row of length 0, merge to ``ref.swa_decode_ref`` over the whole window
  at f32 rtol 1e-6 / atol 1e-6 (an output coordinate near zero is a sum
  of terms of order one, so its relative error alone is unbounded; the
  largest gap seen is 1.6e-7) and to the reference's Pallas ``swa_decode``
  in interpret mode (GQA expanded) at tests/test_torch_swa.py's
  tolerance; ``m + log(l)`` is the logsumexp of the reference's scaled
  logits; the partial form cast to q's dtype is ``swa_decode`` bit for
  bit, and the merge of one state is the identity on the bits;
* (b) ``qwen2-smoke`` in f32 with the reference's weights
  (``weights.params_from_jax``): the port at P = 2 (one module fixture,
  two spawned gloo ranks with one intra-op thread each) against the
  reference's ``transformer.prefill`` / ``decode_step`` at rtol 1e-5 /
  atol 1e-5 with equal greedy tokens, in three cases: a full cache (rank
  1 holds no slot until the position reaches it), a ring that wraps (a
  slot's owner changes from rank 1 to rank 0) and a cache of odd length,
  which ``cache_specs`` keeps whole on every rank (with steps past its
  end, whose writes are dropped); both ranks' logits and tokens are equal
  bit for bit, and each run's collectives are pinned;
* (c) after prefill and after the steps, each rank's K/V cache equals its
  ``cache_specs`` block of the P = 1 port's cache within that tolerance;
* (d) the refusals: the moe, vlm and audio families under a mesh name
  A12c (the ssm and hybrid families serve there since A12c's first part:
  their steps build and ``init_cache`` gives each rank its ``cache_specs``
  block; tests/test_torch_ssm_model_axis.py holds them against the
  reference), a model axis that does not divide the kv heads raises
  ValueError.
"""
import concurrent.futures
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tp_jobs as tp_jobs  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels.swa_attention import swa_decode as j_swa_decode  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import kernels as pk  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import serve_decode  # noqa: E402
from repro_torch.launch import sharding_rules as rules  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RTOL = ATOL = 1e-5
MERGE_TOL = 1e-6
TOL_PALLAS = {"float32": 2e-5, "bfloat16": 1e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
J_CFG = dataclasses.replace(j_smoke("qwen2-1.5b"), dtype=jnp.float32)
P_CFG = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                            dtype=torch.float32)
N_LAYERS = P_CFG.n_layers


def _case(name, prompt, cache_len, window, steps, seed):
    prompts = np.random.default_rng(seed).integers(
        0, J_CFG.vocab_size, (2, prompt), dtype=np.int32)
    return dict(name=name, prompts=prompts, cache_len=cache_len,
                window=window, steps=steps)


#: (b) and (c): 8 tokens into 24 slots (12 a rank: rank 1 empty until
#: position 12); 12 tokens into a 16-slot ring, 24 steps (positions 12-35,
#: the ring wraps at 16 and 32); 8 tokens into 21 slots (odd: whole on
#: every rank), 16 steps (past the end at 21)
CASES = [_case("full", 8, 24, 0, 12, 1), _case("ring", 12, 16, 16, 24, 2),
         _case("whole", 8, 21, 0, 16, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _j_decode(window):
    @jax.jit
    def step(params, token, cache):
        logits, cache = jtf.decode_step(params, J_CFG, token, cache,
                                        window=window)
        return logits, jnp.argmax(logits, -1).astype(jnp.int32)[:, None], \
            cache
    return step


def _reference(jp) -> dict:
    """Each case through the reference: prefill logits and cache, every
    step's logits and greedy tokens, the final cache."""
    out = {}
    for c in CASES:
        logits, cache = jtf.prefill(jp, J_CFG,
                                    {"tokens": jnp.asarray(c["prompts"])},
                                    c["cache_len"])
        res = {"prefill_logits": np.asarray(logits),
               "prefill_cache": {k: np.asarray(cache["kv"][k])
                                 for k in ("k", "v")}}
        step = _j_decode(c["window"])
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        toks, step_logits = [np.asarray(tok)], []
        for _ in range(c["steps"]):
            logits, tok, cache = step(jp, tok, cache)
            toks.append(np.asarray(tok))
            step_logits.append(np.asarray(logits))
        res |= {"logits": np.stack(step_logits),
                "tokens": np.concatenate(toks, 1),
                "cache": {k: np.asarray(cache["kv"][k]) for k in ("k", "v")},
                "pos": int(cache["pos"])}
        out[c["name"]] = res
    return out


def _port_p1(pp) -> dict:
    """Each case through the port at P = 1: the caches after prefill and
    after the steps, whose blocks (c) compares with the ranks'."""
    out = {}
    for c in CASES:
        logits, cache = make_prefill_step(P_CFG, c["cache_len"],
                                          device="cpu")(
            pp, {"tokens": torch.from_numpy(c["prompts"])})
        res = {"prefill_cache": {k: cache["kv"][k].clone()
                                 for k in ("k", "v")}}
        step = make_serve_step(P_CFG, c["window"], device="cpu")
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for _ in range(c["steps"]):
            tok, cache = step(pp, tok, cache)
        res["cache"] = {k: cache["kv"][k] for k in ("k", "v")}
        out[c["name"]] = res
    return out


@pytest.fixture(scope="module")
def world():
    """The serve job on two spawned gloo ranks and, meanwhile, the
    reference's runs and the P = 1 port's in this process."""
    jp = jtf.init_params(J_CFG, jax.random.PRNGKey(0))
    pp = params_from_jax(jax.device_get(jp))
    job = dict(name="serve", kind="serve", arch="qwen2-1.5b", smoke=True,
               f32=True, params=_flat(jax.device_get(jp)), cases=CASES)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pmesh.spawn, tp_jobs.rank_main, 2, "gloo",
                            ([job], "cpu"), 300.0)
        ref = _reference(jp)
        p1 = _port_p1(pp)
        ranks = ranks.result()
    return [r["results"]["serve"] for r in ranks], ref, p1


# ---------------------------------------------------------------------------
# (a) the partial form and the merge
# ---------------------------------------------------------------------------

def _inputs(b, h, kv, w, dh, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, kv, w, dh)).astype(np.float32)
    v = rng.standard_normal((b, kv, w, dh)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def _sharded_partials(q, k, v, ln, p):
    """Each of ``p`` ranks' partial state over its W / p slots, with the
    rank's length as ``layers.attention_decode`` cuts it."""
    s_loc = k.shape[2] // p
    states = [pk.swa_decode_partial(
        q, k[:, :, r * s_loc:(r + 1) * s_loc].contiguous(),
        v[:, :, r * s_loc:(r + 1) * s_loc].contiguous(),
        torch.clamp(ln - r * s_loc, 0, s_loc).to(torch.int32))
        for r in range(p)]
    return [torch.stack(t) for t in zip(*states)]


# B = 4, GQA 2:1, W = 256: a row of length 0, two ending inside the first
# of four shards (later ranks empty), a full one
SHARD_CASE = dict(b=4, h=4, kv=2, w=256, dh=64, lengths=[0, 3, 60, 256])


@pytest.mark.parametrize("p", [1, 2, 4])
def test_shards_merge_to_the_whole_window(p):
    c = SHARD_CASE
    q, k, v, ln = (torch.from_numpy(a) for a in _inputs(
        c["b"], c["h"], c["kv"], c["w"], c["dh"], c["lengths"], p))
    outs, ms, ls = _sharded_partials(q, k, v, ln, p)
    got = pref.merge_decode_partials(outs, ms, ls, torch.float32)
    want = pref.swa_decode_ref(q, k, v, ln)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=MERGE_TOL,
                               atol=MERGE_TOL)
    assert torch.all(got[0] == 0.0)                   # the empty row
    # later ranks of the short rows hold nothing: m = -inf, l = 0, zeros
    for r in range(1, p):
        assert torch.isneginf(ms[r, 1]).all() and (ls[r, 1] == 0).all()
        assert torch.all(outs[r, 1] == 0.0)
    if p == 1:                                       # the identity
        assert torch.equal(got, outs[0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("p", [1, 2, 4])
def test_merged_shards_match_the_pallas_kernel(p, dtype):
    """Against the reference's Pallas ``swa_decode`` (interpret mode) on
    the GQA-expanded cache, as tests/test_torch_swa.py holds the plain
    form."""
    c = SHARD_CASE
    arrays = _inputs(c["b"], c["h"], c["kv"], c["w"], c["dh"], c["lengths"],
                     10 + p)
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays[:3])
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays[:3])
    ln = torch.from_numpy(arrays[3])

    def expand(x):   # (B,Kv,W,Dh) -> (B,H,W,Dh) through (B,W,Kv,Dh)
        return jnp.swapaxes(jl._expand_kv(jnp.swapaxes(x, 1, 2), c["h"]),
                            1, 2)
    want = np.asarray(j_swa_decode(jq, expand(jk), expand(jv),
                                   jnp.asarray(arrays[3]), chunk=64)
                      .astype(jnp.float32))
    outs, ms, ls = _sharded_partials(q, k, v, ln, p)
    got = pref.merge_decode_partials(outs, ms, ls, tdt)
    assert got.dtype == tdt
    tol = TOL_PALLAS[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_partial_state_is_the_logsumexp_and_the_plain_output(dtype):
    c = SHARD_CASE
    arrays = _inputs(c["b"], c["h"], c["kv"], c["w"], c["dh"], c["lengths"],
                     21)
    jdt, tdt = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays[:3])
    ln = torch.from_numpy(arrays[3])
    out, m, l_sum = pk.swa_decode_partial(q, k, v, ln)
    assert out.dtype == m.dtype == l_sum.dtype == torch.float32
    assert out.shape == q.shape and m.shape == l_sum.shape == q.shape[:2]
    plain = pk.swa_decode(q, k, v, ln)
    assert torch.equal(out.to(tdt).view(torch.int16 if tdt ==
                                        torch.bfloat16 else torch.int32),
                       plain.view(torch.int16 if tdt == torch.bfloat16
                                  else torch.int32))
    # the reference's scaled logits of the expanded cache, in f32
    jq, jk = (jnp.asarray(a).astype(jdt).astype(jnp.float32)
              for a in arrays[:2])
    rep = c["h"] // c["kv"]
    logits = jnp.einsum("bhd,bhwd->bhw", jq, jnp.repeat(jk, rep, axis=1)) \
        / jnp.sqrt(jnp.float32(c["dh"]))
    valid = jnp.arange(c["w"])[None, None, :] < jnp.asarray(
        arrays[3])[:, None, None]
    lse = np.asarray(jax.nn.logsumexp(jnp.where(valid, logits, -jnp.inf),
                                      axis=-1))
    got = (m + torch.log(l_sum)).numpy()
    assert np.isneginf(got[0]).all() and np.isneginf(lse[0]).all()
    np.testing.assert_allclose(got[1:], lse[1:], rtol=1e-5, atol=1e-5)
    assert torch.all(out[0] == 0.0) and torch.all(l_sum[0] == 0.0)


def test_merge_weighs_an_empty_rank_zero_and_keeps_all_empty_rows_zero():
    outs = torch.randn(3, 2, 4, 32)
    ms = torch.tensor([[[0.5] * 4, [-np.inf] * 4],
                       [[-np.inf] * 4, [-np.inf] * 4],
                       [[1.5] * 4, [-np.inf] * 4]], dtype=torch.float32)
    ls = torch.where(torch.isneginf(ms), torch.zeros_like(ms),
                     torch.full_like(ms, 2.0))
    outs[1] = 1e9                                 # never read: weight 0
    outs[:, 1] = 0.0
    got = pref.merge_decode_partials(outs, ms, ls)
    w0, w2 = np.exp(0.5 - 1.5), 1.0
    want = (w0 * outs[0, 0] + w2 * outs[2, 0]) / (w0 + w2)
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.all(got[1] == 0.0) and torch.isfinite(got).all()


# ---------------------------------------------------------------------------
# (b) the port at P = 2 against the reference
# ---------------------------------------------------------------------------

def _collectives(c, slots_split: bool) -> int:
    """Prefill: the embedding's sum, per layer the K/V gather and the two
    row-parallel sums, the logits' gather; a step the same with the q / k /
    v gather in place of the K/V one, plus the merge's gather where the
    cache is split."""
    per_layer = 4 if slots_split else 3
    return (2 + 3 * N_LAYERS) + c["steps"] * (2 + per_layer * N_LAYERS)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_p2_serving_matches_the_reference(world, case):
    ranks, ref, _ = world
    r0, r1 = (r[case["name"]] for r in ranks)
    want = ref[case["name"]]
    for r in (r0, r1):
        np.testing.assert_allclose(r["prefill_logits"], want["prefill_logits"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(r["tokens"], want["tokens"])
        for i in range(case["steps"]):
            np.testing.assert_allclose(r["logits"][i], want["logits"][i],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i}")
        assert r["pos"] == want["pos"] == case["prompts"].shape[1] \
            + case["steps"]
        assert r["slots"] == case["cache_len"]
    for key in ("prefill_logits", "logits", "tokens"):
        assert np.array_equal(r0[key], r1[key]), key
    split = case["cache_len"] % 2 == 0
    assert r0["collectives"] == r1["collectives"] == _collectives(case,
                                                                  split)


# ---------------------------------------------------------------------------
# (c) each rank's cache is its cache_specs block of the P = 1 cache
# ---------------------------------------------------------------------------

def _rank_mesh(rank: int):
    return SimpleNamespace(axis_names=("data", "model"), rank=rank,
                           shape={"data": 1, "model": 2})


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_rank_caches_are_their_cache_specs_blocks(world, case):
    ranks, ref, p1 = world
    whole = p1[case["name"]]
    for stage in ("prefill_cache", "cache"):
        # the P = 1 port holds the reference's cache
        for k in ("k", "v"):
            np.testing.assert_allclose(whole[stage][k].numpy(),
                                       ref[case["name"]][stage][k],
                                       rtol=RTOL, atol=ATOL)
        tree = {"pos": 0, "kv": whole[stage]}
        for rank, res in enumerate(ranks):
            mesh = _rank_mesh(rank)
            specs = rules.cache_specs(P_CFG, tree, mesh)
            split = specs["kv"]["k"][3] == "model"
            assert split == (case["cache_len"] % 2 == 0)
            block = rules.shard_tree(tree, specs, mesh)
            for k in ("k", "v"):
                got = res[case["name"]][stage][k]
                assert got.shape == tuple(block["kv"][k].shape), (stage, k)
                np.testing.assert_allclose(got, block["kv"][k].numpy(),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{stage} {k} rank {rank}")


def test_init_cache_gives_each_rank_its_block():
    for slots, local in ((24, 12), (21, 21)):
        cache = ptf.init_cache(P_CFG, 2, slots, device="cpu",
                               mesh=_fake_mesh(2))
        assert cache["slots"] == slots and cache["pos"] == 0
        assert cache["kv"]["k"].shape == (N_LAYERS, 2, 2, local, P_CFG.hd)
    assert "slots" not in ptf.init_cache(P_CFG, 2, 24, device="cpu")


# ---------------------------------------------------------------------------
# (d) the refusals
# ---------------------------------------------------------------------------

def _fake_mesh(model: int):
    return SimpleNamespace(model_size=model, model_rank=0,
                           shape={"data": 1, "model": model},
                           axis_names=("data", "model"), rank=0,
                           device=torch.device("cpu"))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m",
                                  "zamba2-1.2b", "phi-3-vision-4.2b",
                                  "whisper-small"])
def test_other_families_refuse_to_serve_under_a_mesh(arch):
    """No family refuses a mesh any more: the moe, ssm, hybrid, vlm and
    audio families serve on one (A12c).  The steps build, and each rank's
    ``init_cache`` is its ``cache_specs`` block of the whole (the audio
    family's cross cache whole on every rank)."""
    cfg = get_smoke_config(arch)
    makers = (lambda: make_prefill_step(cfg, 8, mesh=_fake_mesh(2)),
              lambda: make_serve_step(cfg, 8, mesh=_fake_mesh(2)))
    for make in makers:
        assert callable(make())
    whole = ptf.init_cache(cfg, 2, 8, device="cpu")
    for rank in range(2):
        mesh = _fake_mesh(2)
        mesh.model_rank = mesh.rank = rank
        got = ptf.init_cache(cfg, 2, 8, device="cpu", mesh=mesh)
        block = rules.shard_tree(whole, rules.cache_specs(cfg, whole, mesh),
                                 mesh)
        assert got.get("slots") == (8 if "kv" in whole else None)
        for group in ("kv", "ssm"):
            assert set(got.get(group, {})) == set(block.get(group, {}))
            for k, t in block.get(group, {}).items():
                assert got[group][k].shape == t.shape, (group, k)
                assert not got[group][k].any()
        for k in ("cross_k", "cross_v"):
            assert (k in got) == (k in whole) == (cfg.arch_type == "audio")
            if k in got:
                assert got[k].shape == block[k].shape == whole[k].shape, k
                assert not got[k].any()


def test_model_axis_must_divide_the_kv_heads_to_serve():
    with pytest.raises(ValueError, match="must divide n_kv_heads=2"):
        make_serve_step(P_CFG, 8, mesh=_fake_mesh(4))
    with pytest.raises(ValueError, match="must divide n_kv_heads=2"):
        make_prefill_step(P_CFG, 8, mesh=_fake_mesh(4))
    with pytest.raises(ValueError, match="n_kv_heads"):
        serve_decode.serve({}, P_CFG, torch.zeros((1, 4), dtype=torch.int64),
                           2, mesh=_fake_mesh(4))
