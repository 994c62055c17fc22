"""The port's simulator core held against the JAX reference, in one process:
the rank-exact LGC compressors and error feedback, QSGD, the channel model
and cost model, every scenario's chain carry and dropout, the server
registry, the flat-vector helpers and the numpy data copies.

Selections, masks, integer counts and byte counts are compared bitwise;
floats that go through ``normal`` / ``exp`` at rtol 1e-6.  Magnitudes in
the compressor tests are half-integers, so ties are common and the stable
rank rule is exercised.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channels as jch  # noqa: E402
from repro.core import compressor as jcomp  # noqa: E402
from repro.core import error_feedback as jef  # noqa: E402
from repro.core import scenario as jscn  # noqa: E402
from repro.core import server as jsrv  # noqa: E402
from repro.data import mnist as jmnist  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro_torch.core import channels as pch  # noqa: E402
from repro_torch.core import compressor as pcomp  # noqa: E402
from repro_torch.core import error_feedback as pef  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import scenario as pscn  # noqa: E402
from repro_torch.core import server as psrv  # noqa: E402
from repro_torch.data import mnist as pmnist  # noqa: E402
from repro_torch.data import partition as ppart  # noqa: E402

RTOL = 1e-6
RECEIVED = [list(r) for r in itertools.product([True, False], repeat=3)]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _bitwise(got: torch.Tensor, want, msg="") -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _half_integers(n: int, seed: int) -> np.ndarray:
    """Signed half-integer magnitudes with many ties (and some zeros)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-12, 13, n) + 0.5 * rng.integers(0, 2, n)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# compressors and error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ks", [(97, [5, 10, 20]), (1000, [50, 0, 120]),
                                  (4096, [1, 2, 3])])
def test_lgc_layers_bitwise(n, ks):
    u = _half_integers(n, n)
    want = jcomp.lgc_layers(jnp.asarray(u), ks)
    got = pcomp.lgc_layers(torch.from_numpy(u), ks)
    for g, w in zip(got, want):
        _bitwise(g, w)
    _bitwise(pcomp.top_k(torch.from_numpy(u), sum(ks)),
             jcomp.top_k(jnp.asarray(u), sum(ks)))


@pytest.mark.parametrize("received", RECEIVED)
def test_lgc_compress_and_ef_compress_bitwise(received):
    n, ks = 1000, [40, 60, 100]
    e, delta = _half_integers(n, 1), _half_integers(n, 2) * 0.25
    _bitwise(pcomp.lgc_compress(torch.from_numpy(e + delta), ks, received),
             jcomp.lgc_compress(jnp.asarray(e + delta), ks, received))
    g_j, st_j = jef.ef_compress(jef.EFState(jnp.asarray(e)),
                                jnp.asarray(delta),
                                jcomp.LGCCompressor(ks), received)
    g_p, st_p = pef.ef_compress(pef.EFState(torch.from_numpy(e)),
                                torch.from_numpy(delta),
                                pcomp.LGCCompressor(ks), received)
    _bitwise(g_p, g_j)
    _bitwise(st_p.e, st_j.e)
    u = torch.from_numpy(e) + torch.from_numpy(delta)
    assert torch.equal((g_p + st_p.e).view(torch.int32), u.view(torch.int32))


def test_ef_compress_without_a_mask_and_init_ef():
    e, delta = _half_integers(500, 3), _half_integers(500, 4)
    g_j, st_j = jef.ef_compress(jef.EFState(jnp.asarray(e)),
                                jnp.asarray(delta),
                                jcomp.LGCCompressor([10, 20]))
    g_p, st_p = pef.ef_compress(pef.EFState(torch.from_numpy(e)),
                                torch.from_numpy(delta),
                                pcomp.LGCCompressor([10, 20]))
    _bitwise(g_p, g_j)
    _bitwise(st_p.e, st_j.e)
    _bitwise(pef.init_ef(7).e, jef.init_ef(7).e)


@pytest.mark.parametrize("ks", [[1, 2, 3], [100, 0, 7]])
@pytest.mark.parametrize("value_bytes,index_bytes", [(4, 4), (1, 4), (2, 2)])
def test_wire_bytes_equal(ks, value_bytes, index_bytes):
    assert (pcomp.wire_bytes(ks, value_bytes, index_bytes)
            == jcomp.wire_bytes(ks, value_bytes, index_bytes))


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1])
def test_qsgd_bitwise_given_the_same_key(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(7850) * 1e-3).astype(np.float32)
    x[rng.random(7850) < 0.9] = 0.0                 # a sparse LGC update
    q_j, s_j = jcomp.qsgd_quantize(jnp.asarray(x), jax.random.PRNGKey(seed))
    q_p, s_p = pcomp.qsgd_quantize(torch.from_numpy(x), prng.PRNGKey(seed))
    _bitwise(q_p, q_j)
    _bitwise(s_p, s_j)
    _bitwise(pcomp.qsgd_dequantize(q_p, s_p), jcomp.qsgd_dequantize(q_j, s_j))


def test_flat_helpers_follow_the_reference_leaf_order():
    rng = np.random.default_rng(0)
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, s in
            [("c1", (3, 3, 1, 2)), ("b1", (2,)), ("w2", (4, 3)),
             ("bw2", (3,)), ("w1", (5, 4)), ("b2", (1,))]}
    flat_t = {k: torch.from_numpy(v) for k, v in tree.items()}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    assert pcomp.tree_size(flat_t) == jcomp.tree_size(jt)
    flat = pcomp.flatten_tree(flat_t)
    _bitwise(flat, jcomp.flatten_tree(jt))
    back = pcomp.unflatten_like(flat * 2, flat_t)
    want = jcomp.unflatten_like(jcomp.flatten_tree(jt) * 2, jt)
    for k in tree:
        _bitwise(back[k], want[k], k)


# ---------------------------------------------------------------------------
# channels and costs
# ---------------------------------------------------------------------------

def _close(got: torch.Tensor, want, rtol=RTOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)


def _assert_sample(got, want) -> None:
    _bitwise(got.up, want.up, "up")
    _close(got.energy_j_per_mb, want.energy_j_per_mb)
    _close(got.bandwidth_mb_s, want.bandwidth_mb_s)
    _bitwise(got.money_per_mb, want.money_per_mb, "money")


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_sample_channels_from(seed):
    consts_j, consts_p = jch.stack_specs(), pch.stack_specs()
    for a, b in zip(consts_p, consts_j):
        _bitwise(a, b)
    n_down = 0
    for t in range(40):
        key_j = jscn.stream_key(jax.random.PRNGKey(seed), 1, t, 2)
        key_p = pscn.stream_key(prng.PRNGKey(seed), 1, t, 2)
        s_j = jch.sample_channels_from(key_j, consts_j)
        s_p = pch.sample_channels_from(key_p, consts_p)
        _assert_sample(s_p, s_j)
        n_down += int((~s_p.up).sum())
        nbytes = [t * 1000, 0, 77_777 + t]
        c_j, c_p = jch.comm_cost(s_j, nbytes), pch.comm_cost(s_p, nbytes)
        for k in ("energy_j", "money", "time_s"):
            _close(c_p[k], c_j[k])
    assert n_down > 0                      # some draws drop a channel


def test_comp_cost_and_profiles():
    for prof in (pch.DeviceProfile(),
                 pscn.SCENARIOS["mobile_noniid"].device_profile_at(4)):
        jprof = jch.DeviceProfile(**dataclasses.asdict(prof))
        for h in (1, 4, 8):
            assert pch.comp_cost(prof, h) == pytest.approx(
                jch.comp_cost(jprof, h), rel=RTOL)
    assert [dataclasses.asdict(s) for s in pch.DEFAULT_CHANNELS] == \
        [dataclasses.asdict(s) for s in jch.DEFAULT_CHANNELS]


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def _spec_dict(spec) -> dict:
    return dataclasses.asdict(spec)


def test_every_scenarios_entry_matches_the_reference():
    assert sorted(pscn.SCENARIOS) == sorted(jscn.SCENARIOS)
    for name, scn in pscn.SCENARIOS.items():
        ref = jscn.SCENARIOS[name]
        assert _spec_dict(scn) == _spec_dict(ref), name
        assert (scn.is_static, scn.has_dropout) == (ref.is_static,
                                                    ref.has_dropout)
        for i in range(9):
            assert (dataclasses.asdict(scn.device_profile_at(i))
                    == dataclasses.asdict(ref.device_profile_at(i)))
        ids = np.arange(9, dtype=np.int32)
        _bitwise(scn.drop_probs(torch.from_numpy(ids)),
                 ref.drop_probs(jnp.asarray(ids)))
    assert pscn.get_scenario(None).name == "static"
    with pytest.raises(ValueError):
        pscn.get_scenario("nope")


@pytest.mark.parametrize("name", sorted(jscn.SCENARIOS))
def test_scenario_carry_and_dropout_match(name):
    """init_carry, 5 rounds of step_carry, sample_from_carry and
    dropout_mask for M=4 devices: booleans and the carry bitwise, the
    sample's floats rtol 1e-6.  The carry steps as the reference's engines
    step it, inside ``jax.jit`` (its eager form differs in the last bit:
    XLA:CPU folds the innovation's constants and fuses the AR(1)
    multiply-add only when jitted)."""
    m, n_ch = 4, 3
    scn_p, scn_j = pscn.SCENARIOS[name], jscn.SCENARIOS[name]
    base_p, base_j = prng.PRNGKey(11), jax.random.PRNGKey(11)
    step_j = jax.jit(lambda c, t, i: jscn.step_carry(scn_j, base_j, c, t, i,
                                                     jnp.bool_(True)))
    consts_p, consts_j = pch.stack_specs(), jch.stack_specs()
    carries = [(pscn.init_carry(scn_p, base_p, i, n_ch),
                jscn.init_carry(scn_j, base_j, jnp.int32(i), n_ch))
               for i in range(m)]
    ids = np.arange(m, dtype=np.int32)
    for t in range(5):
        for i, (cp, cj) in enumerate(carries):
            _bitwise(cp.good, cj.good, f"good t={t} m={i}")
            _bitwise(cp.bw_log, cj.bw_log, f"bw_log t={t} m={i}")
            key_p = pscn.stream_key(base_p, pscn.TAG_CHANNEL, t, i)
            key_j = jscn.stream_key(base_j, jscn.TAG_CHANNEL, t, i)
            _assert_sample(pscn.sample_from_carry(scn_p, consts_p, cp, key_p),
                           jscn.sample_from_carry(scn_j, consts_j, cj, key_j))
            carries[i] = (
                pscn.step_carry(scn_p, base_p, cp, t, i, True),
                step_j(cj, jnp.int32(t), jnp.int32(i)))
        _bitwise(pscn.dropout_mask(scn_p, base_p, t, torch.from_numpy(ids)),
                 jscn.dropout_mask(scn_j, base_j, jnp.int32(t),
                                   jnp.asarray(ids)), f"dropout t={t}")
    cp, _ = carries[0]
    same = pscn.step_carry(scn_p, base_p, cp, 9, 0, False)
    assert same is cp


def test_server_registry_matches():
    assert sorted(psrv.AGGREGATORS) == sorted(jsrv.AGGREGATORS)
    for name, spec in psrv.AGGREGATORS.items():
        ref = jsrv.AGGREGATORS[name]
        assert (spec.name, spec.uses_timing, spec.carries_state) == \
            (ref.name, ref.uses_timing, ref.carries_state)
        assert psrv.get_aggregator(name) is spec
    with pytest.raises(ValueError):
        psrv.get_aggregator("nope")


# ---------------------------------------------------------------------------
# data copies
# ---------------------------------------------------------------------------

def _assert_shards(got, want) -> None:
    assert len(got) == len(want)
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)


@pytest.mark.parametrize("seed,n", [(0, 300), (3, 1200), (17, 64)])
def test_data_copies_match_reference(seed, n):
    (xp, yp), (xtp, ytp) = pmnist.load_synthetic_mnist(n_train=n, n_test=50,
                                                       seed=seed)
    (xj, yj), (xtj, ytj) = jmnist.load_synthetic_mnist(n_train=n, n_test=50,
                                                       seed=seed)
    for a, b in ((xp, xj), (yp, yj), (xtp, xtj), (ytp, ytj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for m in (1, 3, 8):
        _assert_shards(pmnist.partition_iid(xp, yp, m, seed),
                       jmnist.partition_iid(xj, yj, m, seed))
        _assert_shards(pmnist.partition_noniid(xp, yp, m, seed=seed),
                       jmnist.partition_noniid(xj, yj, m, seed=seed))
        for alpha in (0.3, 5.0):
            _assert_shards(
                ppart.partition_dirichlet(xp, yp, m, alpha=alpha, seed=seed),
                jpart.partition_dirichlet(xj, yj, m, alpha=alpha, seed=seed))
            _assert_shards(
                ppart.partition_quantity_skew(xp, yp, m, alpha=alpha,
                                              seed=seed),
                jpart.partition_quantity_skew(xj, yj, m, alpha=alpha,
                                              seed=seed))
