"""Port parity of the threat-model plane (``core/attacks.py``,
``core/poisoning.ModelPoisonAttack``) against the JAX package's.

Data attacks are host numpy on both sides: byte-identical output and the
same RNG draws. ``ModelAttack.apply_stacked`` equals ``apply_loop`` bit for
bit inside the port (elementwise float32 ops in the same order) and is held
within 1e-6 of the reference's (XLA may fuse the update into an FMA).
Report attacks, the registry and the metric helpers are exact.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs.base import FeelConfig
from repro_torch.core import attacks as atk
from repro_torch.core.poisoning import ModelPoisonAttack, pick_malicious
from repro_torch.data.partition import partition
from repro_torch.data.synthetic_mnist import generate
from repro_torch.federated.server import FeelServer
from repro_torch.federated.simulation import run_experiment

KW = dict(n_train=1200, n_test=300, rounds=2, device="cpu")


def _cfg():
    return FeelConfig(n_ues=8, n_malicious=2, min_selected=3)


@pytest.fixture(scope="module")
def ref():
    return types.SimpleNamespace(at=reference("core.attacks"),
                                 po=reference("core.poisoning"),
                                 sm=reference("data.synthetic_mnist"))


# ---------------------------------------------------------------------- #
# Data attacks: byte-identical output, the same draws
# ---------------------------------------------------------------------- #
def _xy(seed, n=400):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 12)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _same_poison(port, refa, x, y, seed):
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    x1, y1 = port.poison(x, y, r1)
    x2, y2 = refa.poison(x, y, r2)
    assert x1.dtype == x2.dtype and y1.dtype == y2.dtype
    assert x1.tobytes() == x2.tobytes() and y1.tobytes() == y2.tobytes()
    assert r1.bit_generator.state == r2.bit_generator.state
    return x1, y1


@pytest.mark.parametrize("pairs,frac", [(((6, 2),), 1.0), (((8, 4),), 0.5),
                                        (((6, 2), (8, 4)), 1.0),
                                        (((6, 2), (2, 8)), 0.3)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_label_flip_same_bytes_and_draws(ref, pairs, frac, seed):
    x, y = _xy(seed)
    x1, y1 = _same_poison(atk.LabelFlip(pairs, frac),
                          ref.at.LabelFlip(pairs, frac), x, y, seed + 10)
    changed = np.flatnonzero(y1 != y)
    sources = [s for s, _ in pairs]
    assert np.isin(y[changed], sources).all()    # only source rows
    np.testing.assert_array_equal(x1, x)          # labels only


@pytest.mark.parametrize("sigma", [0.3, 0.8, 2.0])
def test_feature_noise_same_bytes_and_draws(ref, sigma):
    x, y = _xy(3)
    x1, y1 = _same_poison(atk.FeatureNoise(sigma),
                          ref.at.FeatureNoise(sigma), x, y, 7)
    np.testing.assert_array_equal(y1, y)
    assert (x1 >= 0).all() and (x1 <= 1).all() and np.any(x1 != x)


def _padded_rows(seed, k=4):
    """The stacked padded layout of k clients of the partition (data
    pre-poison), as tests/test_attacks.py builds it."""
    from repro_torch.data.partition import pad_clients
    rng = np.random.default_rng(seed)
    train, _ = generate(800, 50, seed=seed % 7)
    clients = partition(train, k, rng)
    return clients, pad_clients(clients, multiple_of=50), rng


@pytest.mark.parametrize("pairs,frac", [(((6, 2), (8, 4)), 1.0),
                                        (((6, 2), (8, 4)), 0.3),
                                        (((6, 2), (2, 8)), 0.7)])
@pytest.mark.parametrize("seed", [0, 5])
def test_label_flip_apply_rows_equals_host_and_reference(ref, pairs, frac,
                                                         seed):
    """The stacked twin on the padded (K, S) layout equals the per-client
    host oracle given the same float32 draws, and the reference's twin,
    exactly; honest rows and padding untouched."""
    clients, padded, rng = _padded_rows(seed)
    mal = np.array([True, False, True, False])
    attack = atk.LabelFlip(pairs, frac)
    u = np.zeros(padded.y.shape, np.float32)
    want = padded.y.copy()
    for i, c in enumerate(clients):
        ui = attack.draw(rng, c.data.x, c.data.y)
        if ui is not None:
            u[i, :c.size] = ui
        if mal[i]:
            want[i, :c.size] = attack.apply_host(c.data.x, c.data.y, ui)[1]
    uu = None if frac >= 1.0 else u
    x, got = attack.apply_rows(torch.from_numpy(padded.x),
                               torch.from_numpy(padded.y),
                               torch.from_numpy(padded.mask),
                               torch.from_numpy(mal),
                               None if uu is None else torch.from_numpy(uu))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(x.numpy(), padded.x)
    _, want_r = ref.at.LabelFlip(pairs, frac).apply_rows(
        padded.x, padded.y, padded.mask, mal, uu)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("sigma", [0.3, 0.8, 2.0])
def test_feature_noise_apply_rows_equals_host_and_reference(ref, sigma):
    """Noise lands only on malicious rows' real samples, equal to the host
    oracle there and to the reference's twin everywhere, bit for bit."""
    clients, padded, _ = _padded_rows(3)
    mal = np.array([True, False, False, True])
    attack = atk.FeatureNoise(sigma)
    eps = attack.draw(np.random.default_rng(11), padded.x, None)
    got_x, got_y = attack.apply_rows(
        torch.from_numpy(padded.x), torch.from_numpy(padded.y),
        torch.from_numpy(padded.mask), torch.from_numpy(mal),
        torch.from_numpy(eps))
    got_x = got_x.numpy()
    for i, c in enumerate(clients):
        want = (attack.apply_host(c.data.x, c.data.y, eps[i, :c.size])[0]
                if mal[i] else c.data.x)
        np.testing.assert_array_equal(got_x[i, :c.size], want)
        np.testing.assert_array_equal(got_x[i, c.size:], 0.0)
    np.testing.assert_array_equal(got_y.numpy(), padded.y)
    want_r, _ = ref.at.FeatureNoise(sigma).apply_rows(
        padded.x, padded.y, padded.mask, mal, eps)
    np.testing.assert_array_equal(got_x, np.asarray(want_r))


@pytest.mark.parametrize("make", ["flip", "flip_frac", "noise"])
def test_token_attacks_same_bytes_and_draws(ref, make):
    tokens = np.random.default_rng(5).integers(0, 64, (30, 16)).astype(
        np.int32)
    port, refa = {
        "flip": (atk.TokenFlip(((1, 5),)), ref.at.TokenFlip(((1, 5),))),
        "flip_frac": (atk.TokenFlip(((1, 5), (5, 9)), 0.4),
                      ref.at.TokenFlip(((1, 5), (5, 9)), 0.4)),
        "noise": (atk.TokenNoise(0.3), ref.at.TokenNoise(0.3)),
    }[make]
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    a, b = port.poison_tokens(tokens, r1), refa.poison_tokens(tokens, r2)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert r1.bit_generator.state == r2.bit_generator.state


class _Tokens:
    """A minimal token dataset: windows + their domain ids."""

    def __init__(self, tokens, y):
        self.tokens, self.y = tokens, y


def test_poison_dataset_dispatch_and_mismatch(ref):
    train, _ = generate(300, 10, seed=0)
    train_r, _ = ref.sm.generate(300, 10, seed=0)
    got = atk.poison_dataset(atk.FeatureNoise(0.5), train,
                             np.random.default_rng(1))
    want = ref.at.poison_dataset(ref.at.FeatureNoise(0.5), train_r,
                                 np.random.default_rng(1))
    assert got.x.tobytes() == want.x.tobytes()
    assert got.y.tobytes() == want.y.tobytes()
    toks = _Tokens(np.arange(40).reshape(4, 10) % 7, np.arange(4))
    out = atk.poison_dataset(atk.TokenFlip(((1, 5),)), toks,
                             np.random.default_rng(0))
    assert isinstance(out, _Tokens) and not (out.tokens == 1).any()
    with pytest.raises(TypeError, match=r"\[task=mnist_mlp, scenario=x\]"):
        atk.poison_dataset(atk.TokenNoise(), train, np.random.default_rng(0),
                           context="task=mnist_mlp, scenario=x")
    with pytest.raises(TypeError, match="feature dataset"):
        atk.poison_dataset(atk.FeatureNoise(), toks,
                           np.random.default_rng(0))


def test_data_attack_arguments_checked():
    with pytest.raises(ValueError):
        atk.LabelFlip(((6, 2), (6, 3)))
    with pytest.raises(ValueError):
        atk.LabelFlip(((6, 2),), flip_fraction=0.0)
    with pytest.raises(ValueError):
        atk.TokenFlip(((1, 5),), flip_fraction=1.5)


# ---------------------------------------------------------------------- #
# Model and report attacks
# ---------------------------------------------------------------------- #
def _stack(seed, n):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (784, 64), "b1": (64,), "w2": (64, 10), "b2": (10,)}
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    st = {k: rng.normal(size=(n,) + s).astype(np.float32)
          for k, s in shapes.items()}
    ref_p = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
    return g, st, ref_p


@pytest.mark.parametrize("scale", [-1.0, 0.0, 3.0])
@pytest.mark.parametrize("with_ref", [False, True])
def test_apply_stacked_matches_loop_and_reference(ref, scale, with_ref):
    import jax.numpy as jnp
    g, st, rp = _stack(int(scale) + 5, 6)
    mal = np.array([True, False, True, True, False, False])
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    r_t = t(rp) if with_ref else None
    attack = atk.ModelAttack(scale=scale)
    got = attack.apply_stacked(t(st), t(g), mal, r_t)
    for i in range(6):
        row = {k: v[i] for k, v in t(st).items()}
        want = attack.apply_loop(t(g), row, r_t) if mal[i] else row
        for k in got:
            assert torch.equal(got[k][i], want[k]), (k, i)
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    want = ref.at.ModelAttack(scale=scale).apply_stacked(
        j(st), j(g), mal, j(rp) if with_ref else None)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6)


def test_model_poison_attack_matches_reference(ref):
    import jax.numpy as jnp
    g, st, _ = _stack(1, 1)
    local = {k: v[0] for k, v in st.items()}
    got = ModelPoisonAttack(-1.0).apply(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in local.items()})
    want = ref.po.ModelPoisonAttack(-1.0).apply(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in local.items()})
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6)


def test_report_attack_exact(ref):
    acc = np.random.default_rng(0).uniform(0, 1, 9)
    mal = np.arange(9) % 3 == 0
    for boost in (0.3, 0.9):
        np.testing.assert_array_equal(
            atk.ReportAttack(boost).apply(acc, mal),
            ref.at.ReportAttack(boost).apply(acc, mal))


def test_server_masked_apply_matches_loop_oracle_end_to_end():
    """A vectorized run with the masked ``_apply_attacks`` equals the same
    run routed through ``_apply_attacks_loop`` — bit for bit params."""
    cfg = _cfg()
    train, test = generate(1200, 300, seed=3)

    def build():
        rng = np.random.default_rng(3)
        malicious = pick_malicious(cfg.n_ues, cfg.n_malicious, rng)
        clients = partition(train, cfg.n_ues, rng, malicious)
        return FeelServer(cfg, clients, test, rng, device="cpu",
                          scenario=atk.model_poison(-1.0))

    a, b = build(), build()
    b._apply_attacks = b._apply_attacks_loop
    for t in range(2):
        a.run_round(t)
        b.run_round(t)
        assert a.logs[-1].n_malicious_selected > 0
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), k


def test_legacy_model_poison_knob_equals_scenario():
    """The server's ``model_poison=`` knob is the scenario's model attack."""
    cfg = _cfg()
    train, test = generate(1200, 300, seed=4)

    def build(**kw):
        rng = np.random.default_rng(4)
        malicious = pick_malicious(cfg.n_ues, cfg.n_malicious, rng)
        clients = partition(train, cfg.n_ues, rng, malicious)
        return FeelServer(cfg, clients, test, rng, device="cpu", **kw)

    a = build(model_poison=ModelPoisonAttack(3.0), lie_boost=0.2)
    b = build(scenario=atk.AttackScenario(
        "explicit", model=atk.ModelAttack(3.0), report=atk.ReportAttack(0.2)))
    assert a.scenario.model == b.scenario.model
    assert a.scenario.report == b.scenario.report
    # the knobs go through the one legacy normaliser, with no pair: no data
    # attack (the partition bakes it in) and nothing watched
    assert a.scenario == atk.legacy_scenario(None, model_poison_scale=3.0,
                                             lie_boost_val=0.2)
    assert a.scenario.data is None and a.scenario.watch is None
    a.run(2)
    b.run(2)
    for la, lb in zip(a.logs, b.logs):
        np.testing.assert_array_equal(la.selected, lb.selected)
        np.testing.assert_array_equal(la.reputations, lb.reputations)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


# ---------------------------------------------------------------------- #
# The legacy-knob contract (as tests/test_attacks.py holds the
# reference's)
# ---------------------------------------------------------------------- #
def test_legacy_scenario_matches_reference(ref):
    for args in [((6, 2), False, -1.0, 0.0), ((6, 2), False, None, 0.0),
                 ((8, 4), True, -1.0, 0.5), ((8, 4), False, None, 0.3),
                 ((6, 2), False, 3.0, 0.2)]:
        a, b = atk.legacy_scenario(*args), ref.at.legacy_scenario(*args)
        assert a.name == b.name and a.watch == b.watch
        assert a.benign == b.benign and str(a.data_key()) == str(
            b.data_key())
        assert (a.model and (a.model.scale, a.model.staleness)) == (
            b.model and (b.model.scale, b.model.staleness))
        assert (a.report and a.report.boost) == (b.report and b.report.boost)
    scn = atk.legacy_scenario((6, 2), False, -1.0, 0.0)
    assert scn.data is None and scn.model.scale == -1.0
    assert scn.data_key() == "mal_only"
    flip = atk.legacy_scenario((6, 2), False, None, 0.0)
    assert isinstance(flip.data, atk.LabelFlip) and flip.model is None


def test_legacy_no_attack_wins_over_model_poison():
    r = run_experiment("dqs", (6, 2), cfg=_cfg(), seed=1, no_attack=True,
                       model_poison_scale=-1.0, **KW)
    clean = run_experiment("dqs", (6, 2), cfg=_cfg(), seed=1,
                           no_attack=True, **KW)
    assert r["malicious_selected"] == [0] * KW["rounds"]
    np.testing.assert_allclose(r["acc"], clean["acc"], atol=1e-7)
    assert all(np.isnan(g) for g in r["rep_gap"])


def test_legacy_model_poison_branch_equals_explicit_scenario():
    legacy = run_experiment("dqs", (8, 4), cfg=_cfg(), seed=0,
                            model_poison_scale=-1.0, **KW)
    scn = dataclasses.replace(atk.model_poison(-1.0), watch=(8, 4))
    explicit = run_experiment("dqs", cfg=_cfg(), seed=0, scenario=scn, **KW)
    np.testing.assert_allclose(legacy["acc"], explicit["acc"], atol=1e-7)
    np.testing.assert_allclose(legacy["source_acc"],
                               explicit["source_acc"], atol=1e-6)


def test_scenario_supersedes_legacy_knobs():
    for kw in (dict(model_poison_scale=-1.0), dict(no_attack=True),
               dict(attack_pair=(8, 4)), dict(lie_boost=0.3)):
        with pytest.raises(ValueError):
            run_experiment(policy="dqs", cfg=_cfg(), seed=0,
                           scenario="sign_flip", **kw, **KW)
    train, test = generate(800, 150, seed=0)
    rng = np.random.default_rng(0)
    clients = partition(train, 4, rng)
    with pytest.raises(ValueError):
        FeelServer(FeelConfig(n_ues=4, n_malicious=0), clients, test, rng,
                   scenario="sign_flip", watch_class=3, device="cpu")


# ---------------------------------------------------------------------- #
# Registry, shim and metric helpers
# ---------------------------------------------------------------------- #
def test_registry_names_and_components_match_reference(ref):
    assert sorted(atk.SCENARIOS) == sorted(ref.at.SCENARIOS)
    assert len(atk.SCENARIOS) == 15
    for name, scn in atk.SCENARIOS.items():
        r = ref.at.SCENARIOS[name]
        assert scn.name == name and scn.watch == r.watch
        assert scn.benign == r.benign
        assert repr(scn.data) == repr(r.data)
        assert repr(scn.model) == repr(r.model)
        assert repr(scn.report) == repr(r.report)
        assert (scn.schedule.kind, scn.schedule.period,
                scn.schedule.duty) == (r.schedule.kind, r.schedule.period,
                                       r.schedule.duty)
        hash(scn)
        hash(scn.data_key())


def test_registry_and_shim():
    assert atk.as_scenario("sign_flip") is atk.SCENARIOS["sign_flip"]
    pair = atk.as_scenario((6, 2))
    assert pair.data.pairs == ((6, 2),) and pair.watch == (6, 2)
    assert atk.as_scenario(pair) is pair
    with pytest.raises(ValueError):
        atk.register(atk.model_poison(-1.0))          # duplicate name
    with pytest.raises(TypeError):
        atk.as_scenario(12)
    with pytest.raises(KeyError):
        atk.as_scenario("no_such_scenario")
    scn = atk.intermittent(atk.label_flip(6, 2), 2)
    assert scn.data is not None and scn.schedule.period == 2


def test_scenario_constructors_match_reference(ref):
    for make in (lambda m: m.label_flip(3, 7, 0.25),
                 lambda m: m.multi_flip(((1, 2), (3, 4)), 0.5),
                 lambda m: m.feature_noise(1.5),
                 lambda m: m.token_flip(2, 9, 0.5),
                 lambda m: m.token_noise(0.1, 32),
                 lambda m: m.free_rider(3),
                 lambda m: m.model_poison(-2.0),
                 lambda m: m.lie_boost(0.4),
                 lambda m: m.colluding(m.model_poison(3.0), 3),
                 lambda m: m.intermittent(m.feature_noise(), 3, 2)):
        a, b = make(atk), make(ref.at)
        assert a.name == b.name and a.watch == b.watch
        assert repr(a.data) == repr(b.data)
        assert repr(a.model) == repr(b.model)
        assert repr(a.schedule) == repr(b.schedule)


@pytest.mark.parametrize("curve,threshold", [
    ([np.nan, np.nan], 0.5), ([], 0.5), ([0.9, 0.8, 0.4, 0.2], 0.5),
    ([0.9, 0.2, 0.6, 0.1], 0.5), ([0.1, 0.2, 0.3], 0.5),
    ([0.2, 0.9], 0.95), ([0.9, 0.9, 0.9], 0.5), ([0.1, 0.1, 0.9], 0.5),
    ([np.nan, 0.7, 0.1], 0.5)])
def test_recovery_rounds_matches_reference(ref, curve, threshold):
    got = atk.recovery_rounds(curve, threshold)
    assert got == ref.at.recovery_rounds(curve, threshold)
    assert isinstance(got, int)


def test_reputation_gap_matches_reference(ref):
    rng = np.random.default_rng(0)
    rep = rng.uniform(0, 1, 12)
    for mal in (rng.uniform(size=12) < 0.3, np.zeros(12, bool),
                np.ones(12, bool)):
        a, b = atk.reputation_gap(rep, mal), ref.at.reputation_gap(rep, mal)
        assert (np.isnan(a) and np.isnan(b)) or a == b
