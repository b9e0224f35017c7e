"""Port parity of the defense plane (``core/defenses.py``) against the JAX
package's.

Inside the port, host against batched as the reference pins its own planes
(tests/test_defenses.py): trimmed mean, median and the norm clip bit for
bit, Krum's selection index for index, the entry points on MLP-shaped
params within 2e-6 (clip and Krum combine through FedAvg in either
layout). Against the reference: every decision and count exact, payloads
within 1e-6 (bit-equal for the trimmed mean and median host oracles). The
detector, the Eq. 1 penalty and the registry are exact.
"""
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs.base import FeelConfig
from repro_torch.core import defenses as dfs
from repro_torch.core.reputation import ReputationTracker
from repro_torch.kernels.robust_aggregate import robust_aggregate


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(df=reference("core.defenses"),
                                 rep=reference("core.reputation"),
                                 cfg=reference("configs.base"),
                                 jax=jax, jnp=jnp)


def _flat(seed, n, m=257):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, m)).astype(np.float32)


def _pad(flat, n_pad):
    out = np.zeros((n_pad,) + flat.shape[1:], flat.dtype)
    out[:flat.shape[0]] = flat
    return torch.from_numpy(out)


# ---------------------------------------------------------------------- #
# Host against batched inside the port
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n,n_pad", [(5, 8), (9, 16), (16, 16)])
def test_trimmed_mean_host_batched_bitwise(n, n_pad):
    x = _flat(0, n)
    tm = dfs.TrimmedMean(0.2)
    host, hs = tm.aggregate_host(x)
    bat, bs = tm.aggregate_batched(_pad(x, n_pad), n)
    np.testing.assert_array_equal(host, bat.numpy())
    assert hs.n_rejected == bs.n_rejected == 2 * tm.n_trim(n)


@pytest.mark.parametrize("n,n_pad", [(5, 8), (6, 8), (9, 16)])
def test_median_host_batched_bitwise(n, n_pad):
    x = _flat(1, n)
    md = dfs.Median()
    host, _ = md.aggregate_host(x)
    bat, _ = md.aggregate_batched(_pad(x, n_pad), n)
    np.testing.assert_array_equal(host, bat.numpy())
    xs = np.sort(x, axis=0)
    np.testing.assert_array_equal(
        host, (xs[(n - 1) // 2] + xs[n // 2]) * np.float32(0.5))


def test_normclip_host_batched_bitwise_and_stats():
    n, n_pad = 6, 8
    x = _flat(2, n)
    g = _flat(3, 1)[0]
    nc = dfs.NormClip(0.5)
    ch, hs = nc.clip_host(x, g)
    cb, bs = nc.clip_batched(_pad(x, n_pad), torch.from_numpy(g), n)
    np.testing.assert_array_equal(ch, cb.numpy()[:n])
    assert hs.n_clipped == bs.n_clipped > 0


def test_krum_selection_host_batched_equal():
    n, n_pad, f = 10, 16, 3
    x = _flat(4, n)
    x[:f] += 25.0           # the Byzantine rows sit far out
    kr = dfs.Krum(f=f)
    sel_h = kr.select_host(x, n_byz=f)
    sel_b = kr.select_batched(_pad(x, n_pad), n, n_byz=f)
    np.testing.assert_array_equal(sel_h, sel_b)
    assert not set(sel_h) & set(range(f))       # outliers rejected
    assert sel_h.size == n - f                  # multi-Krum default m


def test_krum_degrades_to_fedavg_when_cohort_too_small():
    x = _flat(5, 4)
    np.testing.assert_array_equal(dfs.Krum().select_host(x, n_byz=2),
                                  np.arange(4))
    np.testing.assert_array_equal(
        dfs.Krum().select_batched(_pad(x, 8), 4, n_byz=2), np.arange(4))


def _mlp_rows(n, n_byz, seed=6):
    rng = np.random.default_rng(seed)
    shapes = {"b1": (64,), "b2": (10,), "w1": (784, 64), "w2": (64, 10)}
    template = {k: rng.normal(scale=0.05, size=s).astype(np.float32)
                for k, s in shapes.items()}
    rows = [{k: v + rng.normal(size=v.shape).astype(np.float32)
             * (3.0 if i < n_byz else 0.1) for k, v in template.items()}
            for i in range(n)]
    return template, rows


AGGREGATORS = [dfs.TrimmedMean(0.2), dfs.Median(), dfs.NormClip(1.0),
               dfs.Krum()]


@pytest.mark.parametrize("agg", AGGREGATORS, ids=lambda a: type(a).__name__)
def test_aggregate_host_matches_stacked_on_mlp_params(agg):
    """aggregate_host (compressed list) == aggregate_stacked (padded stack)
    — the layouts the two engines feed them."""
    n, n_pad, n_byz = 6, 8, 2
    template, rows = _mlp_rows(n, n_byz)
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    stacked = {k: torch.cat([torch.from_numpy(np.stack([r[k] for r in rows])),
                             torch.zeros((n_pad - n,) + template[k].shape)])
               for k in template}
    weights = np.zeros(n_pad)
    weights[:n] = (np.random.default_rng(7).integers(1, 31, n) * 50).astype(
        float)
    h, hs = dfs.aggregate_host(agg, [t(r) for r in rows], weights[:n],
                               t(template), n_byz)
    b, bs = dfs.aggregate_stacked(agg, stacked, weights, t(template), n,
                                  n_byz)
    assert sorted(h) == sorted(b) == sorted(template)
    for k in h:
        assert h[k].shape == b[k].shape == template[k].shape
        np.testing.assert_allclose(h[k].numpy(), b[k].numpy(), atol=2e-6)
    assert (hs.n_clipped, hs.n_rejected) == (bs.n_clipped, bs.n_rejected)


# ---------------------------------------------------------------------- #
# The port against the reference, every aggregator
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("agg_name", ["TrimmedMean", "Median", "NormClip",
                                      "Krum"])
@pytest.mark.parametrize("n,n_byz", [(6, 2), (11, 3)])
def test_aggregators_match_reference(ref, agg_name, n, n_byz):
    n_pad = -(-n // 8) * 8
    template, rows = _mlp_rows(n, n_byz, seed=n)
    port = getattr(dfs, agg_name)()
    refa = getattr(ref.df, agg_name)()
    weights = np.zeros(n_pad)
    weights[:n] = np.arange(1, n + 1) * 50.0
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    j = lambda d: {k: ref.jnp.asarray(v) for k, v in d.items()}
    stack = lambda: {k: np.concatenate(
        [np.stack([r[k] for r in rows]),
         np.zeros((n_pad - n,) + template[k].shape, np.float32)])
        for k in template}
    got_h, gs_h = dfs.aggregate_host(port, [t(r) for r in rows], weights[:n],
                                     t(template), n_byz)
    want_h, ws_h = ref.df.aggregate_host(refa, [j(r) for r in rows],
                                         weights[:n], j(template), n_byz)
    got_b, gs_b = dfs.aggregate_stacked(port, t(stack()), weights,
                                        t(template), n, n_byz)
    want_b, ws_b = ref.df.aggregate_stacked(refa, j(stack()), weights,
                                            j(template), n, n_byz)
    for got, want, gs, ws in ((got_h, want_h, gs_h, ws_h),
                              (got_b, want_b, gs_b, ws_b)):
        assert (gs.n_clipped, gs.n_rejected) == (ws.n_clipped, ws.n_rejected)
        for k in template:
            w = np.asarray(want[k])
            if agg_name in ("TrimmedMean", "Median") and got is got_h:
                np.testing.assert_array_equal(got[k].numpy(), w)
            else:
                np.testing.assert_allclose(got[k].numpy(), w, atol=1e-6,
                                           rtol=1e-6)


def test_krum_and_clip_decisions_match_reference(ref):
    rng = np.random.default_rng(9)
    for n, f in ((10, 3), (16, 4), (7, 1)):
        x = rng.normal(scale=0.1, size=(n, 96)).astype(np.float32)
        x[:f] += 50.0
        for kr, kr_r in ((dfs.Krum(f=f), ref.df.Krum(f=f)),
                         (dfs.Krum(n_select=1), ref.df.Krum(n_select=1))):
            want = kr_r.select_host(x, n_byz=f)
            np.testing.assert_array_equal(kr.select_host(x, n_byz=f), want)
            np.testing.assert_array_equal(
                kr.select_batched(_pad(x, -(-n // 8) * 8), n, n_byz=f), want)
        g = rng.normal(size=96).astype(np.float32)
        for tau in (0.3, 1.0, 5.0):
            np.testing.assert_array_equal(
                dfs.NormClip(tau).scales_host(x, g),
                ref.df.NormClip(tau).scales_host(x, g))


def test_flatten_and_unflatten_round_trip(ref):
    template, rows = _mlp_rows(3, 0)
    t = {k: torch.from_numpy(v) for k, v in template.items()}
    flat = dfs.flatten_params_np(t)
    np.testing.assert_array_equal(flat, ref.df.flatten_params_np(
        {k: ref.jnp.asarray(v) for k, v in template.items()}))
    back = dfs.unflatten_vec(t, flat)
    for k in t:
        assert torch.equal(back[k], t[k])
    st = {k: torch.from_numpy(np.stack([r[k] for r in rows])) for k in t}
    from repro_torch.federated.aggregation import flatten_stacked
    again = dfs.unflatten_stacked(st, flatten_stacked(st))
    for k in st:
        assert torch.equal(again[k], st[k])


# ---------------------------------------------------------------------- #
# Detector, Eq. 1 penalty, registry
# ---------------------------------------------------------------------- #
def test_detector_anomaly_and_stats(ref):
    det = dfs.ValidationDetector(tol=0.1, weight=5.0)
    acc_val = np.array([[0.9, 0.4, 0.85, 0.2],     # uploads
                        [0.8, 0.8, 0.80, 0.8]])    # global baseline
    a = det.anomaly(acc_val)
    np.testing.assert_allclose(a, [0.0, 0.3, 0.0, 0.5], atol=1e-12)
    np.testing.assert_array_equal(
        a, ref.df.ValidationDetector(tol=0.1, weight=5.0).anomaly(acc_val))
    np.testing.assert_array_equal(det.penalties(acc_val), 5.0 * a)
    truth = [False, True, False, False]
    assert dfs.detection_stats(a > 0, truth) == (0.5, 1.0)
    assert dfs.detection_stats(a > 0, truth) == ref.df.detection_stats(
        a > 0, truth)
    prec, rec = dfs.detection_stats([False] * 4, [False] * 4)
    assert np.isnan(prec) and np.isnan(rec)
    with pytest.raises(ValueError):
        dfs.ValidationDetector(n_val=0)


def test_reputation_penalty_matches_reference_tracker(ref):
    cfg = FeelConfig(n_ues=8, n_malicious=2, min_selected=3)
    rcfg = ref.cfg.FeelConfig(n_ues=8, n_malicious=2, min_selected=3)
    rng = np.random.default_rng(0)
    for penalty in (rng.uniform(0, 0.5, 4), None, np.zeros(4),
                    np.full(4, 3.0)):
        reps = rng.uniform(0.2, 1.0, 8)
        sel = np.sort(rng.choice(8, 4, replace=False))
        al, at = rng.uniform(0, 1, 4), rng.uniform(0, 1, 4)
        a, b = ReputationTracker(cfg), ref.rep.ReputationTracker(rcfg)
        a.values, b.values = reps.copy(), reps.copy()
        a.update(sel, al, at, penalty=penalty)
        b.update(sel, al, at, penalty=penalty)
        np.testing.assert_array_equal(a.values, b.values)


def test_registry_names_and_coercion(ref):
    assert sorted(dfs.DEFENSES) == sorted(ref.df.DEFENSES)
    assert len(dfs.DEFENSES) == 7
    for name, d in dfs.DEFENSES.items():
        r = ref.df.DEFENSES[name]
        assert d.name == name and d.benign == r.benign
        assert repr(d.aggregator) == repr(r.aggregator)
        assert repr(d.detector) == repr(r.detector)
        hash(d)
    assert dfs.as_defense(None) is dfs.NO_DEFENSE
    assert dfs.as_defense("median").aggregator == dfs.Median()
    d = dfs.with_validation(dfs.trimmed_mean(0.2))
    assert d.name == "trimmed_mean+validation" and d.detector is not None
    assert dfs.trimmed_mean(0.1).name == ref.df.trimmed_mean(0.1).name
    assert dfs.norm_clip(2.5).name == ref.df.norm_clip(2.5).name
    with pytest.raises(KeyError):
        dfs.as_defense("nope")
    with pytest.raises(TypeError):
        dfs.as_defense(3.14)
    with pytest.raises(ValueError):
        dfs.register(dfs.median())                 # duplicate name
    with pytest.raises(ValueError):
        dfs.TrimmedMean(0.5)
    with pytest.raises(ValueError):
        dfs.NormClip(0.0)


@pytest.mark.parametrize("trim", [0.05, 0.2, 0.45])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 24, 100])
def test_n_trim_matches_reference(ref, trim, n):
    assert dfs.TrimmedMean(trim).n_trim(n) == ref.df.TrimmedMean(trim).n_trim(
        n)


def test_batched_robust_aggregators_go_through_the_wrapper(monkeypatch):
    """The batched trimmed mean and median call ``robust_aggregate`` with
    the defense's rank window (the port has no jnp-path switch)."""
    calls = []

    def spy(flat, n, trim=0, mode="trimmed_mean"):
        calls.append((tuple(flat.shape), n, trim, mode))
        return robust_aggregate(flat, n, trim=trim, mode=mode)

    monkeypatch.setattr(dfs, "robust_aggregate", spy)
    x = _pad(_flat(8, 11), 16)
    dfs.TrimmedMean(0.2).aggregate_batched(x, 11)
    dfs.Median().aggregate_batched(x, 11)
    assert calls == [((16, 257), 11, 2, "trimmed_mean"),
                     ((16, 257), 11, 0, "median")]


@pytest.mark.parametrize("defense", ["trimmed_mean", "median"])
@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_both_engines_aggregate_through_the_wrapper(monkeypatch, engine,
                                                    defense):
    """Each engine's robust aggregation runs on the server's device through
    ``robust_aggregate``, once a round — the loop engine stacks its uploads
    first — so neither moves it to the host."""
    from repro_torch.core.poisoning import pick_malicious
    from repro_torch.data.partition import partition
    from repro_torch.data.synthetic_mnist import generate
    from repro_torch.federated.server import FeelServer
    calls = []

    def spy(flat, n, trim=0, mode="trimmed_mean"):
        calls.append((flat.device.type, flat.shape[0], n, mode))
        return robust_aggregate(flat, n, trim=trim, mode=mode)

    monkeypatch.setattr(dfs, "robust_aggregate", spy)
    monkeypatch.setattr(dfs.TrimmedMean, "aggregate_host", None)
    monkeypatch.setattr(dfs.Median, "aggregate_host", None)
    cfg = FeelConfig(n_ues=8, n_malicious=2, min_selected=3)
    train, test = generate(800, 200, seed=2)
    rng = np.random.default_rng(2)
    clients = partition(train, cfg.n_ues, rng,
                        pick_malicious(cfg.n_ues, cfg.n_malicious, rng))
    srv = FeelServer(cfg, clients, test, rng, engine=engine, defense=defense,
                     device="cpu")
    logs = srv.run(2)
    assert len(calls) == 2
    for (dev, rows, n, mode), log in zip(calls, logs):
        assert dev == "cpu" and mode == defense and n == log.selected.size
        assert rows == (n if engine == "loop" else -(-n // 8) * 8)


# ---------------------------------------------------------------------- #
# registry completeness (auto-generated from DEFENSES — a new entry is
# exercised here with zero test edits; repro_torch.check pins the
# coverage): the reference's test_defense_registry_contract on the port
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(dfs.DEFENSES))
def test_defense_registry_contract(name, ref):
    """Every registered defense satisfies the DefensePolicy interface:
    registry key == name, frozen/hashable, and its components expose the
    host-oracle entry points both engines dispatch on — with the
    reference's aggregate, stats and detector scores on the same
    uploads."""
    d = dfs.DEFENSES[name]
    r = ref.df.DEFENSES[name]
    assert d.name == name
    hash(d)                                     # frozen dataclass
    assert d.benign == (d.aggregator is None and d.detector is None)
    agg = d.aggregator
    if agg is not None:
        # every aggregator family exposes a host oracle + batched twin
        assert (hasattr(agg, "aggregate_host")
                and hasattr(agg, "aggregate_batched")) \
            or (hasattr(agg, "clip_host") and hasattr(agg, "clip_batched")) \
            or (hasattr(agg, "select_host")
                and hasattr(agg, "select_batched"))
        # ... and dispatches through the shared loop-engine entry point
        rng = np.random.default_rng(0)
        plist = [{"w": rng.normal(size=10).astype(np.float32)}
                 for _ in range(6)]
        out, stats = dfs.aggregate_host(
            agg, [{"w": torch.from_numpy(p["w"])} for p in plist],
            np.ones(6, np.float32), {"w": torch.from_numpy(plist[0]["w"])},
            n_byz=1)
        want, want_stats = ref.df.aggregate_host(
            r.aggregator, plist, np.ones(6, np.float32), plist[0], n_byz=1)
        assert out["w"].shape == (10,)
        assert isinstance(stats, dfs.DefenseStats)
        np.testing.assert_allclose(out["w"].numpy(), np.asarray(want["w"]),
                                   rtol=1e-6, atol=1e-7)
        assert (stats.n_rejected, stats.n_clipped) == (
            want_stats.n_rejected, want_stats.n_clipped)
    if d.detector is not None:
        # (2, n): row 0 per-upload val accuracy, row 1 global baseline
        acc = np.array([[0.9, 0.2, 0.5], [0.6, 0.6, 0.6]], np.float64)
        a = d.detector.anomaly(acc)
        assert a.shape == (3,) and (a >= 0).all()
        np.testing.assert_array_equal(a, r.detector.anomaly(acc))
        assert d.detector.penalties(acc).shape == (3,)
