"""The port's certified unlearning algorithms, privacy mechanisms and the
descent-to-delete fine-tuner, against the JAX package on the CPU at the
reference's `tests/test_algorithms.py` sizes (n 600, d 8, T 30, B 200).

Tolerances: certificates (mechanism, eps, delta, bound, noise_scale,
removals) within 1e-12 relative of the reference's after the same
requests; the calibration (`delta0`, `gaussian_sigma`) likewise;
`empirical_epsilon` within 1e-6 relative (an f32 sum of |w_I - w_U|);
counters exactly; every algorithm within 1e-6 of the reference's
parameters after a mixed delete/add plan; retrain_oracle bitwise the
port's own BaseL.  The noise cannot reproduce
``jax.random``: it is held to its shape, dtype and determinism under one
generator state, and to its moments (std within 2 % of the mechanism's
over 200,000 draws, about four standard errors).
"""

import dataclasses
import math
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as jalg
from repro.core import privacy as jpriv
from repro.core.deltagrad import DeltaGradConfig as JDGConfig
from repro.core.session import UnlearnerConfig as JConfig
from repro.core.session import UnlearnerSession as JSession
from repro.data.synthetic import binary_classification as j_binary
from repro.models.simple import logreg_objective as j_logreg
from repro.optim.optimizers import sgd as j_sgd
from repro.train.loop import make_finetune_runner as j_runner

from repro_torch.core import algorithms as talg
from repro_torch.core import privacy as tpriv
from repro_torch.core.deltagrad import DeltaGradConfig
from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
from repro_torch.data.synthetic import binary_classification as t_binary
from repro_torch.models.simple import (logreg_objective, params_from_jax,
                                       params_to_numpy)
from repro_torch.optim.optimizers import sgd
from repro_torch.train.loop import make_finetune_runner

# the objective's own l2 (5e-3) is too weak for delta0 at these removal
# counts (the designed ValueError): the reference tests' strong constants
PRIVACY = dict(eps=1.0, delta=1e-5, mu=0.5, L=1.0, c0=0.1, c2=0.1)
COUNTERS = ("explicit_steps", "approx_steps", "guard_fallbacks",
            "skipped_steps", "grad_examples", "grad_examples_baseline")
CERT = ("eps", "delta", "bound", "noise_scale")


def _flat(params):
    return np.concatenate([np.asarray(params[k], np.float32).reshape(-1)
                           for k in sorted(params)])


def _port_flat(params):
    return params.flat.detach().cpu().numpy()


def _p0(d, seed=1):
    rng = np.random.default_rng(seed)
    return {"w": (0.01 * rng.normal(size=d)).astype(np.float32),
            "b": np.zeros((), np.float32)}


def make_pair(algorithm="deltagrad", n=600, d=8, steps=30, batch=200,
              seed=0, finetune_steps=4, d2d_lr=None):
    """The same session in both packages: (jax session, port session)."""
    kw = dict(steps=steps, batch_size=batch, lr=0.4, seed=seed,
              algorithm=algorithm)
    j = JSession(j_logreg(5e-3), {k: jnp.asarray(v) for k, v in _p0(d).items()},
                 j_binary(n=n, d=d, seed=seed),
                 JConfig(deltagrad=JDGConfig(period=5, burn_in=8,
                                             history_size=2),
                         privacy=jpriv.PrivacyConfig(**PRIVACY),
                         descent=jalg.DescentToDeleteConfig(
                             finetune_steps=finetune_steps, lr=d2d_lr),
                         **kw))
    t = UnlearnerSession(
        logreg_objective(5e-3), params_from_jax(_p0(d), "cpu"),
        t_binary(n=n, d=d, seed=seed),
        UnlearnerConfig(deltagrad=DeltaGradConfig(period=5, burn_in=8,
                                                  history_size=2),
                        privacy=tpriv.PrivacyConfig(**PRIVACY),
                        descent=talg.DescentToDeleteConfig(
                            finetune_steps=finetune_steps, lr=d2d_lr),
                        **kw),
        device="cpu")
    j.fit()
    t.fit()
    return j, t


def make_session(algorithm="deltagrad", **kw):
    return make_pair(algorithm, **kw)[1]


def assert_cert_equal(ct, cj):
    assert (ct.algorithm, ct.mechanism, ct.removals) == \
        (cj.algorithm, cj.mechanism, cj.removals)
    for f in CERT:
        a, b = getattr(ct, f), getattr(cj, f)
        assert a == pytest.approx(b, rel=1e-12, abs=0.0), (f, a, b)


# -- registry --------------------------------------------------------------


def test_registry_lists_the_references_builtins():
    names = talg.available_algorithms()
    assert names == jalg.available_algorithms()
    assert {"deltagrad", "descent_to_delete", "retrain_oracle"} <= set(names)
    for name in names:
        assert talg.get_algorithm(name).name == name


def test_registry_unknown_name_raises_with_choices():
    with pytest.raises(ValueError, match="deltagrad"):
        talg.get_algorithm("no_such_algorithm")


def test_session_rejects_unknown_algorithm_lazily():
    sess = make_session()
    sess.config = dataclasses.replace(sess.config, algorithm="bogus")
    sess._algorithm = None
    with pytest.raises(ValueError, match="bogus"):
        sess.delete([3]).result()


# -- one serving surface for every algorithm, against the reference --------


def _mixed_stream(sess, ds):
    h1 = sess.delete([3, 5, 7])
    h2 = sess.add(data={k: np.asarray(v[:2]) for k, v in ds.columns.items()})
    h3 = sess.delete([11])
    w = h3.params  # forcing one handle flushes the whole plan
    return [h1, h2, h3], w


@pytest.mark.parametrize("algorithm", sorted(talg.ALGORITHMS))
def test_every_algorithm_serves_delete_and_add_like_the_reference(algorithm):
    j, t = make_pair(algorithm)
    hj, wj = _mixed_stream(j, j.dataset)
    ht, wt = _mixed_stream(t, t.dataset)
    assert all(h.done for h in ht)
    for a, b in zip(ht, hj):
        ra, rb = a.result(), b.result()
        assert ra.group_size == rb.group_size
        assert len(ra.stats) == len(rb.stats)
        for sa, sb in zip(ra.stats, rb.stats):
            for k in COUNTERS:
                assert getattr(sa, k) == getattr(sb, k), (k, sa, sb)
    np.testing.assert_allclose(_port_flat(wt), _flat(wj), rtol=0, atol=1e-6)
    assert np.all(np.isfinite(_port_flat(wt)))
    algo = t.algorithm
    assert algo.name == algorithm and algo._removals == 4
    assert set(algo.added) == {600, 601}
    live = np.asarray(algo.live[:600])
    assert not live[[3, 5, 7, 11]].any() and live.sum() == 596
    np.testing.assert_array_equal(np.asarray(algo.live),
                                  np.asarray(j.algorithm.live))


def test_retrain_oracle_is_bitwise_baseline_retrain():
    """`retrain_oracle` is the engine under an all-explicit plan: it must
    reproduce the port's BaseL EXACTLY, not approximately."""
    rows = [4, 17, 256, 511]
    sess = make_session("retrain_oracle")
    w_oracle = sess.delete(rows).params
    w_base, _ = sess.baseline(rows)
    assert torch.equal(w_oracle.flat, w_base.flat)


def test_descent_to_delete_matches_reference_per_group():
    """Parameters within 1e-6 after every group, and the certified bound
    growing per group exactly as the reference's."""
    j, t = make_pair("descent_to_delete")
    bounds = []
    for rows in ([1], [2, 30, 31], [40]):
        wj = j.delete(rows).params
        wt = t.delete(rows).params
        np.testing.assert_allclose(_port_flat(wt), _flat(wj), rtol=0,
                                   atol=1e-6)
        cj, ct = j.certificate(eps=1.0), t.certificate(eps=1.0)
        assert_cert_equal(ct, cj)
        bounds.append(ct.bound)
    assert 0.0 < bounds[0] < bounds[1] and bounds[2] > 0.0


def test_descent_to_delete_contracts_toward_retrained_optimum():
    """Fine-tuning from the cached optimum moves TOWARD the retrained
    model (long full-batch GD, so the reference is near the optimum)."""
    rows = list(range(0, 120))
    sess = UnlearnerSession(
        logreg_objective(5e-3), params_from_jax(_p0(8), "cpu"),
        t_binary(n=600, d=8, seed=0),
        UnlearnerConfig(steps=400, batch_size=600, lr=0.4, seed=0,
                        algorithm="descent_to_delete",
                        privacy=tpriv.PrivacyConfig(**PRIVACY),
                        descent=talg.DescentToDeleteConfig(finetune_steps=25,
                                                           lr=0.4)),
        device="cpu")
    sess.fit()
    w_star = sess.params
    w_base, _ = sess.baseline(rows)
    w_d2d = sess.delete(rows).params
    d_before = float((w_star.flat - w_base.flat).norm())
    d_after = float((w_d2d.flat - w_base.flat).norm())
    assert d_after < d_before, (d_after, d_before)


# -- certificates ----------------------------------------------------------


@pytest.mark.parametrize("algorithm,mechanism",
                         [("deltagrad", "laplace"),
                          ("descent_to_delete", "gaussian"),
                          ("retrain_oracle", "exact")])
def test_certificates_match_reference(algorithm, mechanism):
    j, t = make_pair(algorithm)
    for sess in (j, t):
        sess.delete([2, 9]).result()
        sess.delete([13], coalesce=False).result()
    ct, cj = t.certificate(eps=1.0), j.certificate(eps=1.0)
    assert ct.mechanism == mechanism and ct.removals == 3
    assert_cert_equal(ct, cj)
    assert ct.as_dict() == pytest.approx(cj.as_dict(), rel=1e-12)
    if mechanism == "exact":
        assert ct.noise_scale == 0.0 and ct.bound == 0.0
    else:
        assert ct.noise_scale > 0.0 and ct.bound > 0.0
    # explicit eps / delta overrides
    assert_cert_equal(t.certificate(eps=0.5, delta=1e-3),
                      j.certificate(eps=0.5, delta=1e-3))


def test_default_constants_refuse_like_the_reference():
    """With PrivacyConfig() defaults (mu = l2 = 5e-3), delta0's denominator
    is negative for these removals: both packages raise ValueError."""
    j, t = make_pair("deltagrad")
    for sess in (j, t):
        sess.config = dataclasses.replace(sess.config, privacy=None)
        sess.delete([2, 9]).result()
    with pytest.raises(ValueError, match="r/n too large"):
        j.certificate()
    with pytest.raises(ValueError, match="r/n too large"):
        t.certificate()


def test_publish_adds_calibrated_noise_and_advances_the_generator():
    sess = make_session("deltagrad")
    sess.delete([2, 9]).result()
    w = sess.params
    p1, c1 = sess.publish(eps=1.0)
    p2, c2 = sess.publish(eps=1.0)
    assert c1.noise_scale == c2.noise_scale > 0.0
    assert not torch.equal(p1.flat, w.flat)  # noise was added
    assert not torch.equal(p1.flat, p2.flat)  # the generator advanced
    assert p1.shapes == w.shapes and p1.flat.dtype == w.flat.dtype


def test_retrain_oracle_publishes_the_model_itself():
    sess = make_session("retrain_oracle")
    sess.delete([2, 9]).result()
    out, cert = sess.publish()
    assert cert.mechanism == "exact" and out is sess.params


# -- privacy: calibration and the mechanisms -------------------------------


@pytest.mark.parametrize("kw", [
    dict(mu=0.5, L=1.0, c0=0.1, c2=0.1, lr=0.1, n=1_000_000, r=10),
    dict(mu=0.5, L=1.0, c0=0.1, c2=0.1, lr=0.4, n=600, r=3),
    dict(mu=0.5, L=2.0, c0=0.1, c2=0.1, lr=0.1, n=20242, r=20, m=3, c1=0.3),
    dict(mu=5e-3, L=1.0, c0=1.0, c2=1.0, lr=0.1, n=10_000, r=10),
])
def test_delta0_matches_reference(kw):
    t = tpriv.DeletionBoundConstants(**kw)
    j = jpriv.DeletionBoundConstants(**kw)
    try:
        want = j.delta0()
    except ValueError:
        with pytest.raises(ValueError, match="denominator"):
            t.delta0()
        return
    assert t.delta0() == pytest.approx(want, rel=1e-12, abs=0.0)


def test_privacy_config_resolves_like_the_reference():
    for l2 in (5e-3, 0.1):
        for mu in (None, 0.5):
            ct = tpriv.PrivacyConfig(mu=mu).constants(lr=0.1, n=1000, r=3,
                                                      l2=l2)
            cj = jpriv.PrivacyConfig(mu=mu).constants(lr=0.1, n=1000, r=3,
                                                      l2=l2)
            assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    with pytest.raises(ValueError, match="strong convexity"):
        tpriv.PrivacyConfig().resolve_mu(0.0)


@pytest.mark.parametrize("bound,eps,delta", [(0.3, 1.0, 1e-5),
                                             (1e-4, 0.25, 0.1),
                                             (2.0, 4.0, 0.5)])
def test_gaussian_sigma_matches_reference(bound, eps, delta):
    assert tpriv.gaussian_sigma(bound, eps, delta) == pytest.approx(
        jpriv.gaussian_sigma(bound, eps, delta), rel=1e-12, abs=0.0)


@pytest.mark.parametrize("delta", [0.0, 1.0, -0.1])
def test_gaussian_sigma_refuses_delta_outside_the_unit_interval(delta):
    with pytest.raises(ValueError, match="0 < delta < 1"):
        jpriv.gaussian_sigma(1.0, 1.0, delta)
    with pytest.raises(ValueError, match="0 < delta < 1"):
        tpriv.gaussian_sigma(1.0, 1.0, delta)


def test_empirical_epsilon_matches_reference():
    rng = np.random.default_rng(4)
    a = {"w": rng.normal(size=(50, 3)).astype(np.float32),
         "b": rng.normal(size=3).astype(np.float32)}
    b = {k: (v + 1e-3 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in a.items()}
    p = 153
    want = jpriv.empirical_epsilon({k: jnp.asarray(v) for k, v in a.items()},
                                   {k: jnp.asarray(v) for k, v in b.items()},
                                   eps=1.0, delta0=1e-3, p=p)
    got = tpriv.empirical_epsilon(params_from_jax(a, "cpu"),
                                  params_from_jax(b, "cpu"), eps=1.0,
                                  delta0=1e-3, p=p)
    assert got == pytest.approx(want, rel=1e-6)
    assert tpriv.num_params(params_from_jax(a, "cpu")) == jpriv.num_params(a)


def _zeros(p=200_000, dtype=torch.float32):
    return params_from_jax({"w": np.zeros(p - 1, np.float32),
                            "b": np.zeros((), np.float32)}, "cpu").with_flat(
        torch.zeros(p, dtype=dtype))


@pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
def test_publish_noise_moments_shape_and_determinism(mechanism):
    params = _zeros()
    p = params.numel
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    if mechanism == "laplace":
        out = tpriv.laplace_publish(gen, params, eps=2.0, delta0=1e-3)
        scale = math.sqrt(p) * 1e-3 / 2.0
        want_std = scale * math.sqrt(2.0)  # Laplace(b): std b sqrt(2)
        # Laplace(b): mean |x| = b
        assert float(out.flat.abs().mean()) == pytest.approx(scale, rel=0.02)
    else:
        out = tpriv.gaussian_publish(gen, params, sigma=0.7)
        want_std = 0.7
    noise = out.flat.double()
    assert out.shapes == params.shapes and out.flat.dtype == torch.float32
    assert float(noise.std()) == pytest.approx(want_std, rel=0.02)
    assert abs(float(noise.mean())) < 5 * want_std / math.sqrt(p)
    assert bool(torch.isfinite(noise).all())
    gen.set_state(state)  # the same state draws the same noise
    again = (tpriv.laplace_publish(gen, params, eps=2.0, delta0=1e-3)
             if mechanism == "laplace"
             else tpriv.gaussian_publish(gen, params, sigma=0.7))
    assert torch.equal(again.flat, out.flat)


@pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
def test_publish_at_scale_zero_draws_no_noise(mechanism):
    params = params_from_jax(_p0(8), "cpu")
    gen = torch.Generator().manual_seed(0)
    out = (tpriv.laplace_publish(gen, params, eps=1.0, delta0=0.0)
           if mechanism == "laplace"
           else tpriv.gaussian_publish(gen, params, sigma=0.0))
    assert torch.equal(out.flat, params.flat)


def test_publish_keeps_the_buffer_dtype():
    params = _zeros(p=1000, dtype=torch.float64)
    out = tpriv.gaussian_publish(torch.Generator().manual_seed(0), params, 1.0)
    assert out.flat.dtype == torch.float64


# -- the fine-tuner and the optimizer --------------------------------------


@pytest.mark.parametrize("radius", [None, 0.05])
def test_finetune_runner_matches_reference(radius):
    ds = t_binary(n=300, d=6, seed=2)
    w = np.random.default_rng(3).random(300).astype(np.float32)
    p0 = _p0(6, seed=5)
    p0["w"] = p0["w"] * 10
    jobj, tobj = j_logreg(5e-3), logreg_objective(5e-3)
    run_j = j_runner(lambda p, b: jobj.weighted_mean_loss(p, b[0], b[1]),
                     j_sgd(), 0.3, 7, project_radius=radius)
    run_t = make_finetune_runner(
        lambda p, b: tobj.weighted_mean_loss(p, b[0], b[1]), sgd(), 0.3, 7,
        project_radius=radius)
    pj, lj = run_j({k: jnp.asarray(v) for k, v in p0.items()},
                   ({k: jnp.asarray(v) for k, v in ds.columns.items()},
                    jnp.asarray(w)))
    pt, lt = run_t(params_from_jax(p0, "cpu"),
                   (ds.device_columns("cpu"), torch.from_numpy(w)))
    np.testing.assert_allclose(_port_flat(pt), _flat(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6)
    if radius is not None:
        assert float(pt.flat.norm()) <= radius * (1 + 1e-6)


@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.9, 0.0), (0.9, 0.01)])
def test_sgd_matches_reference(momentum, wd):
    rng = np.random.default_rng(0)
    w = rng.normal(size=17).astype(np.float32)
    gs = rng.normal(size=(3, 17)).astype(np.float32)
    jo, to = j_sgd(momentum, wd), sgd(momentum, wd)
    jw, js = jnp.asarray(w), jo.init(jnp.asarray(w))
    tw = torch.from_numpy(w)
    ts = to.init(tw)
    for g in gs:
        jw, js = jo.update(jw, jnp.asarray(g), js, jnp.float32(0.1))
        tw, ts = to.update(tw, torch.from_numpy(g), ts, 0.1)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert ts["step"] == int(js["step"]) == 3


# -- snapshot round trip ---------------------------------------------------


@pytest.mark.parametrize("algorithm", sorted(talg.ALGORITHMS))
def test_save_restore_roundtrips_descriptor_and_generator(tmp_path, algorithm):
    """restore() resumes the SAME algorithm mid-stream: the next request
    and the next publish both bitwise the uninterrupted session's."""
    sess = make_session(algorithm)
    sess.delete([3, 5]).result()
    sess.publish(eps=1.0)  # advance the generator before the snapshot
    path = str(tmp_path / "snap")
    sess.save(path)

    restored = UnlearnerSession.restore(path, logreg_objective(5e-3),
                                        device="cpu")
    assert restored.config.algorithm == algorithm
    assert torch.equal(restored.params.flat, sess.params.flat)

    wa = sess.delete([9]).params
    wb = restored.delete([9]).params
    assert torch.equal(wa.flat, wb.flat)
    pa, ca = sess.publish(eps=1.0)
    pb, cb = restored.publish(eps=1.0)
    assert torch.equal(pa.flat, pb.flat)
    assert ca.as_dict() == cb.as_dict()
    assert restored.algorithm.state_dict().keys() == \
        sess.algorithm.state_dict().keys()


def test_restore_rejects_algorithm_mismatch(tmp_path):
    sess = make_session("deltagrad")
    sess.delete([3]).result()
    path = str(tmp_path / "snap")
    step_dir = sess.save(path)
    extra_path = os.path.join(step_dir, "extra.pkl")
    with open(extra_path, "rb") as f:
        extra = pickle.load(f)
    extra["config"] = dataclasses.replace(extra["config"],
                                          algorithm="descent_to_delete")
    with open(extra_path, "wb") as f:
        pickle.dump(extra, f)
    with pytest.raises(ValueError, match="deltagrad"):
        UnlearnerSession.restore(path, logreg_objective(5e-3), device="cpu")


def test_algorithm_state_matches_reference_keys_and_values():
    """The snapshot state the port records is the reference's: the same
    keys, and equal liveness, added rows and capacities after a mixed
    plan (descent_to_delete's and the engine's)."""
    for algorithm in ("deltagrad", "descent_to_delete"):
        j, t = make_pair(algorithm)
        _mixed_stream(j, j.dataset)
        _mixed_stream(t, t.dataset)
        sj, st = j.algorithm.state_dict(), t.algorithm.state_dict()
        if algorithm == "deltagrad":
            sj, st = sj["engine"], st["engine"]
        assert sj.keys() == st.keys()
        for k in ("live", "added", "base_n", "row_cap"):
            np.testing.assert_array_equal(np.asarray(st[k]),
                                          np.asarray(sj[k]), err_msg=k)


def test_port_params_carry_back_to_the_reference_layout():
    sess = make_session()
    w = params_to_numpy(sess.params)
    assert sorted(w) == ["b", "w"] and w["b"].shape == ()
