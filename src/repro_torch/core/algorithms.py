"""Pluggable unlearning algorithms behind one certified-deletion engine.

The serving surface (`core.session.UnlearnerSession`, `core.api`) is
algorithm-agnostic: requests flow through the SAME submit/coalesce/flush/
save/restore surface whichever algorithm answers them.  This module is the
seam: the `UnlearningAlgorithm` protocol, a registry, and three
implementations, as in the JAX package:

  * ``deltagrad``          the paper's Algorithm 3 engine
                           (`core.online.OnlineEngine`), with a Laplace
                           ε-certificate from the paper's δ0 bound (§5.1 /
                           App. B.1);
  * ``descent_to_delete``  noisy projected fine-tuning from the current
                           params (Neel, Roth & Sharifi-Malvajerdi 2020): I
                           full-batch gradient steps on the post-deletion
                           objective, Gaussian noise at publication, with
                           the (ε, δ) certificate from the contraction
                           bound ρ^I (||w−w*|| + Δ);
  * ``retrain_oracle``     exact retraining (BaseL, paper eq. (1)/(S6)): the
                           online engine with an ALL-EXPLICIT plan computes
                           the exact gradient of the current objective at
                           every replayed step, which IS retraining on the
                           modified data under the original schedule.  Its
                           certificate is exact (ε = 0, bound = 0).

Protocol (the session drives exactly this surface):

    algo = get_algorithm(name)(objective, dataset, config, device)
    algo.prepare(history, params, params0)     # after fit()/restore()
    stats = algo.apply(op, rows, coalesce=..)  # -> [RetrainStats]
    noised, cert = algo.publish(generator)     # certified release
    algo.certificate()                         # -> Certificate (no noise)
    algo.state_dict() / algo.load_state(...)   # snapshot round trip

Certificates are comparable across algorithms: each reports the
mechanism, the certified deviation bound ``||w_alg − w_retrain||`` and
the per-coordinate noise scale that ε (and δ) buy at that bound.  All
bounds assume the strongly-convex regularized setting (PrivacyConfig.mu >
0).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np
import torch

from repro_torch.core.deltagrad import Objective, RetrainStats
from repro_torch.core.engine import _next_pow2, _sync, resolve_device
from repro_torch.core.online import OnlineEngine
from repro_torch.core.privacy import (PrivacyConfig, gaussian_publish,
                                      gaussian_sigma, laplace_publish,
                                      num_params)
from repro_torch.data.dataset import Dataset
from repro_torch.optim.optimizers import sgd
from repro_torch.train.loop import make_finetune_runner
from repro_torch.utils.tree import FlatParams

# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

ALGORITHMS: Dict[str, Type["UnlearningAlgorithm"]] = {}


def register(name: str):
    """Class decorator: `@register("name")` adds an algorithm to the
    registry (and stamps `cls.name`) so sessions can select it by string."""

    def deco(cls):
        cls.name = name
        ALGORITHMS[name] = cls
        return cls

    return deco


def get_algorithm(name: str) -> Type["UnlearningAlgorithm"]:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown unlearning algorithm {name!r}; registered: "
            f"{', '.join(available_algorithms())}") from None


def available_algorithms() -> List[str]:
    return sorted(ALGORITHMS)


# --------------------------------------------------------------------------
# Certificates
# --------------------------------------------------------------------------


@dataclass
class Certificate:
    """What a published model promises.

    bound is the certified L2 deviation ``||w_alg − w_retrain*||`` the
    algorithm's analysis guarantees against the exact-retraining optimum;
    noise_scale is the per-coordinate noise the mechanism adds so that the
    release is ε-(or (ε, δ)-)indistinguishable from publishing the
    retrained model through the same mechanism."""

    algorithm: str
    mechanism: str  # "laplace" | "gaussian" | "exact"
    eps: float
    delta: float
    bound: float
    noise_scale: float
    removals: int

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------
# Protocol
# --------------------------------------------------------------------------


class UnlearningAlgorithm:
    """Base class every registered algorithm implements.

    Construction is cheap (no device work); `prepare()` binds the trained
    state after `fit()`/`restore()`.  `apply()` serves one planner group:
    the ONLY mutation path, so the session's bookkeeping and the
    algorithm's never diverge.  ``device``: where requests run (None: the
    card)."""

    name = "base"

    def __init__(self, objective: Objective, dataset: Dataset, config,
                 device=None):
        self.objective = objective
        self.ds = dataset
        self.config = config  # the owning UnlearnerConfig
        self.device = resolve_device(device)
        self.history = None
        self.params0: Optional[FlatParams] = None
        self._params: Optional[FlatParams] = None
        self._removals = 0

    @property
    def compile_time_s(self) -> float:
        """Always 0.0: eager PyTorch compiles no serving program."""
        return 0.0

    # -- lifecycle ---------------------------------------------------------

    def prepare(self, history, params, params0) -> "UnlearningAlgorithm":
        """Bind the cached training run (history), the trained/current
        params, and the init params; idempotent."""
        self.history = history
        self._params = params
        self.params0 = params0
        self._prepared()
        return self

    def _prepared(self) -> None:  # optional hook
        pass

    @property
    def privacy(self) -> PrivacyConfig:
        p = getattr(self.config, "privacy", None)
        return p if p is not None else PrivacyConfig()

    # -- serving surface ---------------------------------------------------

    def apply(self, op: str, rows: Sequence[int],
              coalesce: bool = True) -> List[RetrainStats]:
        """Serve one planner group (`op` in {"delete", "add"}): one entry
        per replay, a single entry for a coalesced group, len(rows)
        entries for a serial group."""
        raise NotImplementedError

    @property
    def params(self) -> FlatParams:
        return self._params

    @property
    def added(self) -> List[int]:
        """Rows appended after the cached run that the algorithm has
        absorbed (the session validates add requests against this)."""
        return []

    @property
    def live(self) -> np.ndarray:
        """Liveness over the dataset's rows (drivers sample from it)."""
        return ~np.asarray(self.ds.removed, dtype=bool)

    def begin_plan(self, n_adds: int) -> None:
        """Called once per flush with the plan's TOTAL add count so the
        algorithm can size capacity before any group executes."""

    def warmup(self, specs=("delete",)) -> float:
        """The reference pre-compiles its serving programs here; eager
        PyTorch has none, so this returns `compile_time_s` (0.0)."""
        return self.compile_time_s

    # -- certified publication --------------------------------------------

    def certificate(self, eps: Optional[float] = None,
                    delta: Optional[float] = None) -> Certificate:
        raise NotImplementedError

    def publish(self, generator: torch.Generator,
                params: Optional[FlatParams] = None,
                eps: Optional[float] = None, delta: Optional[float] = None):
        """(noised_params, Certificate): release the current (or given)
        model through the algorithm's mechanism, randomness drawn ONLY
        from `generator` (deterministic under its state)."""
        params = self.params if params is None else params
        cert = self.certificate(eps=eps, delta=delta)
        if cert.mechanism == "laplace":
            out = laplace_publish(generator, params, cert.eps, cert.bound)
        elif cert.mechanism == "gaussian":
            out = gaussian_publish(generator, params, cert.noise_scale)
        else:  # exact: publishing the model itself is the guarantee
            out = params
        return out, cert

    # -- snapshot ----------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"removals": int(self._removals)}

    def load_state(self, state: Dict[str, Any], params: FlatParams) -> None:
        self._removals = int(state.get("removals", 0))
        self._params = params


# --------------------------------------------------------------------------
# DeltaGrad (the paper's engine) and the exact-retraining oracle
# --------------------------------------------------------------------------


@register("deltagrad")
class DeltaGradAlgorithm(UnlearningAlgorithm):
    """Algorithm 3 replay with L-BFGS corrections: wraps the session's one
    `core.online.OnlineEngine` and keeps its call sequence (request_group
    for coalesced groups, per-row request otherwise), so replay results
    are identical to driving the engine directly."""

    def __init__(self, objective, dataset, config, device=None):
        super().__init__(objective, dataset, config, device)
        self._engine: Optional[OnlineEngine] = None

    def _engine_cfg(self):
        return self.config.deltagrad

    def engine(self, placement=None) -> OnlineEngine:
        """The online engine, made at first call on `placement` (else
        ``config.placement``); a placement given after that raises."""
        if self._engine is None:
            self._engine = OnlineEngine(
                self.objective, self.history, self.ds, self._engine_cfg(),
                device=self.device,
                placement=placement if placement is not None
                else self.config.placement)
        elif placement is not None:
            raise RuntimeError(
                "the session's engine already exists; placement must be "
                "chosen before the first request (pass it to the first "
                "engine() call or set config.placement)")
        return self._engine

    def apply(self, op, rows, coalesce=True):
        engine = self.engine()
        if coalesce and len(rows) > 1:
            stats = [engine.request_group(op, rows)]
        else:
            stats = [engine.request(op, r) for r in rows]
        if op == "delete":
            self._removals += len(rows)
        self._params = engine.params
        return stats

    @property
    def params(self):
        return self._engine.params if self._engine is not None \
            else self._params

    @property
    def added(self):
        return self._engine.added if self._engine is not None else []

    @property
    def live(self):
        if self._engine is not None:
            return self._engine.live
        return super().live

    def begin_plan(self, n_adds: int) -> None:
        engine = self.engine()
        engine.add_capacity = max(engine.add_capacity,
                                  len(engine.added) + n_adds)

    def warmup(self, specs=("delete",)) -> float:
        self.engine().warmup(tuple(specs))
        return self.compile_time_s

    def certificate(self, eps=None, delta=None) -> Certificate:
        pv = self.privacy
        eps = pv.eps if eps is None else float(eps)
        meta = self.history.meta
        r = self._removals
        if r == 0:
            bound = 0.0
        else:
            bound = pv.constants(lr=meta.lr_at(0), n=meta.n, r=r,
                                 l2=self.objective.l2).delta0()
        p = num_params(self.params)
        scale = float(np.sqrt(p)) * bound / eps
        # Laplace mechanism: pure ε-indistinguishability, δ = 0
        return Certificate(algorithm=self.name, mechanism="laplace",
                           eps=eps, delta=0.0, bound=bound,
                           noise_scale=scale, removals=r)

    def state_dict(self):
        state = super().state_dict()
        state["engine"] = (self._engine.state_dict()
                           if self._engine is not None else None)
        return state

    def load_state(self, state, params):
        super().load_state(state, params)
        if state.get("engine") is not None:
            engine = self.engine()
            engine.load_state(state["engine"])
            engine.params = params


@register("retrain_oracle")
class RetrainOracleAlgorithm(DeltaGradAlgorithm):
    """Exact retraining (BaseL) behind the serving surface.

    The online engine under an ALL-EXPLICIT step plan (burn_in past the
    last step): every replayed step evaluates the exact gradient of the
    CURRENT (post-request) objective at the current iterate, which is
    eq. (1)/(S6) retraining from w_0 under the original schedule, with the
    engine's delete/add bookkeeping, coalescing, path rewrite and snapshot
    state.  No L-BFGS correction is consulted (there are no approx steps).

    Caveat: with momentum histories the replay rebuilds the velocity from
    0 like every other path here, so exactness is relative to the
    package's BaseL semantics."""

    def _engine_cfg(self):
        dg = self.config.deltagrad
        return dataclasses.replace(dg, burn_in=self.history.meta.steps + 1,
                                   period=1)

    def certificate(self, eps=None, delta=None) -> Certificate:
        # retraining IS the reference: zero deviation, nothing to hide
        return Certificate(algorithm=self.name, mechanism="exact",
                           eps=0.0, delta=0.0, bound=0.0, noise_scale=0.0,
                           removals=self._removals)


# --------------------------------------------------------------------------
# Descent-to-delete (noisy projected fine-tuning)
# --------------------------------------------------------------------------


@dataclass
class DescentToDeleteConfig:
    """Knobs for the `descent_to_delete` algorithm (Neel et al. 2020).

    finetune_steps is I, the full-batch gradient steps per request group;
    lr=None resolves to 2/(mu+L), the contraction-optimal step size;
    project_radius adds the projected-GD step the analysis assumes (None
    disables: fine whenever iterates stay in the ball anyway)."""

    finetune_steps: int = 5
    lr: Optional[float] = None
    project_radius: Optional[float] = None


@register("descent_to_delete")
class DescentToDeleteAlgorithm(UnlearningAlgorithm):
    """Noisy projected fine-tuning from the current params.

    Each request group updates liveness, then runs I full-batch gradient
    steps (`train.loop.make_finetune_runner` over `Objective.
    weighted_mean_loss` with the live-row weight vector) from the CURRENT
    params: warm-started, never from scratch.  Publication adds Gaussian
    noise calibrated to the certified deviation bound, which contracts
    geometrically per group:

        bound <- rho^I * (bound + 2 c2 |group| / (mu n_live)),
        rho = (kappa - 1) / (kappa + 1),  kappa = L / mu

    Cost per group is I full-batch gradients, independent of the training
    length T."""

    def __init__(self, objective, dataset, config, device=None):
        super().__init__(objective, dataset, config, device)
        self._live: Optional[np.ndarray] = None
        self._added: List[int] = []
        self._bound = 0.0
        self._base_n = dataset.n
        # the reference's pow2-bucketed row capacity, kept as snapshot
        # bookkeeping: the port's weights and columns are ds.n rows long
        self._row_cap = dataset.n
        self._runner = None

    # -- resolved hyperparameters -----------------------------------------

    @property
    def d2d(self) -> DescentToDeleteConfig:
        d = getattr(self.config, "descent", None)
        return d if d is not None else DescentToDeleteConfig()

    def _mu_L(self):
        pv = self.privacy
        mu = pv.resolve_mu(self.objective.l2)
        L = max(float(pv.L), mu)
        return mu, L

    def _lr(self) -> float:
        if self.d2d.lr is not None:
            return float(self.d2d.lr)
        mu, L = self._mu_L()
        return 2.0 / (mu + L)

    def _prepared(self):
        # the original/appended boundary is the CACHED RUN's n, not ds.n at
        # construction: submit() appends add payloads eagerly, and the
        # algorithm is created lazily at the first flush, possibly after
        if self.history is not None:
            self._base_n = int(self.history.meta.n)
        if self._live is None:
            self._live = ~np.asarray(self.ds.removed, dtype=bool).copy()

    # -- serving -----------------------------------------------------------

    @property
    def added(self):
        return list(self._added)

    @property
    def live(self):
        self._prepared()
        return self._live

    def _grow_live(self):
        if len(self._live) < self.ds.n:
            grown = np.ones(self.ds.n, dtype=bool)
            grown[:len(self._live)] = self._live
            self._live = grown

    def _weights(self) -> torch.Tensor:
        w = np.zeros(self.ds.n, dtype=np.float32)
        lv = self._live[:self._base_n]
        w[:self._base_n][lv] = 1.0
        for r in self._added:
            if self._live[r]:
                w[r] = 1.0
        return torch.from_numpy(w).to(self.device)

    def _get_runner(self):
        if self._runner is None:
            loss = (lambda p, b:
                    self.objective.weighted_mean_loss(p, b[0], b[1]))
            self._runner = make_finetune_runner(
                loss, sgd(), self._lr(), int(self.d2d.finetune_steps),
                project_radius=self.d2d.project_radius)
        return self._runner

    def _cols(self):
        if self.ds.n > self._row_cap:
            self._row_cap = self._base_n + _next_pow2(self.ds.n - self._base_n)
        return self.ds.device_columns(self.device)

    def apply(self, op, rows, coalesce=True):
        self._prepared()
        self._grow_live()
        rows = [int(r) for r in rows]
        if op == "delete":
            gone = [r for r in rows if not self._live[r]]
            if gone:
                raise ValueError(f"rows already deleted: {gone}")
            for r in rows:
                self._live[r] = False
                self.ds.removed[r] = True
            self._removals += len(rows)
        else:
            for r in rows:
                if not self._base_n <= r < self.ds.n:
                    raise ValueError("add requests name rows appended after "
                                     f"the cached run, got {r}")
            self._added.extend(rows)
        n_live = int(self._live[:self._base_n].sum()
                     + sum(self._live[r] for r in self._added))
        I = int(self.d2d.finetune_steps)
        mu, L = self._mu_L()
        kappa = L / mu
        rho = ((kappa - 1.0) / (kappa + 1.0)) ** I
        sens = 2.0 * self.privacy.c2 * len(rows) / (mu * max(n_live, 1))
        self._bound = rho * (self._bound + sens)

        t0 = time.perf_counter()
        batch = (self._cols(), self._weights())
        self._params, _losses = self._get_runner()(self._params, batch)
        _sync(self.device)
        stats = RetrainStats(
            explicit_steps=I,
            grad_examples=I * n_live,
            grad_examples_baseline=int(
                self.history.meta.steps
                * min(self.history.meta.batch_size, n_live)),
            wall_time_s=time.perf_counter() - t0,
        )
        stats.extra["finetune_bound"] = self._bound
        # one entry whether or not the group coalesced: the fine-tune IS
        # the group correction
        return [stats]

    def begin_plan(self, n_adds: int) -> None:
        if n_adds:  # the reference sizes its bucketed capacity here
            self._row_cap = max(self._row_cap,
                                self._base_n
                                + _next_pow2(self.ds.n - self._base_n
                                             + n_adds))

    # -- certification -----------------------------------------------------

    def certificate(self, eps=None, delta=None) -> Certificate:
        pv = self.privacy
        eps = pv.eps if eps is None else float(eps)
        delta = pv.delta if delta is None else float(delta)
        scale = gaussian_sigma(self._bound, eps, delta) if self._bound \
            else 0.0
        return Certificate(algorithm=self.name, mechanism="gaussian",
                           eps=eps, delta=delta, bound=self._bound,
                           noise_scale=scale, removals=self._removals)

    # -- snapshot ----------------------------------------------------------

    def state_dict(self):
        self._prepared()
        state = super().state_dict()
        state.update({
            "live": np.asarray(self._live, dtype=bool).copy(),
            "added": list(self._added),
            "bound": float(self._bound),
            "base_n": int(self._base_n),
            "row_cap": int(self._row_cap),
        })
        return state

    def load_state(self, state, params):
        super().load_state(state, params)
        self._live = np.asarray(state["live"], dtype=bool).copy()
        self._added = list(state["added"])
        self._bound = float(state["bound"])
        self._base_n = int(state["base_n"])
        self._row_cap = max(int(state["row_cap"]), self.ds.n)
