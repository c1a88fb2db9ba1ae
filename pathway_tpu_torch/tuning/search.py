"""Successive-halving search over the knob table's tunable flags
(counterpart of ``pathway_tpu/tuning/search.py``).

The search space is coordinate-wise: for each JAX flag name in the
profile's ``tunables`` the knob's :class:`Tunable` spec yields a
deterministic candidate ladder, and each non-default rung becomes one
single-flag candidate. Successive halving evaluates the (seeded, shuffled)
pool at a small trace scale, keeps the better half, and re-runs survivors
at double scale until ≤ 2 remain; the per-coordinate winners are then
composed into one combined candidate. Obviously-bad trials early-abort on
a wall-clock budget derived from the best trial so far.

Surviving candidates are not trusted on speed alone: each is re-run under
the SLO watchdog (profile objectives armed, zero alerts and zero sheds
required) and — when the profile has a serving fault surface — under a
chaos drill at ``chaos_rate`` (every request must still reach a terminal
state). A "faster" config that breaches p95 or shatters under faults is
rejected and the next-ranked candidate is tried. The winner persists as a
JSON artifact in JAX's format (version 1, JAX's flag names), which the
port's constructors load through ``tuned_config=`` and JAX through
``PATHWAY_TPU_TUNED_CONFIG``.

JAX's ``PATHWAY_TPU_TUNE_SEED``, ``PATHWAY_TPU_TUNE_TRIALS`` and
``PATHWAY_TPU_TUNE_CHAOS_RATE`` are the :class:`Autotuner` arguments
``seed``, ``max_trials`` and ``chaos_rate``. The trial evaluator and the
validator are injectable (``evaluate=`` / ``validate=``), so the search
runs against a synthetic cost model with no device work at all.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np

from pathway_tpu_torch.internals.config import KNOBS_BY_ENV
from pathway_tpu_torch.tuning import profiles as profiles_mod

ARTIFACT_VERSION = 1

# validation re-runs a surviving candidate twice (SLO leg + chaos leg);
# walking every trial through that would double the search cost, so only
# the best few are eligible before the search declares failure
VALIDATE_TOP = 3


class TuneError(RuntimeError):
    """No candidate survived search + validation (or the search space
    was empty). The CLI maps this to a nonzero exit."""


@dataclass
class Trial:
    flags: dict
    scale: float
    metrics: dict | None
    score: float


@dataclass
class TuneResult:
    profile: str
    headline: str
    direction: str
    seed: int
    winner: dict | None  # env -> raw value (empty = defaults won)
    winner_score: float
    winner_metrics: dict | None
    baseline_score: float
    baseline_metrics: dict | None
    validation: dict = field(default_factory=dict)
    rejected: list = field(default_factory=list)
    trials: list = field(default_factory=list)


def candidate_axes(profile) -> dict[str, list[str]]:
    """env name → non-default candidate raw values, in declaration
    order. Every tunable env must carry a ``Tunable`` spec in the knob
    table."""
    profile = profiles_mod.get_profile(profile)
    axes: dict[str, list[str]] = {}
    for env in profile.tunables:
        flag = KNOBS_BY_ENV.get(env)
        if flag is None or flag.tunable is None:
            raise TuneError(
                f"profile {profile.name!r}: {env} has no Tunable spec "
                "in the knob table"
            )
        default = flag.render_default()
        cands = [
            c for c in flag.tunable.candidates()
            if flag.parse_raw(c) != flag.parse_raw(default)
        ]
        if cands:
            axes[env] = cands
    return axes


def _score(profile, metrics: dict | None) -> float:
    """Direction-normalized scalar: higher is always better; broken /
    aborted / non-terminal trials sink to -inf so halving drops them."""
    if not metrics or metrics.get("aborted") or not metrics.get(
        "terminal_ok", False
    ):
        return float("-inf")
    v = metrics.get(profile.headline)
    if v is None:
        return float("-inf")
    v = float(v)
    return v if profile.direction == "max" else -v


def _flags_key(flags: dict) -> str:
    return json.dumps(flags, sort_keys=True)


class Autotuner:
    """One profile-keyed search: deterministic given ``(profile,
    seed)``.

    ``evaluate(flags, scale, deadline_s) -> metrics`` defaults to
    :func:`pathway_tpu_torch.tuning.profiles.run_trial` on ``device`` (the
    card by default); ``validate(flags) -> (ok, reason, detail)`` defaults
    to the SLO + chaos drill, whose fault rate is ``chaos_rate``. Both are
    injectable for device-free tests. ``max_trials=0`` lets the schedule
    decide."""

    def __init__(
        self,
        profile,
        *,
        seed: int = 0,
        max_trials: int = 0,
        base_scale: float = 1.0,
        validation_scale: float | None = None,
        rounds: int = 3,
        evaluate=None,
        validate=None,
        resources=None,
        chaos_rate: float = 0.25,
        device=None,
    ):
        self.profile = profiles_mod.get_profile(profile)
        self.seed = int(seed)
        self.max_trials = int(max_trials) if max_trials else 0  # 0 = schedule decides
        self.chaos_rate = max(0.0, float(chaos_rate))
        self.device = device
        self.base_scale = float(base_scale)
        self.validation_scale = float(
            validation_scale if validation_scale is not None else base_scale
        )
        self.rounds = int(rounds)
        self.resources = resources
        self._evaluate = evaluate or self._real_evaluate
        self._validate = validate or self._real_validate
        self._best_wall: float | None = None
        self.trials: list[Trial] = []

    # -- trial plumbing ------------------------------------------------

    def _real_evaluate(self, flags, scale, deadline_s):
        return profiles_mod.run_trial(
            self.profile, flags, scale=scale, seed=self.seed,
            deadline_s=deadline_s, resources=self.resources, device=self.device,
        )

    def _deadline(self, scale: float) -> float | None:
        # early-abort budget: 4x the best completed trial's
        # scale-normalized wall (with floor headroom), stretched to the
        # current scale — an obviously-bad config stops burning time,
        # while halving's doubled traces get proportional room
        if self._best_wall is None:
            return None
        return max(4.0 * self._best_wall * scale, 2.0)

    def _run_trial(self, flags: dict, scale: float) -> Trial:
        try:
            metrics = self._evaluate(
                dict(flags), scale, self._deadline(scale)
            )
        except Exception as exc:  # a crashing config is a losing config
            metrics = {"error": f"{type(exc).__name__}: {exc}",
                       "terminal_ok": False}
        score = _score(self.profile, metrics)
        if (
            metrics and not metrics.get("aborted")
            and metrics.get("wall_s")
        ):
            w = float(metrics["wall_s"]) / max(float(scale), 1e-9)
            if self._best_wall is None or w < self._best_wall:
                self._best_wall = w
        t = Trial(dict(flags), float(scale), metrics, score)
        self.trials.append(t)
        return t

    # -- the search ----------------------------------------------------

    def _candidates(self) -> list[dict]:
        axes = candidate_axes(self.profile)
        cands = [
            {env: raw} for env, values in axes.items() for raw in values
        ]
        rng = np.random.default_rng(self.seed)
        rng.shuffle(cands)
        if self.max_trials:
            # budgeted run (CLI --smoke): baseline + the first cap-1
            # shuffled candidates — still deterministic per seed
            cands = cands[:max(self.max_trials - 1, 1)]
        return [{}] + cands

    def run(self) -> TuneResult:
        profile = self.profile
        cands = self._candidates()
        if len(cands) <= 1:
            raise TuneError(
                f"profile {profile.name!r}: empty search space"
            )
        # successive halving: evaluate the pool, keep the top half,
        # double the trace scale, repeat
        scale = self.base_scale
        pop = cands
        latest: dict[str, Trial] = {}
        for rnd in range(self.rounds):
            for flags in pop:
                latest[_flags_key(flags)] = self._run_trial(flags, scale)
            if len(pop) <= 2:
                break
            ranked = sorted(
                pop,
                key=lambda f: (
                    -latest[_flags_key(f)].score, len(f), _flags_key(f)
                ),
            )
            pop = ranked[:max(2, math.ceil(len(ranked) / 2))]
            scale *= 2.0
        baseline = latest[_flags_key({})]

        # compose the per-axis winners that individually beat baseline
        best_per_axis: dict[str, tuple[float, str]] = {}
        for key, t in latest.items():
            if len(t.flags) != 1 or t.score <= baseline.score:
                continue
            ((env, raw),) = t.flags.items()
            cur = best_per_axis.get(env)
            if cur is None or t.score > cur[0]:
                best_per_axis[env] = (t.score, raw)
        composed = {env: raw for env, (_, raw) in sorted(
            best_per_axis.items()
        )}
        if len(composed) > 1 and _flags_key(composed) not in latest:
            latest[_flags_key(composed)] = self._run_trial(composed, scale)

        # rank everything we measured; validate best-first
        ranked = sorted(
            latest.values(),
            key=lambda t: (-t.score, len(t.flags), _flags_key(t.flags)),
        )
        rejected: list[dict] = []
        winner: Trial | None = None
        validation: dict = {}
        for t in ranked[:VALIDATE_TOP]:
            if t.score == float("-inf"):
                break
            ok, reason, detail = self._validate(dict(t.flags))
            if ok:
                winner, validation = t, detail
                break
            rejected.append({
                "flags": dict(t.flags), "score": t.score, "reason": reason,
                "detail": detail,
            })
        if winner is None:
            raise TuneError(
                f"profile {profile.name!r}: no candidate survived "
                f"validation ({len(rejected)} rejected: "
                f"{[r['reason'] for r in rejected]})"
            )
        return TuneResult(
            profile=profile.name,
            headline=profile.headline,
            direction=profile.direction,
            seed=self.seed,
            winner=dict(winner.flags),
            winner_score=winner.score,
            winner_metrics=winner.metrics,
            baseline_score=baseline.score,
            baseline_metrics=baseline.metrics,
            validation=validation,
            rejected=rejected,
            trials=[
                {"flags": t.flags, "scale": t.scale, "score": t.score,
                 "metrics": t.metrics}
                for t in self.trials
            ],
        )

    # -- validation: SLO watchdog + chaos drill -------------------------

    def _real_validate(self, flags: dict):
        profile = self.profile
        detail: dict = {}
        # SLO leg: profile objectives armed, watchdog constructed inside
        # the trial's override scope, force-ticked after the trace
        slo_metrics = profiles_mod.run_trial(
            profile, {**flags, **profile.slo}, scale=self.validation_scale,
            seed=self.seed + 1, resources=self.resources, arm_slo=True,
            device=self.device,
        )
        detail["slo"] = slo_metrics
        if not slo_metrics.get("terminal_ok"):
            return False, "slo_leg_not_terminal", detail
        if slo_metrics.get("shed", 0) or slo_metrics.get("failures", 0):
            return False, "slo_leg_shed_or_failed", detail
        if slo_metrics.get("slo_alerting") or slo_metrics.get(
            "slo_breaches", 0
        ):
            return False, "slo_breach", detail
        # chaos drill: same trace with deterministic fault injection and
        # a restart/retry budget — the config must stay terminal and
        # never shed (faults fail single requests at worst)
        if profile.chaos_sites:
            chaos_metrics = profiles_mod.run_trial(
                profile,
                {
                    **flags,
                    "PATHWAY_TPU_CHAOS": str(self.chaos_rate),
                    "PATHWAY_TPU_CHAOS_SITES": profile.chaos_sites,
                    "PATHWAY_TPU_CHAOS_SEED": str(self.seed + 7),
                    "PATHWAY_TPU_SERVE_RESTARTS": "2",
                    "PATHWAY_TPU_SERVE_RETRIES": "4",
                },
                scale=self.validation_scale, seed=self.seed + 2,
                resources=self.resources, device=self.device,
            )
            detail["chaos"] = chaos_metrics
            if not chaos_metrics.get("terminal_ok"):
                return False, "chaos_not_terminal", detail
            if chaos_metrics.get("shed", 0):
                return False, "chaos_shed", detail
        return True, "", detail


# --------------------------------------------------------------------- #
# artifact persistence (the JSON constructors load through tuned_config=,
# and JAX through PATHWAY_TPU_TUNED_CONFIG)


def to_artifact(result: TuneResult) -> dict:
    return {
        "version": ARTIFACT_VERSION,
        "profile": result.profile,
        "headline": result.headline,
        "direction": result.direction,
        "seed": result.seed,
        "flags": dict(result.winner or {}),
        "score": result.winner_score,
        "baseline_score": result.baseline_score,
        "metrics": result.winner_metrics,
        "baseline_metrics": result.baseline_metrics,
        "validation": result.validation,
    }


def save_artifact(result: TuneResult, path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_artifact(result), f, indent=2, sort_keys=True)
        f.write("\n")
    return path
