"""The port's autotuner (``pathway_tpu_torch/tuning/``) and its tuned-config
surface (``pathway_tpu_torch/internals/config.py``), held against JAX's
(``pathway_tpu/tuning/``, ``pathway_tpu/internals/config.py``) on the CPU.

* The knob table equals JAX's ``FLAG_REGISTRY`` for every name it carries
  (default, kind, minimum, parser, ``Tunable``) and covers every flag JAX
  gives a ``Tunable``; ``candidate_axes``, ``_prompts`` and ``_arrivals``
  equal JAX's.
* The search, with JAX's synthetic cost model (and a flag-keyed one for
  every profile) injected into both packages' ``Autotuner``, gives JAX's
  ``TuneResult``: winner, scores, baseline, the trials in order,
  rejections, and ``TuneError`` in the same cases. ``tests/test_autotune.py``
  cases are ported one by one.
* ``_real_validate``'s decisions with ``run_trial`` stubbed; artifacts in
  both directions; the loader's errors; precedence (an explicit argument
  beats the artifact, which beats the default) through the four
  constructors and ``unified_snapshot()['tuning']``.
* The real ``run_trial`` on the CPU (tiny decoder) and the CLI's ``tune``.

JAX's continuous server is never driven (it can lose a request)."""

import ast
import dataclasses
import json
import math
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import pathway_tpu.tuning as JT
from pathway_tpu.internals import config as JC
from pathway_tpu.tuning import profiles as JPROF
from pathway_tpu.tuning import search as JSEARCH
import pathway_tpu_torch.tuning as TT
from pathway_tpu_torch import cli as tcli
from pathway_tpu_torch.engine import chaos, probes, slo
from pathway_tpu_torch.internals import config as TC
from pathway_tpu_torch.tuning import profiles as TPROF
from pathway_tpu_torch.tuning import search as TSEARCH

SPEC_K = "PATHWAY_TPU_SPEC_DECODE_K"
CHUNK = "PATHWAY_TPU_PREFILL_CHUNK"
PROFILE_NAMES = sorted(JT.PROFILES)


@pytest.fixture(autouse=True)
def _fresh_tuning_record():
    TC.clear_tuned_configs()
    yield
    TC.clear_tuned_configs()


# ------------------------------------------------------------------ #
# the knob table against JAX's registry


def test_knob_table_covers_every_jax_tunable_and_the_flags_trials_set():
    jax_tunables = {f.env for f in JC.FLAG_REGISTRY if f.tunable is not None}
    assert len(jax_tunables) == 25
    ours = set(TC.KNOBS_BY_ENV)
    assert jax_tunables <= ours
    extra = {"PATHWAY_TPU_" + n for n in (
        "TENANT_SCHED", "TENANT_WEIGHTS", "SLO_E2E_P95_MS", "CHAOS", "CHAOS_SITES",
        "CHAOS_SEED", "SERVE_RESTARTS", "SERVE_RETRIES", "PAGED_KV", "PAGED_KERNEL",
        "WQ_KERNEL")}
    assert ours == jax_tunables | extra
    assert len(TC.KNOBS) == len(ours)
    # every knob a trial, a profile or validation sets has a counterpart
    for p in JT.PROFILES.values():
        for env in (*p.tunables, *p.base_flags, *p.slo):
            assert TC.KNOBS_BY_ENV[env].target is not None, env


@pytest.mark.parametrize("env", sorted(TC.KNOBS_BY_ENV))
def test_knob_equals_jax_flag(env):
    knob, flag = TC.KNOBS_BY_ENV[env], JC._REGISTRY_BY_ENV[env]
    assert (knob.kind, knob.default, knob.minimum) == (flag.kind, flag.default, flag.minimum)
    assert knob.render_default() == flag.render_default()
    if flag.tunable is None:
        assert knob.tunable is None
    else:
        assert dataclasses.asdict(knob.tunable) == dataclasses.asdict(flag.tunable)
        assert knob.tunable.candidates() == flag.tunable.candidates()
        for raw in (*flag.tunable.candidates(), "-3", "1e9", "7.5", "nope"):
            assert knob.tunable.contains(raw) == flag.tunable.contains(raw), raw
    raws = ["0", "1", "2", "64", "0.5", "int8", "on", "", "prod:3,batch:1", "-4"]
    raws += list(flag.tunable.candidates() if flag.tunable else ())
    for raw in raws:
        try:
            want = flag.parse_raw(raw)
        except ValueError:
            with pytest.raises(ValueError):
                knob.parse_raw(raw)
            continue
        assert knob.parse_raw(raw) == want and type(knob.parse_raw(raw)) is type(want), raw
    if knob.target is not None:
        assert knob.arg


def test_knob_targets_are_real_arguments():
    import inspect

    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.ops.query_server import QueryServer
    from pathway_tpu_torch.xpacks.llm import DecoderChat

    targets = {"DecoderChat": DecoderChat.__init__,
               "SentenceEmbedderModel": SentenceEmbedderModel.__init__,
               "QueryServer": QueryServer.__init__, "chaos": chaos.configure,
               "slo": slo.configure}
    fields = {f.name for f in dataclasses.fields(TC.EngineConfig)}
    for knob in TC.KNOBS:
        if knob.target is None:
            assert knob.env in ("PATHWAY_TPU_FLASH_BLOCK_Q", "PATHWAY_TPU_FLASH_BLOCK_K")
        elif knob.target == "EngineConfig":
            assert knob.arg in fields
        else:
            assert knob.arg in inspect.signature(targets[knob.target]).parameters, knob.env


def test_knob_arguments_groups_by_target():
    got = TC.knob_arguments({CHUNK: "128", "PATHWAY_TPU_SPEC_DECODE": False,
                             "PATHWAY_TPU_CHAOS": "0.25", "PATHWAY_TPU_CHAOS_SITES": "decode.admit",
                             "PATHWAY_TPU_PIPELINE_DEPTH": "4",
                             "PATHWAY_TPU_WEIGHT_QUANT": "int8"})
    assert got == {"DecoderChat": {"prefill_chunk": 128, "spec_decode": False,
                                   "weight_quant": "int8"},
                   "chaos": {"rate": 0.25, "sites": "decode.admit"},
                   "SentenceEmbedderModel": {"pipeline_depth": 4}}
    with pytest.raises(KeyError):
        TC.knob_arguments({"PATHWAY_TPU_NOT_A_FLAG": "1"})
    with pytest.raises(TC.TunedConfigError, match="FLASH_BLOCK_Q"):
        TC.knob_arguments({"PATHWAY_TPU_FLASH_BLOCK_Q": "128"})


# ------------------------------------------------------------------ #
# the profiles: equal to JAX's bit for bit


def test_profiles_equal_jax():
    assert sorted(TT.PROFILES) == PROFILE_NAMES
    for name in PROFILE_NAMES:
        assert dataclasses.asdict(TT.PROFILES[name]) == dataclasses.asdict(JT.PROFILES[name])
    assert TT.get_profile(TT.PROFILES["smoke"]) is TT.PROFILES["smoke"]
    with pytest.raises(KeyError, match="unknown workload profile"):
        TT.get_profile("nope")


@pytest.mark.parametrize("name", PROFILE_NAMES)
def test_candidate_axes_equal_jax(name):
    assert TT.candidate_axes(name) == JT.candidate_axes(name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", PROFILE_NAMES)
def test_prompts_and_arrivals_equal_jax(name, seed):
    jp, tp = JT.PROFILES[name], TT.PROFILES[name]
    for nreq in (tp.nreq, 7):
        assert TPROF._prompts(tp, nreq, TPROF._profile_rng(tp, seed)) == JPROF._prompts(
            jp, nreq, JPROF._profile_rng(jp, seed))
        assert np.array_equal(TPROF._arrivals(tp, nreq, TPROF._profile_rng(tp, seed)),
                              JPROF._arrivals(jp, nreq, JPROF._profile_rng(jp, seed)))
    assert TPROF._CharTok().encode("hello q01") == JPROF._CharTok().encode("hello q01")
    assert TPROF._CharTok().decode([5, 200, 33]) == JPROF._CharTok().decode([5, 200, 33])


# ------------------------------------------------------------------ #
# the search, against synthetic cost models (no device work)


def _synthetic_profile(pkg, tunables=(CHUNK,)):
    return pkg.WorkloadProfile(name="synthetic", doc="test-only", headline="tok_s",
                               direction="max", tunables=tuple(tunables))


def _cost_evaluate(flags, scale, deadline_s):
    """JAX's synthetic cost model: peaks at PREFILL_CHUNK=128 (off the
    default of 64) and SPEC_DECODE_K=8, additive across axes."""
    chunk = float(flags.get(CHUNK, JC._REGISTRY_BY_ENV[CHUNK].default))
    k = float(flags.get(SPEC_K, JC._REGISTRY_BY_ENV[SPEC_K].default))
    tok_s = 200.0 - 40.0 * abs(math.log2(chunk) - math.log2(128.0)) + 5.0 * k
    return {"tok_s": round(tok_s, 3), "terminal_ok": True, "aborted": False,
            "wall_s": 0.01, "shed": 0}


def _ok_validate(flags):
    return True, "", {"synthetic": True}


def _both(tunables, **kw):
    """The same search in both packages; (jax result or error, port's)."""
    out = []
    for pkg in (JT, TT):
        try:
            out.append(pkg.Autotuner(_synthetic_profile(pkg, tunables), **kw).run())
        except (JT.TuneError, TT.TuneError) as exc:
            out.append(("TuneError", str(exc)))
    return out


def _result(r):
    return r if isinstance(r, tuple) else dataclasses.asdict(r)


def test_candidate_axes_excludes_defaults():
    axes = TT.candidate_axes(_synthetic_profile(TT))
    assert CHUNK in axes and TC.KNOBS_BY_ENV[CHUNK].render_default() not in axes[CHUNK]
    assert len(axes[CHUNK]) >= 2


def test_candidate_axes_requires_tunable_spec():
    with pytest.raises(TT.TuneError, match="no Tunable spec"):
        TT.candidate_axes(_synthetic_profile(TT, ("PATHWAY_TPU_SERVE_RETRIES",)))
    with pytest.raises(TT.TuneError, match="no Tunable spec"):
        TT.candidate_axes(_synthetic_profile(TT, ("PATHWAY_TPU_METRICS",)))


def test_search_converges_on_synthetic_optimum():
    j, t = _both((CHUNK,), seed=0, evaluate=_cost_evaluate, validate=_ok_validate)
    assert _result(t) == _result(j)
    assert t.winner == {CHUNK: "128"} and t.winner_score > t.baseline_score
    assert t.validation == {"synthetic": True}


def test_search_is_deterministic_per_seed():
    a = _both((CHUNK, SPEC_K), seed=3, evaluate=_cost_evaluate, validate=_ok_validate)
    b = _both((CHUNK, SPEC_K), seed=3, evaluate=_cost_evaluate, validate=_ok_validate)
    assert _result(a[1]) == _result(b[1]) == _result(a[0])
    assert [tr["flags"] for tr in a[1].trials] == [tr["flags"] for tr in a[0].trials]


def test_search_composes_per_axis_winners():
    j, t = _both((CHUNK, SPEC_K), seed=0, evaluate=_cost_evaluate, validate=_ok_validate)
    assert _result(t) == _result(j)
    assert t.winner == {CHUNK: "128", SPEC_K: "8"}


def test_search_drops_crashing_configs():
    def evaluate(flags, scale, deadline_s):
        if flags.get(CHUNK) == "128":
            raise RuntimeError("synthetic crash")
        return _cost_evaluate(flags, scale, deadline_s)

    j, t = _both((CHUNK,), seed=0, evaluate=evaluate, validate=_ok_validate)
    assert _result(t) == _result(j)
    assert t.winner != {CHUNK: "128"}


def test_all_rejected_raises_tune_error():
    def reject(flags):
        return False, "slo_breach", {"synthetic": True}

    j, t = _both((CHUNK,), seed=0, evaluate=_cost_evaluate, validate=reject)
    assert t == j and t[0] == "TuneError" and "slo_breach" in t[1]


def test_rejection_falls_through_to_next_candidate():
    def make():
        first = []

        def validate(flags):
            if not first:
                first.append(dict(flags))
                return False, "chaos_shed", {}
            return True, "", {}
        return validate, first

    (jv, _), (tv, tfirst) = make(), make()
    j = JT.Autotuner(_synthetic_profile(JT), seed=0, evaluate=_cost_evaluate,
                     validate=jv).run()
    t = TT.Autotuner(_synthetic_profile(TT), seed=0, evaluate=_cost_evaluate,
                     validate=tv).run()
    assert _result(t) == _result(j)
    assert t.rejected and t.rejected[0]["reason"] == "chaos_shed"
    assert t.winner != tfirst[0]


def test_max_trials_caps_candidate_pool():
    seen = []

    def evaluate(flags, scale, deadline_s):
        seen.append(dict(flags))
        return _cost_evaluate(flags, scale, deadline_s)

    TT.Autotuner(_synthetic_profile(TT), seed=0, max_trials=2, rounds=1,
                 evaluate=evaluate, validate=_ok_validate).run()
    assert len(seen) <= 3  # baseline + 1 candidate (+ compose never fires)


def test_empty_search_space_raises():
    j, t = _both((), seed=0, evaluate=_cost_evaluate, validate=_ok_validate)
    assert t == j and "empty search space" in t[1]


def _flag_cost(profile, crash: bool):
    """A deterministic cost for any profile: a function of the flags'
    bytes and the trace scale, in the profile's headline; with ``crash``
    a quarter of the configs raise."""
    def evaluate(flags, scale, deadline_s):
        h = zlib.crc32(json.dumps(flags, sort_keys=True).encode())
        if crash and flags and h % 4 == 0:
            raise RuntimeError(f"synthetic crash {h}")
        v = 50.0 + (h % 997) / 7.0 + 3.0 * scale
        return {profile.headline: round(v, 3), "terminal_ok": h % 11 != 3,
                "aborted": False, "wall_s": round(0.01 + (h % 13) / 1000.0, 4), "shed": 0}
    return evaluate


def _flag_validate(reject_first: int):
    calls = [0]

    def validate(flags):
        calls[0] += 1
        if calls[0] <= reject_first:
            return False, "slo_breach" if calls[0] % 2 else "chaos_shed", {"n": calls[0]}
        return True, "", {"validated": dict(flags)}
    return validate


@pytest.mark.parametrize("variant", ["plain", "crash", "max_trials", "reject", "reject_all"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", PROFILE_NAMES)
def test_tune_result_equals_jax_for_every_profile(name, seed, variant):
    """Both packages' ``Autotuner`` over the same profile with the same
    injected cost model: the same ``TuneResult`` (winner, scores,
    baseline, the trials in order with their scale and score, the
    rejections) or the same ``TuneError``; the artifacts are byte-equal."""
    kw = dict(seed=seed)
    if variant == "max_trials":
        kw.update(max_trials=3, rounds=2, base_scale=0.5)
    reject = {"reject": 1, "reject_all": 99}.get(variant, 0)
    out = []
    for pkg in (JT, TT):
        prof = pkg.get_profile(name)
        try:
            out.append(pkg.Autotuner(prof, evaluate=_flag_cost(prof, variant == "crash"),
                                     validate=_flag_validate(reject), **kw).run())
        except (JT.TuneError, TT.TuneError) as exc:
            out.append(("TuneError", str(exc)))
    j, t = out
    assert _result(t) == _result(j)
    if variant == "reject_all":
        assert t[0] == "TuneError"
        return
    assert t.trials and t.trials[0]["flags"] == {}
    assert json.dumps(TT.to_artifact(t), indent=2, sort_keys=True) == json.dumps(
        JT.to_artifact(j), indent=2, sort_keys=True)


# ------------------------------------------------------------------ #
# _real_validate's decisions (run_trial stubbed: no servers)


_CLEAN = {"terminal_ok": True, "shed": 0, "failures": 0, "slo_alerting": [],
          "slo_breaches": 0}


def _validate_with(monkeypatch, slo_metrics, chaos_metrics, name="smoke"):
    got = []
    for pkg, search in ((JT, JSEARCH), (TT, TSEARCH)):
        calls = []

        def fake_run_trial(profile, flags, _calls=calls, **kw):
            _calls.append((dict(flags), {k: v for k, v in kw.items() if k != "device"}))
            return dict(slo_metrics if kw.get("arm_slo") else chaos_metrics)

        monkeypatch.setattr(search.profiles_mod, "run_trial", fake_run_trial)
        got.append((pkg.Autotuner(pkg.get_profile(name), seed=0)._real_validate(
            {CHUNK: "64"}), calls))
    assert got[1] == got[0]
    return got[1]


def test_real_validate_accepts_clean_runs(monkeypatch):
    (ok, reason, detail), calls = _validate_with(monkeypatch, _CLEAN, _CLEAN)
    assert ok and reason == "" and set(detail) == {"slo", "chaos"}
    slo_flags, slo_kw = calls[0]
    assert slo_kw.get("arm_slo") is True
    chaos_flags, _ = calls[1]
    assert chaos_flags["PATHWAY_TPU_CHAOS_SITES"] == "decode.admit"
    assert float(chaos_flags["PATHWAY_TPU_CHAOS"]) == 0.25


@pytest.mark.parametrize("slo_m,chaos_m,want", [
    ({"slo_alerting": ["e2e_p95_ms"]}, {}, "slo_breach"),
    ({"slo_breaches": 1}, {}, "slo_breach"),
    ({"shed": 2}, {}, "slo_leg_shed_or_failed"),
    ({"failures": 1}, {}, "slo_leg_shed_or_failed"),
    ({"terminal_ok": False}, {}, "slo_leg_not_terminal"),
    ({}, {"shed": 1}, "chaos_shed"),
    ({}, {"terminal_ok": False}, "chaos_not_terminal"),
])
def test_real_validate_rejections(monkeypatch, slo_m, chaos_m, want):
    (ok, reason, _), _ = _validate_with(monkeypatch, {**_CLEAN, **slo_m},
                                        {**_CLEAN, **chaos_m})
    assert not ok and reason == want


def test_real_validate_skips_chaos_without_fault_surface(monkeypatch):
    (ok, reason, detail), calls = _validate_with(monkeypatch, _CLEAN, _CLEAN,
                                                 name="retraction_heavy_ingest")
    assert ok and len(calls) == 1 and "chaos" not in detail


def test_chaos_rate_is_an_argument(monkeypatch):
    calls = []

    def fake_run_trial(profile, flags, **kw):
        calls.append(dict(flags))
        return dict(_CLEAN)

    monkeypatch.setattr(TSEARCH.profiles_mod, "run_trial", fake_run_trial)
    TT.Autotuner("smoke", seed=4, chaos_rate=0.5)._real_validate({})
    assert calls[1]["PATHWAY_TPU_CHAOS"] == "0.5"
    assert calls[1]["PATHWAY_TPU_CHAOS_SEED"] == "11"


# ------------------------------------------------------------------ #
# artifacts: both directions, the loader's errors


def _write_artifact(tmp_path, flags, name="tuned.json", **extra):
    path = tmp_path / name
    path.write_text(json.dumps({"version": 1, "flags": flags, **extra}))
    return str(path)


def test_artifacts_load_in_both_packages(tmp_path):
    j = JT.Autotuner(_synthetic_profile(JT, (CHUNK, SPEC_K)), seed=0,
                     evaluate=_cost_evaluate, validate=_ok_validate).run()
    t = TT.Autotuner(_synthetic_profile(TT, (CHUNK, SPEC_K)), seed=0,
                     evaluate=_cost_evaluate, validate=_ok_validate).run()
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    JT.save_artifact(j, jpath)
    TT.save_artifact(t, tpath)
    assert Path(jpath).read_bytes() == Path(tpath).read_bytes()
    art = json.loads(Path(tpath).read_text())
    assert art["version"] == TSEARCH.ARTIFACT_VERSION == JSEARCH.ARTIFACT_VERSION
    assert TC.load_tuned_config(jpath) == j.winner == {CHUNK: "128", SPEC_K: "8"}
    assert JC.load_tuned_config(tpath) == t.winner
    assert TT.to_artifact(t)["flags"] == t.winner


def test_tuned_config_missing_file_is_loud(tmp_path):
    with pytest.raises(TC.TunedConfigError, match="absent.json"):
        TC.load_tuned_config(str(tmp_path / "absent.json"))


@pytest.mark.parametrize("flags,match", [
    ({"PATHWAY_TPU_NOT_A_FLAG": "1"}, "NOT_A_FLAG"),
    ({SPEC_K: "banana"}, "does not parse"),
    ({"PATHWAY_TPU_TUNED_CONFIG": "other.json"}, "TUNED_CONFIG"),
])
def test_tuned_config_loader_errors_as_jax(tmp_path, flags, match):
    path = _write_artifact(tmp_path, flags)
    with pytest.raises(JC.TunedConfigError):
        JC.load_tuned_config(path)
    with pytest.raises(TC.TunedConfigError, match=match):
        TC.load_tuned_config(path)


def test_tuned_config_rejects_non_object(tmp_path):
    path = tmp_path / "bad.json"
    for text in ("[1, 2, 3]", '{"flags": [1]}', "{not json"):
        path.write_text(text)
        with pytest.raises(JC.TunedConfigError):
            JC.load_tuned_config(str(path))
        with pytest.raises(TC.TunedConfigError):
            TC.load_tuned_config(str(path))


@pytest.mark.parametrize("env", ["PATHWAY_TPU_FLASH_BLOCK_Q", "PATHWAY_TPU_FLASH_BLOCK_K"])
def test_pallas_tile_flags_are_refused_by_name(tmp_path, env):
    """JAX loads them (they set the Pallas tiles); the CUDA kernels choose
    their own tiles, so the port refuses them loudly rather than ignore
    them."""
    path = _write_artifact(tmp_path, {env: "128", CHUNK: "128"})
    assert JC.load_tuned_config(path) == {env: "128", CHUNK: "128"}
    with pytest.raises(TC.TunedConfigError, match=env + ".*no counterpart"):
        TC.load_tuned_config(path)


def test_bool_values_normalize_as_jax(tmp_path):
    path = _write_artifact(tmp_path, {"PATHWAY_TPU_SPEC_DECODE": False, SPEC_K: 5})
    assert TC.load_tuned_config(path) == JC.load_tuned_config(path) == {
        "PATHWAY_TPU_SPEC_DECODE": "0", SPEC_K: "5"}


# ------------------------------------------------------------------ #
# precedence: explicit argument > artifact > default


_DCFG = None


def _tiny_decoder():
    from pathway_tpu_torch.models import decoder as TD

    global _DCFG
    if _DCFG is None:
        cfg = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
                               max_position=128, dtype=torch.float32)
        _DCFG = (cfg, TD.init_params(torch.Generator().manual_seed(0), cfg))
    return _DCFG


def _chat(**kw):
    from pathway_tpu_torch.xpacks.llm import DecoderChat

    cfg, params = _tiny_decoder()
    chat = DecoderChat(params=params, cfg=cfg, tokenizer=TPROF._CharTok(), max_new_tokens=4,
                       max_prompt_tokens=32, continuous=True, n_slots=2, device="cpu", **kw)
    chat.close()
    return chat.server


def test_unset_tuned_config_means_defaults():
    srv = _chat()
    assert (srv.prefill_chunk, srv.spec_k, srv.batch_admit, srv._retry_budget) == (64, 3, True, 1)
    assert TC.tuned_config_snapshot() == {"enabled": False, "path": None, "paths": [],
                                          "flags": {}, "shadowed_by_args": []}
    assert probes.unified_snapshot()["tuning"]["enabled"] is False


def test_decoder_chat_precedence_and_snapshot(tmp_path):
    path = _write_artifact(tmp_path, {CHUNK: "128", SPEC_K: "6",
                                      "PATHWAY_TPU_BATCH_ADMIT": "0",
                                      "PATHWAY_TPU_SERVE_RETRIES": "3"})
    srv = _chat(tuned_config=path)
    assert (srv.prefill_chunk, srv.spec_k, srv.batch_admit, srv._retry_budget) == (
        128, 6, False, 3)
    snap = probes.unified_snapshot()["tuning"]
    assert snap["enabled"] and snap["path"] == path and snap["shadowed_by_args"] == []
    assert snap["flags"] == {CHUNK: "128", SPEC_K: "6", "PATHWAY_TPU_BATCH_ADMIT": "0",
                             "PATHWAY_TPU_SERVE_RETRIES": "3"}
    # an explicit argument wins, knob by knob, and is listed as shadowing
    srv = _chat(tuned_config=path, spec_k=2, batch_admit=True)
    assert (srv.prefill_chunk, srv.spec_k, srv.batch_admit) == (128, 2, True)
    snap = TC.tuned_config_snapshot()
    assert snap["shadowed_by_args"] == ["PATHWAY_TPU_BATCH_ADMIT", SPEC_K]


def test_jax_written_artifact_configures_a_port_chat(tmp_path):
    j = JT.Autotuner(_synthetic_profile(JT, (CHUNK, SPEC_K)), seed=0,
                     evaluate=_cost_evaluate, validate=_ok_validate).run()
    path = JT.save_artifact(j, str(tmp_path / "jax.json"))
    srv = _chat(tuned_config=path)
    assert (srv.prefill_chunk, srv.spec_k) == (128, 8)
    srv = _chat(tuned_config=path, prefill_chunk=32)
    assert (srv.prefill_chunk, srv.spec_k) == (32, 8)


def test_other_constructors_take_tuned_config(tmp_path):
    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.models.transformer import MINILM_L6
    from pathway_tpu_torch.ops.query_server import QueryServer

    path = _write_artifact(tmp_path, {"PATHWAY_TPU_PIPELINE_DEPTH": "4",
                                      "PATHWAY_TPU_PIPELINE_QUEUE": "16",
                                      "PATHWAY_TPU_QUERY_TICK_MS": "4.0",
                                      "PATHWAY_TPU_QUERY_MAX_BATCH": "32",
                                      "PATHWAY_TPU_DRAIN_COALESCE_MAX": "16"})
    cfg = dataclasses.replace(MINILM_L6, **TPROF._INGEST_CFG)
    for kw, want in (({}, (2, 8)), ({"tuned_config": path}, (4, 16)),
                     ({"tuned_config": path, "pipeline_queue": 2}, (4, 2))):
        m = SentenceEmbedderModel(cfg=cfg, device="cpu", **kw)
        assert (m.pipeline_depth, m.pipeline_queue) == want
        m.close()
    for kw, want in (({}, (0.002, 64)), ({"tuned_config": path}, (0.004, 32)),
                     ({"tuned_config": path, "max_batch": 8}, (0.004, 8))):
        with QueryServer(object(), **kw) as srv:
            assert (srv.tick_s, srv.max_batch) == want
    assert TC.EngineConfig().drain_coalesce_max == 8
    assert TC.EngineConfig(tuned_config=path).drain_coalesce_max == 16
    assert TC.EngineConfig(tuned_config=path, drain_coalesce_max=2).drain_coalesce_max == 2
    snap = TC.tuned_config_snapshot()
    assert snap["paths"] == [path]
    assert snap["shadowed_by_args"] == ["PATHWAY_TPU_DRAIN_COALESCE_MAX",
                                        "PATHWAY_TPU_PIPELINE_QUEUE",
                                        "PATHWAY_TPU_QUERY_MAX_BATCH"]


def test_refused_flag_fails_the_constructor(tmp_path):
    path = _write_artifact(tmp_path, {"PATHWAY_TPU_FLASH_BLOCK_K": "64"})
    with pytest.raises(TC.TunedConfigError, match="FLASH_BLOCK_K"):
        _chat(tuned_config=path)


# ------------------------------------------------------------------ #
# the real run_trial on the CPU


def _jax_trial_keys(fn_name: str) -> set[str]:
    """The keys of the dict JAX's trial function returns, read from its
    source (JAX's continuous server is never driven here)."""
    tree = ast.parse(Path(JPROF.__file__).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


@pytest.fixture
def captured_chats(monkeypatch):
    from pathway_tpu_torch.xpacks.llm import llms

    chats, real = [], llms.DecoderChat

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            chats.append(self)
            self.reqs = []
            submit = self.submit_batch

            def rec(*sa, **skw):
                out = submit(*sa, **skw)
                self.reqs.extend(out)
                return out
            self.submit_batch = rec

    monkeypatch.setattr(llms, "DecoderChat", Recording)
    return chats


def test_run_trial_smoke_on_the_cpu(captured_chats):
    prof = TT.PROFILES["smoke"]
    m = TT.run_trial("smoke", {CHUNK: "128"}, scale=1.0, device="cpu")
    assert set(m) == _jax_trial_keys("_serving_trial")
    assert m["terminal_ok"] and not m["aborted"] and m["requests"] == prof.nreq
    assert m["failures"] == m["shed"] == 0 and m["tok_s"] > 0
    (chat,) = captured_chats
    assert chat.server.prefill_chunk == 128
    timed = chat.reqs[1:]  # the first is the warm-up request
    assert len(timed) == prof.nreq
    assert sum(len(r.tokens) for r in timed) == prof.nreq * prof.max_new


def test_run_trial_ingest_on_the_cpu():
    prof = TT.PROFILES["retraction_heavy_ingest"]
    m = TT.run_trial(prof, {"PATHWAY_TPU_PIPELINE_DEPTH": "4"}, scale=0.5, device="cpu")
    assert set(m) == _jax_trial_keys("_ingest_trial")
    assert m["terminal_ok"] and m["requests"] == int(round(prof.rows * 0.5))
    assert m["rows_per_s"] > 0


def test_trials_restore_chaos_and_slo_settings(captured_chats):
    """A chaos leg and an SLO leg each arm the module-wide settings for
    their own trial only: after either, chaos and the SLO objectives are
    back to what they were (the defaults)."""
    chaos_before, slo_before = chaos.settings(), slo.settings()
    tuner = TT.Autotuner("smoke", seed=0, base_scale=0.5, device="cpu")
    ok, reason, detail = tuner._real_validate({CHUNK: "32"})
    assert chaos.settings() == chaos_before == {"rate": 0.0, "seed": 0, "sites": ""}
    assert slo.settings() == slo_before
    assert ok, (reason, detail)
    assert detail["slo"]["slo_alerting"] == [] and detail["chaos"]["terminal_ok"]
    slo_chat, chaos_chat = captured_chats
    assert slo_chat.server._chaos_admit is None
    assert chaos_chat.server._chaos_admit is not None
    assert chaos_chat.server._chaos_admit.rate == 0.25
    assert chaos_chat.server._restart_budget == 2 and chaos_chat.server._retry_budget == 4


def test_trial_restores_settings_when_it_fails(monkeypatch):
    def boom(*a, **kw):
        assert chaos.settings()["rate"] == 0.5
        raise RuntimeError("server did not build")

    monkeypatch.setattr(TPROF, "_serving_trial", boom)
    with pytest.raises(RuntimeError, match="did not build"):
        TT.run_trial("smoke", {"PATHWAY_TPU_CHAOS": "0.5",
                               "PATHWAY_TPU_SLO_E2E_P95_MS": "100"}, device="cpu")
    assert chaos.settings()["rate"] == 0.0 and slo.settings()["e2e_p95_ms"] == 0.0


def test_decoder_resources_are_torch_drawn_and_shared():
    params, cfg, tok = TT.decoder_resources("cpu")
    assert (cfg.vocab_size, cfg.hidden, cfg.layers, cfg.heads, cfg.max_position) == (
        128, 32, 4, 4, 256)
    assert cfg.dtype == torch.float32 and tok.eos_id is None
    assert TT.decoder_resources("cpu")[0] is params


# ------------------------------------------------------------------ #
# the CLI's tune


def test_cli_tune_smoke_end_to_end(tmp_path, capsys):
    out = str(tmp_path / "tuned-smoke.json")
    assert tcli.main(["tune", "smoke", "--smoke", "--device", "cpu", "--out", out]) == 0
    cap = capsys.readouterr()
    summary = json.loads(cap.out[cap.out.index("{"):cap.out.rindex("}") + 1])
    assert summary["profile"] == "smoke" and summary["artifact"] == out
    assert summary["trials"] >= 2
    assert "tuned_config=" in cap.err and "export" not in cap.err
    flags = TC.load_tuned_config(out)
    assert JC.load_tuned_config(out) == flags
    for env, raw in flags.items():
        assert TC.KNOBS_BY_ENV[env].tunable.contains(raw), (env, raw)
        assert JC._REGISTRY_BY_ENV[env].tunable.contains(raw), (env, raw)


def test_cli_tune_unknown_profile_exits_2(capsys):
    assert tcli.main(["tune", "nope"]) == 2
    assert "unknown profile" in capsys.readouterr().err


def test_cli_tune_all_rejected_exits_3(monkeypatch, capsys):
    class _Failing:
        def __init__(self, *a, **kw):
            pass

        def run(self):
            raise TT.TuneError("no candidate survived validation")

    monkeypatch.setattr(TT, "Autotuner", _Failing)
    assert tcli.main(["tune", "smoke", "--smoke", "--device", "cpu"]) == 3
    assert "tune failed" in capsys.readouterr().err
