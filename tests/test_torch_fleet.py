"""The port's serving fleet (``pathway_tpu_torch/serving/``) after
tests/test_fleet.py.

* the router and the manager on scripted fake replicas with an injected
  clock: affinity, round-robin, ring metrics, failover, in-flight
  re-queue, sheds, drain and respawn, boot grace, bounded backoff,
  elasticity, state, and the ``RouterServer`` routes over localhost;
* the ``router.forward`` and ``replica.health`` chaos sites fault on the
  same operations as the JAX package's for the same seed;
* ``build_fleet`` constructs nothing while the fleet is off;
* a fleet of two ``InProcessReplica`` over the port's CPU ``DecoderChat``
  keeps each shared head on one replica, hits its prefix cache, and serves
  the streams of a single server and of JAX static ``generate``.
* ``HttpReplica`` beside JAX's on one fake replica server (statuses,
  payloads, ``healthy()``, ``ReplicaError``), the replica environment
  contract of ``spawn_replica_process`` equal to JAX's, and the port's
  ``HttpReplica`` over real CPU child processes: probed, scraped,
  forwarded to and stopped; killed and respawned by a ``FleetManager``;
  and behind ``python -m pathway_tpu_torch fleet serve``.

Every wait is bounded.
"""

import http.server
import json
import socketserver
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as JD
from pathway_tpu.serving.fleet import FleetManager as JFleetManager
from pathway_tpu.serving.router import FleetRouter as JFleetRouter
from pathway_tpu_torch import serving
from pathway_tpu_torch.engine import chaos, probes
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.serving import (
    FleetManager,
    FleetRouter,
    InProcessReplica,
    ReplicaError,
    RouterServer,
    build_fleet,
)
from pathway_tpu_torch.xpacks.llm import DecoderChat
from tests.utils import ToyCharTokenizer

WAIT = 60.0
NEW = 6
JCFG = JD.DecoderConfig(vocab_size=128, hidden=64, layers=2, heads=4,
                        intermediate=128, max_position=128, dtype=jnp.float32)
TCFG = TD.DecoderConfig(vocab_size=128, hidden=64, layers=2, heads=4,
                        intermediate=128, max_position=128, dtype=torch.float32)
TOK = ToyCharTokenizer(96)


@pytest.fixture(autouse=True)
def _defaults():
    chaos.configure()
    serving.configure()
    yield
    chaos.configure()
    serving.configure()


# ---- scripted fakes ----------------------------------------------------


class _FakeReq:
    def __init__(self, text="ok", error_reason=None):
        self.done = threading.Event()
        self.text = text
        self.tokens = [1, 2]
        self.error_reason = error_reason
        self.done.set()


class _FakeReplica:
    kind = "fake"

    def __init__(self, replica_id, *, alive=True, burn=0.0):
        self.replica_id = replica_id
        self.alive = alive
        self.burn = burn
        self.no_objectives = False
        self.submit_raises = False
        self.dead_mid_flight = False
        self.submitted = []
        self.stopped = False

    def submit(self, prompt, max_new=None, *, priority=1):
        if self.submit_raises:
            raise ReplicaError(f"{self.replica_id} loop dead")
        self.submitted.append(prompt)
        if self.dead_mid_flight:
            return _FakeReq(text=None)
        return _FakeReq(text=f"{self.replica_id}:{prompt}")

    def forward(self, path, body):
        if self.submit_raises:
            raise ReplicaError("down")
        return 200, json.dumps({"by": self.replica_id}).encode(), "application/json"

    def healthy(self):
        return self.alive

    def scrape(self):
        if self.no_objectives:
            return {"slo": {"objectives": {}}}
        return {"slo": {"objectives": {"ttft": {"burn_fast": self.burn,
                                                "burn_slow": self.burn}}}}

    def stop(self):
        self.stopped = True


def _router(n, cls=FleetRouter, **kwargs):
    kwargs.setdefault("affinity_blocks", 4)
    kwargs.setdefault("block", 8)
    router = cls(vnodes=32, **kwargs)
    reps = [_FakeReplica(f"replica-{i}") for i in range(n)]
    for r in reps:
        router.add_replica(r)
    return router, reps


def _manager(n=2, state=None, cls=FleetManager, **kwargs):
    state = state if state is not None else {}
    state.setdefault("made", [])

    def factory(rid):
        rep = _FakeReplica(rid)
        state["made"].append(rep)
        return rep

    kwargs.setdefault("replicas", n)
    kwargs.setdefault("min_replicas", 1)
    kwargs.setdefault("max_replicas", 4)
    kwargs.setdefault("health_interval_s", 0.01)
    kwargs.setdefault("scale_cooldown_s", 0.0)
    kwargs.setdefault("sleep", lambda s: None)
    return cls(factory, **kwargs).start(), state


# ---- the kill switch and the defaults ------------------------------------


def test_build_fleet_off_constructs_nothing():
    assert serving.fleet_enabled() is False
    calls = []
    assert build_fleet(lambda rid: calls.append(rid)) is None
    assert calls == []
    serving.configure(enabled=True)
    manager = build_fleet(lambda rid: _FakeReplica(rid), sleep=lambda s: None)
    try:
        assert manager is not None and len(manager.router) == 2
    finally:
        manager.shutdown()


def test_defaults_are_the_jax_flag_defaults():
    m = FleetManager(lambda rid: _FakeReplica(rid))
    assert (m.initial_replicas, m.min_replicas, m.max_replicas) == (2, 1, 4)
    assert m.health_interval_s == 0.5 and m._chaos_health is None
    r = FleetRouter()
    assert r.affinity_blocks == 4 and r.block == 64 and r.ring.vnodes == 64
    assert r._chaos_forward is None


# ---- routing ----------------------------------------------------------------


def test_affinity_groups_stick_to_one_replica():
    probes.REGISTRY.remove("requests_routed")
    router, _ = _router(3)
    owners_a = {router.submit("a" * 32 + f" q{i}").replica_id for i in range(6)}
    owners_b = {router.submit("b" * 32 + f" q{i}").replica_id for i in range(6)}
    assert len(owners_a) == 1 and len(owners_b) == 1
    snap = probes.REGISTRY.snapshot()["counters"]["requests_routed"]
    assert sum(s["value"] for s in snap["series"]) == 12


def test_affinity_zero_round_robins():
    router, _ = _router(3, affinity_blocks=0)
    owners = [router.submit("x" * 32).replica_id for _ in range(9)]
    assert set(owners) == {"replica-0", "replica-1", "replica-2"}


def test_candidates_equal_jax():
    """The same members, prompts and ring give the same candidate order."""
    rng = np.random.default_rng(3)
    prompts = ["".join(rng.choice(list("abcdef"), rng.integers(1, 60))) for _ in range(100)]
    for aff in (4, 0):
        t, _ = _router(4, affinity_blocks=aff)
        j, _ = _router(4, cls=JFleetRouter, affinity_blocks=aff)
        assert [t.candidates(p) for p in prompts] == [j.candidates(p) for p in prompts]


def test_ring_metrics_on_membership_change():
    probes.REGISTRY.remove("ring_moves", "replica_up")
    router, _ = _router(2)
    snap = probes.REGISTRY.snapshot()
    assert snap["counters"]["ring_moves"]["series"][0]["value"] == 64
    up = {s["labels"]["replica"]: s["value"] for s in snap["gauges"]["replica_up"]["series"]}
    assert up == {"replica-0": 1.0, "replica-1": 1.0}
    router.remove_replica("replica-0")
    snap = probes.REGISTRY.snapshot()
    assert snap["counters"]["ring_moves"]["series"][0]["value"] == 96
    up = {s["labels"]["replica"]: s["value"] for s in snap["gauges"]["replica_up"]["series"]}
    assert up["replica-0"] == 0.0


def test_dispatch_skips_dead_replica():
    router, _ = _router(2)
    owner = router.submit("y" * 32 + " q").replica_id
    router.get(owner).submit_raises = True
    fc = router.submit("y" * 32 + " q2")
    assert fc.replica_id is not None and fc.replica_id != owner
    assert fc.wait(timeout=5) and fc.text is not None


def test_mid_flight_death_requeues_on_next_candidate():
    probes.REGISTRY.remove("requests_requeued")
    router, _ = _router(2)
    fc = router.submit("z" * 32 + " q")
    owner = fc.replica_id
    fc._req.text = None
    fc._req.error_reason = None
    assert fc.wait(timeout=5)
    assert fc.text is not None and fc.replica_id != owner
    assert fc.attempts[0] == owner and len(fc.attempts) == 2
    assert probes.REGISTRY.snapshot()["counters"]["requests_requeued"]["series"][0]["value"] == 1


def test_finished_request_is_not_requeued():
    """A replica that dies after answering does not get the request sent
    again: the answer is terminal."""
    router, _ = _router(2)
    fc = router.submit("f" * 32)
    router.get(fc.replica_id).alive = False
    assert fc.wait(timeout=5)
    assert fc.text is not None and len(fc.attempts) == 1
    assert sum(len(r.submitted) for r in router.replicas().values()) == 1


def test_shed_is_terminal_not_retried():
    router, _ = _router(2)
    fc = router.submit("w" * 32)
    fc._req.text = None
    fc._req.error_reason = "shed:deadline"
    assert fc.wait(timeout=5)
    assert fc.error_reason == "shed:deadline" and len(fc.attempts) == 1


def test_all_replicas_dead_is_terminal_no_replica():
    router, reps = _router(2)
    for r in reps:
        r.submit_raises = True
    fc = router.submit("v" * 32)
    assert fc.wait(timeout=5)
    assert fc.text is None and fc.error_reason == "fleet:no_replica"


def test_wait_times_out_unresolved():
    router, _ = _router(1)
    fc = router.submit("t" * 32)
    fc._req.done.clear()
    assert fc.wait(timeout=0.05) is False and not fc.done.is_set()


# ---- the manager --------------------------------------------------------------


def test_health_pass_drains_and_respawns_dead_replica():
    manager, state = _manager(2)
    victim = state["made"][0]
    victim.alive = False
    assert manager.health_pass() == [victim.replica_id]
    assert victim.stopped
    assert victim.replica_id not in manager.router.ring.members()
    assert len(manager.router) == 2
    st = manager.state()
    assert st["respawns"] == 1 and ("drain", victim.replica_id) in st["events"]
    assert ("respawn", "replica-2") in st["events"]


def test_fail_threshold_counts_consecutive_failures():
    manager, state = _manager(1, fail_threshold=2)
    rep = state["made"][0]
    rep.alive = False
    assert manager.health_pass() == []
    assert manager.state()["replicas"][rep.replica_id]["consecutive_failures"] == 1
    rep.alive = True
    assert manager.health_pass() == []
    rep.alive = False
    assert manager.health_pass() == []
    assert manager.health_pass() == [rep.replica_id]


def test_boot_grace_shields_never_ready_replica():
    now = {"t": 0.0}
    manager, state = _manager(2, boot_grace_s=30.0, clock=lambda: now["t"])
    booting = state["made"][0]
    booting.alive = False
    assert manager.health_pass() == []
    assert len(manager.router) == 2
    now["t"] = 31.0
    assert manager.health_pass() == [booting.replica_id]
    assert len(manager.router) == 2
    ready_once = state["made"][1]
    assert manager.health_pass() == []
    ready_once.alive = False
    assert manager.health_pass() == [ready_once.replica_id]


def test_boot_grace_does_not_shield_an_exited_process():
    """A process replica that died while booting is drained at once; a
    live one still gets its grace."""
    class _Proc:
        def __init__(self, rc):
            self.rc = rc

        def poll(self):
            return self.rc

    now = {"t": 0.0}
    manager, state = _manager(2, boot_grace_s=30.0, clock=lambda: now["t"])
    dead, live = state["made"]
    dead.alive = live.alive = False
    dead.proc, live.proc = _Proc(1), _Proc(None)
    assert manager.health_pass() == [dead.replica_id]
    assert live.replica_id in manager.router.replicas() and len(manager.router) == 2


def test_respawn_uses_bounded_backoff():
    sleeps, attempts, made = [], {"n": 0}, []

    def flaky(rid):
        attempts["n"] += 1
        if attempts["n"] <= 2:
            raise RuntimeError("spawn hiccup")
        rep = _FakeReplica(rid)
        made.append(rep)
        return rep

    manager = FleetManager(flaky, replicas=0, min_replicas=0, max_replicas=4,
                           sleep=sleeps.append)
    assert manager._respawn_replica() is not None
    assert attempts["n"] == 3 and len(sleeps) == 2 and sleeps[1] > sleeps[0]
    assert sleeps == [0.05, 0.1]  # 50 ms doubling, no jitter


def test_respawn_gives_up_after_its_budget():
    def broken(rid):
        raise RuntimeError("no capacity")

    manager = FleetManager(broken, replicas=0, min_replicas=0, sleep=lambda s: None)
    assert manager._respawn_replica() is None
    assert ("respawn_failed", None) in manager.state()["events"]


def test_elasticity_scales_up_on_burn_and_down_on_quiescence():
    clock = {"t": 0.0}
    manager, _ = _manager(2, scale_cooldown_s=5.0, clock=lambda: clock["t"])
    clock["t"] = 10.0
    for rep in manager.router.replicas().values():
        rep.burn = 2.0
    assert manager.elasticity_pass() == "scale_up" and len(manager.router) == 3
    assert manager.elasticity_pass() is None  # cooldown
    clock["t"] = 20.0
    for rep in manager.router.replicas().values():
        rep.burn = 0.0
    assert manager.elasticity_pass() == "scale_down" and len(manager.router) == 2
    assert "replica-2" not in manager.router.replicas()  # the newest went
    clock["t"] = 30.0
    manager.min_replicas = 2
    assert manager.elasticity_pass() is None and len(manager.router) == 2


def test_elasticity_inert_without_slo_objectives():
    manager, state = _manager(2)
    for rep in state["made"]:
        rep.no_objectives = True
    assert manager.elasticity_pass() is None and len(manager.router) == 2
    state["made"][0].no_objectives = False
    assert manager.elasticity_pass() == "scale_down" and len(manager.router) == 1


def test_elasticity_respects_max_replicas():
    clock = {"t": 100.0}
    manager, _ = _manager(2, max_replicas=2, clock=lambda: clock["t"])
    for rep in manager.router.replicas().values():
        rep.burn = 5.0
    assert manager.elasticity_pass() is None and len(manager.router) == 2


def test_tick_state_and_shutdown():
    manager, state = _manager(2, min_replicas=2)
    state["made"][1].alive = False
    out = manager.tick()  # a drain and a respawn; a cold fleet at its floor
    assert out == {"drained": ["replica-1"], "scale": None, "size": 2}
    st = manager.state()
    assert st["size"] == 2 and set(st["replicas"]) == set(st["ring_members"])
    assert (st["min"], st["max"], st["respawns"]) == (2, 4, 1)
    manager.shutdown()
    assert len(manager.router) == 0 and all(r.stopped for r in state["made"])


def test_run_in_thread_supervises_and_stops():
    manager, state = _manager(2)
    state["made"][0].alive = False
    manager.run_in_thread()
    try:
        ev = threading.Event()
        for _ in range(500):
            if manager.state()["respawns"] >= 1:
                ev.set()
                break
            ev.wait(0.01)
        assert ev.is_set(), "the supervisor thread never drained the dead replica"
    finally:
        manager.shutdown()
    assert manager._thread is None


# ---- chaos sites: the JAX schedule --------------------------------------------


@pytest.mark.parametrize("rate,seed", [(0.3, 0), (0.5, 3), (1.0, 7)])
def test_router_forward_chaos_schedule_equals_jax(monkeypatch, rate, seed):
    monkeypatch.setenv("PATHWAY_TPU_CHAOS", str(rate))
    monkeypatch.setenv("PATHWAY_TPU_CHAOS_SITES", "router.forward")
    monkeypatch.setenv("PATHWAY_TPU_CHAOS_SEED", str(seed))
    chaos.configure(rate=rate, seed=seed, sites="router.forward")
    t, _ = _router(3)
    j, _ = _router(3, cls=JFleetRouter)
    assert t._chaos_forward is not None and j._chaos_forward is not None
    prompts = [c * 32 + f" q{i}" for i, c in enumerate("abcdefghijklmnop")]
    tfc = [t.submit(p) for p in prompts]
    jfc = [j.submit(p) for p in prompts]
    for a, b in zip(tfc, jfc):
        assert a.wait(timeout=5) and b.wait(timeout=5)
        assert (a.attempts, a.replica_id, a.error_reason) == (b.attempts, b.replica_id,
                                                              b.error_reason)
    if rate == 1.0:
        assert all(fc.error_reason == "fleet:no_replica" and len(fc.attempts) == 3
                   for fc in tfc)


@pytest.mark.parametrize("rate,seed", [(0.3, 7), (1.0, 7)])
def test_replica_health_chaos_schedule_equals_jax(monkeypatch, rate, seed):
    monkeypatch.setenv("PATHWAY_TPU_CHAOS", str(rate))
    monkeypatch.setenv("PATHWAY_TPU_CHAOS_SITES", "replica.health")
    monkeypatch.setenv("PATHWAY_TPU_CHAOS_SEED", str(seed))
    chaos.configure(rate=rate, seed=seed, sites="replica.health")
    t, _ = _manager(2)
    j, _ = _manager(2, cls=JFleetManager)
    assert t._chaos_health is not None and j._chaos_health is not None
    for _ in range(6):
        assert t.health_pass() == j.health_pass()
        assert len(t.router) == len(j.router) == 2
    assert t.state()["events"] == j.state()["events"]
    if rate == 1.0:
        assert t.state()["respawns"] == 12


# ---- the HTTP front end ------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_router_server_routes():
    router, reps = _router(2)
    srv = RouterServer(router).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert _get(base + "/healthz") == (200, b"ok\n")
        assert _get(base + "/readyz")[0] == 200
        status, body = _get(base + "/metrics")
        assert status == 200 and body.decode().rstrip().endswith("# EOF")
        assert "pathway_tpu_ring_moves_total" in body.decode()
        status, body = _get(base + "/v1/fleet")
        assert status == 200 and json.loads(body)["size"] == 2
        assert _get(base + "/nope")[0] == 404
        data = json.dumps({"prompt": "p" * 32}).encode()
        owner = router.candidates("p" * 32)[0]
        req = urllib.request.Request(base + "/v1/pw_ai_answer", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert json.loads(r.read()) == {"by": owner}
        router.get(owner).submit_raises = True  # forward fails: next candidate
        with urllib.request.urlopen(req, timeout=5) as r:
            assert json.loads(r.read())["by"] != owner
        for r in reps:
            r.submit_raises = True
        try:
            urllib.request.urlopen(req, timeout=5)
            raise AssertionError("expected 502")
        except urllib.error.HTTPError as e:
            assert e.code == 502
        for rid in list(router.replicas()):
            router.remove_replica(rid)
        assert _get(base + "/readyz")[0] == 503
    finally:
        srv.stop()


# ---- a fleet of in-process replicas ------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams))


HEADS = ["alpha context " * 3, "beta background " * 2]  # 42 and 32 chars
PROMPTS = [h + f"q{i} {s}" for h in HEADS for i, s in enumerate(("why", "how so", "when?"))]


def _chat(tparams, **kw):
    return DecoderChat(params=tparams, cfg=TCFG, tokenizer=TOK, max_new_tokens=NEW,
                       max_prompt_tokens=96, continuous=True, n_slots=2, chunk_steps=4,
                       pipeline_depth=2, prefill_chunk=8, device="cpu", **kw)


def test_inprocess_fleet_streams_and_affinity(jparams, tparams):
    single = _chat(tparams)
    try:
        ref = [single.submit_batch([p])[0] for p in PROMPTS]
        for r in ref:
            assert r.done.wait(WAIT)
    finally:
        single.close()
    truth = [np.asarray(JD.generate(jparams, jnp.asarray([TOK.encode(p)], jnp.int32),
                                    jnp.ones((1, len(TOK.encode(p))), jnp.int32), JCFG,
                                    NEW))[0].tolist() for p in PROMPTS]
    assert [r.tokens for r in ref] == truth

    chats = {}

    def factory(rid):
        chats[rid] = _chat(tparams)
        return InProcessReplica(rid, chats[rid])

    serving.configure(enabled=True)
    manager = build_fleet(factory, router=FleetRouter(block=8, tokenize=TOK.encode))
    try:
        assert len(manager.router) == 2
        rep = manager.router.get("replica-0")
        assert rep.healthy() and rep.occupancy() == 0.0
        snap = rep.scrape()
        assert set(snap) == {"server", "lanes", "tenants", "slo"}
        out = []
        for head in HEADS:  # each head's first request warms its replica's cache
            group = [p for p in PROMPTS if p.startswith(head)]
            first = manager.router.submit(group[0])
            assert first.wait(WAIT)
            rest = [manager.router.submit(p) for p in group[1:]]
            for fc in rest:
                assert fc.wait(WAIT)
            out += [first] + rest
            assert len({fc.replica_id for fc in [first] + rest}) == 1
        assert [fc.tokens for fc in out] == truth
        assert all(fc.error_reason is None for fc in out)
        hits = sum(c.server.stats["prefix_hit_requests"] for c in chats.values())
        assert hits == len(PROMPTS) - len(HEADS)
        manager.tick()  # all healthy, no objective: nothing moves
        assert manager.state()["events"] == [("spawn", "replica-0"), ("spawn", "replica-1")]
    finally:
        manager.shutdown()
    assert all(not c.server.thread.is_alive() for c in chats.values())


def test_dead_replica_is_drained_and_its_requests_fail_over(tparams):
    chats = {}

    def factory(rid):
        chats[rid] = _chat(tparams)
        return InProcessReplica(rid, chats[rid])

    manager = FleetManager(factory, router=FleetRouter(block=8, tokenize=TOK.encode),
                           sleep=lambda s: None).start()
    try:
        owner = manager.router.candidates(PROMPTS[0])[0]
        chats[owner].close()  # the owner's loop stops: submit raises
        assert not manager.router.get(owner).healthy()
        with pytest.raises(ReplicaError):
            manager.router.get(owner).submit(PROMPTS[0])
        fc = manager.router.submit(PROMPTS[0])
        assert fc.wait(WAIT) and fc.text is not None and fc.replica_id != owner
        assert manager.health_pass() == [owner]
        assert len(manager.router) == 2 and owner not in manager.router.replicas()
        again = [manager.router.submit(p) for p in PROMPTS[:3]]
        for f in again:
            assert f.wait(WAIT) and f.text is not None
    finally:
        manager.shutdown()


# ---- replicas as processes of their own (HttpReplica) ------------------------------
# The port's HttpReplica beside JAX's, both aimed at one fake replica
# server; then the port's against real CPU child processes
# (``tests/torch_replica.py``), alone, under a FleetManager, and behind
# ``python -m pathway_tpu_torch fleet serve``.

class _FakeReplicaServer(http.server.BaseHTTPRequestHandler):
    ready = True
    stats: bytes = b'{"slo": {}, "server": {"n": 1}}'

    def _send(self, status, body, ctype="application/json"):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, b"ok\n", "text/plain")
        elif self.path == "/readyz":
            self._send(200 if self.ready else 503, b"ready\n" if self.ready else b"no\n",
                       "text/plain")
        elif self.path == "/v1/statistics":
            self._send(200, self.stats)
        else:
            self._send(404, b'{"error": "nope"}')

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n)
        if self.path == "/boom":
            self._send(500, b'{"error": "boom"}')
        else:
            self._send(200, json.dumps({"path": self.path, "echo": json.loads(body)}).encode())

    def log_message(self, *a):
        pass


@pytest.fixture
def fake_replica():
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _FakeReplicaServer)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    _FakeReplicaServer.ready = True
    _FakeReplicaServer.stats = b'{"slo": {}, "server": {"n": 1}}'
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


def _http_replicas(url):
    from pathway_tpu.serving.replica import HttpReplica as JHttpReplica
    from pathway_tpu_torch.serving import HttpReplica

    return JHttpReplica("r", url, probe_timeout_s=2.0), HttpReplica("r", url, probe_timeout_s=2.0)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 - compared by kind
        return ("error", type(exc).__name__, str(exc).split(":")[0])


def test_http_replica_equals_jax_on_a_fake_replica(fake_replica):
    j, t = _http_replicas(fake_replica)
    body = json.dumps({"prompt": "hello"}).encode()
    for route in ("/v1/pw_ai_answer", "/v1/retrieve", "/boom", "/missing"):
        assert t.forward(route, body) == j.forward(route, body)
    assert t.forward("/boom", body)[0] == 500
    assert t.healthy() is j.healthy() is True
    assert t.scrape() == j.scrape() == {"slo": {}, "server": {"n": 1}}
    _FakeReplicaServer.ready = False  # live but not ready: not routable
    assert t.healthy() is j.healthy() is False
    _FakeReplicaServer.stats = b"not json"
    assert _outcome(t.scrape) == _outcome(j.scrape) == ("error", "ReplicaError",
                                                        "replica r statistics not JSON")
    t.stop()  # no process: nothing to stop
    assert t.kind == j.kind == "http"


def test_http_replica_unreachable_equals_jax():
    from pathway_tpu_torch.serving import free_port

    j, t = _http_replicas(f"http://127.0.0.1:{free_port()}")
    assert t.healthy() is j.healthy() is False
    for fn in ("scrape",):
        assert _outcome(getattr(t, fn)) == _outcome(getattr(j, fn))
    assert _outcome(lambda: t.forward("/v1/retrieve", b"{}")) == _outcome(
        lambda: j.forward("/v1/retrieve", b"{}"))
    assert _outcome(t.scrape)[1] == "ReplicaError"


def test_spawn_replica_process_env_contract_equals_jax(tmp_path, monkeypatch):
    import subprocess
    import sys

    from pathway_tpu.serving.replica import spawn_replica_process as jspawn
    from pathway_tpu_torch.serving import spawn_replica_process

    monkeypatch.setenv("PATHWAY_TPU_METRICS", "1")  # only for JAX's snapshot
    code = ("import json, os, sys; json.dump({k: v for k, v in os.environ.items() "
            "if k.startswith('PATHWAY_') and not k.startswith('PATHWAY_TPU_')}, "
            "open(sys.argv[1], 'w'))")
    out = {}
    for name, spawn in (("jax", jspawn), ("torch", spawn_replica_process)):
        path = tmp_path / f"{name}.json"
        proc = spawn([sys.executable, "-c", code, str(path)], replica_index=3, port=12345,
                     run_id="run-1", env={"PATH": "/usr/bin:/bin", "X": "1"})
        assert proc.wait(timeout=60) == 0
        out[name] = json.loads(path.read_text())
    assert out["torch"] == out["jax"] == {
        "PATHWAY_THREADS": "1", "PATHWAY_PROCESSES": "1", "PATHWAY_PROCESS_ID": "3",
        "PATHWAY_FIRST_PORT": "12345", "PATHWAY_RUN_ID": "run-1"}
    assert isinstance(proc, subprocess.Popen)


REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


def _child_env():
    import os

    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _spawn_child(idx, tag="r", log=None):
    import sys

    from pathway_tpu_torch.serving import HttpReplica, free_port, spawn_replica_process

    port = free_port()
    proc = spawn_replica_process(
        [sys.executable, "-m", "tests.torch_replica", "--tag", tag, "--port", str(port)],
        replica_index=idx, port=port, run_id="t", env=_child_env(), cwd=str(REPO),
        stdout=log, stderr=log)
    # a generous probe timeout: a loaded test host must not drain a live child
    return HttpReplica(f"replica-{idx}", f"http://127.0.0.1:{port}", proc=proc,
                       probe_timeout_s=10.0)


def _wait(cond, what, timeout=90.0):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.timeout(180)
def test_http_replica_against_a_real_cpu_child(tmp_path):
    with open(tmp_path / "child.log", "wb") as log:
        rep = _spawn_child(0, tag="c0", log=log)
        try:
            _wait(rep.healthy, "the child's /readyz")
            snap = rep.scrape()
            assert {"serving", "hbm", "slo"} <= set(snap)
            status, body, ctype = rep.forward("/v1/pw_ai_answer",
                                              json.dumps({"prompt": "hi"}).encode())
            assert status == 200 and json.loads(body) == {"response": "c0:hi"} and "json" in ctype
            assert rep.forward("/v1/nope", b"{}")[0] == 404
        finally:
            rep.stop()
    assert rep.proc.poll() is not None and not rep.healthy()
    with pytest.raises(ReplicaError):
        rep.forward("/v1/pw_ai_answer", b"{}", timeout=5)


@pytest.mark.timeout(240)
def test_manager_respawns_a_killed_child_process(tmp_path):
    import os
    import signal as sig

    log = open(tmp_path / "children.log", "wb")
    seq = iter(range(100))
    manager = FleetManager(lambda rid: _spawn_child(next(seq), log=log), replicas=2,
                           boot_grace_s=90.0, sleep=lambda s: None).start()
    srv = RouterServer(manager.router, manager=manager).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        _wait(lambda: all(r.healthy() for r in manager.router.replicas().values()),
              "both children")
        manager.tick()
        victim, rep = sorted(manager.router.replicas().items())[0]
        os.kill(rep.proc.pid, sig.SIGKILL)
        rep.proc.wait(timeout=30)
        # the router fails over while the victim is still a member
        req = urllib.request.Request(base + "/v1/pw_ai_answer",
                                     data=json.dumps({"prompt": "q"}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read()) == {"response": "r:q"}
        assert manager.health_pass() == [victim]
        state = manager.state()
        assert state["respawns"] == 1 and len(state["replicas"]) == 2
        assert all("url" in i and "pid" in i for i in state["replicas"].values())
        _wait(lambda: all(r.healthy() for r in manager.router.replicas().values()),
              "the respawned child")
        assert victim not in manager.router.replicas()
    finally:
        srv.stop()
        manager.shutdown()
        log.close()
    assert all(r.proc.poll() is not None for r in [rep])


@pytest.mark.timeout(300)
def test_cli_fleet_serve_over_cpu_child_processes(tmp_path):
    import os
    import signal as sig
    import subprocess
    import sys
    import time

    from pathway_tpu_torch.serving import free_port

    port = free_port()
    logs = tmp_path / "replicas"
    fleet = subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch", "fleet", "serve", "--fleet", "-n", "2",
         "--port", str(port), "--boot-grace", "90", "--health-interval", "0.2",
         "--replica-log-dir", str(logs), sys.executable, "-m", "tests.torch_replica"],
        cwd=str(REPO), env=_child_env(), stderr=open(tmp_path / "fleet.log", "wb"))
    base = f"http://127.0.0.1:{port}"

    def state():
        try:
            with urllib.request.urlopen(base + "/v1/fleet", timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            return None

    def all_ready(n):
        s = state()
        if s is None or s["size"] != n:
            return False
        from pathway_tpu_torch.serving import HttpReplica

        return all(HttpReplica("x", i["url"]).healthy() for i in s["replicas"].values())

    try:
        _wait(lambda: all_ready(2), "two ready replicas")
        answers = []
        for q in ("a", "b", "c", "d"):
            req = urllib.request.Request(base + "/v1/pw_ai_answer",
                                         data=json.dumps({"prompt": q}).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                answers.append(json.loads(r.read())["response"])
        assert answers == ["r:a", "r:b", "r:c", "r:d"]
        # a replica the manager has not yet probed ready is still in its boot
        # grace (90 s here): let a few health passes (every 0.2 s) see both
        time.sleep(1.0)
        pids = {i["pid"] for i in state()["replicas"].values()}
        os.kill(sorted(pids)[0], sig.SIGKILL)
        _wait(lambda: state()["respawns"] >= 1 and all_ready(2), "the respawn")
        import contextlib
        import io

        from pathway_tpu_torch import cli

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["fleet", "stats", "--url", base]) == 0
        out = buf.getvalue()
        assert out.startswith("fleet size 2") and out.count("kind=http") == 2
        assert "respawn replica-2" in out
        survivors = {i["pid"] for i in state()["replicas"].values()}
    finally:
        fleet.send_signal(sig.SIGTERM)
        try:
            rc = fleet.wait(timeout=60)
        finally:
            if fleet.poll() is None:
                fleet.kill()
    assert rc == 0
    for pid in survivors:  # the fleet stopped its replicas
        _wait(lambda: not os.path.exists(f"/proc/{pid}") or
              open(f"/proc/{pid}/stat").read().split()[2] == "Z", f"replica {pid} to exit", 30)
    assert len(list(logs.iterdir())) == 3


@pytest.mark.timeout(300)
def test_phase21_fleet_orchestration_over_cpu_replicas(tmp_path):
    """``chip_smoke.py`` phase 21 (c)'s function over CPU replicas of
    ``tests/torch_replica.py``: both fleets up, the bursts answered and
    equal, the SIGKILL mid-burst answered or shed, the respawn, ``fleet
    stats`` listing 2 members, both fleets and every replica stopped."""
    import sys

    import chip_smoke

    launches = chip_smoke.run_fleet_processes(
        "cpu", str(tmp_path), replica=[sys.executable, "-m", "tests.torch_replica"],
        env=_child_env())
    assert set(launches) == set(chip_smoke.counters()) and not any(launches.values())
    logs = sorted(p.name for p in (tmp_path / "fleet2").iterdir())
    assert logs == ["fleet.log", "replica-0.log", "replica-1.log", "replica-2.log"]
