"""The port's serving plane: contracts, properties and the bitwise pin.

* **slot-cache, request and scheduler contracts** — the suites of
  ``tests/test_serving.py`` run against ``repro_torch.serving`` with the
  same ``MockEngine``: FIFO slot reuse, loud double-free / wrong-owner /
  use-after-free, evict-as-forced-reclaim, FIFO admission, mid-flight
  joins vs lockstep waves, overflow eviction, prefill-failure lease
  return, and (with hypothesis) conservation and slot-bound properties.
* **bitwise equivalence** — on the reduced qwen2 in fp32 on the CPU, a
  request's tokens under continuous batching equal a solo lockstep rerun
  on a fresh engine of the same width, torch against torch; the same on
  the reduced MoE trunks (dbrx-132b, deepseek-v2-236b with the absorbed
  MLA decode) at capacity factor E / k, where a decode step's whole batch
  routes as one group and no expert's capacity can overflow.
* **against JAX** — the first-token logits of ``DecodeEngine.admit``
  match the reference's prefill on the same weights and prompt.
* **launcher** — ``repro_torch.launch.serve.main`` runs in process with
  ``--device cpu`` in both modes (qwen2-7b and dbrx-132b), and raises
  without it when no card is present.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.pipeline.queue import (CLOSED, QueueClosed,  # noqa: E402
                                        TrajectoryQueue)
from repro_torch.serving import (  # noqa: E402
    DONE,
    ERRORED,
    DecodeEngine,
    KVSlotCache,
    OpenLoopTraffic,
    Request,
    Scheduler,
    SlotCacheClosed,
    SlotError,
    SlotsExhausted,
    make_requests,
)

try:  # hypothesis is a dev-extra; the contract tests below run without it
    import hypothesis
    import hypothesis.strategies as st
    from hypothesis import given

    hypothesis.settings.register_profile("ci", deadline=None, max_examples=25)
    hypothesis.settings.register_profile("dev", deadline=None,
                                         max_examples=100)
    hypothesis.settings.load_profile(
        os.environ.get("HYPOTHESIS_PROFILE", "ci"))
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False


# ---------------------------------------------------------------------------
# slot-cache contract (the ring's ownership discipline on cache rows)
# ---------------------------------------------------------------------------


def test_allocate_is_fifo_and_free_recycles_in_order():
    c = KVSlotCache(3)
    assert [c.allocate(f"r{i}") for i in range(3)] == [0, 1, 2]
    c.free(1, "r1")
    c.free(0, "r0")
    # oldest-freed first, like the ring's ticket order
    assert c.allocate("r3") == 1
    assert c.allocate("r4") == 0
    assert c.active_count == 3 and c.free_count == 0
    assert c.leases_issued == 5


def test_exhaustion_raises_instead_of_blocking():
    c = KVSlotCache(1)
    c.allocate("a")
    with pytest.raises(SlotsExhausted):
        c.allocate("b")
    c.free(0, "a")
    assert c.allocate("b") == 0


def test_double_free_and_wrong_owner_are_loud():
    c = KVSlotCache(2)
    s = c.allocate("owner")
    with pytest.raises(SlotError, match="wrong-owner"):
        c.free(s, "intruder")
    c.free(s, "owner")
    with pytest.raises(SlotError, match="double-free"):
        c.free(s, "owner")


def test_use_after_free_is_loud_on_the_read_side():
    c = KVSlotCache(2)
    s = c.allocate("a")
    c.allocate("x")  # occupy the other slot so s is the next reuse
    c.assert_owner(s, "a")
    c.free(s, "a")
    with pytest.raises(SlotError, match="use-after-free"):
        c.owner_of(s)
    # slot reused by someone else: the stale handle's check still fails
    assert c.allocate("b") == s
    with pytest.raises(SlotError, match="use-after-free"):
        c.assert_owner(s, "a")


def test_evict_reclaims_and_reports_the_owner():
    c = KVSlotCache(2)
    s = c.allocate("victim")
    c.allocate("bystander")  # occupy the other slot
    assert c.evict(s) == "victim"
    assert c.evictions == 1
    with pytest.raises(SlotError):
        c.evict(s)  # already free
    assert c.allocate("next") == s  # slot is back in the pool


def test_close_stops_leases_but_drains_active_ones():
    c = KVSlotCache(2)
    s = c.allocate("a")
    c.close()
    assert c.closed
    with pytest.raises(SlotCacheClosed):
        c.allocate("b")
    c.free(s, "a")  # draining still works
    assert c.free_count == 2


def test_slot_range_and_capacity_validation():
    with pytest.raises(ValueError):
        KVSlotCache(0)
    c = KVSlotCache(2)
    with pytest.raises(SlotError, match="out of range"):
        c.free(7, "x")
    with pytest.raises(ValueError):
        c.allocate(None)


# ---------------------------------------------------------------------------
# request validation
# ---------------------------------------------------------------------------


def test_request_validates_prompt_and_budget():
    with pytest.raises(ValueError, match="non-empty 1-D"):
        Request(rid=0, prompt=np.zeros((2, 2), np.int32),
                max_new_tokens=4, seed=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(rid=0, prompt=np.arange(4), max_new_tokens=0, seed=0)


# ---------------------------------------------------------------------------
# scheduler over a MockEngine (pure host logic, no jax)
# ---------------------------------------------------------------------------


class MockEngine:
    """Deterministic stand-in for DecodeEngine: token ``t`` of every
    request is the global step index; records an event log so tests can
    assert scheduling shape (waves vs mid-flight joins)."""

    def __init__(self, max_slots, max_len=10**6, overflow_at=None):
        self.max_slots = max_slots
        self.max_len = max_len
        self._overflow_at = overflow_at  # pos ceiling remaining() honors
        self._pos = [0] * max_slots
        self._resident = [False] * max_slots
        self._toks = [[] for _ in range(max_slots)]  # per-slot token log
        self._t = 0
        self.events = []  # ("admit"|"step"|"release", detail)
        self.max_resident = 0

    def admit(self, slot, prompt, seed):
        self._pos[slot] = len(prompt)
        self._resident[slot] = True
        self._toks[slot] = [1000 + seed]  # the prefill-sampled token (t=0)
        self.max_resident = max(self.max_resident, sum(self._resident))
        self.events.append(("admit", slot))

    def step(self):
        self._t += 1
        self._pos = [p + 1 for p in self._pos]
        for s in range(self.max_slots):
            if self._resident[s]:
                self._toks[s].append(self._t)
        self.events.append(("step", self._t))

    def harvest(self, slot, n):
        return np.asarray(self._toks[slot][:n], np.int32)

    def remaining(self, slot):
        cap = self._overflow_at if self._overflow_at else self.max_len
        return cap - self._pos[slot]

    def release(self, slot):
        self._pos[slot] = 0
        self._resident[slot] = False
        self.events.append(("release", slot))


def _feed(reqs, depth=None):
    q = TrajectoryQueue(depth=depth or (len(reqs) + 2))
    for r in reqs:
        q.put(r)
    q.producer_done()
    return q


def _mock_reqs(gens, prompt_len=4):
    return [Request(rid=i, prompt=np.arange(1, prompt_len + 1),
                    max_new_tokens=g, seed=i) for i, g in enumerate(gens)]


def test_continuous_completes_all_and_admits_fifo():
    eng = MockEngine(2)
    reqs = _mock_reqs([3, 1, 2, 5, 1])
    sched = Scheduler(eng, _feed(reqs), continuous=True)
    done = sched.run()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3, 4]
    assert all(r.status == DONE for r in done)
    assert sched.admit_order == [0, 1, 2, 3, 4]  # FIFO admission
    assert eng.max_resident <= 2
    for r in done:
        assert r.tokens is not None and len(r.tokens) == r.max_new_tokens
        assert r._free is None and r.n_generated == r.max_new_tokens
    assert sched.slots.closed  # run() closes the pool on drain


def test_continuous_joins_mid_flight_lockstep_waits_for_wave():
    """With slots=2 and gens [4, 1, 1, 1]: continuous backfills the short
    requests while the long one decodes; lockstep drains each wave."""
    gens = [4, 1, 1, 1]
    cont = MockEngine(2)
    Scheduler(cont, _feed(_mock_reqs(gens)), continuous=True).run()
    lock = MockEngine(2)
    Scheduler(lock, _feed(_mock_reqs(gens)), continuous=False).run()
    # continuous: a new request joins while another is resident
    assert any(e[0] == "admit" and sum(cont._resident) >= 0
               for e in cont.events)
    joined_mid = False
    resident = 0
    for kind, _ in cont.events:
        if kind == "admit":
            joined_mid = joined_mid or resident > 0
            resident += 1
        elif kind == "release":
            resident -= 1
        elif kind == "step" and resident == 2:
            pass
    assert joined_mid
    # lockstep: every admit happens with an empty batch or during the
    # same wave-fill (never after a step with residents still active)
    resident = 0
    stepped_since_fill = False
    for kind, _ in lock.events:
        if kind == "admit":
            assert resident == 0 or not stepped_since_fill
            resident += 1
        elif kind == "step":
            stepped_since_fill = True
        elif kind == "release":
            resident -= 1
            if resident == 0:
                stepped_since_fill = False
    # lockstep idles finished rows: it needs at least as many steps
    assert lock._t >= cont._t


def test_oversized_request_errors_without_holding_a_slot():
    eng = MockEngine(2, max_len=8)
    good = Request(rid=0, prompt=np.arange(4), max_new_tokens=4, seed=0)
    bad = Request(rid=1, prompt=np.arange(4), max_new_tokens=40, seed=1)
    sched = Scheduler(eng, _feed([good, bad]), continuous=True)
    done = sched.run()
    by = {r.rid: r for r in done}
    assert by[0].status == DONE
    assert by[1].status == ERRORED and "max_len" in by[1].error
    assert by[1].slot is None and sched.slots.free_count == 2
    assert sched.admit_order == [0]  # never admitted


def test_overflow_evicts_errors_and_recycles_the_slot():
    # remaining() hits 0 after 2 decode steps; budget wants 10 tokens
    eng = MockEngine(1, max_len=100, overflow_at=6)
    r0 = Request(rid=0, prompt=np.arange(4), max_new_tokens=10, seed=0)
    r1 = Request(rid=1, prompt=np.arange(4), max_new_tokens=1, seed=1)
    sched = Scheduler(eng, _feed([r0, r1]), continuous=True)
    done = sched.run()
    by = {r.rid: r for r in done}
    assert by[0].status == ERRORED and "overflow" in by[0].error
    assert by[0].tokens is not None and len(by[0].tokens) >= 1  # partial
    assert sched.slots.evictions == 1
    assert by[1].status == DONE  # the evicted slot served the next request


def test_prefill_failure_returns_the_lease_and_errors_the_request():
    class FailingEngine(MockEngine):
        def admit(self, slot, prompt, seed):
            if seed == 1:
                raise RuntimeError("prefill exploded")
            return super().admit(slot, prompt, seed)

    eng = FailingEngine(2)
    reqs = _mock_reqs([2, 2, 2])  # seeds == rids; rid 1 fails
    sched = Scheduler(eng, _feed(reqs), continuous=True)
    done = sched.run()
    by = {r.rid: r for r in done}
    assert by[1].status == ERRORED and "prefill exploded" in by[1].error
    assert by[0].status == DONE and by[2].status == DONE
    assert sched.slots.free_count == 2  # nothing leaked


def test_open_loop_traffic_thread_feeds_the_scheduler():
    eng = MockEngine(2)
    q = TrajectoryQueue(depth=4)
    traffic = OpenLoopTraffic(q, 6, seed=3, rate_hz=200.0,
                              prompt_lens=(2, 4), gen_range=(1, 3))
    sched = Scheduler(eng, q, continuous=True)
    traffic.start()
    done = sched.run()
    traffic.join(timeout=10.0)
    assert sorted(r.rid for r in done) == list(range(6))
    assert all(r.status == DONE for r in done)
    assert all(r.t_submit > 0 and r.latency_s >= 0 for r in done)


# ---------------------------------------------------------------------------
# scheduler properties (hypothesis — dev extra)
# ---------------------------------------------------------------------------

if HAVE_HYPOTHESIS:

    @given(gens=st.lists(st.integers(1, 8), min_size=1, max_size=12),
           capacity=st.integers(1, 4),
           continuous=st.booleans())
    def test_property_conservation_and_fifo(gens, capacity, continuous):
        """Every request completes exactly once, in FIFO admission order,
        with exactly its token budget — under both scheduling modes."""
        eng = MockEngine(capacity)
        reqs = _mock_reqs(gens)
        sched = Scheduler(eng, _feed(reqs), continuous=continuous)
        done = sched.run()
        assert sorted(r.rid for r in done) == list(range(len(gens)))
        assert len({id(r) for r in done}) == len(done)  # exactly once
        assert sched.admit_order == list(range(len(gens)))
        for r in done:
            assert r.status == DONE
            assert len(r.tokens) == r.max_new_tokens  # no starvation
        assert eng.max_resident <= capacity  # slot bound

    @given(gens=st.lists(st.integers(1, 6), min_size=1, max_size=10),
           capacity=st.integers(1, 3),
           bad=st.sets(st.integers(0, 9)))
    def test_property_errors_conserve_and_free_slots(gens, capacity, bad):
        """Random prefill failures: every request still resolves exactly
        once (done or errored) and no slot leaks."""
        class Failing(MockEngine):
            def admit(self, slot, prompt, seed):
                if seed in bad:
                    raise RuntimeError("boom")
                return super().admit(slot, prompt, seed)

        eng = Failing(capacity)
        sched = Scheduler(eng, _feed(_mock_reqs(gens)), continuous=True)
        done = sched.run()
        assert sorted(r.rid for r in done) == list(range(len(gens)))
        for r in done:
            assert r.status == (ERRORED if r.seed in bad else DONE)
        assert sched.slots.free_count == capacity
        assert eng.max_resident <= capacity

    @given(data=st.data())
    def test_property_slot_cache_never_over_allocates(data):
        """Random allocate/free/evict interleavings keep the ledger sane:
        active never exceeds capacity, frees are exact, double ops raise."""
        capacity = data.draw(st.integers(1, 4))
        c = KVSlotCache(capacity)
        held = {}
        for i in range(data.draw(st.integers(1, 40))):
            op = data.draw(st.sampled_from(["alloc", "free", "evict"]))
            if op == "alloc":
                if len(held) == capacity:
                    with pytest.raises(SlotsExhausted):
                        c.allocate(f"r{i}")
                else:
                    held[c.allocate(f"r{i}")] = f"r{i}"
            elif op == "free" and held:
                slot = data.draw(st.sampled_from(sorted(held)))
                c.free(slot, held.pop(slot))
            elif op == "evict" and held:
                slot = data.draw(st.sampled_from(sorted(held)))
                assert c.evict(slot) == held.pop(slot)
            assert c.active_count == len(held) <= capacity
            assert c.active_count + c.free_count == capacity


# ---------------------------------------------------------------------------
# admission queue (the host queue plane's close/backpressure contract)
# ---------------------------------------------------------------------------


def test_queue_is_fifo_and_closes_after_the_last_producer():
    q = TrajectoryQueue(depth=3, producers=2)
    q.put("a")
    q.put("b")
    q.producer_done()
    assert q.get() == "a"
    q.put("c")  # the second producer is still live
    q.producer_done()
    assert [q.get(), q.get(), q.get()] == ["b", "c", CLOSED]


def test_queue_close_wakes_a_blocked_put():
    import threading

    q = TrajectoryQueue(depth=1)
    q.put("full")
    raised = []

    def blocked():
        try:
            q.put("late")
        except QueueClosed:
            raised.append(True)

    th = threading.Thread(target=blocked)
    th.start()
    q.close()
    th.join(timeout=5.0)
    assert not th.is_alive() and raised == [True]
    assert q.get() == "full" and q.get() is CLOSED
    assert q.put_wait_s >= 0.0 and q.get_wait_s >= 0.0


# ---------------------------------------------------------------------------
# the engine on the reduced qwen2 (CPU, fp32)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    from repro_torch.models import init_policy

    cfg = get_config("qwen2-7b").reduced()
    params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    return cfg, params


def _solo_tokens(cfg, params, probe, W, L):
    """Run one request alone, lockstep, on a fresh same-width engine."""
    eng = DecodeEngine(cfg, params, max_slots=W, max_len=L, device="cpu")
    solo = Request(rid=probe.rid, prompt=probe.prompt.copy(),
                   max_new_tokens=probe.max_new_tokens, seed=probe.seed)
    Scheduler(eng, _feed([solo]), continuous=False).run()
    return solo.tokens


def test_bitwise_continuous_equals_solo_lockstep(model):
    """The pin: under continuous batching with random co-residents, each
    request's sampled tokens are bitwise identical to running it alone —
    same seed, same fixed-width step, any co-residency."""
    cfg, params = model
    W, L = 3, 24
    reqs = make_requests(5, seed=11, prompt_lens=(4, 7, 9),
                         gen_range=(3, 8), vocab=cfg.vocab_size)
    eng = DecodeEngine(cfg, params, max_slots=W, max_len=L, device="cpu")
    sched = Scheduler(eng, _feed(reqs), continuous=True)
    done = sched.run()
    by = {r.rid: r for r in done}
    assert all(r.status == DONE for r in done)
    assert len(sched.admit_order) == 5
    for probe in reqs:
        solo = _solo_tokens(cfg, params, probe, W, L)
        assert np.array_equal(by[probe.rid].tokens, solo), (
            f"rid {probe.rid}: continuous {by[probe.rid].tokens.tolist()} "
            f"!= solo {solo.tolist()}")
        assert ((solo >= 0) & (solo < cfg.vocab_size)).all()


@pytest.mark.parametrize("arch,change", [
    ("dbrx-132b", {}), ("deepseek-v2-236b", {"mla_absorb": True})])
def test_bitwise_continuous_equals_solo_on_reduced_moe(arch, change):
    """At capacity factor E / k the capacity of a decode step (the W rows
    are one group) is at least W, so no row's expert slot depends on the
    other rows' routing and the pin holds as for the dense trunks."""
    from repro_torch.models import init_policy

    cfg = get_config(arch).reduced().replace(**change)
    cfg = cfg.replace(moe_capacity_factor=cfg.num_experts
                      / cfg.num_experts_per_tok)
    params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    W, L = 3, 24
    reqs = make_requests(5, seed=11, prompt_lens=(4, 7, 9),
                         gen_range=(3, 8), vocab=cfg.vocab_size)
    sched = Scheduler(DecodeEngine(cfg, params, max_slots=W, max_len=L,
                                   device="cpu"), _feed(reqs),
                      continuous=True)
    by = {r.rid: r for r in sched.run()}
    assert all(r.status == DONE for r in by.values()) and len(by) == 5
    for probe in reqs:
        solo = _solo_tokens(cfg, params, probe, W, L)
        assert np.array_equal(by[probe.rid].tokens, solo), probe.rid


def test_admit_first_token_logits_match_jax(model):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import init_policy as jax_init
    from repro.models import policy_prefill as jax_prefill
    from repro_torch.utils.bridge import params_from_numpy

    cfg = model[0]
    cfg_j = jax_config("qwen2-7b").reduced()
    pj = jax_init(jax.random.PRNGKey(3), cfg_j)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 9)
    eng = DecodeEngine(cfg, pt, max_slots=2, max_len=16, device="cpu")
    got = eng.admit(1, prompt, seed=5)
    ref, _, _ = jax_prefill(pj, cfg_j, jnp.asarray(prompt[None], jnp.int32),
                            max_len=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref[:, -1]),
                               rtol=1e-4, atol=1e-4)
    assert eng.remaining(1) == 16 - 9
    assert eng.harvest(1, 1).shape == (1,)


def test_sampling_draws_depend_only_on_seed_and_index():
    from repro_torch.utils.sampling import sample_streams, stream_generator

    logits = torch.zeros(3, 50)
    a = sample_streams(logits, [7, 7, 8], [0, 0, 0])
    assert a[0] == a[1]  # same (seed, t): same draw, whatever the row
    b = sample_streams(logits[:1], [7], [0])
    assert b[0] == a[0]
    draws = {int(sample_streams(logits[:1], [7], [t])[0]) for t in range(20)}
    assert len(draws) > 5  # the index moves the stream
    with pytest.raises(ValueError):
        stream_generator(-1, 0, "cpu")


def test_engine_rejects_bad_arguments(model):
    cfg, params = model
    with pytest.raises(ValueError):
        DecodeEngine(cfg, params, max_slots=0, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        DecodeEngine(cfg, params, max_slots=2, max_len=1, device="cpu")
    eng = DecodeEngine(cfg, params, max_slots=2, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="headroom"):
        eng.admit(0, np.arange(8, dtype=np.int32), 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecodeEngine(cfg, params, max_slots=2, max_len=8)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def test_launcher_continuous_runs_in_process_on_the_cpu():
    from repro_torch.launch.serve import main

    res = main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                "--continuous", "--requests", "5", "--slots", "2",
                "--prompt-len", "8", "--gen", "4"])
    assert len(res["requests"]) == 5
    assert all(r.status == DONE for r in res["requests"])
    assert res["tokens"] == sum(r.max_new_tokens for r in res["requests"])
    assert res["admitted"] == 5 and res["steps"] > 0 and res["tok_s"] > 0


def test_launcher_serves_dbrx_on_the_cpu():
    from repro_torch.launch.serve import main

    res = main(["--arch", "dbrx-132b", "--reduced", "--device", "cpu",
                "--continuous", "--requests", "4", "--slots", "2",
                "--prompt-len", "12", "--gen", "4"])
    assert res["admitted"] == 4
    assert all(r.status == DONE for r in res["requests"])
    res = main(["--arch", "deepseek-v2-236b", "--reduced", "--device",
                "cpu", "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert res["tokens"].shape == (2, 4) and res["logits_finite"]


def test_launcher_lockstep_demo_runs_in_process_on_the_cpu():
    from repro_torch.launch.serve import main

    res = main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                "--batch", "3", "--prompt-len", "6", "--gen", "4"])
    assert res["tokens"].shape == (3, 5) and res["logits_finite"]


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--continuous", "--requests", "1"])


def test_demo_generators_are_independent_streams():
    from repro_torch.launch.serve import demo_generators

    gens = demo_generators(0, "cpu")
    seeds = [g.initial_seed() for g in gens]
    assert len(set(seeds)) == 3
    again = [g.initial_seed() for g in demo_generators(0, "cpu")]
    assert again == seeds  # reproducible from the root seed
