"""The output check: a run of each cell on the CPU at a small n_e comes
out correct, and comes out not correct with the timed path broken
underneath (an action altered where it is sampled, each step's state put
back unchanged) or with the reference put in the program's place with half
of the batch left out, V-trace's weights taken as 1, or the state not
carried from update to update. The control (TF32, the precision below the
configurations' float32) runs on the card at each cell's own size."""
import dataclasses

import pytest
import torch

from portbench import harness, spec
from portbench.drivers import paac
from portbench.drivers import paac_reference as reference

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 977  # past 32 signed bits


def small(name: str, n_envs: int = 8) -> spec.Cell:
    c = spec.cell(name)
    return dataclasses.replace(c, traffic=dict(c.traffic, n_envs=n_envs,
                                               per_call=6))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "action", "frozen"])
def test_run_on_cpu(cell, fault):
    result, lines = harness.run_cell(small(cell), SEED, 0.2, trace=False,
                                     device="cpu", fault=fault)
    assert harness.schema_errors(result) == []
    assert result["correct"] is (fault is None), result["checks"]
    assert len(lines) == len(result["checks"])
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in
                                      spec.cell(cell).end_to_end}


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_fails(cell):
    c = small(cell)
    nums = paac.stand_in(c, SEED, "cpu", tf32=False, fault="half")
    assert any(v > c.limits[k] for k, v in nums.items()), nums


def test_traced_run_on_cpu():
    result, _ = harness.run_cell(small(CELLS[0]), SEED, 0.1, trace=True,
                                 device="cpu")
    assert harness.schema_errors(result) == []
    assert result["correct"] is True
    # a CPU run names no device metric
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(card, cell):
    c = spec.cell(cell)
    paac.set_precision(c)
    nums = paac.stand_in(c, SEED, card, tf32=True)
    assert any(v > c.limits[k] for k, v in nums.items()), nums


def test_setup_follows_one_call_of_the_window():
    """Set-up drives one ``run(per_call)``: the synchronous loop acts on
    policy; a pipelined actor acts each rollout with a published version at
    most ``queue_depth + 1`` updates behind."""
    for name in CELLS:
        c = small(name)
        s = paac.setup(c, SEED, "cpu")
        obs = paac.release(s)
        assert len(obs.actions) == paac.STEPS * c.traffic["t_max"]
        if c.traffic["backend"] == "sync":
            assert obs.versions == [0, 1, 2] and obs.staleness_max is None
        else:
            assert all(0 <= v <= i for i, v in enumerate(obs.versions))
            assert 0 <= obs.staleness_max <= c.traffic["queue_depth"] + 1


def test_reference_acts_each_rollout_with_its_version():
    c = small(CELLS[-1], n_envs=4)
    net, job = paac.net_of(c), c.job
    on = reference.run(net, job, SEED, "cpu", versions=[0, 1, 2])
    behind = reference.run(net, job, SEED, "cpu", versions=[0, 0, 1])
    # the first rollout is acted alike; later ones with older parameters,
    # so their importance weights leave 1
    assert on.losses[0] == behind.losses[0]
    assert on.losses[1]["loss"] != behind.losses[1]["loss"]
    assert abs(on.losses[1]["rho_mean"] - 1) < 1e-12
    assert abs(behind.losses[1]["rho_mean"] - 1) > 1e-6


@pytest.mark.parametrize("versions", [[0, 1], [0, 2, 1], [1, 1, 1]])
def test_reference_refuses_versions_ahead_of_the_rollout(versions):
    c = small(CELLS[-1], n_envs=4)
    with pytest.raises(ValueError):
        reference.run(paac.net_of(c), c.job, SEED, "cpu", versions=versions)


def test_an_actor_that_never_takes_up_a_publish_fails():
    c = small(CELLS[-1])
    nums = paac.stand_in(c, SEED, "cpu", tf32=False, fault="stale",
                         versions=[0, 0, 1], staleness_max=2)
    assert nums["staleness_max"] > c.limits["staleness_max"], nums


def test_importance_weights_taken_as_one_fail():
    """V-trace that ignores the weights of stale rollouts (here rollouts 2
    and 3 acted one version behind) changes the update of the steps that
    take them."""
    c = small(CELLS[-1], n_envs=16)
    nums = paac.stand_in(c, SEED, "cpu", tf32=False, fault="rho_one",
                         versions=[0, 0, 1], staleness_max=2)
    assert nums["change_gap"] > c.limits["change_gap"], nums


def test_a_state_not_carried_between_updates_fails():
    """The reference starts each update from the weights the program's
    previous update returned: a program whose updates each start again
    from the first weights fails, though each of them is an update."""
    c = small(CELLS[0])
    net, job = paac.net_of(c), c.job
    first = reference.run(net, job, SEED, "cpu", torch.float32)
    again = reference.run(net, job, SEED, "cpu", torch.float32,
                          states=[first.init] * paac.STEPS)
    assert paac.check(c, SEED, "cpu", first)["change_gap"] <= \
        c.limits["change_gap"]
    nums = paac.check(c, SEED, "cpu", again, extra=True)
    assert nums["change_gap"] > c.limits["change_gap"], nums
    assert max(nums["loss_gaps"][1:]) > c.limits["loss_gap"], nums
