"""Fixture: donated-reuse violation — the rule the port keeps so that it
reads either package: a tree read after riding a donated position."""
import jax

update_step = jax.jit(lambda p, o, t: (p, o), donate_argnums=(0, 1))


def learner_iter(params, opt_state, traj):
    new_params, new_opt = update_step(params, opt_state, traj)
    stale = params["w"].sum()        # params was donated: use-after-free
    return new_params, new_opt, stale
