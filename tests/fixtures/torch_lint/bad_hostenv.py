"""Fixture: hostenv-picklable violation — a locally defined env_fn cannot
cross a spawned worker's boundary."""
from repro_torch.envs.host_env import HostEnvSpec


def make_spec(n_envs):
    def env_fn(i):
        return object()

    return HostEnvSpec(env_fn, n_envs=n_envs, obs_shape=(16,))
