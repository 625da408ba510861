"""The scheduling environment over the twin (the RL slice)."""

from repro_torch.envs.sched_env import EnvState, SchedEnv
