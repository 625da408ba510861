"""PPO on the batched scheduling environment (the paper's Fig. 2)."""

from repro_torch.rl.policy import ActorCritic
from repro_torch.rl.ppo import PPOConfig, ppo_train
