from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer,
    latest_step,
    read_meta,
    restore,
    save,
)
from repro_torch.checkpoint.episode import (
    check_fingerprint,
    run_episode_snapshotted,
    run_fingerprint,
    run_fleet_snapshotted,
)
