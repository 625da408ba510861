"""The analytic performance model (host numpy, float64): the roofline of
every arch, and LM jobs and serving profiles for the twin."""

from repro_torch.perfmodel.constants import V5E
from repro_torch.perfmodel.roofline import analytic_roofline
from repro_torch.perfmodel.workload_gen import (
    lm_jobs_workload,
    lm_training_job,
    serving_profile,
)
